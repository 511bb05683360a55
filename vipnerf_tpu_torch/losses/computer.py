"""LossComputer: the weighted sum of the configured losses (counterpart of
vipnerf_tpu/losses/computer.py).

A loss has a constant `weight` or iteration-staged `iter_weights` (the
largest threshold <= the iteration wins; a '0' stage is required, checked up
front); a loss that returns None is skipped; the result holds each loss's
dict and 'TotalLoss'. The iteration is a Python int here, so a staged weight
is a Python float.

`scene_losses` views a batch of S scenes' rays and its render (flat, S*R
rays scene-major) as (S, R, ...), so that every loss comes out per scene.
"""

from typing import Any, Callable, Dict

import torch

from vipnerf_tpu_torch.losses import functions

_REGISTRY: Dict[str, Callable] = {
    "MSE01": functions.mse,
    "VisibilityLoss01": functions.visibility_loss,
    "VisibilityPriorLoss01": functions.visibility_prior_loss,
    "SparseDepthMSE01": functions.sparse_depth_mse,
    "DenseDepthMSE01": functions.dense_depth_mse,
}


class LossComputer:
    def __init__(self, configs: Dict[str, Any]):
        self.configs = configs
        self.losses: Dict[str, Callable] = {}
        self.loss_configs: Dict[str, Dict[str, Any]] = {}
        for loss_cfg in configs["losses"]:
            name = loss_cfg["name"]
            if name not in _REGISTRY:
                raise RuntimeError(f"Unknown Loss Function: {name}; known: {sorted(_REGISTRY)}")
            self.losses[name] = _REGISTRY[name](configs, loss_cfg)
            self.loss_configs[name] = loss_cfg
            if "weight" not in loss_cfg and "iter_weights" in loss_cfg:
                if min(int(k) for k in loss_cfg["iter_weights"]) != 0:
                    raise RuntimeError(
                        f"Invalid iter_weights for {name}: a '0' stage is "
                        f"required (got {sorted(loss_cfg['iter_weights'])})"
                    )

    def get_loss_weight(self, name: str, iter_num: int) -> float:
        cfg = self.loss_configs[name]
        if "weight" in cfg:
            return cfg["weight"]
        if "iter_weights" in cfg:
            stages = sorted((int(k), v) for k, v in cfg["iter_weights"].items())
            return ([0.0] + [v for threshold, v in stages if iter_num >= threshold])[-1]
        raise RuntimeError(f"loss weight is unspecified for {name}")

    def compute_losses(
        self, batch: Dict[str, Any], outputs: Dict[str, Any], *, return_loss_maps: bool = False
    ) -> Dict[str, Any]:
        """{loss_name: {'loss_value': ...[, 'loss_maps': ...]}, 'TotalLoss': x};
        `batch['iter_num']` selects staged weights."""
        iter_num = int(batch["iter_num"])
        loss_values: Dict[str, Any] = {}
        total = torch.zeros((), device=batch["rays_o"].device)
        for name, loss_fn in self.losses.items():
            loss_dict = loss_fn(batch, outputs, return_loss_maps)
            if loss_dict is None:
                continue
            loss_values[name] = loss_dict
            total = total + self.get_loss_weight(name, iter_num) * loss_dict["loss_value"]
        loss_values["TotalLoss"] = total
        return loss_values

    def scene_losses(self, batch: Dict[str, Any], outputs: Dict[str, Any], scenes: int) -> Dict[str, Any]:
        """`compute_losses` of each of S scenes' rays: every value (S,)."""
        nr = batch["rays_o"].shape[0]

        def per_scene(tree):
            return {k: v.reshape(scenes, nr // scenes, *v.shape[1:])
                    if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr else v
                    for k, v in tree.items()}

        return self.compute_losses(per_scene(batch), per_scene(outputs))
