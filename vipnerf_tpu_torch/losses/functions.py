"""The five ViP-NeRF losses on torch tensors (counterpart of
vipnerf_tpu/losses/functions.py, same semantics):

- MSE01: per-ray channel-mean squared rgb error on nerf-stream rays, per
  coarse and fine.
- VisibilityLoss01: symmetric stop-gradient MAE between the MLP's per-point
  visibility and the compositing transmittance, over all rays (pad rays of a
  tiled render excluded through `ray_valid`).
- VisibilityPriorLoss01: sum over other views of prior * (1 - vis2) on
  nerf-stream rays; None without visibility2 (validation-view renders).
- SparseDepthMSE01: squared depth error on sparse-depth-stream rays (fine
  depth when a fine MLP exists, else coarse); 0 for full-image batches.
- DenseDepthMSE01: depth MSE against the dense prior on nerf-stream rays.
  As in the JAX package, the fine branch uses the whole depth_fine vector
  (the reference's fine branch reads an undefined attribute).

Masked means are sum(x * mask) / max(count, 1): 0 on an empty mask.

Every mean runs over the last ray axis, so a batch of S scenes shaped
(S, R, ...) (batched multi-scene training) gives each loss per scene, (S,),
as vmapping the JAX losses over the scenes does; a flat batch gives ().
"""

from typing import Any, Dict

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of values[mask] over the last axis; 0 when the mask is empty.
    values, mask: ([S,] nr)."""
    mask = mask.to(values.dtype)
    return torch.sum(values * mask, dim=-1) / torch.clamp(torch.sum(mask, dim=-1), min=1.0)


def _levels(configs: Dict[str, Any]):
    model = configs["model"]
    return [s for s in ("coarse", "fine") if f"{s}_mlp" in model]


def mse(configs: Dict[str, Any], loss_configs: Dict[str, Any]):
    levels = _levels(configs)

    def compute(batch, outputs, return_loss_maps=False):
        mask = batch["indices_mask_nerf"]
        target = batch["target_rgb"]
        total = 0.0
        loss_maps = {}
        for suffix in levels:
            per_ray = torch.mean(torch.square(outputs[f"rgb_{suffix}"] - target), dim=-1)
            total = total + _masked_mean(per_ray, mask)
            if return_loss_maps:
                loss_maps[f"MSE01_{suffix}"] = per_ray
        out = {"loss_value": total}
        if return_loss_maps:
            out["loss_maps"] = loss_maps
        return out

    return compute


def visibility_loss(configs: Dict[str, Any], loss_configs: Dict[str, Any]):
    levels = _levels(configs)

    def compute(batch, outputs, return_loss_maps=False):
        total = 0.0
        loss_maps = {}
        for suffix in levels:
            pred = outputs[f"raw_visibility_{suffix}"][..., 0]  # (nr, ns)
            target = outputs[f"visibility_{suffix}"]  # (nr, ns) transmittance
            map1 = torch.mean(torch.abs(pred - target.detach()), dim=-1)
            map2 = torch.mean(torch.abs(pred.detach() - target), dim=-1)
            if "ray_valid" in batch:
                total = (total + _masked_mean(map1, batch["ray_valid"])
                         + _masked_mean(map2, batch["ray_valid"]))
            else:
                total = total + torch.mean(map1, dim=-1) + torch.mean(map2, dim=-1)
            if return_loss_maps:
                loss_maps[f"VisibilityLoss01_{suffix}"] = map1 + map2
        out = {"loss_value": total}
        if return_loss_maps:
            out["loss_maps"] = loss_maps
        return out

    return compute


def visibility_prior_loss(configs: Dict[str, Any], loss_configs: Dict[str, Any]):
    levels = _levels(configs)

    def compute(batch, outputs, return_loss_maps=False):
        if any(f"raw_visibility2_{s}" not in outputs for s in levels):
            return None
        mask = batch["indices_mask_nerf"]
        if "visibility_prior_masks" in batch:
            prior = batch["visibility_prior_masks"]
        elif "visibility_prior_weights" in batch:
            prior = batch["visibility_prior_weights"]
        else:
            nf_m1 = outputs[f"visibility2_{levels[0]}"].shape[-1]
            rays_o = batch["rays_o"]
            prior = torch.ones(rays_o.shape[:-1] + (nf_m1,), dtype=rays_o.dtype, device=rays_o.device)
        total = 0.0
        loss_maps = {}
        for suffix in levels:
            per_ray = torch.sum(prior * (1.0 - outputs[f"visibility2_{suffix}"]), dim=-1)
            total = total + _masked_mean(per_ray, mask)
            if return_loss_maps:
                loss_maps[f"VisibilityPriorLoss01_{suffix}"] = per_ray
        out = {"loss_value": total}
        if return_loss_maps:
            out["loss_maps"] = loss_maps
        return out

    return compute


def sparse_depth_mse(configs: Dict[str, Any], loss_configs: Dict[str, Any]):
    suffix = "fine" if "fine_mlp" in configs["model"] else "coarse"

    def compute(batch, outputs, return_loss_maps=False):
        if "indices_mask_sparse_depth" not in batch:
            rays_o = batch["rays_o"]
            return {"loss_value": torch.zeros(rays_o.shape[:-2], device=rays_o.device)}
        per_ray = torch.square(outputs[f"depth_{suffix}"] - batch["sparse_depth_values"][..., 0])
        out = {"loss_value": _masked_mean(per_ray, batch["indices_mask_sparse_depth"])}
        if return_loss_maps:
            out["loss_maps"] = {}
        return out

    return compute


def dense_depth_mse(configs: Dict[str, Any], loss_configs: Dict[str, Any]):
    levels = _levels(configs)

    def compute(batch, outputs, return_loss_maps=False):
        mask = batch["indices_mask_nerf"]
        gt = batch["dense_depth_values"][..., 0]
        total = 0.0
        loss_maps = {}
        for suffix in levels:
            per_ray = torch.square(outputs[f"depth_{suffix}"] - gt)
            total = total + _masked_mean(per_ray, mask)
            if return_loss_maps:
                loss_maps[f"DenseDepthMSE01_{suffix}"] = per_ray
        out = {"loss_value": total}
        if return_loss_maps:
            out["loss_maps"] = loss_maps
        return out

    return compute
