"""One training iteration: render -> losses -> backward -> Adam (counterpart
of vipnerf_tpu/train/step.py `make_optimizer` and `make_train_step`).

- Adam with b1/b2 from the config and eps 1e-8: torch's update is optax's
  (m/(1-b1^t)) / (sqrt(v/(1-b2^t)) + eps). As in optax, update `it` (the
  optimizer's count of earlier updates, saved and restored with its state)
  runs at `schedule(it)`.
- Optional `optimizer.grad_clip_norm`: the gradients are scaled to that
  global norm when it is exceeded, before Adam (optax clip_by_global_norm).
- `sub_batch_size`: the batch is cut into equal sub-batches whose gradients
  are summed before one step; the loss scalars are summed too.
- The loss scalars stay on the device: the caller reads them when it needs
  them, not every step.

The JAX package's TPU dispatch (`make_scan_train`, `make_host_loop_train`,
`default_step_dispatch`) has no counterpart: PyTorch runs eagerly. The
optax `loss_guard` of vipnerf_tpu/train/guards.py is not ported yet.
"""

from typing import Any, Callable, Dict, List

import torch

from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule


def make_optimizer(configs: Dict[str, Any], params) -> torch.optim.Optimizer:
    opt_cfg = configs["optimizer"]
    if opt_cfg.get("loss_guard") is not None:
        raise NotImplementedError(
            "optimizer.loss_guard arrives with a later slice of the port"
        )
    return torch.optim.Adam(
        params, lr=get_lr_schedule(configs)(0),
        betas=(opt_cfg.get("beta1", 0.9), opt_cfg.get("beta2", 0.999)), eps=1e-8,
    )


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale `grads` in place to global norm `max_norm` when it is exceeded."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = (max_norm / norm).clamp(max=1.0)
    for g in grads:
        g.mul_(scale)


def update_count(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has made (Adam keeps the count on the host)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0], {})
    return int(state["step"]) if "step" in state else 0


def _sub_batches(batch: Dict[str, Any], size: int):
    nr = batch["rays_o"].shape[0]
    if nr % size:
        raise ValueError(f"sub_batch_size {size} does not divide the batch of {nr} rays")
    ray_keys = {k for k, v in batch.items()
                if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr}
    for i in range(nr // size):
        yield {k: v[i * size:(i + 1) * size] if k in ray_keys else v for k, v in batch.items()}


def make_train_step(
    configs: Dict[str, Any],
    render_fn: Callable,
    loss_computer: LossComputer,
    optimizer: torch.optim.Optimizer,
) -> Callable:
    """train_step(model, batch, generator) -> {loss name: 0-d device tensor},
    after one optimizer step."""
    sub_batch_size = configs.get("sub_batch_size")
    schedule = get_lr_schedule(configs)
    clip = configs["optimizer"].get("grad_clip_norm")

    def loss_and_backward(model, batch, generator):
        outputs = render_fn(model, configs, batch, train=True, generator=generator)
        losses = loss_computer.compute_losses(batch, outputs)
        losses["TotalLoss"].backward()
        return {k: (v["loss_value"] if isinstance(v, dict) else v).detach()
                for k, v in losses.items()}

    def train_step(model, batch, generator):
        optimizer.zero_grad(set_to_none=True)
        if sub_batch_size is None:
            scalars = loss_and_backward(model, batch, generator)
        else:
            scalars = None
            for sub in _sub_batches(batch, sub_batch_size):
                part = loss_and_backward(model, sub, generator)
                scalars = part if scalars is None else {k: scalars[k] + part[k] for k in part}
        if clip:
            clip_by_global_norm(
                [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None],
                float(clip),
            )
        lr = schedule(update_count(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return scalars

    return train_step
