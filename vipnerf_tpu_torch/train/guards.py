"""Divergence guard: reject optimizer steps whose loss spikes far above the
running average (counterpart of vipnerf_tpu/train/guards.py `loss_guard`).

Off by default. `configs['optimizer']['loss_guard'] = {}` turns it on with
the defaults below; its keys are the JAX package's:

    factor                 10.0  reject when loss > factor * EMA
    ema_decay              0.99  EMA horizon ~100 steps
    warmup                 100   always accept the first N steps
    max_consecutive_skips  100   fail-open: never freeze training

Semantics, as the optax wrapper has them: the first step seeds the EMA (even
with warmup 0); the EMA tracks accepted steps only; `count` counts every
step seen. The optimizer (train/step.py `Adam`) applies a zero update on a
rejected step and holds its moments and its count, so the learning-rate
schedule reads the count of accepted updates.

The state holds S guards at once (one per scene in batched multi-scene
training, as `vmap` of the optax wrapper gives) and stays on the device: a
decision costs a few elementwise kernels and no host read. It is updated in
place, so a training step replayed as a CUDA graph carries it on.
"""

from typing import Any, Dict

import torch


class LossGuard:
    """ema (S,) of accepted losses, count (S,) of steps seen, skips (S,) of
    consecutive rejections."""

    def __init__(self, scenes: int, device, *, factor: float = 10.0, ema_decay: float = 0.99,
                 warmup: int = 100, max_consecutive_skips: int = 100):
        self.factor, self.ema_decay = factor, ema_decay
        self.warmup, self.max_consecutive_skips = warmup, max_consecutive_skips
        self.ema = torch.zeros(scenes, dtype=torch.float32, device=device)
        self.count = torch.zeros(scenes, dtype=torch.int32, device=device)
        self.skips = torch.zeros(scenes, dtype=torch.int32, device=device)

    def __call__(self, loss: torch.Tensor) -> torch.Tensor:
        """The (S,) accept mask of a step with loss (S,) (or () for one
        guard); advances the state."""
        loss = loss.detach().float().reshape(self.ema.shape)
        first = self.count == 0
        accept = (first | (self.count < self.warmup) | (self.skips >= self.max_consecutive_skips)
                  | (loss <= self.factor * self.ema))
        ema_next = torch.where(first, loss, self.ema_decay * self.ema + (1.0 - self.ema_decay) * loss)
        # in place, as the optimizer's state: a replayed CUDA graph writes where it captured
        self.ema.copy_(torch.where(accept, ema_next, self.ema))
        self.skips.copy_(torch.where(accept, 0, self.skips + 1))
        self.count.add_(1)
        return accept

    def state(self, row: int) -> Dict[str, Any]:
        """Guard `row`'s state as numbers, for a checkpoint."""
        return {"ema": float(self.ema[row]), "count": int(self.count[row]), "skips": int(self.skips[row])}

    def load(self, row: int, state: Dict[str, Any]):
        self.ema[row], self.count[row], self.skips[row] = state["ema"], state["count"], state["skips"]
