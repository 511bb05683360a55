"""Learning-rate schedules (counterpart of vipnerf_tpu/train/lr_schedules.py).

A schedule maps the 0-based update count to a learning rate, as optax's
schedules do: update `it` (the optimizer's step count before the update,
restored on resume) runs at `schedule(it)`. The count is a number (a float
comes back) or a tensor of counts, one per scene, on the device (a tensor
comes back, computed there in its dtype, as optax computes in f32).

- NeRFLearningRateDecayer01: lr_initial * 0.1^(it / (lr_decay * 1000)).
- MipNeRFLearningRateDecayer01: log-lerp lr_initial -> lr_final over the run,
  with an optional reverse-cosine warm-up.
"""

import math
from typing import Any, Callable, Dict

import torch


def nerf_lr_decayer(optimizer_configs: Dict[str, Any]) -> Callable[[int], float]:
    lr_init = optimizer_configs["lr_initial"]
    lr_decay = optimizer_configs["lr_decay"]

    def schedule(step):
        return lr_init * (0.1 ** (step / (lr_decay * 1000.0)))

    return schedule


def mip_nerf_lr_decayer(optimizer_configs: Dict[str, Any]) -> Callable[[int], float]:
    lr_init = optimizer_configs["lr_initial"]
    lr_final = optimizer_configs["lr_final"]
    max_steps = optimizer_configs["num_iterations"]
    # the reference's key names first, the original mip-NeRF's second
    lr_delay_steps = optimizer_configs.get(
        "lr_decay_steps", optimizer_configs.get("lr_delay_steps", 0)
    )
    lr_delay_mult = optimizer_configs.get(
        "lr_decay_mult", optimizer_configs.get("lr_delay_mult", 1.0)
    )

    def schedule(step):
        if not torch.is_tensor(step):
            return float(schedule(torch.tensor(float(step), dtype=torch.float64)))
        delay_rate = 1.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        return delay_rate * torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return schedule


_REGISTRY = {
    "NeRFLearningRateDecayer01": nerf_lr_decayer,
    "MipNeRFLearningRateDecayer01": mip_nerf_lr_decayer,
}


def get_lr_schedule(configs: Dict[str, Any]) -> Callable[[int], float]:
    name = configs["optimizer"]["lr_decayer_name"]
    if name not in _REGISTRY:
        raise RuntimeError(f"Unknown lr decayer: {name}; known: {sorted(_REGISTRY)}")
    opt = dict(configs["optimizer"])
    opt.setdefault("num_iterations", configs.get("num_iterations"))
    return _REGISTRY[name](opt)
