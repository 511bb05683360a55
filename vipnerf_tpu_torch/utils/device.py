"""Which device an entry point runs on."""

from typing import Any

import torch

from vipnerf_tpu_torch.parallel.mesh import current_group, select_devices


def resolve_device(device_sel: Any = "all") -> torch.device:
    """`test_configs['device']` -> this process's torch.device.

    In a rank of a multi-device run, that rank's device; otherwise the first
    device `parallel.mesh.select_devices` gives ("all" or None: cuda:0; [i,
    ...]: cuda:i; "cpu" or ["cpu", ...]: the CPU), as the JAX package's
    `get_device` takes the first configured device. The entry points that
    shard (training, batched training, testing) start one rank per selected
    device before they get here. Without CUDA, any choice but the CPU
    raises: the port never falls back to the CPU quietly.
    """
    group = current_group(device_sel)
    return group.device if group is not None else select_devices(device_sel)[0]


def device_from_arg(arg: str) -> Any:
    """A CLI's --device value ("all", "cpu", a GPU index or a comma-separated
    list of them, "cpu,cpu" for two CPU ranks) -> the selection
    `resolve_device` takes."""
    if "," not in arg:
        return [int(arg)] if arg.isdigit() else arg
    parts = [p.strip() for p in arg.split(",")]
    return [int(p) if p.isdigit() else p for p in parts]
