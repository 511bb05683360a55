"""Which device an entry point runs on."""

from typing import Any

import torch


def resolve_device(device_sel: Any = "all") -> torch.device:
    """`test_configs['device']` -> torch.device.

    "all", None or [0] -> cuda:0; [i] -> cuda:i; "cpu" -> the CPU. The
    counterpart of vipnerf_tpu/parallel/mesh.py `select_devices` for one
    card: batched multi-scene training puts all its scenes on this device.
    More than one GPU (scenes or rays sharded over several) is the last slice
    of the port, not yet here. Without CUDA, any choice but "cpu" raises:
    the port never falls back to the CPU quietly.
    """
    if device_sel == "cpu":
        return torch.device("cpu")
    if device_sel in ("all", None):
        index = 0
    elif isinstance(device_sel, (list, tuple)):
        if len(device_sel) != 1:
            raise NotImplementedError(
                f"device {device_sel!r}: sharding scenes or rays over more than one "
                "GPU arrives with the last slice of the port; one GPU runs every scene"
            )
        index = int(device_sel[0])
    else:
        raise ValueError(f"unrecognized device selection: {device_sel!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device_sel!r} asks for CUDA, which is not available; "
            'pass device "cpu" to run on the CPU'
        )
    if index >= torch.cuda.device_count():
        raise ValueError(f"cuda:{index} requested, {torch.cuda.device_count()} present")
    return torch.device("cuda", index)


def device_from_arg(arg: str) -> Any:
    """A CLI's --device value ("all", "cpu" or a GPU index) -> the selection
    `resolve_device` takes."""
    return [int(arg)] if arg.isdigit() else arg
