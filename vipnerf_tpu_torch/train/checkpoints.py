"""Checkpoints in the reference torch layout (counterpart of
vipnerf_tpu/train/checkpoints.py, whose naming and symlink contract it keeps).

saved_models/Model_Iter{N:06}.tar holds `torch.save` of
{iteration_num, model_state_dict, optimizer_state_dict};
saved_models/Model_Latest.tar is a relative symlink to the newest one.
The weights' keys carry the `module.` prefix of a DataParallel-wrapped
model, which both of the reference's load paths need (they wrap the model
before `load_state_dict`); loading strips it.
Files are written to a temporary name and renamed, so a crash never leaves
half a checkpoint. In batched multi-scene training each scene has its own
file: its unstacked model and, with `scene`, its row of the optimizer.
"""

import os
from pathlib import Path
from typing import Optional

import torch
from torch import nn


def save_checkpoint(
    save_dir: Path,
    iteration_num: int,
    model: nn.Module,
    optimizer=None,
    scene: Optional[int] = None,
) -> Path:
    """Write Model_Iter{iter:06}.tar and refresh the Model_Latest symlink."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    state = {
        "iteration_num": iteration_num,
        "model_state_dict": {f"module.{k}": v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer_state_dict": optimizer.state_dict(scene) if optimizer is not None else {},
    }
    path = save_dir / f"Model_Iter{iteration_num:06}.tar"
    tmp = path.with_suffix(".tar.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    update_latest_symlink(save_dir, path)
    return path


def update_latest_symlink(save_dir: Path, path: Path) -> None:
    """Point Model_Latest (with `path`'s suffix: .tar, or .ckpt for the JAX
    package's files) at `path` unless it already points at a newer
    iteration; a dangling or unparseable Latest is replaced."""
    latest = Path(save_dir) / f"Model_Latest{Path(path).suffix}"
    if latest.is_symlink() or latest.exists():
        if latest.exists():
            try:
                if checkpoint_iteration(latest) > checkpoint_iteration(path):
                    return
            except (ValueError, OSError):
                pass
        latest.unlink()
    latest.symlink_to(Path(path).name)


def load_checkpoint(
    path: Path,
    model: nn.Module,
    optimizer=None,
    scene: Optional[int] = None,
) -> int:
    """Load the weights (and optimizer state, into row `scene` of a
    stacked optimizer) of `path` into `model` (and `optimizer`); returns the
    iteration number. The optimizer is given the iteration number too: a
    state with no entries resumes its count there."""
    device = next(model.parameters()).device
    state = torch.load(Path(path), map_location=device, weights_only=True)
    sd = state["model_state_dict"]
    if any(k.startswith("module.") for k in sd):  # DataParallel-wrapped reference
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    model.load_state_dict(sd)
    iteration_num = int(state["iteration_num"])
    if optimizer is not None:
        optimizer.load_state_dict(state.get("optimizer_state_dict") or {}, scene, iteration_num)
    return iteration_num


def latest_checkpoint(save_dir: Path) -> Optional[Path]:
    latest = Path(save_dir) / "Model_Latest.tar"
    if latest.exists():
        return latest
    candidates = sorted(
        Path(save_dir).glob("Model_Iter*.tar"),
        key=lambda p: int(p.stem.replace("Model_Iter", "")),
    )
    return candidates[-1] if candidates else None


def checkpoint_iteration(path: Path) -> int:
    """Iteration number of a checkpoint file (resolves Model_Latest)."""
    return int(Path(path).resolve().stem.replace("Model_Iter", ""))
