"""Helpers of the benchmark's CPU tests: the benchmark's folder on the
import path, TensorBoard kept out (the program's scalar logger then writes
its JSON lines only), and the cells' configurations cut to a size the CPU
runs in seconds (the widths stay: K1's plain version needs them)."""

import copy
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
sys.modules.setdefault("tensorboard", None)

from harness import cells  # noqa: E402

SEED = 2 ** 31 + 12345  # above 32 signed bits, as the driver's seeds are


def tiny_config(name: str):
    bench = cells.load_benchmark()
    cfg = copy.deepcopy(cells.load_config(bench, name))
    cfg["scene"].update(height=24, width=32)
    dl = cfg["train_configs"]["data_loader"]
    dl["num_rays"] = 64
    if "sparse_depth" in dl:
        dl["sparse_depth"]["num_rays"] = 64
    for level in ("coarse_mlp", "fine_mlp"):
        cfg["train_configs"]["model"][level]["num_samples"] = 16
    cfg["program_overrides"] = {}
    return cfg


def tiny_mix(name: str):
    mix = cells.load_traffic(name)
    if mix["driver"] == "train":
        mix["scan_steps"] = 4
    else:
        mix.update(chunk_size=256, check_pixels=64)
    return mix
