"""What every kind of cell shares: the checkout's paths and cache
directories, the seeded weights, the count of the window, the device
record, and the look for JAX in the process."""

import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# the program's build caches, at fixed paths inside the checkout
CACHE_DIR = ROOT / ".bench_cache"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "vipnerf_tpu")


class WindowClosed(Exception):
    """Raised from inside the program's loop once the window has closed."""


def prepare_environment():
    """Cache directories in the checkout, no JAX through a library, and the
    program on the import path."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(CACHE_DIR / sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules_loaded() -> List[str]:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package (whole names: the port's package is not the JAX package)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def mlp_leaf_shapes(mlp_cfg) -> Dict[str, Tuple[int, ...]]:
    """Each parameter's shape of one level of the configuration, by the
    reference checkpoint's names (weights (out, in))."""
    width, depth = mlp_cfg["netwidth"], mlp_cfg["netdepth"]
    pts_in = 3 * (1 + 2 * mlp_cfg["points_positional_encoding_degree"])
    views_in = 3 * (1 + 2 * mlp_cfg["views_positional_encoding_degree"])
    shapes = {}
    fan_in = pts_in
    for i in range(depth):
        shapes[f"pts_linears.{i}.weight"], shapes[f"pts_linears.{i}.bias"] = (width, fan_in), (width,)
        fan_in = width + pts_in if i == 4 else width
    shapes.update({"views_linears.0.weight": (width // 2, width + views_in), "views_linears.0.bias": (width // 2,),
                   "pts_output_linear.weight": (1, width), "pts_output_linear.bias": (1,),
                   "feature_linear.weight": (width, width), "feature_linear.bias": (width,),
                   "views_output_linear.weight": (4, width // 2), "views_output_linear.bias": (4,)})
    return shapes


def seeded_weights(model_cfg, seed: int, device, sigma_offset: float = 0.0, scenes: int = 1
                   ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Every scene's weights ({level: {leaf: tensor}}) drawn on `device` from
    `seed` in one call: torch.nn.Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weights and biases, `sigma_offset` added to the sigma biases."""
    shapes = {level: mlp_leaf_shapes(model_cfg[f"{level}_mlp"]) for level in ("coarse", "fine")}
    per_scene = sum(torch.Size(s).numel() for level in shapes.values() for s in level.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(scenes * per_scene, generator=g, device=device) * 2.0 - 1.0
    out, offset = [], 0
    for _ in range(scenes):
        scene = {}
        for level, leaves in shapes.items():
            scene[level] = {}
            for name, shape in leaves.items():
                n = torch.Size(shape).numel()
                fan_in = leaves[name.rsplit(".", 1)[0] + ".weight"][-1]
                vals = flat[offset:offset + n].reshape(shape) / fan_in ** 0.5
                if name == "pts_output_linear.bias":
                    vals = vals + sigma_offset
                scene[level][name] = vals.contiguous()
                offset += n
        out.append(scene)
    return out


@torch.no_grad()
def load_weights(model, weights: List[Dict[str, Dict[str, torch.Tensor]]]):
    """Copy the benchmark's weights into the program's model (one scene, or
    a stacked model's S scenes along its leading axis)."""
    for name, p in model.named_parameters():
        level, leaf = name.split("_model.", 1)
        vals = [w[level][leaf] for w in weights]
        p.copy_(vals[0] if len(vals) == 1 and p.shape == vals[0].shape else torch.stack(vals))


def device_record(device: torch.device, count: int) -> Dict[str, object]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def start_device(device: torch.device):
    """CUDA initialised on `device` and its peak-memory count started."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()
