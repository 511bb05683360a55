"""Time K1 at the paths' launch shapes, for one copy of the port or several
in one process (an A/B of two trees on the same card).

    python vipnerf_tpu_torch/kernels/time_k1.py [ROOT ...]

Each ROOT is a directory that holds a `vipnerf_tpu_torch/` (default: this
repository); with several, each is timed in the order given, in a fresh
subprocess, so "A B B A" gives two readings of each. For each tree: the
build's ptxas lines (registers, spills) and, for every instance (bf16,
f32, bf16_f32h, and bf16_f32h with FFMA heads, the tensor-core heads'
yardstick), the CUDA-event time of one call (median of 5 rounds of 20;
bf16_f32h's call is its two launches, also split per kernel by
torch.profiler) at the serving
tile shapes (8192 rays x 64 / x 192 points, n_sec 0) and the training
step's (4096 x 64 / x 192, n_sec 2), with seed-0 flagship weights; and, at
the training step's shapes, the shipped mode's backward: each of its two
kernels (`heads_bwd_points`, `heads_bwd_weights`) in turns with the first
design's (`*_mma_sync`, where the tree has them: first design, new, new,
first design, each turn a median as above), and their yardstick (autograd
through raw_recompute's f32 heads on cuBLAS). Prints one JSON line per
tree. Needs CUDA.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

SHAPES = [("serving coarse", 8192 * 64, 0), ("serving fine", 8192 * 192, 0),
          ("training coarse", 4096 * 64, 2), ("training fine", 4096 * 192, 2)]


def time_tree(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from vipnerf_tpu_torch.data.synthetic_rig import flagship_mlp_config
    from vipnerf_tpu_torch.kernels import build
    from vipnerf_tpu_torch.kernels import fused_mlp as k1
    from vipnerf_tpu_torch.models.mlp import NeRFMLP

    libs = [lib for lib in ("fused_mlp", "fused_mlp_bwd", "fused_mlp_bwd_mma_sync") if lib in build.SOURCES]
    build.build_all(libs)
    ptxas = [f"{lib}: {line.strip()}" for lib in libs
             for line in build.ptxas_reports.get(lib, "").splitlines() if "Used " in line or "spill" in line]
    dev = torch.device("cuda", 0)
    mlp = NeRFMLP(flagship_mlp_config(0), torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"root": str(root), "ptxas": ptxas}
    def median_ms(fn):
        for _ in range(3):
            fn()
        rounds = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            rounds.append(start.elapsed_time(end) / 20)
        return sorted(rounds)[2]

    for dtype, f32_heads in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)):
        weights = k1.prepare_weights(mlp, dtype, f32_heads)
        for label, n, n_sec in SHAPES:
            pts = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
            vd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
            vd2 = (torch.nn.functional.normalize(torch.randn((n, n_sec, 3), generator=g, device=dev), dim=-1)
                   if n_sec else None)
            xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
            out[f"{k1.INSTANCE[weights.mode]} {label}"] = median_ms(lambda: k1.fused_mlp_raw(weights, xe, ve, ve2, ns))
            if f32_heads:
                heads32 = k1.ffma_heads(weights)
                out[f"fused_mlp_bf16_f32h_ffma {label}"] = median_ms(
                    lambda: k1.fused_mlp_raw_ffma(weights, heads32, xe, ve, ve2, ns))
                out[f"fused_mlp_bf16_f32h {label} per kernel"] = kernel_split_ms(
                    lambda: k1.fused_mlp_raw(weights, xe, ve, ve2, ns))
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    params = [p.detach() for p in k1.module_params(mlp)]
    for label, n, n_sec in SHAPES[2:]:
        pts = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        vd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
        vd2 = torch.nn.functional.normalize(torch.randn((n, n_sec, 3), generator=g, device=dev), dim=-1)
        xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True)
        with torch.no_grad():
            h = k1.trunk_recompute(params[:16], xe).reshape(n, -1).contiguous()
        up = torch.randn((n, k1.NOUT), generator=g, device=dev) * 1e-3
        heads = params[16:]
        mid = k1.heads_bwd_points(weights, heads, h, ve, ve2, up, ns, False, False)
        new = {"heads_bwd_points": lambda: k1.heads_bwd_points(weights, heads, h, ve, ve2, up, ns, False, False),
               "heads_bwd_weights": lambda: k1.heads_bwd_weights(mid, h, ve, ve2, up)}
        if not hasattr(k1, "heads_bwd_points_mma_sync"):  # a tree from before the redesign
            out.update({f"{name} {label}": median_ms(fn) for name, fn in new.items()})
        else:
            first = {
                "heads_bwd_points": lambda: k1.heads_bwd_points_mma_sync(weights, h, ve, ve2, up, ns, False, False),
                "heads_bwd_weights": lambda: k1.heads_bwd_weights_mma_sync(mid, h, ve, ve2, up)}
            for name in new:
                turns = [median_ms(fn) for fn in (first[name], new[name], new[name], first[name])]
                out[f"{name} {label}"] = (turns[1] + turns[2]) / 2
                out[f"{name}_mma_sync {label}"] = (turns[0] + turns[3]) / 2
                out[f"{name} {label} turns (first design, new, new, first design)"] = turns
        out[f"heads_backward_recompute {label}"] = median_ms(
            lambda: k1.heads_backward_recompute(heads, h, ve, ve2, up, ns))
    return out


def kernel_split_ms(fn, calls: int = 20) -> dict:
    """Device ms per call of each CUDA kernel `fn` launches, from
    torch.profiler over `calls` calls ("not measured" if the profiler
    records no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        name = re.search(r"fused_mlp_(\w+?)_kernel<([^>]*)>", evt.key)
        if us and name:  # e.g. "bf16<false, true>" (the trunk) and "heads<false>"
            kernel = f"{name.group(1)}<{name.group(2)}>"
            split[kernel] = split.get(kernel, 0.0) + us / 1e3 / calls
    return split or "not measured"


def main(argv) -> int:
    roots = argv or [str(Path(__file__).resolve().parents[2])]
    if len(roots) == 1:
        print(json.dumps(time_tree(Path(roots[0]).resolve())), flush=True)
        return 0
    for root in roots:
        rc = subprocess.run([sys.executable, __file__, root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
