"""Time K1 at the paths' launch shapes, for one copy of the port or several
in one process (an A/B of two trees on the same card).

    python vipnerf_tpu_torch/kernels/time_k1.py [ROOT ...]

Each ROOT is a directory that holds a `vipnerf_tpu_torch/` (default: this
repository); with several, each is timed in the order given, in a fresh
subprocess, so "A B B A" gives two readings of each. For each tree: the
build's ptxas lines (registers, spills) and, for every instance (bf16,
f32, bf16_f32h), the CUDA-event time of one call (median of 5 rounds of
20; bf16_f32h's call is its two launches) at the serving
tile shapes (8192 rays x 64 / x 192 points, n_sec 0) and the training
step's (4096 x 64 / x 192, n_sec 2), with seed-0 flagship weights. Prints
one JSON line per tree. Needs CUDA.
"""

import json
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

    build.build_all(["fused_mlp"])
    ptxas = [line.strip() for line in build.ptxas_reports.get("fused_mlp", "").splitlines()
             if "registers" in line or "spill" in line]
    dev = torch.device("cuda", 0)
    mlp = NeRFMLP(flagship_mlp_config(0), torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    out = {"root": str(root), "ptxas": ptxas}
    for dtype, f32_heads in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True)):
        weights = k1.prepare_weights(mlp, dtype, f32_heads)
        for label, n, n_sec in SHAPES:
            pts = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
            vd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
            vd2 = (torch.nn.functional.normalize(torch.randn((n, n_sec, 3), generator=g, device=dev), dim=-1)
                   if n_sec else None)
            xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
            for _ in range(3):
                k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
            rounds = []
            for _ in range(5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
                end.record()
                torch.cuda.synchronize()
                rounds.append(start.elapsed_time(end) / 20)
            out[f"{k1.INSTANCE[weights.mode]} {label}"] = sorted(rounds)[2]
    return out


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
