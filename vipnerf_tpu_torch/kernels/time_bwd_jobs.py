"""Where the shipped-mode weight-gradient kernel's time goes, job by job.

    python vipnerf_tpu_torch/kernels/time_bwd_jobs.py

There is no `ncu` on the card's machine, so this builds variants of
csrc/fused_mlp_bwd.cu with parts of the weight kernel cut out and times
each launch (`heads_bwd_weights`, its two launches) at the training step's
two shapes (4096 x 192 and x 64 points, n_sec 2, seed-0 flagship weights):
the kernel as it is; each job alone (the CTAs of the other jobs return at
once): the small jobs, dW10f, dW8, dW10p; dW10f and dW8 alone without their
wgmma chains ("nochain": the ring, the split and the promotion), and without
the split too ("bare": the tensor-map copies, the mbarriers and the
barriers). The differences give each part's cost; a variant's outputs are
not checked. Variants build into vipnerf_tpu_torch/build/bwd_jobs/ with
nvcc, all at once. Prints one JSON line. Needs CUDA.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path


def variants(src: str) -> dict:
    """The source of each variant, cut by replacing one marker each."""
    job_start = "  const int local = blockIdx.x - job.cta0;\n"
    chain = "for (int cls = 2; cls >= 0; --cls)"
    splits = ["for (int i = 0; i < MT / 32; ++i)", "for (int i = 0; i < NT / 32; ++i)",
              "for (int i = 0; i < 4; ++i) {\n        const int u = tid + 256 * i, c8"]
    for marker in [job_start, chain] + splits:
        if src.count(marker) != 1:
            raise ValueError(f"the weight kernel's source no longer has one {marker!r}")
    out = {"kernel": src}
    for job in ("J_SMALL", "J_W10F", "J_W8", "J_W10P"):
        out[f"only {job}"] = src.replace(job_start, job_start + f"  if (jb != {job}) return;\n")
    for job in ("J_W10F", "J_W8"):
        nochain = out[f"only {job}"].replace(chain, "for (int cls = 2; cls >= 3; --cls)")
        out[f"nochain {job}"] = nochain
        for marker in splits:
            nochain = nochain.replace(marker, marker.replace("i < ", "i < 0 * "))
        out[f"bare {job}"] = nochain
    return out


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    import chip_smoke as cs
    from vipnerf_tpu_torch.kernels import build
    from vipnerf_tpu_torch.kernels import fused_mlp as k1

    torch.backends.cuda.matmul.allow_tf32 = False
    root = build.BUILD_DIR / "bwd_jobs"
    jobs = {}
    for i, (name, text) in enumerate(variants((build.CSRC_DIR / "fused_mlp_bwd.cu").read_text()).items()):
        d = root / str(i)
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "k.so"), str(d / "k.cu")]
        jobs[name] = (d / "k.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    build.build_all(["fused_mlp"])
    for name, (_, proc) in jobs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    mlp = cs.stacked_mlp(dev, 1)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    out = {"card": cs.device_line()}
    for level, n in cs.TRAIN_N.items():
        params, h, ve, ve2, up, ns = cs.heads_inputs(k1, mlp, n, cs.TRAIN_SEC, g, dev)
        build.load("fused_mlp_bwd")
        mid = k1.heads_bwd_points(weights, params, h, ve, ve2, up, ns, False, False)
        for name, (lib, _) in jobs.items():
            build._loaded["fused_mlp_bwd"] = ctypes.CDLL(str(lib))
            out[f"{name}, training {level} ms"] = cs.cuda_ms(lambda: k1.heads_bwd_weights(mid, h, ve, ve2, up),
                                                             reps=10)
        build._loaded.pop("fused_mlp_bwd")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
