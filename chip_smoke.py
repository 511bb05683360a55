"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card's name and power limit, then the build of every library under
   csrc/ (the CUDA kernels with nvcc, the ray stream with g++, nvJPEG's
   binding with g++ against the CUDA toolkit);
2. K1 (the fused MLP forward) against its plain torch version on the card,
   both instances (bf16 and f32), n_sec 0..3, at N = 262,144 points, at
   ragged N = 1, 2,085 and 132 * 128 * 3 + 37 (the bf16 kernel's persistent
   loop runs several tiles per CTA and ends mid-tile), and at the two tile
   shapes the serving path launches (8192 rays x 64 coarse and x 192 fine
   samples) for n_sec 0 and 2, with the kernel's, the plain version's and a
   library yardstick's times at those shapes, and at the training step's
   two launch shapes (4096 rays x 64 and x 192 samples, n_sec 2);
3. the serving path: a run tree at the flagship width (8x256 MLPs, 64+128
   samples, NDC, bf16 matmuls with bf16 heads) with seeded random weights,
   rendered by the port's `start_testing` at 1008x756 -- 3 train frames with
   visibility towards the 2 others, 2 held-out frames -- checking the
   outputs and that K1 ran on every tile; warm frame times; one warm
   held-out frame in each precision mode the dispatch knows (bf16 with bf16
   heads through the bf16 instance, the shipped default bf16 with f32 heads
   through the module MLP, f32 through the f32 instance), counting each
   instance's launches in each; then a 64x48
   crop rendered through the kernel on the card and through the plain
   version on the CPU, and the same crop of the model without its density
   offset (a nearly empty scene) through K1 and the plain version on the
   card and the plain version on the CPU, to show how far depth and
   visibility drift apart where the accumulated weight is near 0; last, a
   torch.profiler table of one held-out frame (device time by kernel, the
   device's busy share);
4. the training slice: a synthetic LLFF scene at 1008x756 (3 train views,
   1 validation, 1 test) with sparse depths and visibility masks, the
   flagship training config (2048 + 2048 rays, 64 + 128 samples, the four
   losses with the visibility prior staged in at half the run, Adam) with
   bf16 heads; K1's parameter gradients against the module MLP's on one
   batch (both instances); `start_training` for 200 steps (checkpoint at
   100, validation at 200), then resumed to 220, checking finite and falling
   losses, the checkpoints, exactly 2 K1 launches per step and the
   validation's, and the trained model's PSNR on the test frame against the
   untrained one's; the median warm step time with rays/s, K1's share and
   peak memory; a torch.profiler table of one step split into forward,
   backward and Adam; a warm step in each precision mode;
5. the user's pipeline at 1008x756: a synthetic LLFF scene under the LLFF
   policy's _down4 suffix without a visibility prior; the prior generated
   by the entry point of `python -m vipnerf_tpu_torch.priors.visibility` on
   the card (64 planes, 3 pairs x 2 directions, timed per direction), its
   files checked and one direction held against the same function on the
   CPU; the sparse-depth CLI's ColmapNotFoundError (the card has no
   COLMAP); the NeRF_LLFF app with demo1a's shipped configs (bf16 with f32
   heads, so the module MLP and no K1) cut to 200 steps: training on the
   generated prior, testing with its QA subprocess (finite RMSE02, PSNR02,
   SSIM02; LPIPS02 null without weights), and both video tracks as frame
   directories;
6. batched multi-scene training: two seeded synthetic LLFF scenes at
   1008x756 (3 train views each) in one database; the scene-batched K1
   (both instances, 2 and 4 scenes with their own weights, at the
   training step's launch shapes) against its plain version and bit for bit against
   single-scene launches, timed beside them, the plain version and a
   `torch.baddbmm` chain; the NeRF_LLFF app with `batch_scenes: true` at
   the flagship width with bf16 heads for 100 steps (checkpoint at 50,
   validation at 100), then resumed to 110, with exactly 2 K1 launches per
   step for both scenes; each scene's test-frame PSNR against its untrained
   value; the batched step's gradients against each scene's own step on
   the same batches; the warm step, rays/s and peak memory at S = 1, 2, 4;
   a step at S = 2 in each precision mode;
7. database and migration: nvJPEG's decode of the committed 4:2:0 JPEG
   fixture against the JAX package's (libjpeg's) decode of it, at least 40
   dB, with its ms per megapixel; a raw NeRF-LLFF scene forged in the
   published layout (COLMAP model, poses_bounds.npy, the fixture as
   images/*.JPG, 1008x756 and 504x378 pyramids), zipped and built by
   `python -m vipnerf_tpu_torch.db_builders.nerf_llff` (nvJPEG decoding
   images/ on the card), its files, split and spiral poses checked; its
   priors (VW02 generated on the card, DE02 from the true depths); the
   NeRF_LLFF app at the flagship width with bf16 heads for 100 steps
   (checkpoint at 50), exactly 2 K1 launches per step; the checkpoint at 50
   through the JAX-checkpoint bridge (export_checkpoint, import_checkpoint)
   bit for bit, then 10 steps resumed from the original and from the round
   trip, their parameters compared; a DataParallel model loading the .tar
   strictly; fast_encoding's PE on the card against the CPU and a training
   step with it; a train-mode preprocessor with spherify;
8. a JSON line of each of phases 3-7 and of the kernels, and the device
   line last.

It needs CUDA and the repository around it, and exits non-zero without a
result otherwise. Nothing of JAX is imported.
"""

import contextlib
import copy
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

# Data-sheet peaks of an H100 SXM (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1 against its plain version, relative to the plain outputs' own scale.
# bf16: the two sum in different orders, so a rounding to bf16 can land one
# step (2^-8 relative) apart and the step propagates; the max error may be a
# few such steps at the largest output, the RMS error stays far below one
# step. f32: summation order only.
TOL_REL_MAX = {torch.bfloat16: 2.0 ** -5, torch.float32: 1e-5}  # max|err| / max|plain|
TOL_REL_RMS = {torch.bfloat16: 2e-3, torch.float32: 1e-6}  # ||err|| / ||plain||
TOL_CROP_RGB = 2.0 / 255  # K1 on the card vs its plain version on the CPU
TOL_CROP_DEPTH = 5e-3  # of the NDC depth, in [0, 1]
MIN_CROP_ACC = 0.1  # the crop check holds only where depth is well conditioned

H, W = 756, 1008
SIGMA_OFFSET = 0.5
CHUNK = 8192
TILE_N = {"coarse": CHUNK * 64, "fine": CHUNK * 192}  # K1's points per launch on the path
MAIN_N = TILE_N["fine"]  # the shape of the kernels line
TRAIN_RAYS = 2048 + 2048  # NeRF + sparse-depth rays per training step
TRAIN_N = {"coarse": TRAIN_RAYS * 64, "fine": TRAIN_RAYS * 192}  # K1's points per training launch
TRAIN_SEC = 2  # a training step sees the 2 other train views
RAGGED_N = [1, 2048 + 37, 132 * 128 * 3 + 37]  # 132 SMs: 3 tiles of 128 per CTA, then 37 rows
# precision modes of a flagship level: (bf16_matmuls, f32_heads) -> K1 instance or None
MODES = {"bf16, bf16 heads": (True, False), "bf16, f32 heads (default)": (True, True),
         "f32": (False, False)}


def log(*args):
    print(*args, flush=True)


def device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def library_raw(layers, xe, ve, ve2, n_sec):
    """Yardstick for K1: the same function as one torch.nn.functional.linear
    (cuBLAS) per layer in the working dtype -- the module path's arithmetic.
    It is a chain of ~12 calls, not one library call."""
    lin = torch.nn.functional.linear
    relu = torch.relu
    b = [bb.to(xe.dtype) for _, bb in layers]
    w = [ww for ww, _ in layers]
    h = relu(lin(xe, w[0]) + b[0])
    for i in (1, 2, 3, 4):
        h = relu(lin(h, w[i]) + b[i])
    h = relu(lin(torch.cat([xe, h], 1), w[5]) + b[5])
    for i in (6, 7):
        h = relu(lin(h, w[i]) + b[i])
    feature = lin(h, w[8]) + b[8]
    sigma = (lin(h, w[9]) + b[9])[:, :1]
    out = [sigma, (lin(relu(lin(torch.cat([feature, ve], 1), w[10]) + b[10]), w[11]) + b[11])[:, :4]]
    for j in range(n_sec):
        hv = relu(lin(torch.cat([feature, ve2[:, 32 * j:32 * j + 32]], 1), w[10]) + b[10])
        out.append((lin(hv, w[11]) + b[11])[:, 3:4])
    return torch.cat(out, 1)


def k1_bound_ms(k1, n, n_sec, dtype, scenes=1):
    """Least time for K1 on n points (of `scenes` scenes, each with its own
    weights): operations at the tensor-core (bf16) or CUDA-core (f32) peak,
    or the bytes of its inputs, outputs and weights."""
    macs = n * (k1.MACS_PER_POINT + n_sec * k1.MACS_PER_SEC_VIEW)
    size = 2 if dtype == torch.bfloat16 else 4
    cols_in = k1.PTS_IN + k1.VIEW_IN * (1 + n_sec)
    nbytes = n * (cols_in + k1.NOUT) * size + scenes * (k1.W_NUMEL * size + k1.B_NUMEL * 4)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = 2 * macs / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_inputs(k1, n, n_sec, dtype, g, dev):
    pts = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=dev))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=dev)) if n_sec else None
    return k1.encode_inputs(pts, vd, vd2, dtype)


def phase_k1(k1, mlp, dev):
    """K1 against its plain version on the card at every checked shape, timed
    at the serving path's two tile shapes and the training step's two launch
    shapes. Returns the worst max|err| of each
    instance and the timings keyed by (dtype, n_sec, n)."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst = {}
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        weights = k1.prepare_weights(mlp, dtype)
        worst[dtype] = 0.0
        for n_sec in range(4):
            timed = set(TILE_N.values()) if n_sec in (0, 2) else set()
            if n_sec == TRAIN_SEC:
                timed |= set(TRAIN_N.values())
            for n in RAGGED_N + sorted({262144} | timed):
                xe, ve, ve2, ns = k1_inputs(k1, n, n_sec, dtype, g, dev)
                out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns).float()
                torch.cuda.synchronize()
                ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
                err = (out - ref).abs().max().item()
                rel_max = err / max(ref.abs().max().item(), 1e-30)
                rel_rms = ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()
                finite = bool(torch.isfinite(out).all())
                pad_zero = not out[:, 5 + ns:].any()
                log(f"K1 {name} n_sec={n_sec} N={n}: max|err| {err:.3g}, max|err|/max|plain| "
                    f"{rel_max:.3g} (tol {TOL_REL_MAX[dtype]:.3g}), rms rel {rel_rms:.3g} "
                    f"(tol {TOL_REL_RMS[dtype]:.3g}), finite {finite}, padding zero {pad_zero}")
                if not (finite and pad_zero and rel_max <= TOL_REL_MAX[dtype]
                        and rel_rms <= TOL_REL_RMS[dtype]):
                    raise AssertionError(f"K1 disagrees with its plain version: {dtype} n_sec={n_sec} N={n}")
                worst[dtype] = max(worst[dtype], err)
                if n not in timed:
                    continue
                ms = cuda_ms(lambda: k1.fused_mlp_raw(weights, xe, ve, ve2, ns))
                plain_ms = cuda_ms(lambda: k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns), reps=3)
                lib_ms = cuda_ms(lambda: library_raw(weights.layers, xe, ve, ve2, ns), reps=5)
                bound, bound_by = k1_bound_ms(k1, n, ns, dtype)
                tflops = 2 * n * (k1.MACS_PER_POINT + ns * k1.MACS_PER_SEC_VIEW) / (ms * 1e-3) / 1e12
                log(f"K1 timing {name} n_sec={n_sec} N={n}: kernel_ms {ms:.4f} "
                    f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (torch.nn.functional.linear "
                    f"per layer, no single call) bound_ms {bound:.4f} ({bound_by}) "
                    f"share of bound {bound / ms:.3f}, achieved {tflops:.1f} TFLOP/s")
                timings[(dtype, n_sec, n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                  bound_ms=bound, bound_by=bound_by)
    return worst, timings


def check_png(path: Path):
    blob = path.read_bytes()
    if blob[:8] != b"\x89PNG\r\n\x1a\n" or blob[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    w, h = int.from_bytes(blob[16:20], "big"), int.from_bytes(blob[20:24], "big")
    if (h, w) != (H, W):
        raise AssertionError(f"{path} is {w}x{h}, expected {W}x{H}")


@contextlib.contextmanager
def k1_runs_plain(k1):
    """Within the block, K1's wrapper runs the plain version on CUDA tensors
    too: the same render with the plain MLP on the card."""
    kernel = k1.fused_mlp_raw
    k1.fused_mlp_raw = lambda w, xe, ve, ve2, ns: k1.fused_mlp_reference(w.layers, xe, ve, ve2, ns)
    try:
        yield
    finally:
        k1.fused_mlp_raw = kernel


def render_crop(model, configs, crop, device):
    from vipnerf_tpu_torch.models.vip_nerf import render_rays

    with torch.no_grad():
        out = render_rays(model.to(device), configs, {k: v.to(device) for k, v in crop.items()},
                          train=False, sec_views_vis=True)
    return {k: out[f"{k}_fine"].cpu() for k in ("rgb", "depth_ndc", "visibility2", "acc")}


def crop_diffs(a, b):
    return {k: (a[k] - b[k]).abs().max().item() for k in ("rgb", "depth_ndc", "visibility2")}


def phase_crop(k1, tester, configs, poses):
    """A 64x48 crop of train frame 0 (visibility towards frames 2 and 4)
    through K1 on the card against the plain version on the CPU; then the
    witness: the same crop without the density offset."""
    batch = tester.data_preprocessor.create_test_data(poses[0], secondary_poses=[poses[2], poses[4]])
    r0, c0 = (H - 48) // 2, (W - 64) // 2
    crop = {k: v.reshape(H, W, *v.shape[1:])[r0:r0 + 48, c0:c0 + 64].reshape(48 * 64, *v.shape[1:])
            for k, v in batch.items()}
    cpu = torch.device("cpu")
    model = copy.deepcopy(tester.model)  # render_crop moves it between devices
    gpu_k1 = render_crop(model, configs, crop, tester.device)
    cpu_plain = render_crop(model, configs, crop, cpu)
    d = crop_diffs(gpu_k1, cpu_plain)
    acc = cpu_plain["acc"]
    log(f"crop 64x48: K1 on the card vs plain on the CPU: max|rgb diff| {d['rgb']:.3g} "
        f"(tol {TOL_CROP_RGB:.3g}), max|NDC depth diff| {d['depth_ndc']:.3g} (tol {TOL_CROP_DEPTH}), "
        f"max|visibility2 diff| {d['visibility2']:.3g} (tol {TOL_CROP_RGB:.3g}); "
        f"acc min {acc.min().item():.4g}, median {acc.median().item():.4g} (must be >= {MIN_CROP_ACC})")
    if acc.min().item() < MIN_CROP_ACC:
        raise AssertionError("the crop's accumulated weight is too small for a depth comparison")
    if not (d["rgb"] <= TOL_CROP_RGB and d["depth_ndc"] <= TOL_CROP_DEPTH and d["visibility2"] <= TOL_CROP_RGB):
        raise AssertionError("the kernel path and the plain path render different crops")

    # witness: without the offset the random scene is nearly empty, and depth
    # and visibility2 (sums over the weights, divided by acc + 1e-6) are ratios
    # of numbers near 0 -- compare K1 with the plain version on the same card.
    # The model write_run_tree(seed=0) draws, before it adds the offset:
    model = type(tester.model)(configs, torch.Generator().manual_seed(0)).eval()
    w_k1 = render_crop(model, configs, crop, tester.device)
    with k1_runs_plain(k1):
        w_plain = render_crop(model, configs, crop, tester.device)
    w_cpu = render_crop(model, configs, crop, cpu)
    acc = w_cpu["acc"]
    worst = (w_k1["depth_ndc"] - w_cpu["depth_ndc"]).abs().argmax()
    log(f"witness crop, no density offset: acc median {acc.median().item():.3g}, "
        f"{int((acc < 1e-4).sum())} of {acc.numel()} rays with acc < 1e-4; at the ray of the "
        f"largest K1-card vs plain-CPU depth diff acc is {w_k1['acc'][worst].item():.3g} (K1, card) "
        f"and {acc[worst].item():.3g} (plain, CPU)")
    for label, a, b in (("K1 card vs plain CPU", w_k1, w_cpu), ("plain card vs plain CPU", w_plain, w_cpu),
                        ("K1 card vs plain card", w_k1, w_plain)):
        d = crop_diffs(a, b)
        log(f"witness {label}: max|rgb diff| {d['rgb']:.3g}, max|NDC depth diff| {d['depth_ndc']:.3g}, "
            f"max|visibility2 diff| {d['visibility2']:.3g}")
    if not all(torch.isfinite(v).all() for r in (w_k1, w_plain, w_cpu) for v in r.values()):
        raise AssertionError("the witness crop is not finite")


def device_time_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def phase_profile(tester, pose, warm_s):
    """torch.profiler over one held-out frame: device time by kernel, and the
    busy share against the fastest unprofiled held-out frame (the profiler's
    own host cost stretches the profiled frame)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        tester.predict_frame(pose)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only (device-side events): the CPU ops that launch them carry
    # the same time again
    rows = []
    for evt in prof.key_averages():
        us = device_time_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"name": evt.key[:90], "calls": evt.count, "device_ms": us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    if not device_ms:
        raise AssertionError("torch.profiler recorded no device time")
    log(f"profile of one held-out frame: device {device_ms:.1f} ms, wall {wall_ms:.1f} ms "
        f"(profiled); busy share {device_ms / (1e3 * min(warm_s)):.3f} of the fastest warm frame")
    for r in rows[:12]:
        log(f"  {r['device_ms']:9.2f} ms  {r['calls']:5d} x  {r['name']}")


def phase_slice(k1, dev, timings):
    from vipnerf_tpu_torch.data.synthetic_rig import (
        flagship_train_configs,
        forward_facing_rig,
        write_run_tree,
    )
    from vipnerf_tpu_torch.infer.tester import NerfTester, start_testing

    poses = forward_facing_rig(5, seed=0)
    is_train = [True, False, True, False, True]
    configs = flagship_train_configs(seed=0)

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # the density offset keeps the random scene from being empty, so depth
        # and visibility (ratios over the accumulated weight) are well conditioned
        model_configs = write_run_tree(root, configs, poses, height=H, width=W,
                                       sigma_offset=SIGMA_OFFSET, seed=0)
        test_configs = {
            "test_num": 1, "train_num": 1, "model_name": "Model_Iter000000.tar",
            "root_dirpath": str(root), "device": "all", "chunk_size": CHUNK,
        }
        scenes_data = {"rig": {"output_dirname": "rig", "frames_data": {
            i: {"extrinsic": poses[i], "is_train_frame": is_train[i]} for i in range(5)
        }}}

        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_dir = start_testing(test_configs, scenes_data, save_depth=True, save_visibility=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(k1.fused_mlp_raw.launches_by_instance)

        tiles = math.ceil(H * W / CHUNK)
        expected = {"fused_mlp_bf16": 5 * 2 * tiles, "fused_mlp_f32": 0}
        log(f"start_testing: 5 frames of {W}x{H} in {seconds:.3f} s "
            f"({seconds / 5:.3f} s per frame, tester set-up and checkpoint load included); "
            f"K1 launches {launches} (expected {expected}: 5 frames x 2 levels x {tiles} tiles)")
        if launches != expected:
            raise AssertionError(f"K1 ran {launches} times, expected {expected}")

        scene = out_dir / "rig"
        train_ids = [i for i in range(5) if is_train[i]]
        for i in range(5):
            check_png(scene / f"predicted_frames/{i:04}.png")
            for name in (f"predicted_depths/{i:04}.npy", f"predicted_depths/{i:04}_ndc.npy"):
                arr = np.load(scene / name)
                if arr.shape != (H, W) or not np.isfinite(arr).all():
                    raise AssertionError(f"{name}: shape {arr.shape}, finite {np.isfinite(arr).all()}")
            for j in train_ids:
                if is_train[i] and j != i:
                    vis = np.load(scene / f"predicted_visibilities/{i:04}_{j:04}.npy")
                    if vis.shape != (H, W) or not np.isfinite(vis).all() or vis.min() < 0 or vis.max() > 1:
                        raise AssertionError(f"visibility {i}->{j} out of range or not finite")
        n_vis = len(list((scene / "predicted_visibilities").glob("*.npy")))
        mean_depth = float(np.load(scene / "predicted_depths/0001_ndc.npy").mean())
        log(f"outputs: 5 PNG frames, 10 depth maps, {n_vis} visibility maps, all finite; "
            f"mean NDC depth of frame 1: {mean_depth:.4f}")

        # steady state: held-out and train frames, warm, twice each
        tester = NerfTester(json.loads((root / "runs/training/train0001/Configs.json").read_text()),
                            model_configs, test_configs, root)
        tester.load_model(root / "runs/training/train0001/rig/saved_models/Model_Latest.tar")
        frame_s = {}
        for label, i, sec in (("held-out, n_sec 0", 1, None), ("train, n_sec 2", 0, [poses[2], poses[4]])):
            frame_s[label] = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tester.predict_frame(poses[i], secondary_poses=sec)
                torch.cuda.synchronize()
                frame_s[label].append(time.perf_counter() - t0)
            n_sec = 2 if sec else 0
            k1_ms = tiles * sum(timings[(torch.bfloat16, n_sec, n)]["ms"] for n in TILE_N.values())
            log(f"predict_frame ({label}): {', '.join(f'{s:.4f}' for s in frame_s[label])} s per "
                f"{W}x{H} frame; K1 {k1_ms:.1f} ms of it ({tiles} tiles x the coarse and fine "
                f"launch times of phase 2)")

        modes = phase_modes(k1, root, model_configs, test_configs, poses[1], tiles)
        phase_crop(k1, tester, configs, poses)
        phase_profile(tester, poses[1], frame_s["held-out, n_sec 0"])
    return launches, seconds / 5, frame_s, modes


def phase_modes(k1, root, model_configs, test_configs, pose, tiles):
    """One warm held-out frame in each precision mode, with each K1
    instance's launches counted over that frame alone: a mode runs through
    the instance the dispatch picks (2 levels x `tiles` launches) or through
    the module MLP (none)."""
    from vipnerf_tpu_torch.infer.tester import NerfTester
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp

    train_configs = json.loads((root / "runs/training/train0001/Configs.json").read_text())
    modes = {}
    for label, (bf16, f32_heads) in MODES.items():
        cfg = copy.deepcopy(train_configs)
        cfg["model"].update(bf16_matmuls=bf16, f32_heads=f32_heads)
        tester = NerfTester(cfg, model_configs, test_configs, root)
        tester.load_model(root / "runs/training/train0001/rig/saved_models/Model_Latest.tar")
        tester.predict_frame(pose)  # warm-up
        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = tester.predict_frame(pose)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(k1.fused_mlp_raw.launches_by_instance)
        expected = dict.fromkeys(launches, 0)
        path = "module MLP"
        if uses_fused_mlp(cfg["model"]["fine_mlp"], bf16, f32_heads):
            path = "fused_mlp_bf16" if bf16 else "fused_mlp_f32"
            expected[path] = 2 * tiles
        finite = all(np.isfinite(np.asarray(v)).all() for v in frame.values())
        log(f"warm held-out frame, {label}: {seconds:.4f} s through the {path}; "
            f"K1 launches {launches} (expected {expected}); outputs finite {finite}")
        if launches != expected or not finite:
            raise AssertionError(f"precision mode {label}: launches {launches}, finite {finite}")
        modes[label] = {"seconds": seconds, "path": path, "launches": launches}
    return modes


# ------------------------------------------------------------- training

TRAIN_STEPS = 200  # the first start_training run; the resume adds RESUME_STEPS
RESUME_STEPS = 20
TIMED_STEPS = 25
# K1's gradients against the module MLP's on the same batch and generator
# state (perturbed samples; no sigma noise, which the module adds in bf16 and
# K1's epilogue in f32, as in the JAX package), relative to the module
# gradient's scale, per parameter tensor. f32: summation order only, except
# where a fine sample lands in the next bin of the inverse CDF. bf16: a
# product rounded one bf16 step (2^-8) apart moves the coarse weights, hence
# the fine samples, and the step propagates (0.6 % RMS measured on the CPU).
TOL_GRAD_REL_MAX = {torch.bfloat16: 0.1, torch.float32: 1e-2}  # max|dg| / max|g|
TOL_GRAD_REL_RMS = {torch.bfloat16: 3e-2, torch.float32: 1e-3}  # ||dg|| / ||g||
MIN_PSNR_GAIN_DB = 1.0


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


@contextlib.contextmanager
def module_mlp_path():
    """Within the block, every level runs the nn.Module MLP, whatever the
    precision mode: the same render without K1."""
    from vipnerf_tpu_torch.models import vip_nerf

    dispatch = vip_nerf.uses_fused_mlp
    vip_nerf.uses_fused_mlp = lambda *a: False
    try:
        yield
    finally:
        vip_nerf.uses_fused_mlp = dispatch


class TrainRig:
    """The flagship model, its training preprocessor on the card, a loss
    computer and an optimizer, for the checks and timings beside
    start_training."""

    def __init__(self, root, configs, dev):
        from vipnerf_tpu_torch.data.loaders import get_data_loader
        from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
        from vipnerf_tpu_torch.losses import LossComputer
        from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays

        self.configs = copy.deepcopy(configs)
        self.configs["data_loader"]["scene_id"] = "synth01"
        raw = get_data_loader(self.configs, root / "data" / configs["database_dirpath"], "train").load_data()
        self.prep = get_data_preprocessor(self.configs, "train", raw_data_dict=raw, device=dev)
        self.model = ViPNeRF(self.configs, torch.Generator().manual_seed(0)).to(dev)
        self.render_rays = render_rays
        self.loss_computer = LossComputer(self.configs)
        self.generator = torch.Generator(device=dev)

    def step_fn(self, bf16: bool, f32_heads: bool):
        from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step

        cfg = copy.deepcopy(self.configs)
        cfg["model"].update(bf16_matmuls=bf16, f32_heads=f32_heads)
        step = make_train_step(cfg, self.render_rays, self.loss_computer,
                               make_optimizer(cfg, self.model.parameters()))
        return lambda batch: step(self.model, batch, self.generator)

    def batch(self, it: int):
        return self.prep.get_next_batch(it)

    def grads(self, configs, batch, seed):
        """Every parameter's gradient of TotalLoss on `batch`."""
        self.model.zero_grad(set_to_none=True)
        self.generator.manual_seed(seed)
        out = self.render_rays(self.model, configs, batch, train=True, generator=self.generator)
        self.loss_computer.compute_losses(batch, out)["TotalLoss"].backward()
        return {k: p.grad.detach().clone() for k, p in self.model.named_parameters()}


def phase_grad_check(k1, rig):
    """One gathered batch, one generator state: the parameters' gradients of
    a training render through K1 against the same render through the module
    MLP, on the card, for the bf16 (bf16 heads) and f32 instances."""
    batch = rig.batch(0)
    worst = {}
    for dtype, bf16 in ((torch.bfloat16, True), (torch.float32, False)):
        cfg = copy.deepcopy(rig.configs)
        cfg["model"].update(bf16_matmuls=bf16, f32_heads=False, raw_noise_std=0.0)
        k1.reset_launch_counts()
        g_k1 = rig.grads(cfg, batch, seed=7)
        launches = k1.fused_mlp_raw.launches
        with module_mlp_path():
            g_mod = rig.grads(cfg, batch, seed=7)
        rel_max = rel_rms = 0.0
        for name, g in g_mod.items():
            d = g_k1[name] - g
            rel_max = max(rel_max, (d.abs().max() / g.abs().max().clamp_min(1e-30)).item())
            rel_rms = max(rel_rms, (d.norm() / g.norm().clamp_min(1e-30)).item())
        log(f"K1 gradients, {k1.INSTANCE[dtype]} vs the module MLP, one batch of {TRAIN_RAYS} rays, "
            f"{len(g_mod)} parameter tensors: worst max|dg|/max|g| {rel_max:.3g} "
            f"(tol {TOL_GRAD_REL_MAX[dtype]}), worst ||dg||/||g|| {rel_rms:.3g} "
            f"(tol {TOL_GRAD_REL_RMS[dtype]}); K1 launches in the K1 render {launches}")
        if launches != 2 or rel_max > TOL_GRAD_REL_MAX[dtype] or rel_rms > TOL_GRAD_REL_RMS[dtype]:
            raise AssertionError(f"K1's gradients disagree with the module MLP's ({dtype})")
        worst[dtype] = (rel_max, rel_rms)
    return worst


def read_scalars(scene_dir: Path):
    series = {}
    for line in (scene_dir / "logs/scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        series.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
    return series


def phase_training_run(k1, root, configs, gt, tiles):
    """start_training for TRAIN_STEPS steps (checkpoint at half, validation
    at the end), then again to TRAIN_STEPS + RESUME_STEPS, which must resume;
    checks the logs, checkpoints, K1 launches and the trained model's PSNR
    on the held-out test frame against the untrained model's."""
    from vipnerf_tpu_torch.infer.tester import NerfTester, start_testing
    from vipnerf_tpu_torch.train.trainer import start_training

    n = TRAIN_STEPS
    cfg = copy.deepcopy(configs)
    cfg.update(num_iterations=n, model_save_interval=n // 2, validation_interval=n)
    k1.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start_training(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_run = dict(k1.fused_mlp_raw.launches_by_instance)
    val_frames = 3 + 1  # train frames (n_sec 2) + the validation frame
    expected = {"fused_mlp_bf16": 2 * n + 2 * tiles * val_frames, "fused_mlp_f32": 0}
    log(f"start_training: {n} steps and one validation of {val_frames} frames in {run_s:.2f} s; "
        f"K1 launches {launches_run} (expected {expected}: 2 per step, 2 levels x {tiles} tiles "
        f"per validation frame)")
    if launches_run != expected:
        raise AssertionError(f"training launched K1 {launches_run}, expected {expected}")

    k1.reset_launch_counts()
    cfg.update(num_iterations=n + RESUME_STEPS)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        start_training(cfg)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    text = out.getvalue()
    sys.stdout.write(text)
    launches_resume = dict(k1.fused_mlp_raw.launches_by_instance)
    if f"Resuming Training from iteration {n + 1}" not in text:
        raise AssertionError(f"the second start_training did not resume at {n}")
    if launches_resume != {"fused_mlp_bf16": 2 * RESUME_STEPS, "fused_mlp_f32": 0}:
        raise AssertionError(f"the resumed run launched K1 {launches_resume}")
    log(f"resumed at {n} and trained to {n + RESUME_STEPS} in {resume_s:.2f} s; K1 launches {launches_resume}")

    scene_dir = root / "runs/training/train0001/synth01"
    saved = scene_dir / "saved_models"
    for it in (n // 2, n, n + RESUME_STEPS):
        if not (saved / f"Model_Iter{it:06}.tar").exists():
            raise AssertionError(f"checkpoint of iteration {it} missing")
    if os.readlink(saved / "Model_Latest.tar") != f"Model_Iter{n + RESUME_STEPS:06}.tar":
        raise AssertionError("Model_Latest.tar does not point at the last checkpoint")
    series = read_scalars(scene_dir)
    total = [v for _, v in sorted(series["train/TotalLoss"])]
    finite = all(np.isfinite(v) for tag, pts in series.items() if tag.startswith("train/") for _, v in pts)
    first, last = float(np.mean(total[:20])), float(np.mean(total[-20:]))
    losses = {tag[6:]: [round(v, 5) for _, v in sorted(p)][::40] for tag, p in series.items()
              if tag.startswith("train/") and tag != "train/lr"}
    log(f"train losses every 40 steps: {json.dumps(losses)}")
    log(f"validation at {n}: " + json.dumps({t: round(p[0][1], 5) for t, p in series.items()
                                              if t.startswith("validation/")}))
    log(f"{len(total)} logged steps, every loss finite {finite}; mean TotalLoss of the first 20 "
        f"steps {first:.5f}, of the last 20 {last:.5f}")
    if len(total) != n + RESUME_STEPS or not finite or not last < first:
        raise AssertionError("training did not log finite, falling losses for every step")
    samples = len(list((scene_dir / "samples/predicted_frames").glob("*.png")))
    log(f"validation wrote {samples} sample frames")

    db = root / "data/databases/NeRF_LLFF/data/all/database_data/synth01"
    extr = np.loadtxt(db / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    intr = np.loadtxt(db / "CameraIntrinsics.csv", delimiter=",").reshape(-1, 3, 3)
    test_configs = {"test_num": 1, "train_num": 1, "model_name": "Model_Latest.tar",
                    "root_dirpath": str(root), "device": "all", "chunk_size": CHUNK}
    frame = {"extrinsic": extr[3], "intrinsic": intr[3], "is_train_frame": False}
    k1.reset_launch_counts()
    out_dir = start_testing(test_configs, {"synth01": {"output_dirname": "synth01", "frames_data": {3: frame}}})
    from vipnerf_tpu_torch.utils.io import read_image

    trained = psnr(read_image(out_dir / "synth01/predicted_frames/0003.png"), gt["images"][3])
    train_configs = json.loads((root / "runs/training/train0001/Configs.json").read_text())
    train_configs["data_loader"]["scene_id"] = "synth01"
    model_configs = json.loads((scene_dir / "ModelConfigs.json").read_text())
    untrained_tester = NerfTester(train_configs, model_configs, test_configs, root)  # seed-0 weights
    untrained = psnr(untrained_tester.predict_frame(extr[3], intrinsic=intr[3])["image"], gt["images"][3])
    log(f"held-out test frame 3 at {W}x{H}: PSNR {trained:.3f} dB after {n + RESUME_STEPS} steps, "
        f"{untrained:.3f} dB untrained (gain must be >= {MIN_PSNR_GAIN_DB} dB)")
    if not trained - untrained >= MIN_PSNR_GAIN_DB:
        raise AssertionError("the trained model does not beat the untrained one on the test frame")
    return {"launches": launches_run["fused_mlp_bf16"] + launches_resume["fused_mlp_bf16"],
            "seconds": run_s, "resume_seconds": resume_s, "psnr": trained, "psnr_untrained": untrained,
            "total_loss_first20": first, "total_loss_last20": last}


def timed_steps(step, rig, start_it: int, count: int, warmup: int = 3):
    """Host-clock seconds of `count` warm steps, one synchronise per step."""
    for i in range(warmup):
        step(rig.batch(start_it + i))
    seconds = []
    for i in range(count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(rig.batch(start_it + warmup + i))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def phase_step_profile(rig, warm_ms):
    """torch.profiler over one bf16 training step, split at synchronised
    boundaries into forward (gather, render, losses), backward and Adam."""
    from vipnerf_tpu_torch.train.step import make_optimizer

    optimizer = make_optimizer(rig.configs, rig.model.parameters())
    batch = rig.batch(1000)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for phase in ("forward", "backward", "adam"):
            with torch.profiler.record_function(f"step/{phase}"):
                if phase == "forward":
                    optimizer.zero_grad()
                    rig.generator.manual_seed(3)
                    out = rig.render_rays(rig.model, rig.configs, batch, train=True, generator=rig.generator)
                    total = rig.loss_computer.compute_losses(batch, out)["TotalLoss"]
                elif phase == "backward":
                    total.backward()
                else:
                    optimizer.step()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name[5:]: (e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("step/") and e.device_type == torch.autograd.DeviceType.CPU}
    # device-side kernels only: record_function ranges (ours, the optimizer's)
    # also appear on the device's timeline as annotations
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and device_time_us(e) > 0 and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("step/", "Optimizer."))]
    device_ms = sum(device_time_us(e) for e in kernels) / 1e3
    if not device_ms:
        raise AssertionError("torch.profiler recorded no device time in the training step")
    split = {}
    for phase, (start, end) in ranges.items():
        rows = {}
        for e in kernels:
            if start <= e.time_range.start <= end:
                r = rows.setdefault(e.name[:80], [0, 0.0])
                r[0] += 1
                r[1] += device_time_us(e) / 1e3
        split[phase] = rows
        ms = sum(v[1] for v in rows.values())
        log(f"training step profile, {phase}: device {ms:.2f} ms in {sum(v[0] for v in rows.values())} "
            f"kernels")
        for name, (calls, t) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"  {t:9.3f} ms  {calls:5d} x  {name}")
    attributed = sum(t for rows in split.values() for _, t in rows.values())
    log(f"training step profile: device {device_ms:.2f} ms ({attributed:.2f} ms attributed to the "
        f"three phases); busy share {device_ms / warm_ms:.3f} of the median warm step ({warm_ms:.2f} ms)")
    return {phase: sum(t for _, t in rows.values()) for phase, rows in split.items()}


def phase_train(k1, dev, timings):
    """The training slice at the flagship width: a synthetic LLFF scene at
    1008x756, K1's gradient check, start_training with a resume, the warm
    step time, the step profile and a step in each precision mode."""
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp

    tiles = math.ceil(H * W / CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        gt = write_synthetic_database(root / "data/databases", scene_name="synth01", num_frames=5,
                                      train_frames=(0, 2, 4), val_frames=(1,), height=H, width=W)
        log(f"synthetic LLFF scene: 5 frames of {W}x{H} (train 0, 2, 4; validation 1; test 3), "
            f"sparse depths and visibility masks written in {time.perf_counter() - t0:.2f} s")
        configs = flagship_training_configs(root, TRAIN_STEPS, visibility_prior_start_iter=TRAIN_STEPS // 2)

        t0 = time.perf_counter()
        rig = TrainRig(root, configs, dev)
        log(f"training data on the card in {time.perf_counter() - t0:.2f} s: "
            f"{rig.prep.cache['rays_o'].shape[0]} cached rays, "
            f"{len(rig.prep._indices_sd)} sparse-depth rays")
        grads = phase_grad_check(k1, rig)
        run = phase_training_run(k1, root, configs, gt, tiles)

        step = rig.step_fn(bf16=True, f32_heads=False)
        torch.cuda.reset_peak_memory_stats()
        k1.reset_launch_counts()
        seconds = timed_steps(step, rig, 2000, TIMED_STEPS)
        launches = k1.fused_mlp_raw.launches
        peak = torch.cuda.max_memory_allocated()
        med_ms = 1e3 * float(np.median(seconds))
        k1_ms = sum(timings[(torch.bfloat16, TRAIN_SEC, n)]["ms"] for n in TRAIN_N.values())
        log(f"warm training step (bf16, bf16 heads, K1): median {med_ms:.2f} ms over {TIMED_STEPS} "
            f"steps (min {1e3 * min(seconds):.2f}, max {1e3 * max(seconds):.2f}), "
            f"{TRAIN_RAYS / (med_ms / 1e3):,.0f} rays/s; K1 forward {k1_ms:.3f} ms of it "
            f"({k1_ms / med_ms:.3f}, CUDA-event times at N {TRAIN_N['coarse']} and "
            f"{TRAIN_N['fine']}, n_sec {TRAIN_SEC}); K1 launches {launches} in {TIMED_STEPS + 3} "
            f"steps; peak memory {peak / 2**30:.2f} GiB")
        if launches != 2 * (TIMED_STEPS + 3):
            raise AssertionError(f"K1 ran {launches} times in {TIMED_STEPS + 3} steps")
        profile = phase_step_profile(rig, med_ms)

        modes = {}
        for label, (bf16, f32_heads) in MODES.items():
            step = rig.step_fn(bf16, f32_heads)
            k1.reset_launch_counts()
            secs = timed_steps(step, rig, 3000, 5, warmup=2)
            launches_m = dict(k1.fused_mlp_raw.launches_by_instance)
            path = "module MLP"
            expected = dict.fromkeys(launches_m, 0)
            if uses_fused_mlp(rig.configs["model"]["fine_mlp"], bf16, f32_heads):
                path = "fused_mlp_bf16" if bf16 else "fused_mlp_f32"
                expected[path] = 2 * 7
            ms = 1e3 * float(np.median(secs))
            log(f"warm training step, {label}: median {ms:.2f} ms over 5 steps through the {path}; "
                f"K1 launches {launches_m} in 7 steps (expected {expected})")
            if launches_m != expected:
                raise AssertionError(f"precision mode {label}: K1 launches {launches_m}")
            modes[label] = {"ms": ms, "path": path, "launches": launches_m}
    return {"run": run, "step_ms": med_ms, "step_ms_all": [1e3 * s for s in seconds],
            "rays_per_s": TRAIN_RAYS / (med_ms / 1e3), "k1_ms": k1_ms, "peak_bytes": peak,
            "profile_ms": profile, "modes": modes, "grad_check": {str(k)[6:]: v for k, v in grads.items()}}


# --------------------------------------------------- batched multi-scene training

MS_SCENES = ["synth01", "synth02"]
MS_STEPS = 100  # the app's first run; the resume adds MS_RESUME_STEPS
MS_RESUME_STEPS = 10
MS_TIMED_STEPS = 15
MS_SIZES = (1, 2, 4)  # scenes per step timed, from the seed's weights; 4 takes each scene twice


def library_raw_batched(layers, xe, ve, ve2, n_sec):
    """Yardstick for the scene-batched K1: `library_raw` with one
    `torch.baddbmm` over the scene axis per layer, in the working dtype."""
    s = layers[0][0].shape[0]
    xe, ve, ve2 = (t.reshape(s, -1, t.shape[-1]) for t in (xe, ve, ve2))
    w = [ww.transpose(1, 2) for ww, _ in layers]
    b = [bb.to(xe.dtype)[:, None] for _, bb in layers]
    relu = torch.relu

    def lin(x, i):
        return torch.baddbmm(b[i], x, w[i])

    h = relu(lin(xe, 0))
    for i in (1, 2, 3, 4):
        h = relu(lin(h, i))
    h = relu(lin(torch.cat([xe, h], -1), 5))
    for i in (6, 7):
        h = relu(lin(h, i))
    feature = lin(h, 8)
    out = [lin(h, 9)[..., :1], lin(relu(lin(torch.cat([feature, ve], -1), 10)), 11)[..., :4]]
    for j in range(n_sec):
        out.append(lin(relu(lin(torch.cat([feature, ve2[..., 32 * j:32 * j + 32]], -1), 10)), 11)[..., 3:4])
    return torch.cat(out, -1)


def phase_k1_scenes(k1, dev, scenes):
    """The scene-batched K1, both instances, at the training step's two
    launch shapes (S x 4096 rays x 64 and x 192 samples, n_sec 2) with
    different weights per scene: against its plain version (looped over the
    scenes, the forward tolerances) and bit for bit against S single-scene
    launches; timed beside the S single launches, the plain version and the
    baddbmm chain. Returns the timings and worst max|err| per instance."""
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_mlp_config
    from vipnerf_tpu_torch.models.mlp import NeRFMLP

    cfg = flagship_mlp_config(0)
    singles = [NeRFMLP(cfg, torch.Generator().manual_seed(10 + s)).to(dev) for s in range(scenes)]
    stacked = NeRFMLP(cfg, scenes=scenes).to(dev)
    with torch.no_grad():
        for name, p in stacked.named_parameters():
            p.copy_(torch.stack([dict(m.named_parameters())[name] for m in singles]))
    g = torch.Generator(device=dev).manual_seed(2)
    out, worst = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = k1.INSTANCE[dtype]
        weights = k1.prepare_weights(stacked, dtype)
        single_w = [k1.prepare_weights(m, dtype) for m in singles]
        worst[name] = 0.0
        for level, n in TRAIN_N.items():
            xe, ve, ve2, ns = k1_inputs(k1, scenes * n, TRAIN_SEC, dtype, g, dev)
            k1.reset_launch_counts()
            raw = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
            torch.cuda.synchronize()
            if k1.fused_mlp_raw.launches != 1:
                raise AssertionError(f"the scene-batched K1 took {k1.fused_mlp_raw.launches} launches")
            ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
            err = (raw.float() - ref).abs().max().item()
            rel_max = err / max(ref.abs().max().item(), 1e-30)
            rel_rms = ((raw.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()
            rows = [slice(s * n, (s + 1) * n) for s in range(scenes)]
            parts = [(xe[r].contiguous(), ve[r].contiguous(), ve2[r].contiguous()) for r in rows]
            same = all(torch.equal(raw[r], k1.fused_mlp_raw(single_w[s], *parts[s], ns))
                       for s, r in enumerate(rows))
            log(f"K1 {name}, {scenes} scenes x {n} points ({level}, n_sec {ns}), one launch: max|err| {err:.3g}, "
                f"max|err|/max|plain| {rel_max:.3g} (tol {TOL_REL_MAX[dtype]:.3g}), rms rel {rel_rms:.3g} "
                f"(tol {TOL_REL_RMS[dtype]:.3g}); bit-identical to {scenes} single-scene launches: {same}")
            if not (same and rel_max <= TOL_REL_MAX[dtype] and rel_rms <= TOL_REL_RMS[dtype]):
                raise AssertionError(f"the scene-batched K1 disagrees ({name}, {level})")
            worst[name] = max(worst[name], err)
            ms = cuda_ms(lambda: k1.fused_mlp_raw(weights, xe, ve, ve2, ns))
            singles_ms = cuda_ms(lambda: [k1.fused_mlp_raw(single_w[s], *parts[s], ns) for s in range(scenes)])
            plain_ms = cuda_ms(lambda: k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns), reps=3)
            lib_ms = cuda_ms(lambda: library_raw_batched(weights.layers, xe, ve, ve2, ns), reps=5)
            bound, bound_by = k1_bound_ms(k1, scenes * n, ns, dtype, scenes)
            log(f"K1 timing {name}, {scenes} scenes x {n} points: one launch {ms:.4f} ms, {scenes} single launches "
                f"{singles_ms:.4f} ms, plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} (torch.baddbmm per layer), "
                f"bound_ms {bound:.4f} ({bound_by}), share of bound {bound / ms:.3f}")
            out[f"{name} S={scenes} {level}"] = dict(ms=ms, singles_ms=singles_ms, plain_ms=plain_ms,
                                                     library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                                                     max_abs_err=err)
    return out, worst


def ms_grad_check(k1, trainer):
    """One step's gradients of the stacked model (its two scenes' trained
    weights) on a gathered two-scene batch against each scene's own model on
    its own batch, deterministic (no perturbation, no sigma noise), through
    each K1 instance."""
    from vipnerf_tpu_torch.losses import LossComputer
    from vipnerf_tpu_torch.models.vip_nerf import render_rays, unstack_model

    nerf, sd = trainer._index_rows(0, 1)
    prep0 = trainer.preprocessors[0]
    batch = prep0.gather_batch(nerf[:, 0], sd[:, 0], 0, cache=trainer.cache, near=trainer.near, far=trainer.far)
    rps = trainer.rays_per_scene
    local = [p.gather_batch(nerf[i, 0] - i * rps, sd[i, 0] - i * rps, 0) for i, p in enumerate(trainer.preprocessors)]
    scenes = len(trainer.scene_ids)
    worst = {}
    for dtype, bf16 in ((torch.bfloat16, True), (torch.float32, False)):
        cfg = copy.deepcopy(trainer.configs)
        cfg["model"].update(bf16_matmuls=bf16, f32_heads=False, perturb=False, raw_noise_std=0.0)
        losses = LossComputer(cfg)
        trainer.model.zero_grad(set_to_none=True)
        k1.reset_launch_counts()
        total = losses.scene_losses(batch, render_rays(trainer.model, cfg, batch, train=True), scenes)["TotalLoss"]
        total.sum().backward()
        launches = k1.fused_mlp_raw.launches
        stacked = {k: p.grad for k, p in trainer.model.named_parameters()}
        rel_max = rel_rms = 0.0
        worst_tensor = (0.0, "")
        for i in range(scenes):
            model = unstack_model(trainer.model, i)
            one = losses.compute_losses(local[i], render_rays(model, cfg, local[i], train=True))["TotalLoss"]
            one.backward()
            if abs(one.item() - total[i].item()) > 1e-5 * abs(one.item()):
                raise AssertionError(f"scene {i}: batched loss {total[i].item()} vs single {one.item()}")
            # the scene's whole gradient: a bias that sums ~10^6 terms which
            # nearly cancel moves more, relative to itself, with the
            # reduction order (reported as the worst tensor)
            d = torch.cat([(stacked[k][i] - p.grad).reshape(-1) for k, p in model.named_parameters()])
            gs = torch.cat([p.grad.reshape(-1) for _, p in model.named_parameters()])
            rel_max = max(rel_max, (d.abs().max() / gs.abs().max().clamp_min(1e-30)).item())
            rel_rms = max(rel_rms, (d.norm() / gs.norm().clamp_min(1e-30)).item())
            for k, p in model.named_parameters():
                r = ((stacked[k][i] - p.grad).norm() / p.grad.norm().clamp_min(1e-30)).item()
                worst_tensor = max(worst_tensor, (r, f"scene {i} {k} ({p.numel()} entries)"))
        log(f"batched step gradients, {k1.INSTANCE[dtype]}, {scenes} scenes x {TRAIN_RAYS} rays vs each scene's own "
            f"step, over all of a scene's parameters: worst max|dg|/max|g| {rel_max:.3g} (tol "
            f"{TOL_GRAD_REL_MAX[dtype]}), worst ||dg||/||g|| {rel_rms:.3g} (tol {TOL_GRAD_REL_RMS[dtype]}); worst "
            f"tensor {worst_tensor[1]} at ||dg||/||g|| {worst_tensor[0]:.3g}; K1 launches in the batched render "
            f"{launches}")
        if launches != 2 or rel_max > TOL_GRAD_REL_MAX[dtype] or rel_rms > TOL_GRAD_REL_RMS[dtype]:
            raise AssertionError(f"the batched step's gradients disagree with single-scene steps ({dtype})")
        worst[k1.INSTANCE[dtype]] = {"rel_max": rel_max, "rel_rms": rel_rms, "worst_tensor": worst_tensor}
    trainer.model.zero_grad(set_to_none=True)
    return worst


def ms_timed_steps(k1, trainer, steps, start_it=0, warmup=3):
    """Host-clock seconds of `steps` warm batched steps (gather included),
    one synchronise per step, and K1's launches over all of them."""
    nerf, sd = trainer._index_rows(start_it, warmup + steps)
    prep0 = trainer.preprocessors[0]

    def step(j):
        batch = prep0.gather_batch(nerf[:, j], None if sd is None else sd[:, j], start_it + j,
                                   cache=trainer.cache, near=trainer.near, far=trainer.far)
        trainer.generator.manual_seed(start_it + j)
        return trainer.train_step(trainer.model, batch, trainer.generator)

    k1.reset_launch_counts()
    for j in range(warmup):
        step(j)
    seconds = []
    for j in range(warmup, warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = step(j)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    if not all(bool(torch.isfinite(v).all()) for v in scalars.values()):
        raise AssertionError("a batched step's losses are not finite")
    return seconds, k1.fused_mlp_raw.launches


def ms_time_trainer(k1, trainer, label):
    """The median warm batched step of `trainer` (bf16 heads, K1), rays/s
    over all its scenes, K1's launches per step and the peak memory."""
    s = len(trainer.scene_ids)
    torch.cuda.reset_peak_memory_stats()
    seconds, launches = ms_timed_steps(k1, trainer, MS_TIMED_STEPS)
    med = float(np.median(seconds))
    out = {"ms": 1e3 * med, "ms_min": 1e3 * min(seconds), "ms_max": 1e3 * max(seconds),
           "rays_per_s": s * TRAIN_RAYS / med, "k1_launches_per_step": launches / (MS_TIMED_STEPS + 3),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"warm batched step, S = {label} (bf16, bf16 heads, K1): median {1e3 * med:.2f} ms over {MS_TIMED_STEPS} "
        f"steps (min {1e3 * min(seconds):.2f}, max {1e3 * max(seconds):.2f}), {s * TRAIN_RAYS / med:,.0f} rays/s in "
        f"all; K1 launches {launches} in {MS_TIMED_STEPS + 3} steps; peak memory {out['peak_bytes'] / 2**30:.2f} GiB")
    if launches != 2 * (MS_TIMED_STEPS + 3):
        raise AssertionError(f"S = {label}: K1 ran {launches} times in {MS_TIMED_STEPS + 3} steps")
    return out


def ms_step_profile(trainer, warm_ms):
    """torch.profiler over one warm batched step (gather included): the
    device time, its busy share of the median warm step, and the kernels
    that take the most of it."""
    nerf, sd = trainer._index_rows(5000, 1)
    batch = trainer.preprocessors[0].gather_batch(nerf[:, 0], None if sd is None else sd[:, 0], 5000,
                                                  cache=trainer.cache, near=trainer.near, far=trainer.far)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        trainer.generator.manual_seed(5000)
        trainer.train_step(trainer.model, batch, trainer.generator)
        torch.cuda.synchronize()
    rows = [(device_time_us(e) / 1e3, e.count, e.key[:80]) for e in prof.key_averages()
            if device_time_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    if not device_ms:
        raise AssertionError("torch.profiler recorded no device time in the batched step")
    kernels = sum(r[1] for r in rows)
    log(f"batched step profile, S = {len(trainer.scene_ids)}: device {device_ms:.2f} ms in {kernels} kernels, busy "
        f"share {device_ms / warm_ms:.3f} of the median warm step ({warm_ms:.2f} ms)")
    for ms, calls, name in rows[:8]:
        log(f"  {ms:9.3f} ms  {calls:5d} x  {name}")
    return {"device_ms": device_ms, "kernels": kernels, "busy_share": device_ms / warm_ms,
            "top": [{"ms": ms, "calls": calls, "name": name} for ms, calls, name in rows[:8]]}


def phase_multi_scene(k1, dev):
    """Batched multi-scene training at the flagship width with bf16 heads:
    two seeded synthetic LLFF scenes at 1008x756 (3 train views each) in one
    database; the scene-batched K1 checks; the NeRF_LLFF app with
    `batch_scenes: true` for MS_STEPS steps (checkpoint at half, validation
    at the end), then resumed by the same call to MS_STEPS + MS_RESUME_STEPS;
    each scene's test-frame PSNR trained vs untrained; the batched step's
    gradients against single-scene steps; the warm step at S = 1, 2, 4; a
    step at S = 2 in each precision mode."""
    from vipnerf_tpu_torch.apps.common import DatasetApp
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs
    from vipnerf_tpu_torch.infer.tester import NerfTester, start_testing
    from vipnerf_tpu_torch.models.vip_nerf import render_rays, uses_fused_mlp
    from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer
    from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
    from vipnerf_tpu_torch.utils.io import read_image

    device_cfg = "cpu" if dev.type == "cpu" else "all"
    k1_timings, k1_worst = {}, {}
    for scenes in (2, 4):
        timings, worst = phase_k1_scenes(k1, dev, scenes)
        k1_timings.update(timings)
        k1_worst = {name: max(err, k1_worst.get(name, 0.0)) for name, err in worst.items()}
    tiles = math.ceil(H * W / CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        gts = [write_synthetic_database(root / "data/databases", scene_name=name, num_frames=5, train_frames=(0, 2, 4),
                                        val_frames=(1,), height=H, width=W, seed=i)
               for i, name in enumerate(MS_SCENES)]
        log(f"multi-scene: scenes {MS_SCENES} (seeds 0, 1) of 5 frames at {W}x{H} (train 0, 2, 4; validation 1; "
            f"test 3) written in {time.perf_counter() - t0:.2f} s")
        configs = flagship_training_configs(root, MS_STEPS, visibility_prior_start_iter=MS_STEPS // 2)
        configs["data_loader"]["scene_names"] = list(MS_SCENES)
        configs.update(train_num=2, batch_scenes=True, device=device_cfg,
                       model_save_interval=MS_STEPS // 2, validation_interval=MS_STEPS)
        app = DatasetApp("NeRF_LLFF", "scene_name", "all", root_dirpath=root)

        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.start_training(copy.deepcopy(configs))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches_run = dict(k1.fused_mlp_raw.launches_by_instance)
        val_frames = 3 + 1
        expected = {"fused_mlp_bf16": 2 * MS_STEPS + 2 * tiles * val_frames * len(MS_SCENES), "fused_mlp_f32": 0}
        log(f"app start_training, batch_scenes, {len(MS_SCENES)} scenes: {MS_STEPS} steps and one validation of "
            f"{val_frames} frames per scene in {run_s:.2f} s; K1 launches {launches_run} (expected {expected}: 2 per "
            f"step for all scenes, 2 levels x {tiles} tiles per validation frame and scene)")
        if launches_run != expected:
            raise AssertionError(f"batched training launched K1 {launches_run}, expected {expected}")

        k1.reset_launch_counts()
        configs["num_iterations"] = MS_STEPS + MS_RESUME_STEPS
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            app.start_training(copy.deepcopy(configs))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        sys.stdout.write(out.getvalue())
        launches_resume = dict(k1.fused_mlp_raw.launches_by_instance)
        if f"Resuming multi-scene training from iteration {MS_STEPS + 1}" not in out.getvalue():
            raise AssertionError(f"the second batched run did not resume at {MS_STEPS}")
        if launches_resume != {"fused_mlp_bf16": 2 * MS_RESUME_STEPS, "fused_mlp_f32": 0}:
            raise AssertionError(f"the resumed batched run launched K1 {launches_resume}")
        log(f"resumed at {MS_STEPS} and trained to {MS_STEPS + MS_RESUME_STEPS} in {resume_s:.2f} s; "
            f"K1 launches {launches_resume}")

        run = root / "runs/training/train0002"
        end = MS_STEPS + MS_RESUME_STEPS
        losses = {}
        for name in MS_SCENES:
            saved = run / f"{name}/saved_models"
            for it in (MS_STEPS // 2, MS_STEPS, end):
                if not (saved / f"Model_Iter{it:06}.tar").exists():
                    raise AssertionError(f"{name}: checkpoint of iteration {it} missing")
            if os.readlink(saved / "Model_Latest.tar") != f"Model_Iter{end:06}.tar":
                raise AssertionError(f"{name}: Model_Latest.tar does not point at the last checkpoint")
            total = [v for _, v in sorted(read_scalars(run / name)["train/TotalLoss"])]
            first, last = float(np.mean(total[:20])), float(np.mean(total[-20:]))
            if len(total) != end or not np.isfinite(total).all() or not last < first:
                raise AssertionError(f"{name}: {len(total)} logged losses, not finite and falling")
            samples = len(list((run / f"{name}/samples/predicted_frames").glob("*.png")))
            losses[name] = {"first20": first, "last20": last, "validation_frames": samples}
            log(f"{name}: {len(total)} logged steps, mean TotalLoss first 20 {first:.5f}, last 20 {last:.5f}; "
                f"validation wrote {samples} sample frames")

        test_configs = {"test_num": 2, "train_num": 2, "model_name": "Model_Latest.tar",
                        "root_dirpath": str(root), "device": device_cfg, "chunk_size": CHUNK}
        scenes_data, extr, intr = {}, {}, {}
        for name in MS_SCENES:
            db = root / f"data/databases/NeRF_LLFF/data/all/database_data/{name}"
            extr[name] = np.loadtxt(db / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
            intr[name] = np.loadtxt(db / "CameraIntrinsics.csv", delimiter=",").reshape(-1, 3, 3)
            scenes_data[name] = {"output_dirname": name, "frames_data": {
                3: {"extrinsic": extr[name][3], "intrinsic": intr[name][3], "is_train_frame": False}}}
        out_dir = start_testing(test_configs, scenes_data)
        train_configs = json.loads((run / "Configs.json").read_text())
        psnrs = {}
        for i, name in enumerate(MS_SCENES):
            trained = psnr(read_image(out_dir / f"{name}/predicted_frames/0003.png"), gts[i]["images"][3])
            cfg = copy.deepcopy(train_configs)
            cfg["data_loader"]["scene_id"] = name
            model_configs = json.loads((run / f"{name}/ModelConfigs.json").read_text())
            untrained_tester = NerfTester(cfg, model_configs, test_configs, root)  # the seed's weights
            frame = untrained_tester.predict_frame(extr[name][3], intrinsic=intr[name][3])["image"]
            untrained = psnr(frame, gts[i]["images"][3])
            psnrs[name] = {"trained": trained, "untrained": untrained}
            log(f"{name} test frame 3 at {W}x{H}: PSNR {trained:.3f} dB after {end} batched steps, {untrained:.3f} dB "
                f"untrained (gain must be >= {MIN_PSNR_GAIN_DB} dB)")
            if not trained - untrained >= MIN_PSNR_GAIN_DB:
                raise AssertionError(f"{name}: the trained model does not beat the untrained one")

        db_dir = root / "data" / configs["database_dirpath"]
        trainer = MultiSceneTrainer(configs, MS_SCENES, db_dir, device=dev, output_dirpath=run, verbose_log=False)
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.load_checkpoints()  # the two scenes' trained weights
        grads = ms_grad_check(k1, trainer)

        steps = {"2, trained": ms_time_trainer(k1, trainer, "2, trained weights")}
        for s in MS_SIZES:
            del trainer
            torch.cuda.empty_cache()
            trainer = MultiSceneTrainer(configs, (MS_SCENES * 2)[:s], db_dir, device=dev, verbose_log=False)
            steps[str(s)] = ms_time_trainer(k1, trainer, str(s))
            steps[str(s)]["profile"] = ms_step_profile(trainer, steps[str(s)]["ms"])
            if s == 2:
                modes = {}
                for label, (bf16, f32_heads) in MODES.items():
                    cfg = copy.deepcopy(configs)
                    cfg["model"].update(bf16_matmuls=bf16, f32_heads=f32_heads)
                    trainer.train_step = make_train_step(cfg, render_rays, trainer.loss_computer,
                                                         make_optimizer(cfg, trainer.model.parameters(), scenes=2))
                    k1.reset_launch_counts()
                    secs, _ = ms_timed_steps(k1, trainer, 5, start_it=1000, warmup=2)
                    launches_m = dict(k1.fused_mlp_raw.launches_by_instance)
                    path = "module MLP"
                    expected = dict.fromkeys(launches_m, 0)
                    if uses_fused_mlp(cfg["model"]["fine_mlp"], bf16, f32_heads):
                        path = k1.INSTANCE[torch.bfloat16 if bf16 else torch.float32]
                        expected[path] = 2 * 7
                    ms = 1e3 * float(np.median(secs))
                    log(f"warm batched step, S = 2, {label}: median {ms:.2f} ms over 5 steps through the {path}; "
                        f"K1 launches {launches_m} in 7 steps (expected {expected})")
                    if launches_m != expected:
                        raise AssertionError(f"S = 2, precision mode {label}: K1 launches {launches_m}")
                    modes[label] = {"ms": ms, "path": path, "launches": launches_m}
        del trainer
        torch.cuda.empty_cache()
    return {"k1": k1_timings, "k1_worst": k1_worst,
            "launches": launches_run["fused_mlp_bf16"] + launches_resume["fused_mlp_bf16"],
            "run_s": run_s, "resume_s": resume_s, "losses": losses, "psnr": psnrs, "grad_check": grads,
            "steps": steps, "modes_s2": modes}


# ------------------------------------------------------- the user's pipeline

PIPE_STEPS = 200  # demo1a's 200k iterations, cut
PIPE_TRAIN = (0, 2, 4)
# the visibility prior on the card against the same function on the CPU: the
# warp is f32 fused multiply-adds on both, so only exp and the last ulps of
# the sampler's sums may differ
TOL_PRIOR_W = 1e-3  # max |w_card - w_cpu|
TOL_PRIOR_MASK_FRAC = 1e-4  # share of pixels whose mask (w > 0.5) differs


def check_prior_outputs(out_dir: Path, pairs):
    """6 directions: weights .npy + .png, masks .npy + .png equal to w > 0.5."""
    from vipnerf_tpu_torch.utils.io import read_mask

    if not (out_dir / "Configs.json").exists():
        raise AssertionError("the visibility prior wrote no Configs.json")
    for a, b in pairs:
        for f1, f2 in ((a, b), (b, a)):
            name = f"{f1:04}_{f2:04}"
            w = np.load(out_dir / f"synth01/visibility_weights/{name}.npy")
            m = np.load(out_dir / f"synth01/visibility_masks/{name}.npy")
            check_png(out_dir / f"synth01/visibility_weights/{name}.png")
            if w.shape != (H, W) or w.dtype != np.float32 or not np.isfinite(w).all() or w.min() < 0 or w.max() > 1:
                raise AssertionError(f"visibility weights {name}: shape {w.shape}, dtype {w.dtype}, out of [0, 1]")
            if m.dtype != bool or not np.array_equal(m, w > 0.5) \
                    or not np.array_equal(read_mask(out_dir / f"synth01/visibility_masks/{name}.png"), m):
                raise AssertionError(f"visibility mask {name} is not weights > 0.5")


def phase_prior_vs_cpu(root: Path, out_dir: Path, f1: int, f2: int):
    """One direction of the card's prior against compute_visibility_weights
    on the CPU at full size, from the same frames, poses and planes."""
    from vipnerf_tpu_torch.priors.visibility import compute_visibility_weights, get_depth_planes
    from vipnerf_tpu_torch.utils.io import read_image

    base = root / "data/databases/NeRF_LLFF/data/all/database_data/synth01"
    extr = np.loadtxt(base / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4).astype(np.float32)
    intr = np.loadtxt(base / "CameraIntrinsics_down4.csv", delimiter=",").reshape(-1, 3, 3).astype(np.float32)
    bds = np.loadtxt(base / "DepthBounds.csv", delimiter=",")[list(PIPE_TRAIN)]
    planes = torch.as_tensor(get_depth_planes(bds.min(), bds.max(), 64), dtype=torch.float32)
    frame = {f: torch.as_tensor(read_image(base / f"rgb_down4/{f:04}.png")[..., :3], dtype=torch.float32)
             for f in (f1, f2)}
    t0 = time.perf_counter()
    cpu = compute_visibility_weights(frame[f1], frame[f2], extr[f1], extr[f2], intr[f1], intr[f2],
                                     planes, 10).numpy()
    cpu_s = time.perf_counter() - t0
    card = np.load(out_dir / f"synth01/visibility_weights/{f1:04}_{f2:04}.npy")
    max_dw = float(np.abs(card - cpu).max())
    mask_frac = float(np.mean((card > 0.5) != (cpu > 0.5)))
    log(f"visibility prior {f1:04}->{f2:04}, card vs CPU at {W}x{H} x 64 planes: max|dw| {max_dw:.3g} "
        f"(tol {TOL_PRIOR_W}), masks differ at {mask_frac:.3g} of the pixels (tol {TOL_PRIOR_MASK_FRAC}); "
        f"mean weight {card.mean():.4f}, visible {np.mean(card > 0.5):.4f}; the CPU took {cpu_s:.2f} s")
    if not (max_dw <= TOL_PRIOR_W and mask_frac <= TOL_PRIOR_MASK_FRAC):
        raise AssertionError("the visibility prior on the card disagrees with the CPU")
    return {"max_abs_dw": max_dw, "mask_diff_frac": mask_frac, "cpu_s": cpu_s}


def qa_breakdown(root: Path, pred_path: Path):
    """Where a QA subprocess's seconds go: a process that starts and imports
    what the runner imports (with the CUDA probe of its LPIPS device), one
    1008x756 PNG decode (the runner decodes ground truth and prediction once
    per metric and frame), and each metric on one frame."""
    from vipnerf_tpu_torch.qa import metrics
    from vipnerf_tpu_torch.utils.io import read_image

    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch, vipnerf_tpu_torch.qa.runner; torch.cuda.device_count()"],
                   check=True, cwd=Path(__file__).resolve().parent)
    parts = {"start_and_imports": time.perf_counter() - t0}
    t0 = time.perf_counter()
    gt = read_image(root / "data/databases/NeRF_LLFF/data/all/database_data/synth01/rgb_down4/0003.png")[..., :3]
    parts["png_decode"] = time.perf_counter() - t0
    pred = read_image(pred_path)[..., :3]
    for name in ("rmse", "psnr", "ssim"):
        t0 = time.perf_counter()
        getattr(metrics, f"compute_{name}")(gt, pred)
        parts[name] = time.perf_counter() - t0
    log("QA breakdown (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; the runner decodes 8 PNGs per frame (2 per metric, LPIPS included)")
    return parts


def phase_pipeline(k1):
    """The user's pipeline at 1008x756: a synthetic LLFF scene written under
    the LLFF policy's _down4 suffix with sparse depths and no visibility
    prior; the prior generated by `priors.cli.main_visibility` on the card
    (64 planes, 3 pairs x 2 directions) with TF32 matmuls allowed, its files
    checked and one direction held against the CPU; the sparse-depth CLI's
    ColmapNotFoundError; then the NeRF_LLFF app with demo1a's shipped configs
    (bf16 with f32 heads: the module MLP) cut to PIPE_STEPS iterations:
    start_training on the generated prior, start_testing with its QA
    subprocess, and both video tracks of a 3-pose track."""
    from vipnerf_tpu_torch.apps import nerf_llff
    from vipnerf_tpu_torch.apps.common import DatasetApp
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp
    from vipnerf_tpu_torch.priors.cli import main_sparse_depth, main_visibility
    from vipnerf_tpu_torch.priors.sparse_depth import ColmapNotFoundError

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_synthetic_database(root / "data/databases", scene_name="synth01", num_frames=5,
                                 train_frames=PIPE_TRAIN, val_frames=(1,), height=H, width=W,
                                 resolution_suffix="_down4", with_visibility_prior=False)
        log(f"pipeline: synthetic LLFF scene at {W}x{H} under rgb_down4 (train {PIPE_TRAIN}, validation 1, "
            f"test 3), sparse depths, no visibility prior, in {time.perf_counter() - t0:.2f} s")

        k1.reset_launch_counts()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True  # no matmul setting may reach the warp
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root)])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        prior_s = time.perf_counter() - t0
        sys.stdout.write(out.getvalue())
        directions = [float(s) for pair in re.findall(r"([\d.]+) s and ([\d.]+) s per direction", out.getvalue())
                      for s in pair]
        pairs = [(a, b) for i, a in enumerate(PIPE_TRAIN) for b in PIPE_TRAIN[i + 1:]]
        if len(directions) != 2 * len(pairs) or "on cuda:0" not in out.getvalue():
            raise AssertionError(f"main_visibility ran {len(directions)} directions on the card, expected {2 * len(pairs)}")
        out_dir = root / "data/databases/NeRF_LLFF/data/all/visibility_prior/VW02"
        check_prior_outputs(out_dir, pairs)
        log(f"visibility prior on the card: {len(directions)} directions of {W}x{H} x 64 planes, seconds per "
            f"direction {', '.join(f'{s:.4f}' for s in directions)}; "
            f"{prior_s:.2f} s with reads and writes; outputs checked")
        prior_cmp = phase_prior_vs_cpu(root, out_dir, 0, 2)

        try:
            main_sparse_depth(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root)])
        except ColmapNotFoundError as e:
            log(f"sparse-depth prior: ColmapNotFoundError as expected ({e}); DE02 comes from the writer")
        else:
            raise AssertionError("main_sparse_depth did not raise ColmapNotFoundError")

        app = DatasetApp("NeRF_LLFF", "scene_name", "all", root_dirpath=root)
        train_configs, test_configs = nerf_llff.demo_configs(11, 2, "synth01", sparse_depth=True, num_rays=2048,
                                                             num_iterations=PIPE_STEPS)
        model = train_configs["model"]
        path_k1 = uses_fused_mlp(model["fine_mlp"], model["bf16_matmuls"], model["f32_heads"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.start_training(train_configs)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        scene_train = root / "runs/training/train0011/synth01"
        losses = [v for _, v in sorted(read_scalars(scene_train)["train/TotalLoss"])]
        if len(losses) != PIPE_STEPS or not np.isfinite(losses).all() \
                or not (scene_train / f"saved_models/Model_Iter{PIPE_STEPS:06}.tar").exists():
            raise AssertionError("the app's training logged no finite loss per step or wrote no checkpoint")
        log(f"app start_training (demo1a configs: bf16, f32 heads, 2048 + 2048 rays, the generated VW02 prior): "
            f"{PIPE_STEPS} steps in {train_s:.2f} s with set-up and checkpoint, {PIPE_STEPS / train_s:.2f} steps/s; "
            f"mean TotalLoss first 20 {np.mean(losses[:20]):.5f}, last 20 {np.mean(losses[-20:]):.5f}")

        qa_s = []
        run_qa = app.run_qa

        def timed_qa(*args):
            t = time.perf_counter()
            run_qa(*args)
            qa_s.append(time.perf_counter() - t)

        app.run_qa = timed_qa
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test_dir = app.start_testing(test_configs)
        test_s = time.perf_counter() - t0 - sum(qa_s)
        scene = test_dir / "synth01"
        test_frames = sorted(int(p.stem) for p in (scene / "predicted_frames").glob("*.png"))
        if test_frames != [0, 2, 3, 4] or len(qa_s) != 1:
            raise AssertionError(f"start_testing rendered frames {test_frames}, QA ran {len(qa_s)} times")
        for f in test_frames:
            check_png(scene / f"predicted_frames/{f:04}.png")
        scores = json.loads((test_dir / "QA_Scores.json").read_text())["predicted_frames"]
        log(f"app start_testing: {len(test_frames)} frames (test 3; train 0, 2, 4 with visibility) in {test_s:.2f} s, "
            f"{test_s / len(test_frames):.3f} s per frame with set-up; QA subprocess {qa_s[0]:.2f} s for 1 test "
            f"frame; QA_Scores.json {json.dumps(scores)}")
        if not (all(np.isfinite(scores.get(k, np.nan)) for k in ("RMSE02", "PSNR02", "SSIM02"))
                and "LPIPS02" in scores and scores["LPIPS02"] is None):
            raise AssertionError("QA_Scores.json lacks finite RMSE02, PSNR02, SSIM02 or LPIPS02 null")
        qa_parts = qa_breakdown(root, scene / "predicted_frames/0003.png")

        track_dir = root / "data/databases/NeRF_LLFF/data/train_test_sets/set02/video_poses01"
        track_dir.mkdir(parents=True)
        extr = np.loadtxt(root / "data/databases/NeRF_LLFF/data/all/database_data/synth01/CameraExtrinsics.csv",
                          delimiter=",")
        np.savetxt(track_dir / "synth01.csv", extr[[1, 2, 3]], delimiter=",")  # 3 poses: 2 frames
        video_s = {}
        for label, fn, suffix, name in (
                ("moving", app.start_testing_videos, "_video01", "PredictedVideo"),
                ("static", app.start_testing_static_videos, "_video01_static_camera", "StaticCameraVideo")):
            t0 = time.perf_counter()
            fn(test_configs)
            video_s[label] = time.perf_counter() - t0
            frames = sorted((test_dir / f"synth01{suffix}/{name}_frames").glob("*.png"))
            if [p.name for p in frames] != ["0000.png", "0001.png"]:
                raise AssertionError(f"the {label} video track wrote {[p.name for p in frames]}")
            for p in frames:
                check_png(p)
        launches = dict(k1.fused_mlp_raw.launches_by_instance)
        log(f"app video tracks: 2 frames each, moving {video_s['moving']:.2f} s, static {video_s['static']:.2f} s, "
            f"written as frame directories; K1 launches over the pipeline {launches} (the shipped f32 heads run "
            f"the module MLP: {'K1' if path_k1 else 'no K1'} expected)")
        if path_k1 or any(launches.values()):
            raise AssertionError(f"the pipeline launched K1 {launches}")
    return {"prior_s_per_direction": directions, "prior_vs_cpu": prior_cmp, "train_s": train_s,
            "steps_per_s": PIPE_STEPS / train_s, "test_s_per_frame": test_s / len(test_frames),
            "qa_s_per_frame": qa_s[0], "qa_breakdown_s": qa_parts,
            "video_s_per_frame": {k: v / 2 for k, v in video_s.items()},
            "qa_scores": scores, "k1_launches": launches}


# ------------------------------------------------- database and migration

FIXTURES = Path(__file__).resolve().parent / "tests/data"
JPEG_MIN_PSNR = 40.0  # nvJPEG against libjpeg on the 4:2:0 fixture: the IDCT and the chroma upsampling differ
DB_STEPS = 100  # the built database's run; checkpoints at half and at the end
DB_RESUME_STEPS = 10
DB_SCENE = "synth01"
TOL_FAST_PE = 2.0 ** 10 * 1e-7  # fast_encoding at degree 10, card vs CPU: the recurrence amplifies an ulp ~2^10


def phase_jpeg(dev):
    """nvJPEG's decode of the committed fixture against the JAX package's
    (libjpeg's) decode of it; host-clock ms per decode, host Huffman stage
    included, synchronised."""
    from vipnerf_tpu_torch.utils.io import read_png
    from vipnerf_tpu_torch.utils.jpeg import decode_jpeg

    data = (FIXTURES / "synth_1008x756.jpg").read_bytes()
    want = read_png(FIXTURES / "synth_1008x756_decoded.png")
    got = decode_jpeg(data, dev).cpu().numpy()
    if got.shape != want.shape:
        raise AssertionError(f"nvJPEG decoded {got.shape}, libjpeg {want.shape}")
    max_diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    db = psnr(got, want)
    seconds = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_jpeg(data, dev)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(seconds[2:]))
    mpix = got.shape[0] * got.shape[1] / 1e6
    log(f"nvJPEG: the {got.shape[1]}x{got.shape[0]} 4:2:0 fixture ({len(data)} bytes) against libjpeg's decode: "
        f"max |diff| {max_diff}, PSNR {db:.2f} dB (must be >= {JPEG_MIN_PSNR}); median {ms:.3f} ms per decode "
        f"over 10 after 2 warm-up, {ms / mpix:.3f} ms per megapixel")
    if not db >= JPEG_MIN_PSNR:
        raise AssertionError(f"nvJPEG's decode is {db:.2f} dB from libjpeg's")
    return {"psnr_db": db, "max_abs_diff": max_diff, "ms_per_decode": ms, "ms_per_megapixel": ms / mpix,
            "megapixels": mpix, "bytes": len(data)}


def check_built_database(db_dir: Path, gt):
    """The built scene's files, its split and its spiral poses."""
    from vipnerf_tpu_torch.utils.io import read_csv_columns, read_png

    scene = db_dir / f"all/database_data/{DB_SCENE}"
    decoded = read_png(FIXTURES / "synth_1008x756_decoded.png")
    for sub, shape in (("rgb", decoded.shape), ("rgb_down4", (H, W, 3)), ("rgb_down8", (H // 2, W // 2, 3))):
        names = sorted(p.name for p in (scene / sub).iterdir())
        if names != [f"{i:04}.png" for i in range(5)]:
            raise AssertionError(f"{sub}: {names}")
        for i in range(5):
            img = read_png(scene / f"{sub}/{i:04}.png")
            if img.shape != shape:
                raise AssertionError(f"{sub}/{i:04}.png is {img.shape}, expected {shape}")
            if sub == "rgb_down4" and not np.array_equal(img, gt["images"][i]):
                raise AssertionError(f"rgb_down4/{i:04}.png differs from the frame it was built from")
    rgb_db = psnr(read_png(scene / "rgb/0000.png"), decoded)
    if not rgb_db >= JPEG_MIN_PSNR:
        raise AssertionError(f"rgb/0000.png (nvJPEG) is {rgb_db:.2f} dB from libjpeg's decode")
    extr = np.loadtxt(scene / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    intr = np.loadtxt(scene / "CameraIntrinsics_down4.csv", delimiter=",").reshape(-1, 3, 3)
    bounds = np.loadtxt(scene / "DepthBounds.csv", delimiter=",")
    errs = {"extrinsics": float(np.abs(extr - gt["extrinsics"]).max()),
            "intrinsics_down4": float(np.abs(intr - gt["intrinsics"]).max()),
            "bounds": float(np.abs(bounds - gt["bounds"]).max())}
    if max(errs.values()) > 1e-9:
        raise AssertionError(f"the built cameras differ from the forged ones: {errs}")
    names = read_csv_columns(scene / "FrameNamesMapping.csv")
    if list(names["OldFrameName"]) != [f"IMG_{i:04}" for i in range(5)]:
        raise AssertionError(f"FrameNamesMapping.csv: {names}")
    sets = db_dir / "train_test_sets/set02"
    split = {name: [int(f) for f in read_csv_columns(sets / f"{name}VideosData.csv")["pred_frame_num"]]
             for name in ("Train", "Validation", "Test")}
    if split != {"Train": [2, 3], "Validation": [0], "Test": [0]}:
        raise AssertionError(f"the set02 split is {split}")
    spiral = np.loadtxt(sets / f"video_poses01/{DB_SCENE}.csv", delimiter=",").reshape(-1, 4, 4)
    det_err = float(np.abs(np.linalg.det(spiral[:, :3, :3]) - 1).max())
    if spiral.shape != (121, 4, 4) or det_err > 1e-6 or not np.allclose(spiral[:, 3], [0, 0, 0, 1]):
        raise AssertionError(f"spiral poses {spiral.shape}, max |det(R) - 1| {det_err:.2e}")
    log(f"built database checked: rgb (nvJPEG, {rgb_db:.2f} dB from libjpeg), rgb_down4 equal to the forged frames, "
        f"rgb_down8 at {W // 2}x{H // 2}; cameras within {max(errs.values()):.1e} of the forged ones; set02 {split}; "
        f"121 spiral poses, max |det(R) - 1| {det_err:.1e}")
    return {"camera_max_err": max(errs.values()), "spiral_det_err": det_err, "split": split, "rgb_psnr_db": rgb_db}


def tar_states_equal(a: Path, b: Path) -> bool:
    sa, sb = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    same = sa["iteration_num"] == sb["iteration_num"] and sa["model_state_dict"].keys() == sb["model_state_dict"].keys()
    same = same and all(torch.equal(v, sb["model_state_dict"][k]) for k, v in sa["model_state_dict"].items())
    oa, ob = sa["optimizer_state_dict"], sb["optimizer_state_dict"]
    same = same and oa["param_groups"] == ob["param_groups"] and oa.get("loss_guard") == ob.get("loss_guard")
    return same and oa["state"].keys() == ob["state"].keys() and all(
        torch.equal(e[key], ob["state"][i][key]) for i, e in oa["state"].items()
        for key in ("step", "exp_avg", "exp_avg_sq"))


def phase_database(k1, dev):
    """Database and migration: nvJPEG against libjpeg; a raw NeRF-LLFF scene
    forged in the published layout (COLMAP model, poses_bounds.npy, the
    JPEG fixture as images/, 1008x756 and 504x378 pyramids) zipped and built
    by the builder's CLI (nvJPEG decoding images/ on the card); its files,
    split and spiral poses checked; its priors (VW02 generated on the card,
    DE02 written from the true depths); the NeRF_LLFF app at the flagship
    width with bf16 heads for DB_STEPS steps (exactly 2 K1 launches per
    step); checkpoint DB_STEPS / 2 through export_checkpoint and
    import_checkpoint, bit for bit; a resume from the original and one from
    the round trip; a DataParallel model loading the .tar strictly; a step
    with fast_encoding (PE on the card against the CPU) and a train-mode
    preprocessor with spherify."""
    from vipnerf_tpu_torch.apps import nerf_llff as app_llff
    from vipnerf_tpu_torch.apps.common import DatasetApp
    from vipnerf_tpu_torch.core.encoding import positional_encoding
    from vipnerf_tpu_torch.data.loaders import get_data_loader
    from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
    from vipnerf_tpu_torch.data.synthetic import write_raw_llff_scene, write_sparse_depths
    from vipnerf_tpu_torch.db_builders import nerf_llff
    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, uses_fused_mlp
    from vipnerf_tpu_torch.priors.cli import main_visibility
    from vipnerf_tpu_torch.utils import jax_ckpt
    from vipnerf_tpu_torch.utils.jpeg import decode_jpeg

    t_phase = time.perf_counter()
    device_arg = "cpu" if dev.type == "cpu" else "all"
    jpeg = phase_jpeg(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        gt = write_raw_llff_scene(root / "raw", scene_name=DB_SCENE, num_frames=5, height=H, width=W,
                                  source_jpeg=FIXTURES / "synth_1008x756.jpg")
        zip_path = root / "raw/nerf_llff_data.zip"
        with zipfile.ZipFile(zip_path, "w") as zf:
            for p in sorted((root / "raw/nerf_llff_data").rglob("*")):
                zf.write(p, p.relative_to(root / "raw"))
        forge_s = time.perf_counter() - t0
        db_dir = root / "data/databases/NeRF_LLFF/data"
        decodes = decode_jpeg.launches
        t0 = time.perf_counter()
        nerf_llff.main(["--database_dirpath", str(db_dir), "--zip_filepath", str(zip_path),
                        "--set_nums", "2", "--num_train_frames", "2", "--video_poses", "--device", device_arg])
        build_s = time.perf_counter() - t0
        decodes = decode_jpeg.launches - decodes
        log(f"raw NeRF-LLFF scene forged (5 frames, COLMAP model, images/ JPEG fixture, images_4 {W}x{H}, images_8) "
            f"and zipped in {forge_s:.2f} s; `python -m vipnerf_tpu_torch.db_builders.nerf_llff --zip_filepath ... "
            f"--set_nums 2 --num_train_frames 2 --video_poses` built it in {build_s:.2f} s with {decodes} nvJPEG "
            f"decodes")
        if decodes != 5:
            raise AssertionError(f"the build decoded {decodes} JPEGs on the card, expected 5")
        built = check_built_database(db_dir, gt)

        write_sparse_depths(db_dir / f"all/estimated_depths/DE02/{DB_SCENE}/estimated_depths_down4",
                            gt["depths"], built["split"]["Train"])
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root),
                             "--device", device_arg])
        prior_s = time.perf_counter() - t0
        if f"on {dev}" not in out.getvalue():
            raise AssertionError("the visibility prior did not run on the card")
        check_prior_outputs(db_dir / "all/visibility_prior/VW02", [(2, 3)])
        log(f"priors of the built scene: VW02 generated on the card in {prior_s:.2f} s, DE02 from the true depths")

        app = DatasetApp("NeRF_LLFF", "scene_name", "all", root_dirpath=root)
        train_configs, _ = app_llff.demo_configs(21, 2, DB_SCENE, sparse_depth=True, num_rays=2048,
                                                 num_iterations=DB_STEPS)
        train_configs["model"].update(bf16_matmuls=True, f32_heads=False)
        train_configs.update(model_save_interval=DB_STEPS // 2, validation_interval=10 * DB_STEPS, device=device_arg)
        if not uses_fused_mlp(train_configs["model"]["fine_mlp"], True, False):
            raise AssertionError("the built database's training does not take K1")
        k1.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.start_training(copy.deepcopy(train_configs))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches_train = dict(k1.fused_mlp_raw.launches_by_instance)
        run = root / "runs/training/train0021"
        saved = run / f"{DB_SCENE}/saved_models"
        losses = [v for _, v in sorted(read_scalars(run / DB_SCENE)["train/TotalLoss"])]
        log(f"app start_training on the built database (flagship width, bf16 heads, 2048 + 2048 rays): {DB_STEPS} "
            f"steps in {train_s:.2f} s with set-up and 2 checkpoints; K1 launches {launches_train}; mean TotalLoss "
            f"first 10 {np.mean(losses[:10]):.5f}, last 10 {np.mean(losses[-10:]):.5f}")
        if launches_train != {"fused_mlp_bf16": 2 * DB_STEPS, "fused_mlp_f32": 0}:
            raise AssertionError(f"training the built database launched K1 {launches_train}")
        if len(losses) != DB_STEPS or not np.isfinite(losses).all():
            raise AssertionError("the built database's training logged no finite loss per step")

        configs = json.loads((run / "Configs.json").read_text())
        tar = saved / f"Model_Iter{DB_STEPS // 2:06}.tar"
        t0 = time.perf_counter()
        ckpt = jax_ckpt.export_checkpoint(tar, configs, root / "jax")
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = jax_ckpt.import_checkpoint(ckpt, configs, root / "back")
        import_s = time.perf_counter() - t0
        if not tar_states_equal(tar, back):
            raise AssertionError("the .tar -> .ckpt -> .tar round trip is not bit for bit")
        log(f"migration: {tar.name} -> {ckpt.name} ({ckpt.stat().st_size} bytes) in {export_s:.2f} s -> .tar in "
            f"{import_s:.2f} s: weights, moments, count and LR bit for bit")

        wrapped = torch.nn.DataParallel(ViPNeRF(configs).to(dev))
        wrapped.load_state_dict(torch.load(tar, map_location=dev, weights_only=True)["model_state_dict"], strict=True)
        del wrapped

        original = shutil.copyfile(tar, root / "original.tar")
        resumed, launches_resume = {}, 0
        for label, source in (("original", original), ("round trip", back)):
            for p in saved.glob("Model_*"):
                if p.name != tar.name:
                    p.unlink()
            shutil.copyfile(source, saved / tar.name)
            (saved / "Model_Latest.tar").symlink_to(tar.name)
            cfg = copy.deepcopy(train_configs)
            cfg["num_iterations"] = DB_STEPS // 2 + DB_RESUME_STEPS
            k1.reset_launch_counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                app.start_training(cfg)
            launches = k1.fused_mlp_raw.launches
            if f"Resuming Training from iteration {DB_STEPS // 2 + 1}" not in out.getvalue() \
                    or launches != 2 * DB_RESUME_STEPS:
                raise AssertionError(f"the resume from the {label} did not resume at {DB_STEPS // 2} "
                                     f"or launched K1 {launches} times")
            launches_resume += launches
            end = torch.load(saved / f"Model_Iter{cfg['num_iterations']:06}.tar", map_location="cpu",
                             weights_only=True)
            resumed[label] = end["model_state_dict"]
        resume_diff = max(float((resumed["original"][k] - resumed["round trip"][k]).abs().max())
                          for k in resumed["original"])
        log(f"resumed {DB_RESUME_STEPS} steps from the original checkpoint and from the round trip: max parameter "
            f"difference {resume_diff:.3e} (the card's nondeterminism alone); a DataParallel model loaded "
            f"{tar.name} strictly")

        x = torch.rand((TRAIN_N["fine"], 3), generator=torch.Generator().manual_seed(7)) * (2 * math.pi) - math.pi
        pe_err = float((positional_encoding(x.to(dev), 10, fast=True).cpu() - positional_encoding(x, 10, fast=True))
                       .abs().max())
        fast_cfg = copy.deepcopy(configs)
        for level in ("coarse_mlp", "fine_mlp"):
            fast_cfg["model"][level]["fast_encoding"] = True
        rig = TrainRig(root, fast_cfg, dev)
        k1.reset_launch_counts()
        scalars = rig.step_fn(True, False)(rig.batch(0))
        fast_launches = k1.fused_mlp_raw.launches
        fast_loss = float(scalars["TotalLoss"])
        log(f"fast_encoding: PE at degree 10 of {x.shape[0]} points on the card vs the CPU max |diff| {pe_err:.2e} "
            f"(tolerance {TOL_FAST_PE:.2e}); one training step with it: TotalLoss {fast_loss:.5f}, "
            f"{fast_launches} K1 launches")
        if not pe_err <= TOL_FAST_PE or not math.isfinite(fast_loss) or fast_launches != 2:
            raise AssertionError("fast_encoding on the card failed its checks")
        del rig

        sph_cfg = copy.deepcopy(configs)
        sph_cfg["data_loader"].update(scene_id=DB_SCENE, spherify=True, ndc=False)
        raw = get_data_loader(sph_cfg, root / "data" / sph_cfg["database_dirpath"], "train").load_data()
        prep = get_data_preprocessor(sph_cfg, "train", raw_data_dict=raw, device=dev)
        batch = prep.get_next_batch(0)
        finite = all(bool(torch.isfinite(v).all()) for v in batch.values()
                     if torch.is_tensor(v) and v.is_floating_point())
        radius = float(np.sqrt((prep.poses[:, :3, 3] ** 2).sum(-1).mean()))
        log(f"spherify: a train-mode preprocessor of the built scene on the card, poses {tuple(prep.poses.shape)} at "
            f"RMS radius {radius:.6f}, bounds {np.round(prep.bounds, 4).tolist()}, a batch of "
            f"{batch['rays_o'].shape[0]} rays, finite {finite}")
        if not finite or abs(radius - 1) > 1e-5:
            raise AssertionError("the spherified preprocessor failed its checks")
    phase_s = time.perf_counter() - t_phase
    log(f"database and migration phase: {phase_s:.1f} s")
    return {"seconds": phase_s, "jpeg": jpeg, "forge_s": forge_s, "build_s": build_s, "nvjpeg_decodes": decodes,
            "built": built, "prior_s": prior_s, "train_s": train_s, "train_steps": DB_STEPS,
            "k1_launches": launches_train["fused_mlp_bf16"] + launches_resume + fast_launches,
            "k1_launches_per_step": launches_train["fused_mlp_bf16"] / DB_STEPS,
            "loss_first10": float(np.mean(losses[:10])), "loss_last10": float(np.mean(losses[-10:])),
            "export_s": export_s, "import_s": import_s, "round_trip_bitwise": True,
            "resume_steps": DB_RESUME_STEPS, "resume_max_param_diff": resume_diff,
            "fast_pe_max_diff": pe_err, "fast_step_loss": fast_loss, "spherify_rms_radius": radius}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_mlp_config
    from vipnerf_tpu_torch.kernels import build
    from vipnerf_tpu_torch.kernels import fused_mlp as k1
    from vipnerf_tpu_torch.models.mlp import NeRFMLP

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = device_line()
    log(card)

    t0 = time.perf_counter()
    build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build.build_seconds.items()))
    for name, report in build.ptxas_reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    for dtype in (torch.bfloat16, torch.float32):
        log(f"{k1.INSTANCE[dtype]}: {k1.smem_bytes(dtype)} bytes of dynamic shared memory per CTA")

    mlp = NeRFMLP(flagship_mlp_config(0), torch.Generator().manual_seed(0)).to(dev)
    worst, timings = phase_k1(k1, mlp, dev)
    launches, s_per_frame, frame_s, modes = phase_slice(k1, dev, timings)
    train = phase_train(k1, dev, timings)
    pipeline = phase_pipeline(k1)
    multi = phase_multi_scene(k1, dev)
    database = phase_database(k1, dev)

    log(json.dumps({"slice": {
        "resolution": [H, W], "chunk_size": CHUNK, "k1_timing_shape": {"points": MAIN_N, "n_sec": 0},
        "seconds_per_frame_start_testing": s_per_frame, "warm_frame_seconds": frame_s,
        "precision_modes": modes, "card": card}}))
    log(json.dumps({"training": {
        "resolution": [H, W], "rays_per_step": TRAIN_RAYS, "k1_shapes": TRAIN_N, "n_sec": TRAIN_SEC,
        **{k: v for k, v in train.items() if k != "run"}, **train["run"], "card": card}}))
    log(json.dumps({"multi_scene": {"resolution": [H, W], "scenes": MS_SCENES, "rays_per_step_per_scene": TRAIN_RAYS,
                                    "steps": MS_STEPS + MS_RESUME_STEPS, **multi, "card": card}}))
    log(json.dumps({"pipeline": {"resolution": [H, W], "prior_planes": 64, "app_steps": PIPE_STEPS,
                                 **pipeline, "card": card}}))
    log(json.dumps({"database": {"resolution": [H, W], **database, "card": card}}))
    # each instance's launches come from its own path: the bf16 one from
    # start_testing, start_training, the batched app run and the built
    # database's runs, the f32 one from the f32 frame of phase_modes
    path_launches = {"fused_mlp_bf16": launches["fused_mlp_bf16"] + train["run"]["launches"] + multi["launches"]
                     + database["k1_launches"],
                     "fused_mlp_f32": modes["f32"]["launches"]["fused_mlp_f32"]}
    kernels = []
    for dtype in (torch.bfloat16, torch.float32):
        name = k1.INSTANCE[dtype]
        main_shape = timings[(dtype, 0, MAIN_N)]
        if not path_launches[name]:
            raise AssertionError(f"{name} was not launched on its path")
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "vipnerf_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "experiments/fused_mlp.py:130",
            "launches": path_launches[name],
            "max_abs_err": worst[dtype],
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "library_ms": main_shape["library_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
