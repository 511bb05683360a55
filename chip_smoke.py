"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:

1. the card's name and power limit, then the build of every library under
   csrc/ (the CUDA kernels with nvcc, the ray stream with g++, nvJPEG's
   binding with g++ against the CUDA toolkit);
2. K1 (the fused MLP forward) against its plain torch version on the card,
   every instance (bf16; f32; bf16_f32h, the shipped mode: bf16 trunk, f32
   heads), n_sec 0..3, at N = 262,144 points, at
   ragged N = 1, 2,085 and 132 * 128 * 3 + 37 (the bf16 kernel's persistent
   loop runs several tiles per CTA and ends mid-tile), and at the two tile
   shapes the serving path launches (8192 rays x 64 coarse and x 192 fine
   samples) for n_sec 0 and 2, with the kernel's, the plain version's and a
   library yardstick's times at those shapes, and at the training step's
   two launch shapes (4096 rays x 64 and x 192 samples, n_sec 2), each with
   its bound (the trunk's and the heads' operations and the bytes apart) and
   the L2 bytes its design reads per launch; bf16_f32h (heads on tensor
   cores from split bf16 products) also against its FFMA yardstick (the
   former heads on CUDA cores, on no path) at every one of those shapes,
   timed beside it; each instance's weight pack per training step; the
   encode kernel that writes K1's inputs (csrc/fused_mlp.cu
   k1_encode_kernel) in the shipped mode at a serving tile's fine level
   (8192 rays x 192 samples, n_sec 0) and a training step's (4096 x 192,
   n_sec 2), directions per ray: bit for bit the torch chain's, timed
   beside it and against its bytes bound (on the paths of phases 3, 4, 5
   and 8 every K1 launch must be fed by one encode launch); then
   K1's backward in the shipped mode (csrc/fused_mlp_bwd.cu, the f32
   heads' gradient on the bf16 tensor cores, wgmma fed by bulk copies):
   the two kernels bit for bit the plain version on exact-sum inputs (and
   the forward heads on one), each against its plain version in f64 and
   both end to end against f64, the yardstick (autograd through
   raw_recompute's f32 heads) and the first design's kernels
   (csrc/fused_mlp_bwd_mma_sync.cu, on no path) at the training step's two
   launch shapes for n_sec 0..3, at S = 2 and at ragged sizes, on inputs
   without ReLU ties; two launches bit for bit the same; timed at the
   training shapes at S = 1, 2, 4 in turns with the first design's kernels,
   beside their plain versions, their library routes (f32 torch.matmul per
   product) and the yardstick, with the L2 bytes each design moves;
3. the serving path: a run tree at the flagship width (8x256 MLPs, 64+128
   samples, NDC, bf16 matmuls with bf16 heads) with seeded random weights,
   rendered by the port's `start_testing` at 1008x756 -- 3 train frames with
   visibility towards the 2 others, 2 held-out frames -- checking the
   outputs and that K1 ran on every tile; warm frame times; one warm
   held-out frame in each precision mode (bf16 with bf16 heads through the
   bf16 instance, the shipped default bf16 with f32 heads through
   bf16_f32h, f32 through the f32 instance) and in the shipped mode through
   the module MLP beside it, counting each instance's launches in each;
   then a 64x48
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
   batch (every instance); `start_training` for 200 steps (checkpoint at
   100, validation at 200), then resumed to 220, checking finite and falling
   losses, the checkpoints, exactly 2 K1 launches per step and the
   validation's, and the trained model's PSNR on the test frame against the
   untrained one's; 100 shipped-mode steps through K1, K1 with the
   yardstick backward and the module MLP from the same weights and batches,
   each pair compared (the first 20 steps held to the port-vs-JAX
   trajectory's bands); in
   the shipped mode (bf16_f32h) the median warm step
   time with rays/s, K1's share and peak memory, and a torch.profiler table
   of one step split into forward, backward and Adam (the backward with
   K1's backward kernels and no f32 matrix product); a warm step in each
   precision mode, and in the shipped mode through the module MLP;
5. the user's pipeline at 1008x756: a synthetic LLFF scene under the LLFF
   policy's _down4 suffix without a visibility prior; the prior generated
   by the entry point of `python -m vipnerf_tpu_torch.priors.visibility` on
   the card (64 planes, 3 pairs x 2 directions, timed per direction), its
   files checked and one direction held against the same function on the
   CPU; the sparse-depth CLI's ColmapNotFoundError (the card has no
   COLMAP); the NeRF_LLFF app with demo1a's shipped configs (bf16 with f32
   heads, so K1's bf16_f32h instance, exactly 2 launches per training step)
   cut to 200 steps: training on the generated prior, testing with its QA
   subprocess (finite RMSE02, PSNR02, SSIM02; LPIPS02 null without
   weights), and both video tracks as frame directories;
6. batched multi-scene training: two seeded synthetic LLFF scenes at
   1008x756 (3 train views each) in one database; the scene-batched K1
   (every instance, 2 and 4 scenes with their own weights, at the
   training step's launch shapes) against its plain version and bit for bit against
   single-scene launches (bf16_f32h also against its FFMA yardstick),
   timed beside them, the plain version and a
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
8. the protocol: the DTU quality control's driver
   (`python -m vipnerf_tpu_torch.protocol.run_dtu_control`) at 300x400:
   its database with object masks and VW03 generated on the card (DTU's
   policy, 128 linear planes), the masks checked and one direction held
   against the CPU; a 200-step leg in the shipped mode (bf16 with f32
   heads, through bf16_f32h, exactly 2 launches per training step) with its
   loss falling and its masked QA written,
   train/MSE01 at 100 and 200 printed beside the JAX run's; a checkpoint at
   29,950 written from those weights with Adam's count set to match, and
   the driver resumed to 30,050 with bf16 heads (K1 on metric-space rays):
   TotalLoss against its terms on both sides of the visibility prior's
   switch at iter_num 30,000, the LR there, exactly 2 K1 launches per step;
   every K1 instance against its plain version on this scene's
   2048 + 2048-ray batch;
9. more than one device, as far as one card shows it (the script needs
   one card): a synthetic two-scene LLFF database at 1008x756 and
   the flagship config with bf16 heads at 2048 + 2048 rays; (a) 10 steps of
   the port's Trainer through the distributed step code on NCCL at world
   size 1, bit for bit against the single-process Trainer; (b) two gloo
   ranks sharing the card, spawned by the port's launcher, 10 steps from
   the same weights: the ranks' parameters bit for bit equal, TotalLoss
   per step and the parameters' distance within their limits of the
   one-rank run, K1 exactly 2 launches per step per rank; (c) a held-out frame by
   `start_testing` on the two ranks against one rank (bitwise or not,
   printed); (d) `batch_scenes` with S = 2 over the two ranks against S = 2
   in one process, the scenes in both orders; the seconds of two ranks sharing one card (not a
   scaling figure);
10. a JSON line of each of phases 3-9, of K1's backward, and of the
   kernels (K1's instances, its two backward kernels and the encode; the FFMA yardstick
   and the backward's first design apart, under "yardsticks", each with
   its launches on the main path: 0), and the device line last.

It needs CUDA and the repository around it, and exits non-zero without a
result otherwise. Nothing of JAX is imported.
"""

import contextlib
import copy
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

from vipnerf_tpu_torch.utils import tracing

# Data-sheet peaks of an H100 SXM (dense): bf16 and TF32 tensor cores, f32 CUDA cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1's instances: name -> (trunk dtype, f32 heads)
K1_MODES = {"fused_mlp_bf16": (torch.bfloat16, False), "fused_mlp_f32": (torch.float32, False),
            "fused_mlp_bf16_f32h": (torch.bfloat16, True)}
# K1 against its plain version, relative to the plain outputs' own scale.
# bf16: the two sum in different orders, so a rounding to bf16 can land one
# step (2^-8 relative) apart and the step propagates; the max error may be a
# few such steps at the largest output, the RMS error stays far below one
# step. f32: summation order only. bf16_f32h: the bf16 trunk's steps, carried
# through f32 heads that round nothing more (measured at most 9.3e-4 and
# 3.0e-5 on an H100 80GB HBM3 at 700 W, so the bf16 limits tightened 8x and
# 10x).
TOL_REL_MAX = {"fused_mlp_bf16": 2.0 ** -5, "fused_mlp_f32": 1e-5,
               "fused_mlp_bf16_f32h": 2.0 ** -8}  # max|err| / max|plain|
TOL_REL_RMS = {"fused_mlp_bf16": 2e-3, "fused_mlp_f32": 1e-6, "fused_mlp_bf16_f32h": 2e-4}  # ||err|| / ||plain||
# bf16_f32h against its FFMA yardstick (`fused_mlp_raw_ffma`) on the same
# inputs: both run the same trunk code, so h is the same and the difference
# is the heads' arithmetic alone, split bf16 products on tensor cores against
# FFMA, both f32-accurate (measured 1.9e-6 and 1.3e-6 on an H100 80GB HBM3 at
# 700 W: the tensor cores round each k16 step's sum toward zero, which
# tests/test_torch_fused_mlp.py's emulation reproduces); a single TF32 or bf16
# pass over an f32 operand misses these by more than 10x, a split missing one
# operand's third part does not (the same file emulates both)
TOL_HEADS_MAX = 3e-5  # max|new - ffma| / max|ffma|
TOL_HEADS_RMS = 3e-6  # ||new - ffma|| / ||ffma||
# The shipped mode's heads backward (kernels/fused_mlp.py heads_backward)
# on inputs whose ReLU ties are taken out (`untie_relu`); errors are
# max|err| / max|ref| and ||err|| / ||ref|| per tensor, and the share of d
# h's (bf16) entries off the reference's rounding. The limits come from the
# numpy emulation of the kernels' arithmetic (tests/
# test_torch_heads_backward.py: 512 points, n_sec 0-3, the card's
# truncating k16 sums), which reads at most the figure in the comment.
# End to end (the 8 gradients and d PE(dir): worst tensor) against the plain
# version in f64 (on the CPU, against the JAX package's f32 gradients).
# Emulated: 8.1e-7, 5.8e-7, d h 2.3e-4 off; one pass of TF32 reads 1.2e-1,
# 2.6e-2, 0.12 (>10x over each). A dropped third part reads 2e-6-5e-6: any
# f32 computation of this chain sits at ~5e-7 (its f32 intermediates), so
# the per-kernel limits below are the ones that see a dropped part.
TOL_BWD_MAX = 2e-6
TOL_BWD_RMS = 1.5e-6
TOL_BWD_DH_FRAC = 5e-4
# Each kernel alone against its plain version in f64 on the same inputs.
# The per-point kernel's f32 outputs from h, PE(dir) and g, per tensor
# (RMS; emulated floors feature 9.6e-8, d feature 8.9e-8, D 4.9e-8, hv
# 1.4e-7, d hv 3.6e-8, d PE 8.8e-8, the worst entry 2.7e-7; the card read
# less). A dropped third
# part of W8 reads 11x over (feature), of W10 11x (d feature) and 12x (d
# PE), of D 12x (d feature), of d hv 12x (d PE); of the feature 7x and of
# PE(dir) 3x (hv: its parts are the smallest), and of d feature only through
# d h (3x): those three splits are the weight kernel's too, where they read
# over 10x.
TOL_BWD_POINTS_RMS = {"feature": 2e-7, "d_feature": 2e-7, "D": 1e-7, "hv": 3e-7, "d_hv": 8e-8,
                      "d_ve": 2e-7, "d_ve2": 2e-7}
TOL_BWD_POINTS_MAX = 6e-7
# The weight-gradient kernel's 8 gradients (dW10's feature and PE(dir)
# columns apart) from the per-point kernel's outputs, worst tensor: emulated
# 1.1e-7 and 7.6e-8 (1.1e-5 without promotion at 786,432 points); a dropped
# third part of the feature, PE(dir), D, d feature, d hv, hv or d o reads
# 15x-23x over the RMS limit. The max limits, here and for the per-point
# kernel, guard single entries (a stray tile) at 2-3x the worst measured:
# this one was 2e-7 as first derived, and the card read 1.8e-7 (dW9 at S =
# 2 x 786,432 points, an H100 80GB HBM3 at 700 W), so it is 4e-7.
TOL_BWD_WEIGHTS_MAX = 4e-7
TOL_BWD_WEIGHTS_RMS = 1.5e-7
# End to end against the yardstick (autograd through raw_recompute's f32
# heads, cuBLAS FFMA): one-pass TF32 reads >1000x over (emulated). First
# set at 1e-5 and 5e-6; on an H100 80GB HBM3 at 700 W the yardstick then
# read up to 4.83e-6 (max) and 4.58e-6 (RMS) from the kernels at 786,432
# points, where the kernels read 2.1e-7 and 1.3e-7 from f64 (the
# yardstick's own summation over the points), hence 2e-5 and 1e-5.
TOL_BWD_YARD_MAX = 2e-5
TOL_BWD_YARD_RMS = 1e-5
TOL_BWD_YARD_DH_FRAC = 1e-3
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
# precision modes of a flagship level: (bf16_matmuls, f32_heads), each through its K1 instance
MODES = {"bf16, bf16 heads": (True, False), "bf16, f32 heads (default)": (True, True),
         "f32": (False, False)}
# (label, bf16_matmuls, f32_heads, through the nn.Module MLP): each mode through
# its instance, and the shipped mode through the module MLP beside it, the
# path that mode took before it had an instance
MODE_RUNS = [(label, bf16, f32_heads, False) for label, (bf16, f32_heads) in MODES.items()] \
    + [("bf16, f32 heads, module MLP", True, True, True)]


def log(*args):
    print(*args, flush=True)


def launches_since(k1, mark: dict, kernels=None) -> dict:
    """Launches of each of `kernels` (K1's forward instances by default)
    since `mark`, a `tracing.counts()` taken before."""
    kernels = k1.FORWARD if kernels is None else kernels
    return {k: n - mark.get(f"k1.launches.{k}", 0) for k, n in k1.launches(kernels).items()}


# (path, encode launches) of each path whose K1 launches were all fed by the
# encode kernel (`encode_fed`)
ENCODE_FED: list = []


def encode_fed(k1, mark: dict, path: str) -> None:
    """Records in `ENCODE_FED` the encode kernel's launches since `mark`,
    which must equal K1's forward launches since then: every K1 launch on
    `path` took its inputs from one encode launch."""
    encodes = launches_since(k1, mark, [k1.ENCODE])[k1.ENCODE]
    forward = sum(launches_since(k1, mark).values())
    if encodes != forward:
        raise AssertionError(f"{path}: {encodes} encode launches fed {forward} K1 launches")
    ENCODE_FED.append((path, encodes))


def launch_counts(k1, **counts) -> dict:
    """Every instance's launch count: `counts`, 0 for the others."""
    return {name: counts.get(name, 0) for name in k1.INSTANCE.values()}


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
    (cuBLAS) per layer, each in its layer's dtype (with f32 heads: bf16 to
    layer 7, then f32) -- the module path's arithmetic. It is a chain of ~12
    calls, not one library call."""
    lin = torch.nn.functional.linear
    relu = torch.relu
    b = [bb.to(ww.dtype) for ww, bb in layers]
    w = [ww for ww, _ in layers]
    h = relu(lin(xe, w[0]) + b[0])
    for i in (1, 2, 3, 4):
        h = relu(lin(h, w[i]) + b[i])
    h = relu(lin(torch.cat([xe, h], 1), w[5]) + b[5])
    for i in (6, 7):
        h = relu(lin(h, w[i]) + b[i])
    h = h.to(ve.dtype)
    feature = lin(h, w[8]) + b[8]
    sigma = (lin(h, w[9]) + b[9])[:, :1]
    out = [sigma, (lin(relu(lin(torch.cat([feature, ve], 1), w[10]) + b[10]), w[11]) + b[11])[:, :4]]
    for j in range(n_sec):
        hv = relu(lin(torch.cat([feature, ve2[:, 32 * j:32 * j + 32]], 1), w[10]) + b[10])
        out.append((lin(hv, w[11]) + b[11])[:, 3:4])
    return torch.cat(out, 1)


def k1_bound_parts(k1, n, n_sec, name, scenes=1) -> dict:
    """Least times (ms) of K1's parts on n points (of `scenes` scenes, each
    with its own weights): the trunk's and the heads' operations, each at
    the peak of its unit, and the bytes of the inputs, the raw output and the
    packed weights. bf16_f32h's heads run on the bf16 tensor cores as split
    products (`k1.F32H_SPLIT_MACS`: 3 per MAC of the feature and sigma
    layers, 6 per MAC of the view and output layers, the view layer's
    feature columns once per point); the other instances' heads on their
    trunk's unit, as plain products."""
    trunk, f32_heads = K1_MODES[name]
    head = torch.float32 if f32_heads else trunk
    peak = {torch.bfloat16: PEAK_BF16_FLOPS, torch.float32: PEAK_F32_FLOPS}
    trunk_macs = n * k1.TRUNK_MACS_PER_POINT
    if f32_heads:
        head_macs, head_peak = n * (k1.F32H_SPLIT_MACS + n_sec * k1.F32H_SPLIT_MACS_PER_SEC_VIEW), PEAK_BF16_FLOPS
    else:
        head_macs = n * (k1.MACS_PER_POINT - k1.TRUNK_MACS_PER_POINT + n_sec * k1.MACS_PER_SEC_VIEW)
        head_peak = peak[head]
    nbytes = (n * (k1.PTS_IN * trunk.itemsize + (k1.VIEW_IN * (1 + n_sec) + k1.NOUT) * head.itemsize)
              + scenes * (k1.PACK_BYTES[trunk, head] + k1.B_NUMEL * 4))
    return {"trunk_ops": 2e3 * trunk_macs / peak[trunk], "heads_ops": 2e3 * head_macs / head_peak,
            "bytes": 1e3 * nbytes / PEAK_BYTES}


def k1_bound_ms(k1, n, n_sec, name, scenes=1):
    """Least time for K1: the larger of its operations' time and its bytes'
    time (`k1_bound_parts`). Each instance runs its trunk and its heads on
    one unit (bf16_f32h's both on the bf16 tensor cores), so their times
    add."""
    parts = k1_bound_parts(k1, n, n_sec, name, scenes)
    ops = parts["trunk_ops"] + parts["heads_ops"]
    return max(ops, parts["bytes"]), ("operations" if ops >= parts["bytes"] else "bytes")


def f32_split_bound_ms(k1, n, n_sec):
    """The f32 instance's operations counted as bf16_f32h's heads are: every
    MAC as three TF32 products (3xTF32, f32-accurate) at the TF32 peak; a
    yardstick for ranking, not the bound of the FFMA kernel it runs."""
    return 2e3 * 3 * n * (k1.MACS_PER_POINT + n_sec * k1.MACS_PER_SEC_VIEW) / PEAK_TF32_FLOPS


def k1_inputs(k1, n, n_sec, name, g, dev):
    pts = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=dev))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=dev)) if n_sec else None
    dtype, f32_heads = K1_MODES[name]
    return k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)


FFMA = "fused_mlp_bf16_f32h_ffma"  # bf16_f32h with FFMA heads: the tensor-core heads' yardstick, on no path


def rel_errors(out, ref):
    """max|out - ref| / max|ref| and ||out - ref|| / ||ref||, in f32."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item(), \
        ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def check_against_ffma(k1, weights, heads32, out, xe, ve, ve2, ns, label):
    """bf16_f32h's output against its FFMA yardstick on the same inputs
    (`TOL_HEADS_*`), and the yardstick against the plain version (the
    instance's `TOL_REL_*`). Returns the yardstick's max|err| from the plain
    version."""
    ffma = k1.fused_mlp_raw_ffma(weights, heads32, xe, ve, ve2, ns)
    tracing.count("chip_smoke.ffma_compared")  # a comparison's launch, not a path's
    torch.cuda.synchronize()
    ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
    h_max, h_rms = rel_errors(out, ffma)
    f_max, f_rms = rel_errors(ffma, ref)
    log(f"K1 fused_mlp_bf16_f32h against its FFMA heads, {label}: max|new - ffma|/max|ffma| {h_max:.3g} "
        f"(tol {TOL_HEADS_MAX:.3g}), rms rel {h_rms:.3g} (tol {TOL_HEADS_RMS:.3g}); the FFMA route against the "
        f"plain version {f_max:.3g}, rms rel {f_rms:.3g}")
    if not (h_max <= TOL_HEADS_MAX and h_rms <= TOL_HEADS_RMS and bool(torch.isfinite(ffma).all())
            and f_max <= TOL_REL_MAX["fused_mlp_bf16_f32h"] and f_rms <= TOL_REL_RMS["fused_mlp_bf16_f32h"]):
        raise AssertionError(f"bf16_f32h's tensor-core heads disagree with its FFMA heads: {label}")
    return (ffma.float() - ref).abs().max().item()



def rel_pair(got, want):
    """(max|got - want| / max|want|, ||got - want|| / ||want||) in f64."""
    got, want = got.double(), want.double()
    return (((got - want).abs().max() / want.abs().max().clamp_min(1e-300)).item(),
            ((got - want).norm() / want.norm().clamp_min(1e-300)).item())


def worst_rel(pairs) -> tuple:
    """The worst `rel_pair` (max, rms) over (got, want) pairs, each taken
    on its own."""
    worst = [0.0, 0.0]
    for got, want in pairs:
        if got is None and want is None:
            continue
        worst = [max(a, b) for a, b in zip(worst, rel_pair(got, want))]
    return tuple(worst)


def dh_off(d_h, want) -> float:
    """Share of d h's (bf16) entries that differ from `want` rounded to
    bf16."""
    return (d_h.float() != want.to(torch.bfloat16).float()).double().mean().item()


def bwd_errors(got, want) -> dict:
    """The heads backward `got` = (d h, the 8 gradients, d ve, d ve2)
    against `want` (the same, any dtype): {"max", "rms"} worst over the
    gradients and d PE(dir), "dh_off"."""
    e_max, e_rms = worst_rel(list(zip(got[1], want[1])) + [(got[2], want[2]), (got[3], want[3])])
    return {"max": e_max, "rms": e_rms, "dh_off": dh_off(got[0], want[0])}


POINT_FIELDS = tuple(TOL_BWD_POINTS_RMS)
GRAD_PIECES = ("W8", "b8", "W9", "b9", "W10f", "W10p", "b10", "W11", "b11")


def points_errors(got, want) -> dict:
    """The per-point kernel's outputs (a `k1.HeadsIntermediates`) against
    another's: (max, rms) per field of `POINT_FIELDS` present, "dh_off"."""
    out = {f: rel_pair(getattr(got, f), getattr(want, f)) for f in POINT_FIELDS if getattr(want, f) is not None}
    out["dh_off"] = dh_off(got.d_h, want.d_h)
    return out


def points_ok(errs: dict) -> bool:
    return all(e[1] <= TOL_BWD_POINTS_RMS[f] and e[0] <= TOL_BWD_POINTS_MAX for f, e in errs.items()
               if f != "dh_off") and errs["dh_off"] <= TOL_BWD_DH_FRAC


def weights_errors(got, want) -> dict:
    """The 8 gradients against another's, dW10's feature and PE(dir)
    columns apart: (max, rms) per piece of `GRAD_PIECES`."""
    pieces = lambda g: g[:4] + [g[4][..., :256], g[4][..., 256:]] + g[5:]  # noqa: E731
    return dict(zip(GRAD_PIECES, (rel_pair(a, b) for a, b in zip(pieces(got), pieces(want)))))


def weights_ok(errs: dict) -> bool:
    return all(e[0] <= TOL_BWD_WEIGHTS_MAX and e[1] <= TOL_BWD_WEIGHTS_RMS for e in errs.values())


def untie_relu(k1, params, h, ve, ve2, g, n_sec, rel_gap: float = 1e-4):
    """g with each view's output gradient zeroed at the points where a
    pre-activation of that view's hidden layer, recomputed in f64, lies
    within `rel_gap` of its RMS from 0: there a ReLU's side can differ
    between two f32 computations of the same function (the kernels, the
    plain version, cuBLAS), and the whole d hv entry with it, which no
    rounding tolerance describes. The other entries' gradients are left as
    they are."""
    w8, b8, w10, b10 = (p.double() for p in (params[0], params[1], params[4], params[5]))
    views = [ve] + [ve2[:, 32 * j:32 * j + 32] for j in range(n_sec)]
    scenes = w8.shape[0] if w8.dim() == 3 else 1
    g = g.clone()
    for s in range(scenes):
        pick = (lambda t: t[s]) if w8.dim() == 3 else (lambda t: t)  # noqa: E731
        rows = slice(s * (h.shape[0] // scenes), (s + 1) * (h.shape[0] // scenes))
        feature = h[rows].double() @ pick(w8).t() + pick(b8)
        for v, pe in enumerate(views):
            pre = torch.cat([feature, pe[rows, :27].double()], 1) @ pick(w10).t() + pick(b10)
            tie = (pre.abs() < rel_gap * pre.square().mean().sqrt()).any(1)
            cols = slice(1, 5) if v == 0 else slice(4 + v, 5 + v)
            g[rows][tie, cols] = 0.0
    return g


def exact_heads_case(case: str, n: int, scenes: int = 1, n_sec: int = 2, seed: int = 0):
    """Inputs of the shipped mode's heads backward for which every sum of
    its function is exact in f32, whatever the order: (the heads' parameters
    in `module_params` order, stacked for S > 1; h (S n, 256) bf16; ve, ve2,
    g f32), CPU tensors. Every value is a small multiple of a power of two,
    and the sums' terms are few enough that no partial sum needs more than
    24 bits. "dense": every product of the function has many nonzero
    terms, but no operand has a second or third bf16 part. "witness": h is
    one-hot (a column per point, no column twice in a scene), W8 has one
    nonzero of 18 significant bits per column and W9 18 bits everywhere
    (their third parts are not zero), W10's feature columns are zero: the
    feature, D^T feature (dW10), d sigma W9 (d h) and h W9 (sigma) carry
    bits that only the third parts hold, each in a sum of one term, so a
    dropped third part moves dW10 by ~2^-17."""
    rng = np.random.default_rng(seed)

    def grid(shape, step, values=(-1, 1), density=1.0):
        v = rng.choice(np.asarray(values, np.float64), size=shape) * step
        return np.where(rng.uniform(size=shape) < density, v, 0.0)

    def scene(s):
        if case == "dense":
            h = (rng.uniform(size=(n, 256)) < 0.25).astype(np.float64)
            w8 = grid((256, 256), 2.0 ** -4, density=8 / 256)
            w10f = grid((128, 256), 2.0 ** -2, density=8 / 256)
        else:
            if n > 256:
                raise ValueError("the witness case takes at most 256 points per scene")
            h = np.zeros((n, 256))
            h[np.arange(n), rng.permutation(256)[:n]] = 1.0
            w8 = np.zeros((256, 256))
            w8[rng.permutation(256), np.arange(256)] = rng.integers(2 ** 17, 2 ** 18, 256) * rng.choice(
                [-1.0, 1.0], 256) * 2.0 ** -22
            w10f = np.zeros((128, 256))
        b8 = grid(256, 2.0 ** -4, (-1, 0, 1)) if case == "dense" else np.zeros(256)
        w9 = grid((1, 256), 2.0 ** -4, (-2, -1, 1, 2)) if case == "dense" else \
            rng.integers(2 ** 17, 2 ** 18, (1, 256)) * rng.choice([-1.0, 1.0], (1, 256)) * 2.0 ** -22
        w10 = np.concatenate([w10f, grid((128, 27), 2.0 ** -4, density=4 / 27)], 1)
        params = [w8, b8, w9, grid(1, 2.0 ** -4),
                  w10, grid(128, 2.0 ** -4, (-1, 0, 1)), grid((4, 128), 2.0 ** -2, density=0.25), grid(4, 2.0 ** -4)]
        pe = [np.pad(grid((n, 27), 2.0 ** -2, (-4, -3, -2, -1, 0, 1, 2, 3, 4)), ((0, 0), (0, 5)))
              for _ in range(1 + n_sec)]
        g = np.zeros((n, 8))
        g[:, :5 + n_sec] = grid((n, 5 + n_sec), 0.5, (-2, -1, 0, 1, 2))
        return params, h, pe, g

    parts = [scene(s) for s in range(scenes)]
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    params = [f32(np.stack([p[0][i] for p in parts]) if scenes > 1 else parts[0][0][i]) for i in range(8)]
    h = f32(np.concatenate([p[1] for p in parts])).to(torch.bfloat16)
    ve = f32(np.concatenate([p[2][0] for p in parts]))
    ve2 = f32(np.concatenate([np.concatenate(p[2][1:], 1) for p in parts])) if n_sec else ve
    return params, h, ve, ve2, f32(np.concatenate([p[3] for p in parts])), n_sec


def phase_k1(k1, mlp, dev):
    """K1 against its plain version on the card at every checked shape, timed
    at the serving path's two tile shapes and the training step's two launch
    shapes, each instance; bf16_f32h also against its FFMA yardstick at every
    shape, timed beside it. Returns the worst max|err| of each instance (and
    of the yardstick, under `FFMA`) and the timings keyed by (instance or
    `FFMA`, n_sec, n)."""
    g = torch.Generator(device=dev).manual_seed(1)
    worst = {}
    timings = {}
    for name, (dtype, f32_heads) in K1_MODES.items():
        weights = k1.prepare_weights(mlp, dtype, f32_heads)
        heads32 = k1.ffma_heads(weights) if f32_heads else None
        worst[name] = 0.0
        if f32_heads:
            worst[FFMA] = 0.0
        for n_sec in range(4):
            timed = set(TILE_N.values()) if n_sec in (0, 2) else set()
            if n_sec == TRAIN_SEC:
                timed |= set(TRAIN_N.values())
            for n in RAGGED_N + sorted({262144} | timed):
                xe, ve, ve2, ns = k1_inputs(k1, n, n_sec, name, g, dev)
                out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
                torch.cuda.synchronize()
                ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
                out_dtype, out = out.dtype, out.float()
                err = (out - ref).abs().max().item()
                rel_max, rel_rms = rel_errors(out, ref)
                finite = bool(torch.isfinite(out).all())
                pad_zero = not out[:, 5 + ns:].any()
                log(f"K1 {name} n_sec={n_sec} N={n}: max|err| {err:.3g}, max|err|/max|plain| "
                    f"{rel_max:.3g} (tol {TOL_REL_MAX[name]:.3g}), rms rel {rel_rms:.3g} "
                    f"(tol {TOL_REL_RMS[name]:.3g}), finite {finite}, padding zero {pad_zero}")
                if not (finite and pad_zero and out_dtype == ve.dtype and rel_max <= TOL_REL_MAX[name]
                        and rel_rms <= TOL_REL_RMS[name]):
                    raise AssertionError(f"K1 disagrees with its plain version: {name} n_sec={n_sec} N={n}")
                worst[name] = max(worst[name], err)
                if f32_heads:
                    worst[FFMA] = max(worst[FFMA], check_against_ffma(
                        k1, weights, heads32, out, xe, ve, ve2, ns, f"n_sec={n_sec} N={n}"))
                if n not in timed:
                    continue
                runs = {name: lambda: k1.fused_mlp_raw(weights, xe, ve, ve2, ns)}
                if f32_heads:
                    runs[FFMA] = lambda: k1.fused_mlp_raw_ffma(weights, heads32, xe, ve, ve2, ns)
                plain_ms = cuda_ms(lambda: k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns), reps=3)
                lib_ms = cuda_ms(lambda: library_raw(weights.layers, xe, ve, ve2, ns), reps=5)
                bound, bound_by = k1_bound_ms(k1, n, ns, name)
                parts = k1_bound_parts(k1, n, ns, name)
                for run_name, run in runs.items():
                    ms = cuda_ms(run)
                    l2 = k1.stream_bytes(run_name, n, ns)
                    tflops = 2 * n * (k1.MACS_PER_POINT + ns * k1.MACS_PER_SEC_VIEW) / (ms * 1e-3) / 1e12
                    extra = (f", 3xTF32 split-product bound {f32_split_bound_ms(k1, n, ns):.4f} ms"
                             if name == "fused_mlp_f32" else "")
                    log(f"K1 timing {run_name} n_sec={n_sec} N={n}: kernel_ms {ms:.4f} "
                        f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (torch.nn.functional.linear "
                        f"per layer, no single call) bound_ms {bound:.4f} ({bound_by}; trunk operations "
                        f"{parts['trunk_ops']:.4f}, heads operations {parts['heads_ops']:.4f}, bytes "
                        f"{parts['bytes']:.4f}) share of bound {bound / ms:.3f}, achieved {tflops:.1f} TFLOP/s "
                        f"of the function's own products, L2 bytes per launch by design {l2 / 1e9:.3f} GB "
                        f"({l2 / (ms * 1e-3) / 1e12:.2f} TB/s){extra}")
                    timings[(run_name, n_sec, n)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                                         bound_ms=bound, bound_by=bound_by, bound_parts_ms=parts)
    # training repacks every step (the optimizer moves the weights): the
    # pack of each mode, its layers' padding and casts included
    for name, (dtype, f32_heads) in K1_MODES.items():
        head = torch.float32 if f32_heads else dtype
        pack_ms = cuda_ms(lambda: k1.kernel_buffers(k1.pack_layers(mlp, dtype, head), dtype, head), reps=20)
        log(f"K1 {name}: packing the weights takes {pack_ms:.4f} ms per training step")
    return worst, timings


# ------------------------------------------------- K1's inputs (the encode kernel)

# (rays, samples per ray, n_sec) of the encode's timed shapes, each one K1
# launch's inputs: the serving path's fine tile, and a training step's fine
# level
ENCODE_SHAPES = {"serving": (CHUNK, 192, 0), "training": (TRAIN_RAYS, 192, TRAIN_SEC)}


def encode_bytes(k1, n, rays, n_sec, trunk=torch.bfloat16, head=torch.float32) -> int:
    """Bytes the encode must move for n points of `rays` rays: each point,
    each of its secondary directions and each ray's direction read once
    (f32), xe, ve and ve2 written once."""
    return 12 * (n * (1 + n_sec) + rays) + n * (k1.PTS_IN * trunk.itemsize + k1.VIEW_IN * (1 + n_sec) * head.itemsize)


def phase_encode(k1, dev):
    """The encode kernel in the shipped mode at `ENCODE_SHAPES`, with the
    directions per ray as the renderer gives them: bit for bit the torch
    chain's (`encode_reference`), timed beside the chain (the renderer's
    copy of each direction to its samples included) and against its bytes
    bound. Returns the timings keyed by shape."""
    g = torch.Generator(device=dev).manual_seed(3)
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    timings = {}
    for label, (rays, samples, n_sec) in ENCODE_SHAPES.items():
        n = rays * samples
        pts = torch.rand((n, 3), generator=g, device=dev) * 2 - 1
        vd = unit(torch.randn((rays, 3), generator=g, device=dev))
        vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=dev)) if n_sec else None
        got = k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True)
        want = k1.encode_reference(pts, vd, vd2, torch.bfloat16, f32_heads=True)
        for a, b, name in zip(got[:3], want[:3], ("xe", "ve", "ve2")):
            ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
            if not torch.equal(a.view(ints), b.view(ints)):
                raise AssertionError(f"the encode kernel's {name} differs from the torch chain's at the {label} shape: "
                                     f"max|diff| {(a.float() - b.float()).abs().max().item():.3g}")
        ms = cuda_ms(lambda: k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True), reps=20)
        plain_ms = cuda_ms(lambda: k1.encode_reference(pts, vd, vd2, torch.bfloat16, f32_heads=True), reps=5)
        nbytes = encode_bytes(k1, n, rays, n_sec)
        bound = 1e3 * nbytes / PEAK_BYTES
        log(f"K1 encode timing {label}: N={n} ({rays} rays x {samples} samples), n_sec={n_sec}, bf16_f32h: "
            f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} (the torch chain) bound_ms {bound:.4f} (bytes, "
            f"{nbytes / 1e6:.1f} MB) share of bound {bound / ms:.3f}, {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s; "
            f"bit for bit the chain's")
        timings[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", bytes=nbytes,
                              shape={"points": n, "rays": rays, "n_sec": n_sec})
    return timings


# ------------------------------------------------- K1's backward (shipped mode)

BWD = ("heads_bwd_points", "heads_bwd_weights")  # k1.BWD_KERNELS: the two kernels, as the kernels line names them
BWD_SCENES = (1, 2, 4)  # scenes per launch timed at the training shapes


def stacked_mlp(dev, scenes, seed=10):
    """A flagship MLP (stacked over `scenes`, different weights per scene)."""
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_mlp_config
    from vipnerf_tpu_torch.models.mlp import NeRFMLP

    cfg = flagship_mlp_config(0)
    if scenes == 1:
        return NeRFMLP(cfg, torch.Generator().manual_seed(seed)).to(dev)
    singles = [NeRFMLP(cfg, torch.Generator().manual_seed(seed + s)) for s in range(scenes)]
    stacked = NeRFMLP(cfg, scenes=scenes)
    with torch.no_grad():
        for name, p in stacked.named_parameters():
            p.copy_(torch.stack([dict(m.named_parameters())[name] for m in singles]))
    return stacked.to(dev)


def heads_inputs(k1, mlp, n, n_sec, g, dev):
    """The heads backward's inputs on n points: the heads' parameters, h
    from the trunk's recompute, f32 PE(dir), and an upstream gradient of
    raw's scale without ReLU ties (`untie_relu`)."""
    xe, ve, ve2, ns = k1_inputs(k1, n, n_sec, "fused_mlp_bf16_f32h", g, dev)
    params = [p.detach() for p in k1.module_params(mlp)]
    with torch.no_grad():
        h = k1.trunk_recompute(params[:2 * k1.FEATURE], xe).reshape(-1, k1.WIDTH).contiguous()
    up = torch.randn((n, k1.NOUT), generator=g, device=dev) * 1e-3
    up[:, 5 + ns:] = 0.0
    heads = params[2 * k1.FEATURE:]
    return heads, h, ve, ve2, untie_relu(k1, heads, h, ve, ve2, up, ns), ns


def to_f64(mid):
    return type(mid)(*(t.double() if t is not None and t.dtype == torch.float32 else t for t in mid))


def check_heads_backward(k1, weights, params, h, ve, ve2, up, ns, label):
    """The two kernels on one input: the per-point kernel against its plain
    version in f64 (`TOL_BWD_POINTS_*`), the weight kernel against its plain
    version in f64 on the per-point kernel's outputs (`TOL_BWD_WEIGHTS_*`),
    both end to end against the whole plain version in f64 (`TOL_BWD_*`),
    against the yardstick (`TOL_BWD_YARD_*`) and against the first design's
    kernels (`heads_backward_mma_sync`, `TOL_BWD_YARD_*`). Returns each
    kernel's max|err| against its plain version."""
    stacked = params[0].dim() == 3
    mid = k1.heads_bwd_points(weights, params, h, ve, ve2, up, ns)
    grads = k1.heads_bwd_weights(mid, h, ve, ve2, up, weights.scenes, stacked)
    torch.cuda.synchronize()
    p64 = [p.double() for p in params]
    want_mid = k1.heads_points_reference(p64, h, ve.double(), ve2.double(), up.double(), ns)
    points = points_errors(mid, want_mid)
    want_w = k1.heads_weights_reference(to_f64(mid), h, ve, ve2, up, weights.scenes, stacked)
    weights_err = weights_errors(grads, want_w)
    got = (mid.d_h, grads, mid.d_ve, mid.d_ve2)
    full = k1.heads_weights_reference(want_mid, h, ve, ve2, up, weights.scenes, stacked)
    e2e = bwd_errors(got, (want_mid.d_h, full, want_mid.d_ve, want_mid.d_ve2))
    yard = bwd_errors(got, k1.heads_backward_recompute(params, h, ve, ve2, up, ns))
    got_first = k1.heads_backward_mma_sync(weights, params, h, ve, ve2, up, ns)
    first = bwd_errors(got, got_first)
    finite = all(bool(torch.isfinite(t).all()) for t in [mid.d_h.float(), *grads, mid.d_ve]
                 + ([mid.d_ve2] if ns else []))
    fmt = lambda d: ", ".join(f"{k} {v[0]:.3g}/{v[1]:.3g}" if isinstance(v, tuple) else f"{k} {v:.3g}"  # noqa: E731
                              for k, v in d.items())
    log(f"K1 backward (bf16_f32h heads), {label}: per-point kernel vs f64 (max/rms) {fmt(points)}; weight kernel "
        f"vs f64 on its inputs {fmt(weights_err)}; end to end vs f64 max {e2e['max']:.3g} (tol {TOL_BWD_MAX:.3g}), "
        f"rms {e2e['rms']:.3g} (tol {TOL_BWD_RMS:.3g}), d h off {e2e['dh_off']:.3g} (tol {TOL_BWD_DH_FRAC:.3g}); "
        f"vs the yardstick max {yard['max']:.3g} (tol {TOL_BWD_YARD_MAX:.3g}), rms {yard['rms']:.3g} "
        f"(tol {TOL_BWD_YARD_RMS:.3g}), d h off {yard['dh_off']:.3g} (tol {TOL_BWD_YARD_DH_FRAC:.3g}); vs the first "
        f"design's kernels (mma.sync) max {first['max']:.3g}, rms {first['rms']:.3g}, d h off {first['dh_off']:.3g}; "
        f"finite {finite}")
    if not (finite and points_ok(points) and weights_ok(weights_err) and e2e["max"] <= TOL_BWD_MAX
            and e2e["rms"] <= TOL_BWD_RMS and e2e["dh_off"] <= TOL_BWD_DH_FRAC
            and all(y["max"] <= TOL_BWD_YARD_MAX and y["rms"] <= TOL_BWD_YARD_RMS
                    and y["dh_off"] <= TOL_BWD_YARD_DH_FRAC for y in (yard, first))):
        raise AssertionError(f"K1's heads backward disagrees with its plain version or its yardstick: {label}")
    err_points = max((getattr(mid, f).double() - getattr(want_mid, f)).abs().max().item()
                     for f in POINT_FIELDS if getattr(want_mid, f) is not None)
    err_weights = max((a.double() - b).abs().max().item() for a, b in zip(grads, want_w))
    # the first design's, end to end (its gradients and d PE(dir) against f64)
    err_first = max((a.double() - b).abs().max().item() for a, b in zip(
        [*got_first[1], got_first[2], got_first[3]], [*full, want_mid.d_ve, want_mid.d_ve2]) if b is not None)
    return {"heads_bwd_points": err_points, "heads_bwd_weights": err_weights, "mma_sync": err_first}


def heads_bound_parts(k1, n, n_sec, scenes=1):
    """Least times (ms) of each heads-backward kernel on n points: its bf16
    products (`k1.BWD_*_MACS`) at the bf16 tensor-core peak, and its bytes
    (`k1.bwd_bytes`) at the memory rate."""
    ops = {"heads_bwd_points": n * (k1.BWD_POINT_MACS + (1 + n_sec) * k1.BWD_POINT_MACS_PER_VIEW),
           "heads_bwd_weights": n * (k1.BWD_WEIGHT_MACS + (1 + n_sec) * k1.BWD_WEIGHT_MACS_PER_VIEW)}
    nbytes = dict(zip(BWD, k1.bwd_bytes(n, n_sec, scenes)))
    return {k: {"ops": 2e3 * ops[k] / PEAK_BF16_FLOPS, "bytes": 1e3 * nbytes[k] / PEAK_BYTES} for k in BWD}


def library_heads_routes(k1, params, h, ve, ve2, up, ns, mid, scenes):
    """Each heads-backward kernel's function as f32 `torch.matmul` calls
    (TF32 off), on the same inputs and the per-point kernel's outputs, every
    operand laid out beforehand: the per-point kernel's products (h W8^T,
    feature W10f^T, per view PE(dir) W10p^T and d o W11, D W10f, d feature
    W8, d sigma W9; one batched call per product over the scene axis; its
    elementwise steps are not in it), the weight kernel's five X^T Y
    products and its column sums (one call per product and scene: batched
    over the scenes, these long reductions with small outputs run far
    slower). The port never calls them."""
    sc = lambda t: t.reshape(scenes, -1, t.shape[-1])  # noqa: E731
    w8, w9, w10, w11 = (params[i].reshape(scenes, *params[i].shape[-2:]) for i in (0, 2, 4, 6))
    w8t, w10f = w8.transpose(1, 2).contiguous(), w10[..., :256].contiguous()
    w10ft, w10pt = w10f.transpose(1, 2).contiguous(), w10[..., 256:].transpose(1, 2).contiguous()
    h32, feature, D, dfeat = sc(h.float()), sc(mid.feature), sc(mid.D), sc(mid.d_feature)
    dsig = sc(up[:, :1].contiguous())
    pe_rows, do_rows = k1._view_rows(ve, ve2, up, ns)
    pe_flat, do_flat = sc(pe_rows.contiguous()), sc(do_rows.contiguous())
    pe_v = [sc(t.contiguous()) for t in pe_rows.reshape(-1, 1 + ns, 27).unbind(1)]
    do_v = [sc(t.contiguous()) for t in do_rows.reshape(-1, 1 + ns, 4).unbind(1)]
    hv_flat, dhv_flat = sc(mid.hv.reshape(-1, 128)), sc(mid.d_hv.reshape(-1, 128))
    dfeat_t, dsig_t, D_t = dfeat.transpose(1, 2), dsig.transpose(1, 2), D.transpose(1, 2)
    dhv_t, do_t = dhv_flat.transpose(1, 2), do_flat.transpose(1, 2)
    mm = torch.matmul

    def points():
        mm(h32, w8t), mm(feature, w10ft)
        for pe, d_o in zip(pe_v, do_v):
            mm(pe, w10pt), mm(d_o, w11)
        mm(D, w10f), mm(dfeat, w8), mm(dsig, w9)

    def weights():
        for s in range(scenes):
            mm(dfeat_t[s], h32[s]), mm(dsig_t[s], h32[s]), mm(D_t[s], feature[s]), mm(dhv_t[s], pe_flat[s])
            mm(do_t[s], hv_flat[s])
            dfeat[s].sum(0), dsig[s].sum(0), D[s].sum(0), do_flat[s].sum(0)

    return {"heads_bwd_points": points, "heads_bwd_weights": weights}


def time_heads_backward(k1, weights, params, h, ve, ve2, up, ns, label):
    """CUDA-event times of each kernel (the wrapper's call) against the
    first design's kernel in turns (first design, new, new, first design),
    of its plain version in f32, of its library route
    (`library_heads_routes`) and of the yardstick on the same inputs, with
    the kernels' bounds and their L2 bytes by design."""
    stacked = params[0].dim() == 3
    scenes, n = weights.scenes, h.shape[0]
    mid = k1.heads_bwd_points(weights, params, h, ve, ve2, up, ns, False, False)
    run = {"heads_bwd_points": lambda: k1.heads_bwd_points(weights, params, h, ve, ve2, up, ns, False, False),
           "heads_bwd_weights": lambda: k1.heads_bwd_weights(mid, h, ve, ve2, up, scenes, stacked)}
    first = {"heads_bwd_points": lambda: k1.heads_bwd_points_mma_sync(weights, h, ve, ve2, up, ns, False, False),
             "heads_bwd_weights": lambda: k1.heads_bwd_weights_mma_sync(mid, h, ve, ve2, up, scenes, stacked)}
    plain = {"heads_bwd_points": lambda: k1.heads_points_reference(params, h, ve, ve2, up, ns),
             "heads_bwd_weights": lambda: k1.heads_weights_reference(mid, h, ve, ve2, up, scenes, stacked)}
    library = library_heads_routes(k1, params, h, ve, ve2, up, ns, mid, scenes)
    out = {}
    bounds = heads_bound_parts(k1, n, ns, scenes)
    for name in BWD:
        turns = [cuda_ms(f, reps=5) for f in (first[name], run[name], run[name], first[name])]
        parts = bounds[name]
        out[name] = dict(ms=(turns[1] + turns[2]) / 2, mma_sync_ms=(turns[0] + turns[3]) / 2, turns_ms=turns,
                         plain_ms=cuda_ms(plain[name], reps=3), library_ms=cuda_ms(library[name], reps=5),
                         bound_ms=max(parts.values()), bound_by=max(parts, key=parts.get), bound_parts_ms=parts,
                         l2_bytes_by_design=k1.bwd_stream_bytes(name, n, ns, scenes),
                         mma_sync_l2_bytes_by_design=k1.bwd_stream_bytes(name + "_mma_sync", n, ns, scenes))
    yard_ms = cuda_ms(lambda: k1.heads_backward_recompute(params, h, ve, ve2, up, ns), reps=3)
    total = sum(out[k]["ms"] for k in BWD)
    for name in BWD:
        o = out[name]
        log(f"K1 backward timing, {label}, {name}: {o['ms']:.4f} ms (turns, first design / new / new / first "
            f"design: {' / '.join(f'{t:.4f}' for t in o['turns_ms'])}), share of bound {o['bound_ms'] / o['ms']:.3f}"
            f"; the first design (mma.sync) {o['mma_sync_ms']:.4f}, plain {o['plain_ms']:.4f}, library "
            f"{o['library_ms']:.4f}; bound {o['bound_ms']:.4f} by {o['bound_by']} (operations "
            f"{o['bound_parts_ms']['ops']:.4f}, bytes {o['bound_parts_ms']['bytes']:.4f}); L2 bytes by design "
            f"{o['l2_bytes_by_design']} ({o['l2_bytes_by_design'] / n:.0f} per point; the first design's "
            f"{o['mma_sync_l2_bytes_by_design'] / n:.0f})")
    log(f"K1 backward timing, {label}: both {total:.4f} ms (the first design's "
        f"{sum(out[k]['mma_sync_ms'] for k in BWD):.4f}) against the yardstick (autograd through raw_recompute's "
        f"f32 heads, cuBLAS) {yard_ms:.4f} ms")
    return {**out, "yardstick_ms": yard_ms, "both_ms": total}


def check_reproducible(k1, weights, params, h, ve, ve2, up, ns, label):
    """Two launches of each kernel on the same inputs: every output bit for
    bit the same (no float atomics, a fixed reduction order)."""
    stacked = params[0].dim() == 3
    mids = [k1.heads_bwd_points(weights, params, h, ve, ve2, up, ns) for _ in range(2)]
    grads = [k1.heads_bwd_weights(mids[0], h, ve, ve2, up, weights.scenes, stacked) for _ in range(2)]
    torch.cuda.synchronize()
    same_points = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*mids))
    same_weights = all(torch.equal(a, b) for a, b in zip(*grads))
    log(f"K1 backward, {label}: two launches bit for bit the same: per-point kernel {same_points}, weight kernel "
        f"{same_weights}")
    if not (same_points and same_weights):
        raise AssertionError(f"the heads backward's kernels are not reproducible: {label}")


def exact_case_on_card(k1, case, scenes, dev):
    """`exact_heads_case` through the kernels and the plain version in f32
    on the card: every output bit for bit."""
    params, h, ve, ve2, up, ns = exact_heads_case(case, 200, scenes)
    params = [p.to(dev) for p in params]
    h, ve, ve2, up = (t.to(dev) for t in (h, ve, ve2, up))
    mlp = stacked_mlp(dev, scenes)
    with torch.no_grad():
        for p, q in zip(k1.module_params(mlp)[2 * k1.FEATURE:], params):
            p.copy_(q)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    got = k1.heads_backward(weights, params, h, ve, ve2, up, ns)
    ref = k1.heads_backward_reference(params, h, ve, ve2, up, ns)
    same = [torch.equal(a, b) for a, b in zip([got[0], *got[1], got[2], got[3]], [ref[0], *ref[1], ref[2], ref[3]])]
    log(f"K1 backward, exact-sum case {case!r}, S = {scenes}, 200 points per scene, n_sec {ns}: kernels bit for bit "
        f"the plain version in f32 (d h, 8 gradients, d ve, d ve2): {same}")
    if not all(same):
        raise AssertionError(f"the heads backward is not exact on the exact-sum case {case} (S = {scenes})")


def exact_forward_on_card(k1, dev):
    """K1's bf16_f32h forward on the witness case's heads, with the trunk's
    last layer zero and a one-hot bias (h = e_c for every point): each sum
    of the heads is exact, so the forward heads kernel equals the plain
    version's f32 products bit for bit, and W9's third parts reach the
    output (sigma)."""
    params, _, ve, ve2, _, ns = exact_heads_case("witness", 256, 1)
    mlp = stacked_mlp(dev, 1)
    with torch.no_grad():
        for p, q in zip(k1.module_params(mlp)[2 * k1.FEATURE:], params):
            p.copy_(q.to(dev))
        mlp.pts_linears[7].weight.zero_()
        mlp.pts_linears[7].bias.zero_()
        mlp.pts_linears[7].bias[37] = 1.0
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    g = torch.Generator(device=dev).manual_seed(3)
    xe = k1_inputs(k1, 256, ns, "fused_mlp_bf16_f32h", g, dev)[0]
    ve, ve2 = ve.to(dev), ve2.to(dev)
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns)
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    log(f"K1 forward bf16_f32h, exact-sum heads (one-hot h, 256 points, n_sec {ns}): bit for bit the plain "
        f"version's f32 products: {same}")
    if not same:
        raise AssertionError("the bf16_f32h forward heads are not exact on the exact-sum case")


def phase_heads_backward(k1, dev):
    """K1's backward in the shipped mode: the exact-sum cases bit for bit
    (and the forward heads on the witness case); the two kernels against
    their plain versions, the yardstick and the first design's kernels at
    the training step's two launch shapes for n_sec 0..3, at S = 2, and at
    ragged sizes; two launches bit for bit the same at the training fine
    shape (S = 1, 2); their times against the first design's in turns, the
    plain versions' and the library routes' at the training shapes at S =
    1, 2, 4. Returns the timings and each kernel's worst max|err|."""
    for case in ("dense", "witness"):
        for scenes in (1, 2):
            exact_case_on_card(k1, case, scenes, dev)
    exact_forward_on_card(k1, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    worst = dict.fromkeys(BWD + ("mma_sync",), 0.0)
    timings = {}
    cases = [(1, n, n_sec) for n in sorted(TRAIN_N.values()) for n_sec in range(4)]
    cases += [(1, n, n_sec) for n in RAGGED_N for n_sec in (0, 3)] + [(2, TRAIN_N["fine"], TRAIN_SEC),
                                                                       (2, 2048 + 37, 1)]
    for scenes, n, n_sec in cases:
        mlp = stacked_mlp(dev, scenes)
        weights = k1.prepare_weights(mlp, torch.bfloat16, True)
        inputs = heads_inputs(k1, mlp, scenes * n, n_sec, g, dev)
        errs = check_heads_backward(k1, weights, *inputs, f"S = {scenes} x {n} points, n_sec {n_sec}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
        if n == TRAIN_N["fine"] and n_sec == TRAIN_SEC:
            check_reproducible(k1, weights, *inputs, f"S = {scenes} x {n} points, n_sec {n_sec}")
        del inputs
    for scenes in BWD_SCENES:
        mlp = stacked_mlp(dev, scenes)
        weights = k1.prepare_weights(mlp, torch.bfloat16, True)
        for level, n in TRAIN_N.items():
            inputs = heads_inputs(k1, mlp, scenes * n, TRAIN_SEC, g, dev)
            timings[(scenes, level)] = time_heads_backward(k1, weights, *inputs,
                                                           f"S = {scenes} x {n} points ({level}), n_sec {TRAIN_SEC}")
            del inputs
    return {"timings": timings, "worst": worst}


def check_png(path: Path, shape=None):
    """A PNG of `shape` (H, W by default)."""
    want_h, want_w = shape or (H, W)
    blob = path.read_bytes()
    if blob[:8] != b"\x89PNG\r\n\x1a\n" or blob[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    w, h = int.from_bytes(blob[16:20], "big"), int.from_bytes(blob[20:24], "big")
    if (h, w) != (want_h, want_w):
        raise AssertionError(f"{path} is {w}x{h}, expected {want_w}x{want_h}")


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

        mark = tracing.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_dir = start_testing(test_configs, scenes_data, save_depth=True, save_visibility=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launches_since(k1, mark)
        encode_fed(k1, mark, "start_testing")

        tiles = math.ceil(H * W / CHUNK)
        expected = launch_counts(k1, fused_mlp_bf16=5 * 2 * tiles)
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
            k1_ms = tiles * sum(timings[("fused_mlp_bf16", n_sec, n)]["ms"] for n in TILE_N.values())
            log(f"predict_frame ({label}): {', '.join(f'{s:.4f}' for s in frame_s[label])} s per "
                f"{W}x{H} frame; K1 {k1_ms:.1f} ms of it ({tiles} tiles x the coarse and fine "
                f"launch times of phase 2)")

        modes = phase_modes(k1, root, model_configs, test_configs, poses[1], tiles)
        phase_crop(k1, tester, configs, poses)
        phase_profile(tester, poses[1], frame_s["held-out, n_sec 0"])
    return launches, seconds / 5, frame_s, modes


def phase_modes(k1, root, model_configs, test_configs, pose, tiles):
    """One warm held-out frame in each of `MODE_RUNS`, with each K1
    instance's launches counted over that frame alone: a mode runs through
    the instance the dispatch picks, 2 levels x `tiles` launches, or, under
    `module_mlp_path`, through the module MLP with none."""
    from vipnerf_tpu_torch.infer.tester import NerfTester
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp

    train_configs = json.loads((root / "runs/training/train0001/Configs.json").read_text())
    modes = {}
    for label, bf16, f32_heads, module in MODE_RUNS:
        cfg = copy.deepcopy(train_configs)
        cfg["model"].update(bf16_matmuls=bf16, f32_heads=f32_heads)
        tester = NerfTester(cfg, model_configs, test_configs, root)
        tester.load_model(root / "runs/training/train0001/rig/saved_models/Model_Latest.tar")
        with module_mlp_path() if module else contextlib.nullcontext():
            tester.predict_frame(pose)  # warm-up
            mark = tracing.counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = tester.predict_frame(pose)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        launches = launches_since(k1, mark)
        encode_fed(k1, mark, f"warm frame, {label}")
        path = "module MLP" if module else uses_fused_mlp(cfg["model"]["fine_mlp"], bf16, f32_heads)
        expected = launch_counts(k1, **{path: 2 * tiles})
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
# bf16_f32h: the bf16 trunk's steps, as in bf16.
TOL_GRAD_REL_MAX = {"fused_mlp_bf16": 0.1, "fused_mlp_f32": 1e-2, "fused_mlp_bf16_f32h": 0.1}  # max|dg| / max|g|
TOL_GRAD_REL_RMS = {"fused_mlp_bf16": 3e-2, "fused_mlp_f32": 1e-3, "fused_mlp_bf16_f32h": 3e-2}  # ||dg|| / ||g||
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


# K1 through a training trajectory at the flagship width: the bands of
# tests/test_torch_protocol.py's port-vs-JAX trajectory (TRAJ_TOL_FIRST for
# the shipped mode, TRAJ_TOL_STEP, TRAJ_TOL_PARAMS; a CPU test holds them
# equal)
TRAJ_STEPS = 100
TRAJ_LOSSES = ("MSE01", "VisibilityLoss01", "SparseDepthMSE01", "VisibilityPriorLoss01")
TRAJ_TOL_FIRST = 1e-4  # relative, the first step's loss terms
TRAJ_TOL_STEP = 5e-3  # relative, every later step's
TRAJ_TOL_PARAMS = 5e-2  # the final parameters' distance over the reference run's move from the start
TRAJ_PATHS = ("K1", "K1, yardstick backward", "module MLP")
# At the flagship width the shipped mode's training is chaotic: two
# computations of the same step that differ by f32 rounding (~1e-7) move a
# bf16 rounding of the trunk now and then, and Adam carries it on. The two
# routes from before the backward kernels (K1 with the yardstick backward,
# the module MLP) leave TRAJ_TOL_STEP against each other as K1 leaves it
# against either: on the card (`phase_trajectory` prints all three pairs)
# and on the CPU with no kernel anywhere
# (tests/test_torch_heads_backward.py::test_flagship_training_is_chaotic_without_any_kernel).
# So every step is printed against the bands, and the first TRAJ_BAND_STEPS
# steps are held to them.
TRAJ_BAND_STEPS = 20


@contextlib.contextmanager
def yardstick_backward(k1):
    """Within the block, K1's shipped-mode backward computes the heads'
    gradients with its yardstick (autograd through raw_recompute's f32
    heads, the route before the backward kernels) instead of the kernels."""
    kernels = k1.heads_backward
    k1.heads_backward = lambda weights, params, h, ve, ve2, g, n_sec, *need: \
        k1.heads_backward_recompute(params, h, ve, ve2, g, n_sec)
    try:
        yield
    finally:
        k1.heads_backward = kernels


def trajectory_compare(got, end_got, want, end_want, start):
    """The worst relative difference of the loss terms at the first step
    and after it, per term after it, and the final parameters' distance
    over the reference run's move."""
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    dist = math.sqrt(sum(float(((end_got[k] - end_want[k]).double() ** 2).sum()) for k in start))
    moved = math.sqrt(sum(float(((end_want[k] - start[k]).double() ** 2).sum()) for k in start))
    return {"first": float(rel[0].max()), "band": float(rel[1:TRAJ_BAND_STEPS + 1].max()),
            "later": float(rel[1:].max()),
            "later_by_term": dict(zip(TRAJ_LOSSES, (float(x) for x in rel[1:].max(0)))),
            "first_over_tol_step": int(np.argmax(rel.max(1) > TRAJ_TOL_STEP)) if (rel.max(1) > TRAJ_TOL_STEP).any()
            else None, "params": dist / moved}


def run_trajectories(k1, rig, paths=TRAJ_PATHS, steps: int = TRAJ_STEPS, start_it: int = 5000):
    """`steps` training steps in the shipped mode (bf16 trunk, f32 heads)
    along each of `paths` (of `TRAJ_PATHS`), perturbation and sigma noise
    off, from the same weights (the rig's, +0.5 on the sigma biases, so
    that depth, a ratio over the accumulated weight, is well conditioned
    from the start) on the same gathered batches. Returns the start's
    state and, per path, (the loss terms per step, the end state, K1's
    launch counts)."""
    from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step

    cfg = copy.deepcopy(rig.configs)
    cfg["model"].update(bf16_matmuls=True, f32_heads=True, perturb=False, raw_noise_std=0.0)
    batches = [rig.batch(start_it + it) for it in range(steps)]
    original = {k: v.detach().clone() for k, v in rig.model.state_dict().items()}
    with torch.no_grad():
        for mlp in rig.model.children():
            mlp.pts_output_linear.bias += SIGMA_OFFSET
    start = {k: v.detach().clone() for k, v in rig.model.state_dict().items()}
    runs = {}
    for path in paths:
        rig.model.load_state_dict(start)
        step = make_train_step(cfg, rig.render_rays, rig.loss_computer, make_optimizer(cfg, rig.model.parameters()))
        mark = tracing.counts()
        losses = []
        context = {"K1": contextlib.nullcontext(), "K1, yardstick backward": yardstick_backward(k1),
                   "module MLP": module_mlp_path()}[path]
        with context:
            for it, batch in enumerate(batches):
                rig.generator.manual_seed(it)
                scalars = step(rig.model, batch, rig.generator)
                losses.append([float(scalars[k]) for k in TRAJ_LOSSES])
        if rig.generator.device.type == "cuda":
            torch.cuda.synchronize()
        runs[path] = (np.asarray(losses), {k: v.detach().clone() for k, v in rig.model.state_dict().items()},
                      {"fused_mlp_bf16_f32h": launches_since(k1, mark)["fused_mlp_bf16_f32h"],
                       **launches_since(k1, mark, k1.BWD_KERNELS)})
    rig.model.load_state_dict(original)
    return start, runs


def phase_trajectory(k1, rig, steps: int = TRAJ_STEPS):
    """`run_trajectories` on the card through K1 (its forward and its
    backward kernels), through K1 with the yardstick backward (the same
    forward; the heads' gradient by autograd through raw_recompute's f32
    heads, as before the kernels), and through the module MLP. Each pair is
    compared; K1 against each of the others, and the two routes from before
    the kernels against each other: the loss terms of the first step within
    `TRAJ_TOL_FIRST`, of the next `TRAJ_BAND_STEPS` within `TRAJ_TOL_STEP`;
    every step and the final parameters are printed against the bands (see
    `TRAJ_BAND_STEPS`). Returns the comparisons and K1's launches."""
    t0 = time.perf_counter()
    start, runs = run_trajectories(k1, rig, TRAJ_PATHS, steps)
    seconds = time.perf_counter() - t0
    (got, end_k1, launches), (old, end_old, old_launches), (mod, end_mod, mod_launches) = (
        runs[p] for p in TRAJ_PATHS)
    pairs = {"K1 vs K1 with the yardstick backward": trajectory_compare(got, end_k1, old, end_old, start),
             "K1 vs the module MLP": trajectory_compare(got, end_k1, mod, end_mod, start),
             "K1 with the yardstick backward vs the module MLP (both from before the kernels)":
                 trajectory_compare(old, end_old, mod, end_mod, start)}
    for label, c in pairs.items():
        log(f"K1 trajectory, shipped mode at the flagship width, {steps} steps of {TRAIN_RAYS} rays (perturbation "
            f"and sigma noise off, {SIGMA_OFFSET} on the sigma biases), {label}, from the same weights and "
            f"batches: the loss terms' worst relative difference at the first step {c['first']:.3g} (tol "
            f"{TRAJ_TOL_FIRST}), steps 2-{TRAJ_BAND_STEPS + 1} {c['band']:.3g} (tol {TRAJ_TOL_STEP}); every step "
            f"{c['later']:.3g} (band {TRAJ_TOL_STEP}, left at step {c['first_over_tol_step']}; by term "
            f"{json.dumps(c['later_by_term'])}), the parameters' distance over the second run's move "
            f"{c['params']:.3g} (band {TRAJ_TOL_PARAMS})")
    log(f"K1 trajectory: launches through K1 {launches}, with the yardstick backward {old_launches}, the module "
        f"run {mod_launches}; {seconds:.1f} s")
    if not (all(c["first"] <= TRAJ_TOL_FIRST and c["band"] <= TRAJ_TOL_STEP for c in pairs.values())
            and launches == {"fused_mlp_bf16_f32h": 2 * steps, **dict.fromkeys(BWD, 2 * steps)}
            and old_launches == {"fused_mlp_bf16_f32h": 2 * steps, **dict.fromkeys(BWD, 0)}
            and not any(mod_launches.values()) and np.isfinite(got).all()):
        raise AssertionError("K1's training trajectory leaves its bands")
    vs_old, vs_mod, old_vs_mod = pairs.values()
    return {"vs_yardstick_backward": vs_old, "vs_module_mlp": vs_mod,
            "yardstick_backward_vs_module_mlp": old_vs_mod, "launches": launches, "seconds": seconds}


def phase_grad_check(k1, rig):
    """One gathered batch, one generator state: the parameters' gradients of
    a training render through K1 against the same render through the module
    MLP, on the card, for each instance: bf16 (bf16 heads), f32 and
    bf16_f32h (the shipped mode, f32 heads)."""
    batch = rig.batch(0)
    worst = {}
    for name, (dtype, f32_heads) in K1_MODES.items():
        cfg = copy.deepcopy(rig.configs)
        cfg["model"].update(bf16_matmuls=dtype == torch.bfloat16, f32_heads=f32_heads, raw_noise_std=0.0)
        mark = tracing.counts()
        g_k1 = rig.grads(cfg, batch, seed=7)
        launches = launches_since(k1, mark)[name]
        with module_mlp_path():
            g_mod = rig.grads(cfg, batch, seed=7)
        rel_max = rel_rms = 0.0
        for tensor, g in g_mod.items():
            d = g_k1[tensor] - g
            rel_max = max(rel_max, (d.abs().max() / g.abs().max().clamp_min(1e-30)).item())
            rel_rms = max(rel_rms, (d.norm() / g.norm().clamp_min(1e-30)).item())
        log(f"K1 gradients, {name} vs the module MLP, one batch of {TRAIN_RAYS} rays, "
            f"{len(g_mod)} parameter tensors: worst max|dg|/max|g| {rel_max:.3g} "
            f"(tol {TOL_GRAD_REL_MAX[name]}), worst ||dg||/||g|| {rel_rms:.3g} "
            f"(tol {TOL_GRAD_REL_RMS[name]}); {name} launches in the K1 render {launches}")
        if launches != 2 or rel_max > TOL_GRAD_REL_MAX[name] or rel_rms > TOL_GRAD_REL_RMS[name]:
            raise AssertionError(f"K1's gradients disagree with the module MLP's ({name})")
        worst[name] = (rel_max, rel_rms)
    return worst


def phase_training_run(k1, root, configs, gt, tiles):
    """start_training for TRAIN_STEPS steps (checkpoint at half, validation
    at the end), then again to TRAIN_STEPS + RESUME_STEPS, which must resume;
    checks the logs, checkpoints, K1 launches and the trained model's PSNR
    on the held-out test frame against the untrained model's."""
    from vipnerf_tpu_torch.infer.tester import NerfTester, start_testing
    from vipnerf_tpu_torch.protocol.common import read_scalars
    from vipnerf_tpu_torch.train.trainer import start_training

    n = TRAIN_STEPS
    cfg = copy.deepcopy(configs)
    cfg.update(num_iterations=n, model_save_interval=n // 2, validation_interval=n)
    mark = tracing.counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start_training(cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_run = launches_since(k1, mark)
    encode_fed(k1, mark, "start_training")
    val_frames = 3 + 1  # train frames (n_sec 2) + the validation frame
    expected = launch_counts(k1, fused_mlp_bf16=2 * n + 2 * tiles * val_frames)
    log(f"start_training: {n} steps and one validation of {val_frames} frames in {run_s:.2f} s; "
        f"K1 launches {launches_run} (expected {expected}: 2 per step, 2 levels x {tiles} tiles "
        f"per validation frame)")
    if launches_run != expected:
        raise AssertionError(f"training launched K1 {launches_run}, expected {expected}")

    mark = tracing.counts()
    cfg.update(num_iterations=n + RESUME_STEPS)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        start_training(cfg)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    text = out.getvalue()
    sys.stdout.write(text)
    launches_resume = launches_since(k1, mark)
    encode_fed(k1, mark, "start_training, resumed")
    if f"Resuming Training from iteration {n + 1}" not in text:
        raise AssertionError(f"the second start_training did not resume at {n}")
    if launches_resume != launch_counts(k1, fused_mlp_bf16=2 * RESUME_STEPS):
        raise AssertionError(f"the resumed run launched K1 {launches_resume}")
    log(f"resumed at {n} and trained to {n + RESUME_STEPS} in {resume_s:.2f} s; K1 launches {launches_resume}")

    scene_dir = root / "runs/training/train0001/synth01"
    saved = scene_dir / "saved_models"
    for it in (n // 2, n, n + RESUME_STEPS):
        if not (saved / f"Model_Iter{it:06}.tar").exists():
            raise AssertionError(f"checkpoint of iteration {it} missing")
    if os.readlink(saved / "Model_Latest.tar") != f"Model_Iter{n + RESUME_STEPS:06}.tar":
        raise AssertionError("Model_Latest.tar does not point at the last checkpoint")
    series = read_scalars(scene_dir / "logs/scalars.jsonl")
    total = [v for _, v in sorted(series["train/TotalLoss"].items())]
    finite = all(np.isfinite(v) for tag, pts in series.items() if tag.startswith("train/") for v in pts.values())
    first, last = float(np.mean(total[:20])), float(np.mean(total[-20:]))
    losses = {tag[6:]: [round(v, 5) for _, v in sorted(p.items())][::40] for tag, p in series.items()
              if tag.startswith("train/") and tag != "train/lr"}
    log(f"train losses every 40 steps: {json.dumps(losses)}")
    log(f"validation at {n}: " + json.dumps({t: round(p[min(p)], 5) for t, p in series.items()
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


def phase_step_profile(rig, configs, warm_ms):
    """torch.profiler over one training step in `configs`' precision mode,
    split at synchronised boundaries into forward (gather, render, losses),
    backward and Adam."""
    from vipnerf_tpu_torch.train.step import make_optimizer

    optimizer = make_optimizer(configs, rig.model.parameters())
    batch = rig.batch(1000)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for phase in ("forward", "backward", "adam"):
            with torch.profiler.record_function(f"step/{phase}"):
                if phase == "forward":
                    optimizer.zero_grad()
                    rig.generator.manual_seed(3)
                    out = rig.render_rays(rig.model, configs, batch, train=True, generator=rig.generator)
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
    out = {phase: sum(t for _, t in rows.values()) for phase, rows in split.items()}
    if configs["model"]["bf16_matmuls"] and configs["model"]["f32_heads"]:
        # the shipped mode's backward: K1's two backward kernels, and no f32
        # matrix product (every GEMM left is the bf16 trunk's)
        backward = split["backward"]
        kernels = {k: sum(t for name, (_, t) in backward.items() if f"{k}_kernel" in name) for k in BWD}
        counts = {k: sum(c for name, (c, _) in backward.items() if f"{k}_kernel" in name) for k in BWD}
        # cuBLAS names its products *gemm* (sgemm, xmma_gemm_f32f32: f32;
        # the dtype in the name otherwise) or nvjet_<a><b><c>_* (cuBLASLt on
        # Hopper: s for f32 operands, t for bf16)
        gemms = {name: t for name, (_, t) in backward.items()
                 if "gemm" in name.lower() or name.startswith("nvjet_")}
        f32_gemms = [name for name in gemms if name.startswith("nvjet_s")
                     or ("gemm" in name.lower() and "bf16" not in name.lower())]
        log(f"training step profile, backward: K1's backward kernels {kernels} ms ({counts} launches); "
            f"matrix products {len(gemms)} kinds, {sum(gemms.values()):.2f} ms, none of them f32: {not f32_gemms}")
        if not all(counts.values()) or f32_gemms:
            raise AssertionError(f"the shipped step's backward ran {counts} of K1's backward kernels and f32 "
                                 f"products {f32_gemms}")
        out["k1_backward_ms"] = kernels
    return out


def phase_train(k1, dev, timings):
    """The training slice at the flagship width: a synthetic LLFF scene at
    1008x756, K1's gradient check, start_training with a resume (bf16
    heads), the warm step time and the step profile in the shipped mode
    (bf16 with f32 heads, through bf16_f32h) and a step in each of
    `MODE_RUNS`."""
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
        trajectory = phase_trajectory(k1, rig)
        run = phase_training_run(k1, root, configs, gt, tiles)

        step = rig.step_fn(bf16=True, f32_heads=True)
        torch.cuda.reset_peak_memory_stats()
        mark = tracing.counts()
        seconds = timed_steps(step, rig, 2000, TIMED_STEPS)
        launches = launches_since(k1, mark)["fused_mlp_bf16_f32h"]
        peak = torch.cuda.max_memory_allocated()
        med_ms = 1e3 * float(np.median(seconds))
        k1_ms = sum(timings[("fused_mlp_bf16_f32h", TRAIN_SEC, n)]["ms"] for n in TRAIN_N.values())
        log(f"warm training step (shipped mode: bf16, f32 heads, K1 fused_mlp_bf16_f32h): median {med_ms:.2f} ms "
            f"over {TIMED_STEPS} steps (min {1e3 * min(seconds):.2f}, max {1e3 * max(seconds):.2f}), "
            f"{TRAIN_RAYS / (med_ms / 1e3):,.0f} rays/s; K1 forward {k1_ms:.3f} ms of it "
            f"({k1_ms / med_ms:.3f}, CUDA-event times at N {TRAIN_N['coarse']} and "
            f"{TRAIN_N['fine']}, n_sec {TRAIN_SEC}); K1 launches {launches} in {TIMED_STEPS + 3} "
            f"steps; peak memory {peak / 2**30:.2f} GiB")
        if launches != 2 * (TIMED_STEPS + 3):
            raise AssertionError(f"K1 ran {launches} times in {TIMED_STEPS + 3} steps")
        shipped = copy.deepcopy(rig.configs)
        shipped["model"].update(bf16_matmuls=True, f32_heads=True)
        profile = phase_step_profile(rig, shipped, med_ms)

        modes = {}
        for label, bf16, f32_heads, module in MODE_RUNS:
            step = rig.step_fn(bf16, f32_heads)
            mark = tracing.counts()
            with module_mlp_path() if module else contextlib.nullcontext():
                secs = timed_steps(step, rig, 3000, 5, warmup=2)
            launches_m = launches_since(k1, mark)
            path = "module MLP" if module else uses_fused_mlp(rig.configs["model"]["fine_mlp"], bf16, f32_heads)
            expected = launch_counts(k1, **{path: 2 * 7})
            ms = 1e3 * float(np.median(secs))
            log(f"warm training step, {label}: median {ms:.2f} ms over 5 steps through the {path}; "
                f"K1 launches {launches_m} in 7 steps (expected {expected})")
            if launches_m != expected:
                raise AssertionError(f"precision mode {label}: K1 launches {launches_m}")
            modes[label] = {"ms": ms, "path": path, "launches": launches_m}
    return {"run": run, "step_ms": med_ms, "step_ms_all": [1e3 * s for s in seconds],
            "rays_per_s": TRAIN_RAYS / (med_ms / 1e3), "k1_ms": k1_ms, "peak_bytes": peak,
            "profile_ms": profile, "modes": modes, "grad_check": grads, "trajectory": trajectory}


# --------------------------------------------------- batched multi-scene training

MS_SCENES = ["synth01", "synth02"]
MS_STEPS = 100  # the app's first run; the resume adds MS_RESUME_STEPS
MS_RESUME_STEPS = 10
MS_TIMED_STEPS = 15
MS_SIZES = (1, 2, 4)  # scenes per step timed, from the seed's weights; 4 takes each scene twice


def library_raw_batched(layers, xe, ve, ve2, n_sec):
    """Yardstick for the scene-batched K1: `library_raw` with one
    `torch.baddbmm` over the scene axis per layer, in its layer's dtype."""
    s = layers[0][0].shape[0]
    xe, ve, ve2 = (t.reshape(s, -1, t.shape[-1]) for t in (xe, ve, ve2))
    w = [ww.transpose(1, 2) for ww, _ in layers]
    b = [bb.to(ww.dtype)[:, None] for ww, bb in layers]
    relu = torch.relu

    def lin(x, i):
        return torch.baddbmm(b[i], x, w[i])

    h = relu(lin(xe, 0))
    for i in (1, 2, 3, 4):
        h = relu(lin(h, i))
    h = relu(lin(torch.cat([xe, h], -1), 5))
    for i in (6, 7):
        h = relu(lin(h, i))
    h = h.to(ve.dtype)
    feature = lin(h, 8)
    out = [lin(h, 9)[..., :1], lin(relu(lin(torch.cat([feature, ve], -1), 10)), 11)[..., :4]]
    for j in range(n_sec):
        out.append(lin(relu(lin(torch.cat([feature, ve2[..., 32 * j:32 * j + 32]], -1), 10)), 11)[..., 3:4])
    return torch.cat(out, -1)


def phase_k1_scenes(k1, dev, scenes):
    """The scene-batched K1, every instance, at the training step's two
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
    for name, (dtype, f32_heads) in K1_MODES.items():
        weights = k1.prepare_weights(stacked, dtype, f32_heads)
        single_w = [k1.prepare_weights(m, dtype, f32_heads) for m in singles]
        worst[name] = 0.0
        for level, n in TRAIN_N.items():
            xe, ve, ve2, ns = k1_inputs(k1, scenes * n, TRAIN_SEC, name, g, dev)
            mark = tracing.counts()
            raw = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
            torch.cuda.synchronize()
            taken = sum(launches_since(k1, mark).values())
            if taken != 1:
                raise AssertionError(f"the scene-batched K1 took {taken} launches")
            ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
            err = (raw.float() - ref).abs().max().item()
            rel_max = err / max(ref.abs().max().item(), 1e-30)
            rel_rms = ((raw.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()
            rows = [slice(s * n, (s + 1) * n) for s in range(scenes)]
            parts = [(xe[r].contiguous(), ve[r].contiguous(), ve2[r].contiguous()) for r in rows]
            same = all(torch.equal(raw[r], k1.fused_mlp_raw(single_w[s], *parts[s], ns))
                       for s, r in enumerate(rows))
            log(f"K1 {name}, {scenes} scenes x {n} points ({level}, n_sec {ns}), one launch: max|err| {err:.3g}, "
                f"max|err|/max|plain| {rel_max:.3g} (tol {TOL_REL_MAX[name]:.3g}), rms rel {rel_rms:.3g} "
                f"(tol {TOL_REL_RMS[name]:.3g}); bit-identical to {scenes} single-scene launches: {same}")
            if not (same and rel_max <= TOL_REL_MAX[name] and rel_rms <= TOL_REL_RMS[name]):
                raise AssertionError(f"the scene-batched K1 disagrees ({name}, {level})")
            worst[name] = max(worst[name], err)
            if f32_heads:
                check_against_ffma(k1, weights, k1.ffma_heads(weights), raw, xe, ve, ve2, ns,
                                   f"{scenes} scenes x {n} points ({level}, n_sec {ns}), one launch each")
            ms = cuda_ms(lambda: k1.fused_mlp_raw(weights, xe, ve, ve2, ns))
            singles_ms = cuda_ms(lambda: [k1.fused_mlp_raw(single_w[s], *parts[s], ns) for s in range(scenes)])
            plain_ms = cuda_ms(lambda: k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns), reps=3)
            lib_ms = cuda_ms(lambda: library_raw_batched(weights.layers, xe, ve, ve2, ns), reps=5)
            bound, bound_by = k1_bound_ms(k1, scenes * n, ns, name, scenes)
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

    nerf, sd = (None if r is None else torch.from_numpy(r).to(trainer.device) for r in trainer._index_rows(0, 1))
    prep0 = trainer.preprocessors[0]
    batch = prep0.gather_batch(nerf[:, 0], sd[:, 0], 0, cache=trainer.cache, near=trainer.near, far=trainer.far)
    rps = trainer.rays_per_scene
    local = [p.gather_batch(nerf[i, 0] - i * rps, sd[i, 0] - i * rps, 0) for i, p in enumerate(trainer.preprocessors)]
    scenes = len(trainer.scene_ids)
    worst = {}
    for name, (dtype, f32_heads) in K1_MODES.items():
        cfg = copy.deepcopy(trainer.configs)
        cfg["model"].update(bf16_matmuls=dtype == torch.bfloat16, f32_heads=f32_heads, perturb=False,
                            raw_noise_std=0.0)
        losses = LossComputer(cfg)
        trainer.model.zero_grad(set_to_none=True)
        mark = tracing.counts()
        total = losses.scene_losses(batch, render_rays(trainer.model, cfg, batch, train=True), scenes)["TotalLoss"]
        total.sum().backward()
        launches = launches_since(k1, mark)[name]
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
        log(f"batched step gradients, {name}, {scenes} scenes x {TRAIN_RAYS} rays vs each scene's own "
            f"step, over all of a scene's parameters: worst max|dg|/max|g| {rel_max:.3g} (tol "
            f"{TOL_GRAD_REL_MAX[name]}), worst ||dg||/||g|| {rel_rms:.3g} (tol {TOL_GRAD_REL_RMS[name]}); worst "
            f"tensor {worst_tensor[1]} at ||dg||/||g|| {worst_tensor[0]:.3g}; {name} launches in the batched "
            f"render {launches}")
        if launches != 2 or rel_max > TOL_GRAD_REL_MAX[name] or rel_rms > TOL_GRAD_REL_RMS[name]:
            raise AssertionError(f"the batched step's gradients disagree with single-scene steps ({name})")
        worst[name] = {"rel_max": rel_max, "rel_rms": rel_rms, "worst_tensor": worst_tensor}
    trainer.model.zero_grad(set_to_none=True)
    return worst


def ms_timed_steps(k1, trainer, steps, start_it=0, warmup=3):
    """Host-clock seconds of `steps` warm batched steps (gather included),
    one synchronise per step, and K1's launches over all of them."""
    nerf, sd = (None if r is None else torch.from_numpy(r).to(trainer.device)
                for r in trainer._index_rows(start_it, warmup + steps))
    prep0 = trainer.preprocessors[0]

    def step(j):
        batch = prep0.gather_batch(nerf[:, j], None if sd is None else sd[:, j], start_it + j,
                                   cache=trainer.cache, near=trainer.near, far=trainer.far)
        trainer.generator.manual_seed(start_it + j)
        return trainer.train_step(trainer.model, batch, trainer.generator)

    mark = tracing.counts()
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
    return seconds, sum(launches_since(k1, mark).values())


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
    nerf, sd = (None if r is None else torch.from_numpy(r).to(trainer.device) for r in trainer._index_rows(5000, 1))
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
    from vipnerf_tpu_torch.protocol.common import read_scalars
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

        mark = tracing.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.start_training(copy.deepcopy(configs))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches_run = launches_since(k1, mark)
        val_frames = 3 + 1
        expected = launch_counts(k1, fused_mlp_bf16=2 * MS_STEPS + 2 * tiles * val_frames * len(MS_SCENES))
        log(f"app start_training, batch_scenes, {len(MS_SCENES)} scenes: {MS_STEPS} steps and one validation of "
            f"{val_frames} frames per scene in {run_s:.2f} s; K1 launches {launches_run} (expected {expected}: 2 per "
            f"step for all scenes, 2 levels x {tiles} tiles per validation frame and scene)")
        if launches_run != expected:
            raise AssertionError(f"batched training launched K1 {launches_run}, expected {expected}")

        mark = tracing.counts()
        configs["num_iterations"] = MS_STEPS + MS_RESUME_STEPS
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            app.start_training(copy.deepcopy(configs))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        sys.stdout.write(out.getvalue())
        launches_resume = launches_since(k1, mark)
        if f"Resuming multi-scene training from iteration {MS_STEPS + 1}" not in out.getvalue():
            raise AssertionError(f"the second batched run did not resume at {MS_STEPS}")
        if launches_resume != launch_counts(k1, fused_mlp_bf16=2 * MS_RESUME_STEPS):
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
            total = [v for _, v in sorted(read_scalars(run / name / "logs/scalars.jsonl")["train/TotalLoss"].items())]
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
                    mark = tracing.counts()
                    secs, _ = ms_timed_steps(k1, trainer, 5, start_it=1000, warmup=2)
                    launches_m = launches_since(k1, mark)
                    path = uses_fused_mlp(cfg["model"]["fine_mlp"], bf16, f32_heads) or "module MLP"
                    expected = launch_counts(k1, **{path: 2 * 7})
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


def check_prior_outputs(out_dir: Path, pairs, scene: str = "synth01", shape=None):
    """Both directions of each pair: weights .npy + .png in [0, 1] at
    `shape` (H, W by default), masks .npy + .png equal to w > 0.5."""
    from vipnerf_tpu_torch.utils.io import read_mask

    shape = shape or (H, W)
    if not (out_dir / "Configs.json").exists():
        raise AssertionError("the visibility prior wrote no Configs.json")
    for a, b in pairs:
        for f1, f2 in ((a, b), (b, a)):
            name = f"{f1:04}_{f2:04}"
            w = np.load(out_dir / f"{scene}/visibility_weights/{name}.npy")
            m = np.load(out_dir / f"{scene}/visibility_masks/{name}.npy")
            check_png(out_dir / f"{scene}/visibility_weights/{name}.png", shape)
            if w.shape != shape or w.dtype != np.float32 or not np.isfinite(w).all() or w.min() < 0 or w.max() > 1:
                raise AssertionError(f"visibility weights {name}: shape {w.shape}, dtype {w.dtype}, out of [0, 1]")
            if m.dtype != bool or not np.array_equal(m, w > 0.5) \
                    or not np.array_equal(read_mask(out_dir / f"{scene}/visibility_masks/{name}.png"), m):
                raise AssertionError(f"visibility mask {name} is not weights > 0.5")


def phase_prior_vs_cpu(root: Path, out_dir: Path, f1: int, f2: int):
    """One direction of the card's LLFF prior against the CPU (64 planes
    from the train frames' depth bounds)."""
    from vipnerf_tpu_torch.priors.visibility import get_depth_planes

    base = root / "data/databases/NeRF_LLFF/data/all/database_data/synth01"
    bds = np.loadtxt(base / "DepthBounds.csv", delimiter=",")[list(PIPE_TRAIN)]
    return prior_direction_vs_cpu(base, "_down4", get_depth_planes(bds.min(), bds.max(), 64),
                                  out_dir / "synth01", f1, f2)


def prior_direction_vs_cpu(base: Path, suffix: str, planes: np.ndarray, out_scene: Path, f1: int, f2: int):
    """One direction of the card's prior against compute_visibility_weights
    on the CPU at full size, from the same frames, poses and planes."""
    from vipnerf_tpu_torch.priors.visibility import compute_visibility_weights
    from vipnerf_tpu_torch.utils.io import read_image

    extr = np.loadtxt(base / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4).astype(np.float32)
    intr = np.loadtxt(base / f"CameraIntrinsics{suffix}.csv", delimiter=",").reshape(-1, 3, 3).astype(np.float32)
    planes = torch.as_tensor(planes, dtype=torch.float32)
    frame = {f: torch.as_tensor(read_image(base / f"rgb{suffix}/{f:04}.png")[..., :3], dtype=torch.float32)
             for f in (f1, f2)}
    t0 = time.perf_counter()
    cpu = compute_visibility_weights(frame[f1], frame[f2], extr[f1], extr[f2], intr[f1], intr[f2],
                                     planes, 10).numpy()
    cpu_s = time.perf_counter() - t0
    card = np.load(out_scene / f"visibility_weights/{f1:04}_{f2:04}.npy")
    max_dw = float(np.abs(card - cpu).max())
    mask_frac = float(np.mean((card > 0.5) != (cpu > 0.5)))
    h, w = card.shape
    log(f"visibility prior {f1:04}->{f2:04}, card vs CPU at {w}x{h} x {len(planes)} planes: max|dw| {max_dw:.3g} "
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
    (bf16 with f32 heads: K1's bf16_f32h instance, 2 launches per step) cut
    to PIPE_STEPS iterations: start_training on the generated prior,
    start_testing with its QA subprocess, and both video tracks of a 3-pose
    track."""
    from vipnerf_tpu_torch.apps import nerf_llff
    from vipnerf_tpu_torch.apps.common import DatasetApp
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp
    from vipnerf_tpu_torch.priors.cli import main_sparse_depth, main_visibility
    from vipnerf_tpu_torch.priors.sparse_depth import ColmapNotFoundError
    from vipnerf_tpu_torch.protocol.common import read_scalars

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_synthetic_database(root / "data/databases", scene_name="synth01", num_frames=5,
                                 train_frames=PIPE_TRAIN, val_frames=(1,), height=H, width=W,
                                 resolution_suffix="_down4", with_visibility_prior=False)
        log(f"pipeline: synthetic LLFF scene at {W}x{H} under rgb_down4 (train {PIPE_TRAIN}, validation 1, "
            f"test 3), sparse depths, no visibility prior, in {time.perf_counter() - t0:.2f} s")

        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True  # no matmul setting may reach the warp
        t0 = time.perf_counter()
        try:
            records = main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(root)])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        prior_s = time.perf_counter() - t0
        directions = [r["seconds"] for r in records]
        pairs = [(a, b) for i, a in enumerate(PIPE_TRAIN) for b in PIPE_TRAIN[i + 1:]]
        if len(directions) != 2 * len(pairs) or {r["device"] for r in records} != {"cuda:0"}:
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
        if path_k1 != "fused_mlp_bf16_f32h":
            raise AssertionError(f"demo1a's shipped configs run {path_k1}, not fused_mlp_bf16_f32h")
        mark = tracing.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.start_training(train_configs)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches_train = launches_since(k1, mark)
        backward_train = launches_since(k1, mark, k1.BWD_KERNELS)
        if launches_train != launch_counts(k1, fused_mlp_bf16_f32h=2 * PIPE_STEPS) \
                or backward_train != dict.fromkeys(BWD, 2 * PIPE_STEPS if torch.cuda.is_available() else 0):
            raise AssertionError(f"the app's {PIPE_STEPS} steps launched K1 {launches_train} and its backward "
                                 f"{backward_train}, expected 2 per step of fused_mlp_bf16_f32h and of each")
        scene_train = root / "runs/training/train0011/synth01"
        losses = [v for _, v in sorted(read_scalars(scene_train / "logs/scalars.jsonl")["train/TotalLoss"].items())]
        if len(losses) != PIPE_STEPS or not np.isfinite(losses).all() \
                or not (scene_train / f"saved_models/Model_Iter{PIPE_STEPS:06}.tar").exists():
            raise AssertionError("the app's training logged no finite loss per step or wrote no checkpoint")
        log(f"app start_training (demo1a configs: bf16, f32 heads, 2048 + 2048 rays, the generated VW02 prior): "
            f"{PIPE_STEPS} steps in {train_s:.2f} s with set-up and checkpoint, {PIPE_STEPS / train_s:.2f} steps/s; "
            f"mean TotalLoss first 20 {np.mean(losses[:20]):.5f}, last 20 {np.mean(losses[-20:]):.5f}; K1 launches "
            f"{launches_train}")

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
        launches = launches_since(k1, mark)
        encode_fed(k1, mark, "demo1a app: training, testing, videos")
        log(f"app video tracks: 2 frames each, moving {video_s['moving']:.2f} s, static {video_s['static']:.2f} s, "
            f"written as frame directories; K1 launches over the app's training, testing and videos {launches} "
            f"(the shipped f32 heads: fused_mlp_bf16_f32h only)")
        if launches["fused_mlp_bf16_f32h"] <= launches_train["fused_mlp_bf16_f32h"] \
                or any(n for name, n in launches.items() if name != "fused_mlp_bf16_f32h"):
            raise AssertionError(f"the pipeline launched K1 {launches}")
    return {"prior_s_per_direction": directions, "prior_vs_cpu": prior_cmp, "train_s": train_s,
            "steps_per_s": PIPE_STEPS / train_s, "test_s_per_frame": test_s / len(test_frames),
            "qa_s_per_frame": qa_s[0], "qa_breakdown_s": qa_parts,
            "video_s_per_frame": {k: v / 2 for k, v in video_s.items()},
            "qa_scores": scores, "k1_launches": launches, "k1_backward_launches": backward_train}


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
    from vipnerf_tpu_torch.protocol.common import read_scalars
    from vipnerf_tpu_torch.utils import jax_ckpt

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
        decodes = tracing.counts().get("jpeg.decodes", 0)
        t0 = time.perf_counter()
        nerf_llff.main(["--database_dirpath", str(db_dir), "--zip_filepath", str(zip_path),
                        "--set_nums", "2", "--num_train_frames", "2", "--video_poses", "--device", device_arg])
        build_s = time.perf_counter() - t0
        decodes = tracing.counts().get("jpeg.decodes", 0) - decodes
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
        mark = tracing.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        app.start_training(copy.deepcopy(train_configs))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches_train = launches_since(k1, mark)
        run = root / "runs/training/train0021"
        saved = run / f"{DB_SCENE}/saved_models"
        losses = [v for _, v in sorted(read_scalars(run / DB_SCENE / "logs/scalars.jsonl")["train/TotalLoss"].items())]
        log(f"app start_training on the built database (flagship width, bf16 heads, 2048 + 2048 rays): {DB_STEPS} "
            f"steps in {train_s:.2f} s with set-up and 2 checkpoints; K1 launches {launches_train}; mean TotalLoss "
            f"first 10 {np.mean(losses[:10]):.5f}, last 10 {np.mean(losses[-10:]):.5f}")
        if launches_train != launch_counts(k1, fused_mlp_bf16=2 * DB_STEPS):
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
            mark = tracing.counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                app.start_training(cfg)
            launches = sum(launches_since(k1, mark).values())
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
        mark = tracing.counts()
        scalars = rig.step_fn(True, False)(rig.batch(0))
        fast_launches = sum(launches_since(k1, mark).values())
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


# ------------------------------------------------------------- protocol

PROTO_H, PROTO_W = 300, 400  # the DTU protocol's size
PROTO_STEPS = 200  # the shipped-mode leg of demo1b's 50k iterations
PROTO_VIDEO_FRAMES = 4  # the driver's 20-frame ring, cut
SEAM_START, SEAM_END = 29950, 30050  # the resumed leg around the visibility prior's switch
PRIOR_SWITCH = 30000  # the JAX package's threshold: the prior's weight from iter_num >= 30000
PRIOR_WEIGHT = 0.001
TOL_LOSS_ULPS = 8  # TotalLoss against its terms: f32 sums, a few ulps of the terms' magnitude


def loss_composition(series, step: int):
    """TotalLoss - (MSE01 + 0.1 VisibilityLoss01 + 0.1 SparseDepthMSE01) at
    a logged step, and the f32 rounding allowed there."""
    terms = {"MSE01": 1.0, "VisibilityLoss01": 0.1, "SparseDepthMSE01": 0.1}
    base = sum(w * series[f"train/{name}"][step] for name, w in terms.items())
    scale = sum(abs(w * series[f"train/{name}"][step]) for name, w in terms.items()) \
        + PRIOR_WEIGHT * abs(series["train/VisibilityPriorLoss01"][step])
    return series["train/TotalLoss"][step] - base, TOL_LOSS_ULPS * 2.0 ** -24 * scale


@contextlib.contextmanager
def dtu_configs_edit(edit):
    """Within the block, `apps.dtu.demo_configs` returns configs that `edit`
    has changed in place: the driver's own call, in another precision mode."""
    from vipnerf_tpu_torch.apps import dtu

    original = dtu.demo_configs

    def edited(*args, **kwargs):
        train_configs, test_configs = original(*args, **kwargs)
        edit(train_configs)
        return train_configs, test_configs

    dtu.demo_configs = edited
    try:
        yield
    finally:
        dtu.demo_configs = original


def run_driver(driver, argv):
    """One call of the protocol driver: its summary and seconds."""
    t0 = time.perf_counter()
    summary = driver.main(argv)
    return summary, time.perf_counter() - t0


def phase_protocol(k1, dev):
    """The DTU quality control's driver (`protocol.run_dtu_control`) at the
    protocol's 300x400: (1) its database and VW03 on the card, the masks
    checked and one direction held against the CPU; (2) a PROTO_STEPS leg in
    the shipped mode (bf16 with f32 heads: K1's bf16_f32h instance, exactly
    2 launches per training step), its loss falling and its masked QA
    written; (3) from those weights a checkpoint at
    SEAM_START written by `train.checkpoints.save_checkpoint` with Adam's
    count set to match, and the driver resumed to SEAM_END with bf16 heads
    (K1 on metric-space rays): the loss composition on both sides of the
    prior's switch, the LR at the switch and exactly 2 K1 launches per step;
    (4) every K1 instance against its plain version on this scene's
    2048 + 2048-ray batch, coarse and fine; (5) the phase's figures."""
    from vipnerf_tpu_torch.apps import dtu
    from vipnerf_tpu_torch.data.loaders import get_data_loader
    from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays
    from vipnerf_tpu_torch.priors.visibility import get_depth_planes
    from vipnerf_tpu_torch.protocol import run_dtu_control as driver
    from vipnerf_tpu_torch.protocol.common import read_scalars
    from vipnerf_tpu_torch.train import checkpoints
    from vipnerf_tpu_torch.train.step import make_optimizer
    from vipnerf_tpu_torch.utils.io import read_csv_columns, read_mask

    t_phase = time.perf_counter()
    device_arg = "cpu" if dev.type == "cpu" else "all"
    parts = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(os.getcwd()):
        work = Path(tmp) / "dtu_control"
        argv = ["--workdir", str(work), "--height", str(PROTO_H), "--width", str(PROTO_W),
                "--video_frames", str(PROTO_VIDEO_FRAMES), "--device", device_arg]
        db_dir = work / "data/databases/DTU/data"
        scene = db_dir / "all/database_data/00021"
        run = work / "runs/training/train0042/00021"

        # (1) + (2): the database, VW03 and the shipped-mode leg
        shipped_training = {}
        start_training = dtu.app.start_training

        def counted_shipped(cfg):
            before = k1.launches()["fused_mlp_bf16_f32h"]
            start_training(cfg)
            after = k1.launches()["fused_mlp_bf16_f32h"]
            shipped_training["fused_mlp_bf16_f32h"] = after - before

        mark = tracing.counts()
        torch.cuda.synchronize()
        dtu.app.start_training = counted_shipped
        try:
            summary, leg_s = run_driver(driver, argv + ["--iters", str(PROTO_STEPS)])
        finally:
            dtu.app.start_training = start_training
        shipped_launches = launches_since(k1, mark)
        encode_fed(k1, mark, "protocol, shipped leg")
        shipped_backward = launches_since(k1, mark, k1.BWD_KERNELS)
        directions = summary["prior_s_per_direction"]
        pairs = [(a, b) for i, a in enumerate(driver.TRAIN_FRAMES) for b in driver.TRAIN_FRAMES[i + 1:]]
        if len(directions) != 2 * len(pairs) or summary["prior_devices"] != [str(dev)]:
            raise AssertionError(f"VW03 ran {len(directions)} directions on {summary['prior_devices']}, expected "
                                 f"{2 * len(pairs)} on {dev}")
        out_dir = db_dir / "all/visibility_prior/VW03"
        check_prior_outputs(out_dir, pairs, scene="00021", shape=(PROTO_H, PROTO_W))
        gen_cfg = json.loads((out_dir / "Configs.json").read_text())
        if (gen_cfg["num_depth_planes"], gen_cfg.get("depth_planes_linear"), gen_cfg.get("fixed_bounds")) \
                != (128, True, [0.1, 5.0]):
            raise AssertionError(f"VW03 was not generated with DTU's policy: {gen_cfg}")
        prior_cmp = prior_direction_vs_cpu(scene, "", get_depth_planes(0.1, 5.0, 128, linear=True),
                                           out_dir / "00021", 0, 2)
        masks = [read_mask(scene / f"ObjectMasks/{f:04}.png") for f in range(6)]
        mask_share = [float(np.mean(m > 0)) for m in masks]
        if any(m.shape[:2] != (PROTO_H, PROTO_W) for m in masks) or not all(0.02 < x < 0.98 for x in mask_share):
            raise AssertionError(f"ObjectMasks: shapes {[m.shape for m in masks]}, object share {mask_share}")
        log(f"protocol: DTU database at {PROTO_W}x{PROTO_H} (train {driver.TRAIN_FRAMES}, validation "
            f"{driver.VAL_FRAMES}), ObjectMasks covering {min(mask_share):.3f}-{max(mask_share):.3f} of each view; "
            f"VW03 on {dev} with DTU's policy (128 linear planes over [0.1, 5]): {len(directions)} directions, "
            f"seconds {', '.join(f'{x:.4f}' for x in directions)}")

        series = read_scalars(run / "logs/scalars.jsonl")
        losses = [v for _, v in sorted(series["train/TotalLoss"].items())]
        window = max(PROTO_STEPS // 10, 1)
        first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
        if len(losses) != PROTO_STEPS or not np.isfinite(losses).all() or not last < first:
            raise AssertionError(f"the shipped-mode leg logged {len(losses)} losses, first {first}, last {last}")
        # the backward's kernels launch on the card only (a CPU rehearsal runs their plain version)
        if shipped_training["fused_mlp_bf16_f32h"] != 2 * PROTO_STEPS \
                or shipped_backward != dict.fromkeys(BWD, 2 * PROTO_STEPS if dev.type == "cuda" else 0) \
                or shipped_launches != launch_counts(k1, fused_mlp_bf16_f32h=shipped_launches["fused_mlp_bf16_f32h"]):
            raise AssertionError(f"the shipped mode (f32 heads) launched K1 {shipped_launches}, "
                                 f"{shipped_training} in start_training; expected bf16_f32h only, 2 per step")
        test_dir = work / "runs/testing/test0042"
        scores = json.loads((test_dir / "QA_Scores.json").read_text())["predicted_frames"]
        framewise = read_csv_columns(test_dir / "QA_Scores/predicted_frames/MaskedPSNR05_FrameWise.csv")
        test_frames = sorted(int(f) for f in framewise["pred_frame_num"])
        want_frames = [f for f in range(6) if f not in driver.TRAIN_FRAMES + driver.VAL_FRAMES]
        if scores.get("MaskedPSNR05") is None or test_frames != want_frames \
                or scores["MaskedPSNR05"] == scores["PSNR05"]:
            raise AssertionError(f"masked QA: {scores}, frames {test_frames} (expected {want_frames})")
        mse = series["train/MSE01"]
        mse_vs_jax = {s: {"port": mse.get(s), "jax": ref} for s, ref in driver.JAX_MSE_AT.items()}
        parts["database_prior_and_leg_s"] = leg_s
        log(f"protocol: the shipped-mode leg, {PROTO_STEPS} steps (K1 fused_mlp_bf16_f32h: "
            f"{shipped_training['fused_mlp_bf16_f32h']} launches in start_training, {shipped_launches} over the "
            f"leg with its test and videos; its backward kernels {shipped_backward}): TotalLoss "
            f"mean of the first {window} {first:.5f}, of the last {window} {last:.5f}; median chunk "
            f"{summary['ms_per_step_median']} ms per step; masked QA of test frames {test_frames} against "
            f"ObjectMasks: {json.dumps(scores)}; train/MSE01 beside the JAX run's (information, not a gate): "
            f"{json.dumps(mse_vs_jax)}; the driver took {leg_s:.1f} s")

        # (3): the seam, with bf16 heads
        t0 = time.perf_counter()
        configs = json.loads((work / "runs/training/train0042/Configs.json").read_text())
        configs["data_loader"]["scene_id"] = "00021"
        model = ViPNeRF(configs).to(dev)
        optimizer = make_optimizer(configs, model.parameters())
        saved = run / "saved_models"
        checkpoints.load_checkpoint(saved / f"Model_Iter{PROTO_STEPS:06}.tar", model, optimizer)
        optimizer.count.fill_(SEAM_START)
        checkpoints.save_checkpoint(saved, SEAM_START, model, optimizer)
        if checkpoints.checkpoint_iteration(saved / "Model_Latest.tar") != SEAM_START:
            raise AssertionError("Model_Latest.tar does not point at the seam's checkpoint")
        del model, optimizer

        seam_launches = {}

        def counted_training(cfg):
            before = sum(k1.launches().values())
            start_training(cfg)
            seam_launches["training"] = sum(k1.launches().values()) - before

        def bf16_heads(cfg):
            cfg["model"].update(bf16_matmuls=True, f32_heads=False)

        mark = tracing.counts()
        dtu.app.start_training = counted_training
        try:
            with dtu_configs_edit(bf16_heads):
                seam_summary, seam_s = run_driver(driver, argv + ["--iters", str(SEAM_END)])
        finally:
            dtu.app.start_training = start_training
        seam_total = launches_since(k1, mark)
        parts["seam_s"] = time.perf_counter() - t0
        series = read_scalars(run / "logs/scalars.jsonl")
        steps = list(range(SEAM_START + 1, SEAM_END + 1))
        leg_steps = sorted(s for s in series["train/TotalLoss"] if s > PROTO_STEPS)
        if leg_steps != steps or seam_summary["steps"] != len(steps):
            raise AssertionError(f"the driver did not resume at {SEAM_START}: it logged steps "
                                 f"{leg_steps[:1]}..{leg_steps[-1:]}, {seam_summary['steps']} in its summary")
        worst = {"before": 0.0, "after": 0.0}
        for step in steps:
            resid, tol = loss_composition(series, step)
            expect = PRIOR_WEIGHT * series["train/VisibilityPriorLoss01"][step] if step - 1 >= PRIOR_SWITCH else 0.0
            side = "after" if step - 1 >= PRIOR_SWITCH else "before"
            worst[side] = max(worst[side], abs(resid - expect) / tol)
            if abs(resid - expect) > tol:
                raise AssertionError(f"step {step}: TotalLoss - weighted terms {resid:.3e}, expected {expect:.3e} "
                                     f"within {tol:.1e}")
        lr_at = series["train/lr"][PRIOR_SWITCH]
        lr_want = 5e-4 * 0.1 ** ((PRIOR_SWITCH - 1) / 250000)  # logged at step s: the rate of iteration s - 1
        lr_rel = abs(lr_at - driver.JAX_LR[PRIOR_SWITCH]) / driver.JAX_LR[PRIOR_SWITCH]
        if abs(lr_at - lr_want) > 1e-12 or lr_rel > driver.BAND_LR_REL or f"{lr_at:.4e}" != "3.7929e-04":
            raise AssertionError(f"train/lr at {PRIOR_SWITCH}: {lr_at!r}, expected {lr_want!r}")
        end = torch.load(saved / f"Model_Iter{SEAM_END:06}.tar", map_location="cpu", weights_only=True)
        count = max(int(e["step"]) for e in end["optimizer_state_dict"]["state"].values())
        seam_steps = SEAM_END - SEAM_START
        val_frames = len(driver.TRAIN_FRAMES) + len(driver.VAL_FRAMES)
        tile = min(configs["validation_chunk_size"], 8192)
        val_launches = 2 * val_frames * -(-(PROTO_H * PROTO_W) // tile)
        log(f"protocol: the seam, {saved.name}/Model_Iter{SEAM_START:06}.tar (Adam count {SEAM_START}) resumed to "
            f"{SEAM_END} with bf16 heads: TotalLoss - (MSE01 + 0.1 VisibilityLoss01 + 0.1 SparseDepthMSE01) is 0 "
            f"through step {PRIOR_SWITCH} and 0.001 VisibilityPriorLoss01 from step {PRIOR_SWITCH + 1} (iter_num "
            f">= {PRIOR_SWITCH}), worst {worst['before']:.3f} and {worst['after']:.3f} of the f32 tolerance; "
            f"train/lr at {PRIOR_SWITCH} {lr_at!r} (the JAX run's {driver.JAX_LR[PRIOR_SWITCH]!r}, relative "
            f"{lr_rel:.1e}); Adam's count at the end {count}; K1 launches in start_training "
            f"{seam_launches['training']} = 2 x {seam_steps} steps + {val_launches} of the validation at "
            f"{PRIOR_SWITCH}; over the whole leg {seam_total}; {parts['seam_s']:.1f} s")
        if count != SEAM_END or seam_launches["training"] != 2 * seam_steps + val_launches:
            raise AssertionError(f"the seam's Adam count {count} or K1 launches {seam_launches}")

        # (4): K1 on this scene's metric-space inputs
        t0 = time.perf_counter()
        configs["model"].update(bf16_matmuls=True, f32_heads=False)
        model = ViPNeRF(configs).to(dev)
        checkpoints.load_checkpoint(saved / f"Model_Iter{SEAM_END:06}.tar", model)
        raw = get_data_loader(configs, work / "data" / configs["database_dirpath"], "train").load_data()
        prep = get_data_preprocessor(configs, "train", raw_data_dict=raw, device=dev)
        batch = prep.get_next_batch(SEAM_END)
        captured = []
        apply = k1.apply_fused_mlp

        def capture(mlp, pts, view_dirs, view_dirs2=None, **kw):
            captured.append((mlp, pts.detach(), view_dirs.detach(),
                             None if view_dirs2 is None else view_dirs2.detach()))
            return apply(mlp, pts, view_dirs, view_dirs2, **kw)

        k1.apply_fused_mlp = capture
        try:
            with torch.no_grad():
                render_rays(model, configs, batch, train=True, generator=torch.Generator(device=dev).manual_seed(0))
        finally:
            k1.apply_fused_mlp = apply
        k1_dtu = {}
        for (mlp, pts, vd, vd2), level in zip(captured, ("coarse", "fine")):
            for name, (dtype, f32_heads) in K1_MODES.items():
                weights = k1.prepare_weights(mlp, dtype, f32_heads)
                xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
                out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns).float()
                torch.cuda.synchronize()
                ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
                err = (out - ref).abs().max().item()
                rel_max = err / max(ref.abs().max().item(), 1e-30)
                rel_rms = ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()
                k1_dtu[f"{level}_{name}"] = {"points": pts.shape[0], "n_sec": ns, "max_abs_err": err,
                                             "rel_max": rel_max, "rel_rms": rel_rms}
                log(f"K1 {name} on DTU's {level} points ({pts.shape[0]}, n_sec {ns}, max |pts| "
                    f"{pts.abs().max().item():.3f}): max|err| {err:.3g}, max|err|/max|plain| {rel_max:.3g} "
                    f"(tol {TOL_REL_MAX[name]:.3g}), rms rel {rel_rms:.3g} (tol {TOL_REL_RMS[name]:.3g})")
                if not (torch.isfinite(out).all() and rel_max <= TOL_REL_MAX[name]
                        and rel_rms <= TOL_REL_RMS[name]):
                    raise AssertionError(f"K1 disagrees with its plain version on DTU's {level} points ({name})")
        if len(captured) != 2:
            raise AssertionError(f"a training render captured {len(captured)} K1 calls, expected 2")
        parts["k1_check_s"] = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    log(f"protocol phase: {phase_s:.1f} s")
    return {"seconds": phase_s, "parts_s": parts, "shipped_leg": summary, "qa": scores,
            "loss_first": first, "loss_last": last, "mse_vs_jax": mse_vs_jax, "prior_vs_cpu": prior_cmp,
            "prior_s_per_direction": directions, "seam": {
                "start": SEAM_START, "end": SEAM_END, "lr_at_switch": lr_at, "lr_rel_to_jax": lr_rel,
                "worst_of_tolerance": worst, "adam_count": count, "k1_launches_training": seam_launches["training"],
                "k1_launches_per_step": (seam_launches["training"] - val_launches) / seam_steps},
            "k1_dtu": k1_dtu, "k1_launches": seam_total["fused_mlp_bf16"],
            "k1_launches_shipped": shipped_launches["fused_mlp_bf16_f32h"],
            "k1_backward_launches_shipped": shipped_backward}



# ----------------------------------------------------------- multi-device

PAR_STEPS = 10
PAR_SCENES = ["synth01", "synth02"]
PAR_TRAIN_NUM, PAR_BATCHED_NUM = 21, 22  # train{N}: the one-rank runs, under root/one and root/two
# Two ranks against one: the ranks' sums of their halves' gradients round apart from one sum over
# the batch. The JAX package holds its mesh to TotalLoss within rtol 1e-5 and parameters within
# atol 2e-6 / rtol 1e-5 (tests/test_parallel.py, a narrow model). At the flagship width the two
# trajectories part further with every step: each step's rounding-level differences feed the
# next gradients, and Adam's normalisation turns a relative difference of a small gradient into
# an update difference of the learning rate's order. Measured in f32 on an H100 80GB HBM3 at
# 700 W (the f32 twin writes a checkpoint after every step, read by `par_f32_drift`): 1 entry of
# 1.19M outside the mesh's tolerance after step 1, no gradient sign changed there, then 4.5e-5,
# 7.7e-4, 3.4e-3, ... 6.4e-2 of the entries by step 10. So the parameters are held by their
# distance over how far they moved, and the share outside the mesh's tolerance is printed. In
# bf16 the weights are rounded to bf16 for every forward, so a rounding-level difference in a
# weight near a bf16 rounding boundary moves it by a bf16 step (2^-8 relative), and the losses
# part by far more than in f32. Measured there: the first step's TotalLoss equal to 8.5e-8 in
# both modes, then within 1.2e-6 in f32 and 5.6e-4 in bf16 over 10 steps; ||d|| / ||moved||
# 1.4e-3 (f32) and 1.0e-2 (bf16).
TOL_PAR_LOSS_RTOL = {"f32": 1e-5, "bf16": 2e-3}
TOL_PAR_PARAM_ATOL, TOL_PAR_PARAM_RTOL = 2e-6, 1e-5
TOL_PAR_REL_DIST = {"f32": 1e-2, "bf16": 5e-2}
# batch_scenes over two ranks: the step has no collective (each rank trains its own scene at
# S = 1), so the runs differ only where the one process's S = 2 step rounds a scene's sums apart
# from an S = 1 step. The scenes are trained in both orders, so each is seen on each rank.
# Measured on an H100 80GB HBM3 at 700 W: ||d|| / ||moved|| 1.85e-7 for synth01 and 2.29e-4 for
# synth02, the same to every printed digit on rank 0 and on rank 1: the difference follows the
# scene's trajectory, not the rank.
TOL_PAR_BATCHED_REL_DIST = 2e-3
# The frame: each rank renders whole rays, but a kernel over half a tile's rays may sum in another
# order. The NDC depth (in [0, 1]) is compared; the metric depth, 1 / (1 - ndc) near the far plane,
# magnifies an ulp there and is printed only.
TOL_PAR_PNG = 1  # grey levels
TOL_PAR_DEPTH_NDC = 2e-3  # measured 6.7e-4 on an H100 80GB HBM3 at 700 W


def par_configs(root: Path, train_num: int, device, scenes=("synth01",), precision: str = "bf16") -> dict:
    """The flagship training config for PAR_STEPS steps through K1, with
    bf16 heads (one checkpoint, at the end) or in f32 (a checkpoint after
    every step), no validation."""
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs

    cfg = flagship_training_configs(root, PAR_STEPS)
    cfg["data_loader"]["scene_names"] = list(scenes)
    cfg["model"]["bf16_matmuls"] = precision == "bf16"
    cfg.update(train_num=train_num, device=device, model_save_interval=PAR_STEPS if precision == "bf16" else 1,
               validation_interval=10 * PAR_STEPS)
    return cfg


def par_train(cfg: dict) -> dict:
    """PAR_STEPS steps of the port's `Trainer` on this process's group (or
    alone), from the seed's weights, into the run tree of
    cfg['configs']: each step's TotalLoss (rank 0's log), the final
    parameters on the host and K1's launches in this process."""
    from vipnerf_tpu_torch.data.loaders import get_data_loader
    from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
    from vipnerf_tpu_torch.kernels import fused_mlp as k1
    from vipnerf_tpu_torch.losses import LossComputer
    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF
    from vipnerf_tpu_torch.parallel.mesh import current_group
    from vipnerf_tpu_torch.protocol.common import read_scalars
    from vipnerf_tpu_torch.train.trainer import Trainer
    from vipnerf_tpu_torch.utils.config import save_configs, save_model_configs
    from vipnerf_tpu_torch.utils.device import resolve_device

    configs = copy.deepcopy(cfg["configs"])
    group = current_group(configs["device"])
    writes = group is None or group.is_writer
    dev = resolve_device(configs["device"])
    run = Path(configs["root_dirpath"]) / f"runs/training/train{configs['train_num']:04}"
    db = Path(configs["root_dirpath"]) / "data" / configs["database_dirpath"]
    if writes:  # the tree the tester reads
        (run / "synth01").mkdir(parents=True, exist_ok=True)
        save_configs(run, copy.deepcopy(configs))
    configs["data_loader"]["scene_id"] = "synth01"
    prep = get_data_preprocessor(configs, "train", device=dev,
                                 raw_data_dict=get_data_loader(configs, db, "train").load_data())
    val = get_data_preprocessor(configs, "validation", model_configs=prep.get_model_configs(), device=dev,
                                raw_data_dict=get_data_loader(configs, db, "validation").load_data())
    if writes:
        save_model_configs(run / "synth01", prep.get_model_configs())
    model = ViPNeRF(configs, torch.Generator().manual_seed(0)).to(dev)
    trainer = Trainer(configs, prep.get_model_configs(), prep, val, model, LossComputer(configs), run / "synth01",
                      verbose_log=False, group=group)
    mark = tracing.counts()
    try:
        trainer.train()
    finally:
        trainer.logger.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    losses = None
    if writes:
        series = read_scalars(run / "synth01/logs/scalars.jsonl")["train/TotalLoss"]
        losses = [series[i] for i in range(1, PAR_STEPS + 1)]
    return {"losses": losses, "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "launches": sum(launches_since(k1, mark).values()), "sharded": trainer.shard is not None}


def par_start(configs: dict) -> dict:
    """The seed's weights every run of the phase starts from."""
    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF

    return ViPNeRF(configs, torch.Generator().manual_seed(0)).state_dict()


def par_rank(cfg: dict) -> None:
    """One of the two ranks: `par_train` (bf16, then f32), then a held-out
    frame through `start_testing` and the two scenes, in both orders,
    through `start_training_batched`, each joining this rank's group; its
    results to cfg['out']."""
    from vipnerf_tpu_torch.infer.tester import start_testing
    from vipnerf_tpu_torch.parallel.mesh import current_group
    from vipnerf_tpu_torch.train.multi_scene import start_training_batched

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = current_group(cfg["configs"]["device"]).rank
    t0 = time.perf_counter()
    result = par_train(cfg)
    result["train_s"] = time.perf_counter() - t0
    result["f32"] = par_train({"configs": cfg["configs_f32"]})
    t0 = time.perf_counter()
    start_testing(cfg["test_configs"], cfg["scenes_data"], save_depth=True)
    result["test_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batched in cfg["batched"]:
        start_training_batched(batched)
    result["batched_s"] = time.perf_counter() - t0
    torch.save(result, Path(cfg["out"]) / f"par_rank{rank}.pt")


def par_compare(label: str, got: dict, want: dict, start: dict, tol_rel_dist: float) -> dict:
    """Parameter dicts after the same steps from `start`: bitwise or not,
    the largest absolute difference, its share of the JAX mesh's tolerance
    and the share of entries outside it, and the distance between the two
    over the distance `want` moved from `start`."""
    atol, rtol = TOL_PAR_PARAM_ATOL, TOL_PAR_PARAM_RTOL
    worst_abs, worst_share, outside, count, dist2, moved2, bitwise = 0.0, 0.0, 0, 0, 0.0, 0.0, True
    for k, w in want.items():
        g, w, w0 = (x.detach().cpu().double() for x in (got[k], w, start[k]))
        bitwise &= torch.equal(g, w)
        d = (g - w).abs()
        share = d / (atol + rtol * w.abs())
        worst_abs, worst_share = max(worst_abs, float(d.max())), max(worst_share, float(share.max()))
        outside, count = outside + int((share > 1).sum()), count + d.numel()
        dist2, moved2 = dist2 + float((d ** 2).sum()), moved2 + float(((w - w0) ** 2).sum())
    out = {"bitwise": bitwise, "max_abs": worst_abs, "share_of_tol": worst_share, "outside_tol": outside / count,
           "rel_dist": math.sqrt(dist2 / moved2)}
    log(f"{label}: parameters bitwise {bitwise}, max|d| {worst_abs:.3g}, worst share of the JAX mesh's tolerance "
        f"(atol {atol:g}, rtol {rtol:g}) {worst_share:.3g}, entries outside it {outside} of {count}, "
        f"||d|| / ||moved|| {out['rel_dist']:.3g} (tol {tol_rel_dist:g})")
    return out


def par_f32_drift(one: Path, two: Path) -> dict:
    """The f32 twin's checkpoints after every step, one rank's (`one`) and
    two ranks' (`two`): the share of parameter entries outside the JAX
    mesh's tolerance after each step; and after step 1, where Adam's update
    is lr * g / (|g| + eps) with g = exp_avg / (1 - beta1) (so where the two
    gradients differ in sign the parameters part by about 2 lr), the share
    whose gradient changed sign, the share of the entries outside the
    tolerance that are such, and the largest |g| of a changed sign over the
    RMS |g| of its tensor."""
    atol, rtol = TOL_PAR_PARAM_ATOL, TOL_PAR_PARAM_RTOL
    per_step = []
    for step in range(1, PAR_STEPS + 1):
        a, b = (torch.load(d / f"Model_Iter{step:06}.tar", weights_only=True) for d in (one, two))
        beta1 = a["optimizer_state_dict"]["param_groups"][0]["betas"][0]
        outside = flipped = both = count = 0
        worst_rel_g = 0.0
        for i, (k, wa) in enumerate(a["model_state_dict"].items()):
            wa, wb = wa.double(), b["model_state_dict"][k].double()
            out = (wa - wb).abs() > atol + rtol * wa.abs()
            outside, count = outside + int(out.sum()), count + wa.numel()
            if step > 1:
                continue
            ga, gb = (x["optimizer_state_dict"]["state"][i]["exp_avg"].double() / (1 - beta1) for x in (a, b))
            if ga.shape != wa.shape:
                raise AssertionError(f"optimizer state {i} of shape {tuple(ga.shape)} does not belong to {k}")
            flip = torch.sign(ga) != torch.sign(gb)
            flipped, both = flipped + int(flip.sum()), both + int((out & flip).sum())
            if flip.any():
                worst_rel_g = max(worst_rel_g, float(ga[flip].abs().max() / ga.pow(2).mean().sqrt()))
        per_step.append(outside / count)
        if step == 1:
            first = {"sign_changed": flipped / count, "outside_with_sign_changed": both / max(outside, 1),
                     "max_rel_grad_sign_changed": worst_rel_g}
    return {"outside_tol_per_step": per_step, "first_step": first}


def phase_parallel(k1, dev):
    """More than one device, as far as one card shows it: (a) the
    distributed step code on NCCL at world size 1, PAR_STEPS steps of the
    Trainer bit for bit against the single-process Trainer; (b) two gloo
    ranks sharing the card (NCCL refuses two ranks on one device), spawned
    by the port's launcher: their parameters bit for bit equal to each
    other, within the mesh tolerances of the one-rank run, K1 exactly 2
    launches per step per rank; (c) a held-out frame by `start_testing` on
    the two ranks against one rank; (d) `batch_scenes`' S = 2 over the two
    ranks against S = 2 in one process, with the scenes in both orders. The
    phase's seconds are those of two ranks sharing one card: no scaling
    figure."""
    import torch.distributed as dist

    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.infer.tester import start_testing
    from vipnerf_tpu_torch.parallel.mesh import backend_for, run_on_devices, select_devices
    from vipnerf_tpu_torch.train.multi_scene import start_training_batched
    from vipnerf_tpu_torch.utils.io import read_image

    cuda = dev.type == "cuda"
    one = [dev.index or 0] if cuda else "cpu"
    two = [dev.index or 0] * 2 if cuda else ["cpu", "cpu"]
    t_phase = time.perf_counter()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        roots = {"one": tmp / "one", "world1": tmp / "world1", "two": tmp / "two"}
        t0 = time.perf_counter()
        gts = [write_synthetic_database(roots["one"] / "data/databases", scene_name=name, num_frames=5,
                                        train_frames=(0, 2, 4), val_frames=(1,), height=H, width=W, seed=i)
               for i, name in enumerate(PAR_SCENES)]
        for key in ("world1", "two"):
            shutil.copytree(roots["one"], roots[key])
        log(f"multi-device: scenes {PAR_SCENES} of 5 frames at {W}x{H} written in {time.perf_counter() - t0:.2f} s")

        # (a) the single-process Trainer, then the distributed step code on a group of one
        t0 = time.perf_counter()
        single = par_train({"configs": par_configs(roots["one"], PAR_TRAIN_NUM, one)})
        single_f32 = par_train({"configs": par_configs(roots["one"], PAR_TRAIN_NUM + 10, one, precision="f32")})
        backend = backend_for(select_devices(one))
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
        try:
            world1 = par_train({"configs": par_configs(roots["world1"], PAR_TRAIN_NUM, one)})
        finally:
            dist.destroy_process_group()
        a_s = time.perf_counter() - t0
        same = single["losses"] == world1["losses"] and all(
            torch.equal(world1["params"][k], v) for k, v in single["params"].items())
        log(f"(a) {PAR_STEPS} Trainer steps, one process vs {backend} at world size 1 (sharded step: "
            f"{world1['sharded']}): TotalLoss {single['losses'][0]:.6f} -> {single['losses'][-1]:.6f}, bit for bit "
            f"{same}; K1 launches {single['launches']} and {world1['launches']} ({a_s:.1f} s)")
        if not (same and world1["sharded"] and backend == ("nccl" if cuda else "gloo")):
            raise AssertionError("the distributed step at world size 1 is not the single-process step")
        if cuda and not single["launches"] == world1["launches"] == 2 * PAR_STEPS:
            raise AssertionError(f"K1 launches {single['launches']}, {world1['launches']}, expected {2 * PAR_STEPS}")

        # (b)-(d): one spawn of two ranks sharing the card
        db = roots["one"] / "data/databases/NeRF_LLFF/data/all/database_data/synth01"
        extr = np.loadtxt(db / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
        intr = np.loadtxt(db / "CameraIntrinsics.csv", delimiter=",").reshape(-1, 3, 3)
        scenes_data = {"synth01": {"output_dirname": "synth01", "frames_data": {
            3: {"extrinsic": extr[3], "intrinsic": intr[3], "is_train_frame": False}}}}

        def test_configs(root, device):
            return {"test_num": PAR_TRAIN_NUM, "train_num": PAR_TRAIN_NUM, "model_name": "Model_Latest.tar",
                    "root_dirpath": str(root), "device": device, "chunk_size": CHUNK}

        def batched(root, device):  # the scenes in both orders: each trained on each rank
            return [par_configs(root, PAR_BATCHED_NUM + i, device, order)
                    for i, order in enumerate((PAR_SCENES, PAR_SCENES[::-1]))]

        t0 = time.perf_counter()
        run_on_devices(par_rank, {"configs": par_configs(roots["two"], PAR_TRAIN_NUM, two), "out": str(tmp),
                                  "configs_f32": par_configs(roots["two"], PAR_TRAIN_NUM + 10, two, precision="f32"),
                                  "test_configs": test_configs(roots["two"], two), "scenes_data": scenes_data,
                                  "batched": batched(roots["two"], two)}, two)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(tmp / f"par_rank{r}.pt", weights_only=False) for r in (0, 1)]
        log(f"two {'gloo ranks sharing cuda:%d' % two[0] if cuda else 'CPU ranks'}: {spawn_s:.1f} s for the spawn, "
            f"the steps, the frame and the batched run (rank 0: train {ranks[0]['train_s']:.1f} s, test "
            f"{ranks[0]['test_s']:.1f} s, batched {ranks[0]['batched_s']:.1f} s); two ranks sharing one card, "
            "not a scaling figure")

        # (b), in bf16 (the phase's mode) and in f32
        start = par_start(par_configs(roots["one"], PAR_TRAIN_NUM, one))
        b_out = {}
        for precision, mine, ref in (("bf16", ranks, single), ("f32", [r["f32"] for r in ranks], single_f32)):
            ranks_equal = all(torch.equal(mine[0]["params"][k], v) for k, v in mine[1]["params"].items())
            rel = [abs(a - b) / abs(b) for a, b in zip(mine[0]["losses"], ref["losses"])]
            cmp = par_compare(f"(b) {precision}, two ranks vs one", mine[0]["params"], ref["params"], start,
                              TOL_PAR_REL_DIST[precision])
            launches = [r["launches"] for r in mine]
            log(f"(b) {precision}: {PAR_STEPS} steps on two ranks (sharded {mine[0]['sharded']}): the ranks' "
                f"parameters bit for bit {ranks_equal}; TotalLoss relative difference from one rank per step "
                f"{[float(f'{x:.3g}') for x in rel]} (tol {TOL_PAR_LOSS_RTOL[precision]:g}); K1 launches per rank "
                f"{launches} (expected {2 * PAR_STEPS} each)")
            if not (ranks_equal and mine[0]["sharded"] and max(rel) <= TOL_PAR_LOSS_RTOL[precision]
                    and cmp["rel_dist"] <= TOL_PAR_REL_DIST[precision]):
                raise AssertionError(f"two ranks do not match one ({precision})")
            if cuda and any(n != 2 * PAR_STEPS for n in launches):
                raise AssertionError(f"K1 launched {launches} times on the ranks ({precision})")
            b_out[precision] = {"ranks_bitwise": ranks_equal, "loss_rel": rel, **cmp, "launches_per_rank": launches}
        run_f32 = f"runs/training/train{PAR_TRAIN_NUM + 10:04}/synth01/saved_models"
        drift = par_f32_drift(roots["one"] / run_f32, roots["two"] / run_f32)
        first = drift["first_step"]
        log(f"(b) f32, two ranks vs one: share of entries outside the JAX mesh's tolerance after steps 1-{PAR_STEPS} "
            f"{[float(f'{x:.3g}') for x in drift['outside_tol_per_step']]}; after step 1, gradient sign changed in "
            f"{first['sign_changed']:.3g} of the entries, {first['outside_with_sign_changed']:.3g} of those outside "
            f"the tolerance; largest |g| with a changed sign over its tensor's RMS |g| "
            f"{first['max_rel_grad_sign_changed']:.3g}")
        b_out["f32"]["drift"] = drift

        # (c)
        t0 = time.perf_counter()
        start_testing(test_configs(roots["one"], one), scenes_data, save_depth=True)
        c_s = time.perf_counter() - t0
        frames = {}
        for key in ("one", "two"):
            scene_out = roots[key] / f"runs/testing/test{PAR_TRAIN_NUM:04}/synth01"
            frames[key] = (read_image(scene_out / "predicted_frames/0003.png"),
                           np.load(scene_out / "predicted_depths/0003_ndc.npy"),
                           np.load(scene_out / "predicted_depths/0003.npy"))
        bitwise = [np.array_equal(a, b) for a, b in zip(frames["one"], frames["two"])]
        png_diff = int(np.abs(frames["one"][0].astype(int) - frames["two"][0].astype(int)).max())
        ndc_diff, depth_diff = (float(np.abs(a - b).max()) for a, b in zip(frames["one"][1:], frames["two"][1:]))
        frame_psnr = psnr(frames["two"][0], gts[0]["images"][3])
        log(f"(c) held-out frame 3 at {W}x{H} (train{PAR_TRAIN_NUM:04}'s weights after {PAR_STEPS} steps, PSNR "
            f"{frame_psnr:.3f} dB) by two ranks vs one rank ({c_s:.1f} s): bit for bit: PNG {bitwise[0]}, NDC depth "
            f"{bitwise[1]}, depth {bitwise[2]}; max difference: {png_diff} grey levels (tol {TOL_PAR_PNG}), NDC depth "
            f"{ndc_diff:.3g} (tol {TOL_PAR_DEPTH_NDC:g}), depth {depth_diff:.3g}")
        if png_diff > TOL_PAR_PNG or ndc_diff > TOL_PAR_DEPTH_NDC:
            raise AssertionError("the two ranks' frame differs from the one rank's")

        # (d)
        t0 = time.perf_counter()
        for cfg in batched(roots["one"], one):
            start_training_batched(cfg)
        d_s = time.perf_counter() - t0
        d_cmp = {}
        for i, order in enumerate((PAR_SCENES, PAR_SCENES[::-1])):
            for rank, name in enumerate(order):
                path = f"runs/training/train{PAR_BATCHED_NUM + i:04}/{name}/saved_models/Model_Iter{PAR_STEPS:06}.tar"
                got, want = ({k.removeprefix("module."): v for k, v in
                              torch.load(roots[key] / path, weights_only=True)["model_state_dict"].items()}
                             for key in ("two", "one"))
                d_cmp[f"{name}_rank{rank}"] = par_compare(
                    f"(d) batch_scenes S = 2, {name} on rank {rank}: two ranks (one scene each) vs one process",
                    got, want, start, TOL_PAR_BATCHED_REL_DIST)
        if any(c["rel_dist"] > TOL_PAR_BATCHED_REL_DIST for c in d_cmp.values()):
            raise AssertionError("batched training over two ranks does not match one process")
        out.update(a={"bitwise": same, "backend": backend, "seconds": a_s},
                   b=b_out,
                   c={"bitwise": dict(zip(("png", "depth_ndc", "depth"), bitwise)), "png_max_diff": png_diff,
                      "depth_ndc_max_diff": ndc_diff, "depth_max_diff": depth_diff, "psnr": frame_psnr,
                      "one_rank_s": c_s},
                   d={**d_cmp, "one_process_s": d_s}, spawn_s=spawn_s,
                   rank0_s={k: ranks[0][k] for k in ("train_s", "test_s", "batched_s")},
                   k1_launches=single["launches"] + world1["launches"] + sum(r["launches"] for r in ranks),
                   k1_launches_f32=single_f32["launches"] + sum(r["f32"]["launches"] for r in ranks))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"multi-device phase: {out['seconds']:.1f} s (two ranks sharing one card)")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    builds = [r for r in tracing.snapshot()["spans"] if r["name"] == "kernels.build"]
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{r['attrs']['library']} {(r['end_ns'] - r['start_ns']) * 1e-9:.2f} s" for r in builds))
    for name, report in build.ptxas_reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line or "Used " in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    for name, (dtype, f32_heads) in K1_MODES.items():
        log(f"{name}: {' and '.join(map(str, k1.smem_bytes(dtype, f32_heads)))} bytes of dynamic shared memory "
            f"per CTA")

    mlp = NeRFMLP(flagship_mlp_config(0), torch.Generator().manual_seed(0)).to(dev)
    worst, timings = phase_k1(k1, mlp, dev)
    encode = phase_encode(k1, dev)
    backward = phase_heads_backward(k1, dev)
    # the yardsticks (the first design's backward kernels, bf16_f32h with
    # FFMA heads): their launches from here on, less check_against_ffma's
    # comparisons, are launches on the main path's phases
    yardsticks = tracing.counts()
    launches, s_per_frame, frame_s, modes = phase_slice(k1, dev, timings)
    train = phase_train(k1, dev, timings)
    pipeline = phase_pipeline(k1)
    multi = phase_multi_scene(k1, dev)
    database = phase_database(k1, dev)
    protocol = phase_protocol(k1, dev)
    parallel = phase_parallel(k1, dev)
    compared = tracing.counts().get("chip_smoke.ffma_compared", 0) - yardsticks.get("chip_smoke.ffma_compared", 0)
    ffma_path = launches_since(k1, yardsticks, [k1.FFMA])[k1.FFMA] - compared
    mma_sync_path = launches_since(k1, yardsticks, k1.BWD_MMA_SYNC_KERNELS)
    log(f"K1's backward, the first design's kernels' launches on the main path: {mma_sync_path} (expected 0)")
    log(f"K1 {FFMA} launches on the main path: {ffma_path} (expected 0; "
        f"{compared} more compared bf16_f32h with it)")

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
    log(json.dumps({"protocol": {"resolution": [PROTO_H, PROTO_W], "steps": PROTO_STEPS, **protocol, "card": card}}))
    log(json.dumps({"multi_device": {"resolution": [H, W], "steps": PAR_STEPS, "rays_per_step": TRAIN_RAYS,
                                     **parallel, "card": card}}))
    # each instance's launches come from its own path: the bf16 one from
    # start_testing, start_training, the batched app run, the built
    # database's runs, the protocol's seam and the multi-device phase's
    # Trainer runs (both ranks' too), the f32 one from the f32 frame of
    # phase_modes and the multi-device phase's f32 Trainer runs, the
    # bf16_f32h one (the shipped mode) from the app's run of demo1a's configs
    # (training, testing, videos), the protocol's shipped leg and the
    # shipped frame of phase_modes
    path_launches = {"fused_mlp_bf16": launches["fused_mlp_bf16"] + train["run"]["launches"] + multi["launches"]
                     + database["k1_launches"] + protocol["k1_launches"] + parallel["k1_launches"],
                     "fused_mlp_f32": modes["f32"]["launches"]["fused_mlp_f32"] + parallel["k1_launches_f32"],
                     "fused_mlp_bf16_f32h": pipeline["k1_launches"]["fused_mlp_bf16_f32h"]
                     + protocol["k1_launches_shipped"]
                     + modes["bf16, f32 heads (default)"]["launches"]["fused_mlp_bf16_f32h"]}
    # K1's backward kernels run in every shipped-mode training step: the
    # app's run of demo1a's configs, the protocol's shipped leg and the
    # trajectory through K1
    for name in BWD:
        path_launches[name] = (pipeline["k1_backward_launches"][name]
                               + protocol["k1_backward_launches_shipped"][name]
                               + train["trajectory"]["launches"][name])

    def bwd_entry(name, first=False):
        fine = backward["timings"][(1, "fine")][name]
        entry = {"name": name + "_mma_sync" if first else name, "route": "cuda",
                 "source": f"vipnerf_tpu_torch/csrc/fused_mlp_bwd{'_mma_sync' if first else ''}.cu",
                 "replaces": "experiments/fused_mlp.py:261",
                 "launches": mma_sync_path[name + "_mma_sync"] if first else path_launches[name],
                 "max_abs_err": backward["worst"]["mma_sync" if first else name],
                 "ms": fine["mma_sync_ms" if first else "ms"], "plain_ms": fine["plain_ms"],
                 "bound_ms": fine["bound_ms"], "bound_by": "bytes" if fine["bound_by"] == "bytes" else "operations",
                 "bound_parts_ms": fine["bound_parts_ms"], "library_ms": fine["library_ms"],
                 "l2_bytes_by_design": fine["mma_sync_l2_bytes_by_design" if first else "l2_bytes_by_design"],
                 "yardstick_ms": backward["timings"][(1, "fine")]["yardstick_ms"],
                 "shape": {"points": TRAIN_N["fine"], "n_sec": TRAIN_SEC}}
        return dict(entry, yardstick_of=name) if first else entry

    def kernel_entry(name, launches):
        main_shape = timings[(name, 0, MAIN_N)]
        return {
            "name": name,
            "route": "cuda",
            "source": "vipnerf_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "experiments/fused_mlp.py:130",
            "launches": launches,
            "max_abs_err": worst[name],
            "ms": main_shape["ms"],
            "plain_ms": main_shape["plain_ms"],
            "bound_ms": main_shape["bound_ms"],
            "bound_by": main_shape["bound_by"],
            "bound_parts_ms": main_shape["bound_parts_ms"],
            "library_ms": main_shape["library_ms"],
        }

    for name in K1_MODES:
        if not path_launches[name]:
            raise AssertionError(f"{name} was not launched on its path")
    # launches per frame: those counted over phase_modes' one warm frame in
    # the shipped mode
    per_frame = dict(ENCODE_FED)["warm frame, bf16, f32 heads (default)"]
    encode_entry = {"name": k1.ENCODE, "route": "cuda", "source": "vipnerf_tpu_torch/csrc/fused_mlp.cu",
                    "replaces": "no TPU kernel: the torch chain of kernels/fused_mlp.py encode_reference",
                    "launches": sum(n for _, n in ENCODE_FED), "launches_per_frame": per_frame,
                    "paths_checked": [path for path, _ in ENCODE_FED], **encode["serving"],
                    "training": encode["training"]}
    log(f"K1 encode: {encode_entry['launches']} launches on {len(ENCODE_FED)} paths, each path's equal to its K1 "
        f"forward launches; {per_frame} in a warm {W}x{H} frame")
    if ffma_path:
        raise AssertionError(f"the FFMA yardstick was launched {ffma_path} times on a path")
    # the FFMA heads are on no path: they are listed apart, as the
    # tensor-core heads' yardstick, timed in the same call
    for name in BWD:
        if not path_launches[name]:
            raise AssertionError(f"{name} was not launched on its path")
    if any(mma_sync_path.values()):
        raise AssertionError(f"the first design's backward kernels were launched on a path: {mma_sync_path}")
    log(json.dumps({"k1_backward": {
        "timings": {f"S={s} {level}": t for (s, level), t in backward["timings"].items()},
        "worst_max_abs_err": backward["worst"], "step_profile_ms": train["profile_ms"].get("k1_backward_ms"),
        "trajectory": {k: v for k, v in train["trajectory"].items() if k != "launches"}, "card": card}}))
    log(json.dumps({"kernels": [kernel_entry(name, path_launches[name]) for name in K1_MODES]
                    + [bwd_entry(name) for name in BWD] + [encode_entry],
                    "yardsticks": [dict(kernel_entry(FFMA, ffma_path), yardstick_of="fused_mlp_bf16_f32h")]
                    + [bwd_entry(name, first=True) for name in BWD]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
