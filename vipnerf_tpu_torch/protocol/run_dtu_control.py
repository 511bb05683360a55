"""The DTU quality control on the port (counterpart of
tools/run_dtu_control.py): demo1b's surface (train 42, set03, 3 input views,
sparse depth, 2048 + 2048 rays, the shipped bf16 trunk with f32 heads) on
the seeded synthetic DTU scan the 2-view run uses (run_dtu_50k.py), with
train views (0, 2, 5), validation view 3 and object masks.

Stages, each restart-safe (protocol/common.py):
1. the database at 300x400 (`write_dtu_database`), without a visibility
   prior;
2. VW03 from the port's generator (`priors.cli.main_visibility`: DTU's
   policy, 128 linear planes over [0.1, 5]) on the card;
3. `apps.dtu._run_full` with demo1b's arguments and `--iters` iterations:
   train, test with masked QA, both video tracks;
4. the run held against the JAX package's committed run of the same
   control (`protocol_evidence/dtu_control_3view/`): the train/MSE01
   medians of the windows the leg covers, and at 10k the validation MSE,
   the LR and the test frames' masked PSNR, PSNR and masked SSIM, each
   with its band (`REFERENCE_COMPARISON:`).

    python -m vipnerf_tpu_torch.protocol.run_dtu_control --workdir W [--iters 10000] [--device cpu]
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

from vipnerf_tpu_torch.apps import dtu
from vipnerf_tpu_torch.priors.cli import main_visibility
from vipnerf_tpu_torch.protocol.common import (
    DEVICE_HELP,
    DTU_SCENE,
    read_scalars,
    run_demo_leg,
    write_dtu_database,
)
from vipnerf_tpu_torch.utils.device import device_from_arg

SET_NUM = 3  # demo1b: set03, 3 input views
TRAIN_NUM = 42  # demo1b's train and test number
TRAIN_FRAMES = (0, 2, 5)
VAL_FRAMES = (3,)

# The JAX package's run of this control (a TPU's quality figures, not a
# speed): protocol_evidence/dtu_control_3view/ -- the 10k checkpoint's QA
# (checkpoint_sweep.jsonl, test0901/QA_Scores.json) and its scalars every 100
# steps (scalars_train0042_00021_every100.jsonl).
JAX_QA_10K = {"MaskedPSNR05": 33.8623, "PSNR05": 29.2534, "MaskedSSIM05": 0.9739}
# median of train/MSE01 over the steps that are multiples of 100 in [a, b]
JAX_MSE_WINDOWS = {(100, 1000): 0.002806785865686834, (1000, 2000): 0.0017709208186715841,
                   (4000, 5000): 0.0009529661620035768, (9000, 10000): 0.0006543787312693894}
JAX_MSE_AT = {100: 0.0172295942902565, 200: 0.006951093673706055}  # train/MSE01 at these steps
JAX_VAL_MSE_10K = 0.04863014842470487  # validation/val_images/MSE01 at 10000
JAX_TRAIN_IMAGES_MSE_10K = 0.0007288914391796828  # validation/train_images/MSE01 at 10000
JAX_LR = {10000: 0.0004560096196624232, 30000: 0.00037929228090951184}  # train/lr logged at these steps

# the bands the port's run is held to
BAND_MASKED_PSNR_DB = 2.0
BAND_MSE_FACTOR = 1.5
BAND_LR_REL = 1e-6


def window_median(series: dict, lo: int, hi: int) -> float:
    """Median of a {step: value} series over the multiples of 100 in
    [lo, hi], the steps the snapshots every 100 steps keep."""
    return float(np.median([v for s, v in series.items() if lo <= s <= hi and s % 100 == 0]))


def compare_with_jax(scalars: dict, qa: dict, iters: int) -> dict:
    """The figures of the port's run that the JAX run has, each beside the
    JAX figure, with its band and whether it holds. QA compares only a leg
    that ends at 10000, whose test renders are the 10k checkpoint's."""
    out: dict = {"iters": iters, "mse_windows": [], "within_bands": True}
    mse = scalars.get("train/MSE01", {})
    for (lo, hi), ref in JAX_MSE_WINDOWS.items():
        if not all(s in mse for s in range(lo, hi + 1, 100)):  # a window the run's log does not cover
            continue
        port = window_median(mse, lo, hi)
        ok = ref / BAND_MSE_FACTOR <= port <= ref * BAND_MSE_FACTOR
        out["mse_windows"].append({"steps": [lo, hi], "port": port, "jax": ref, "ratio": port / ref,
                                   "band_factor": BAND_MSE_FACTOR, "within": ok})
        out["within_bands"] &= ok
    out["mse_at"] = {s: {"port": mse.get(s), "jax": ref} for s, ref in JAX_MSE_AT.items() if s <= iters}
    lr = scalars.get("train/lr", {})
    for step, ref in JAX_LR.items():
        if step in lr:
            rel = abs(lr[step] - ref) / ref
            out[f"lr_{step}"] = {"port": lr[step], "jax": ref, "rel_diff": rel, "band_rel": BAND_LR_REL,
                                 "within": rel <= BAND_LR_REL}
            out["within_bands"] &= rel <= BAND_LR_REL
    if iters == 10000:
        val = scalars.get("validation/val_images/MSE01", {}).get(10000)
        train_images = scalars.get("validation/train_images/MSE01", {}).get(10000)
        out["val_mse_10k"] = {"port": val, "jax": JAX_VAL_MSE_10K}
        out["train_images_mse_10k"] = {"port": train_images, "jax": JAX_TRAIN_IMAGES_MSE_10K}
        scores = (qa or {}).get("predicted_frames", {})
        out["qa_10k"] = {k: {"port": scores.get(k), "jax": ref} for k, ref in JAX_QA_10K.items()}
        masked = scores.get("MaskedPSNR05")
        ok = masked is not None and abs(masked - JAX_QA_10K["MaskedPSNR05"]) <= BAND_MASKED_PSNR_DB
        out["qa_10k"]["MaskedPSNR05"].update(band_db=BAND_MASKED_PSNR_DB, within=ok)
        out["within_bands"] &= ok
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.run_dtu_control",
                                 description="demo1b on the synthetic DTU scan, held against the JAX run")
    ap.add_argument("--workdir", default="protocol_runs/dtu_control")
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--video_frames", type=int, default=20)
    ap.add_argument("--iters", type=int, default=50000, help="the last iteration of this leg")
    ap.add_argument("--seed", type=int, default=0, help="the training seed (a second seed gives the spread)")
    ap.add_argument("--device", default="all", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).absolute()
    write_dtu_database(workdir / "data/databases", set_num=SET_NUM, train_frames=TRAIN_FRAMES,
                       val_frames=VAL_FRAMES, height=args.height, width=args.width,
                       video_frames=args.video_frames, with_visibility_prior=False)

    t_gen = time.perf_counter()
    directions = main_visibility(["--database", "DTU", "--gen_nums", str(SET_NUM), "--root_dirpath", str(workdir),
                                  "--device", args.device])
    gen_wall = time.perf_counter() - t_gen
    print(f"DTU PRIOR GENERATION WALL CLOCK: {gen_wall:.1f}s ({len(TRAIN_FRAMES)} views)", flush=True)

    # demo1b's call, the scan list swapped for the synthetic scan
    leg = run_demo_leg(workdir, dtu, "DTU DEMO1B", train_num=TRAIN_NUM, set_num=SET_NUM, scene_ids=[21],
                       iters=args.iters, device=device_from_arg(args.device), seed=args.seed)
    scalars = read_scalars(workdir / f"runs/training/train{TRAIN_NUM:04}/{DTU_SCENE}/logs/scalars.jsonl")
    print("REFERENCE_COMPARISON:", json.dumps(compare_with_jax(scalars, leg.pop("qa"), args.iters)), flush=True)
    summary = {"seed": args.seed, "gen_wall_s": round(gen_wall, 1),
               "prior_s_per_direction": [d["seconds"] for d in directions],
               "prior_devices": sorted({d["device"] for d in directions}), **leg}
    print("SUMMARY:", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
