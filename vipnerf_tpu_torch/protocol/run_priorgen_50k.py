"""The prior-generation protocol run on the port (counterpart of
tools/run_priorgen_50k.py): the visibility prior generated at protocol size
on the card, checked against the scene's exact geometry, then consumed by a
demo1a-shaped run.

Stages, each restart-safe (protocol/common.py):
1. a synthetic LLFF database synth01 at 756x1008 under _down4 WITHOUT the
   writer's visibility prior (its true depths and cameras kept in
   gt_geometry.npz), with the spiral video track;
2. VW02 from the port's generator (`priors.cli.main_visibility`: LLFF's
   policy, 64 inverse-depth planes from DepthBounds.csv, both directions of
   each train pair, temperature 10);
3. each generated mask against the exact cross-view visibility of the true
   depths and poses (`MASK_GEOMETRY_STATS:`): it must not be degenerate and
   must agree at least as well as the best constant predictor, less 0.02;
4. `apps.nerf_llff._run_full` with demo1a's arguments and `--iters`
   iterations, the prior loss from 30k reading the generated masks;
5. with `--sweep`, test and QA of every 10k checkpoint (checkpoint_sweep).

    python -m vipnerf_tpu_torch.protocol.run_priorgen_50k --workdir W [--iters 50000] [--sweep] [--device cpu]
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

from vipnerf_tpu_torch.apps import nerf_llff
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.db_builders.nerf_llff import create_spiral_video_poses
from vipnerf_tpu_torch.priors.cli import main_visibility
from vipnerf_tpu_torch.protocol.common import DEVICE_HELP, read_scalars, run_demo_leg, write_database_once
from vipnerf_tpu_torch.utils.device import device_from_arg
from vipnerf_tpu_torch.utils.io import read_mask

TRAIN_FRAMES = (0, 5)


def geometric_visibility(depth1, w2c1, k1, depth2, w2c2, k2, tol=0.03):
    """Exact visibility of frame 1's pixels in frame 2: each pixel lifted
    to 3D with its true depth and projected into frame 2 is visible iff it
    lands in the frame and is not occluded (frame 2's true depth at the
    landing pixel is at least the point's camera-2 depth, within `tol`
    relative and 0.01 absolute)."""
    h, w = depth1.shape
    x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64), indexing="xy")
    pix = np.stack([x, y, np.ones_like(x)], axis=-1)
    pts_cam1 = depth1[..., None] * (pix @ np.linalg.inv(k1).T)
    c2w1 = np.linalg.inv(w2c1)
    pts_world = pts_cam1 @ c2w1[:3, :3].T + c2w1[:3, 3]
    cam2 = pts_world @ w2c2[:3, :3].T + w2c2[:3, 3]
    z2 = cam2[..., 2]
    proj = cam2 @ k2.T
    xy2 = proj[..., :2] / np.maximum(proj[..., 2:3], 1e-9)
    in_frame = ((z2 > 0) & (xy2[..., 0] >= 0) & (xy2[..., 0] <= w - 1)
                & (xy2[..., 1] >= 0) & (xy2[..., 1] <= h - 1))
    xi = np.clip(np.round(xy2[..., 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(xy2[..., 1]).astype(int), 0, h - 1)
    d2 = depth2[yi, xi]
    return in_frame & (z2 <= d2 * (1 + tol) + 0.01)


def check_masks(db_dir: Path, gt_path: Path, train_frames) -> dict:
    """Each generated VW02 mask against the geometric truth; returns the
    statistics of each direction and raises on a degenerate or inconsistent
    mask."""
    gt = np.load(gt_path)
    depths, extr, intr = gt["depths"], gt["extrinsics"], gt["intrinsics"]
    vis_dir = db_dir / "all/visibility_prior/VW02/synth01/visibility_masks"
    stats = {}
    for f1 in train_frames:
        for f2 in train_frames:
            if f1 == f2:
                continue
            mask = read_mask(vis_dir / f"{f1:04}_{f2:04}.png")
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = mask > 0
            gt_vis = geometric_visibility(depths[f1], extr[f1], intr[f1], depths[f2], extr[f2], intr[f2])
            agree = float(np.mean(mask == gt_vis))
            # precision and recall, the geometrically visible pixels the positive class
            tp = float(np.sum(mask & gt_vis))
            prec = tp / max(float(np.sum(mask)), 1.0)
            rec = tp / max(float(np.sum(gt_vis)), 1.0)
            const_best = max(float(np.mean(gt_vis)), 1 - float(np.mean(gt_vis)))
            name = f"{f1:04}_{f2:04}"
            stats[name] = {
                "agreement": round(agree, 4),
                "precision": round(prec, 4),
                "recall": round(rec, 4),
                "mask_mean": round(float(np.mean(mask)), 4),
                "gt_visible_mean": round(float(np.mean(gt_vis)), 4),
                "const_predictor": round(const_best, 4),
            }
            print(f"  mask {name}: {stats[name]}", flush=True)
            if not 0.02 < float(np.mean(mask)) < 0.995:
                raise AssertionError("generated mask is degenerate (all-ones/all-zeros)")
            if not agree > const_best - 0.02:
                raise AssertionError(f"mask agreement {agree:.3f} does not beat the constant predictor "
                                     f"{const_best:.3f}: the generator's output disagrees with the geometry")
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.run_priorgen_50k",
                                 description="generated visibility prior, checked, then demo1a on it")
    ap.add_argument("--workdir", default="protocol_runs/priorgen_50k")
    ap.add_argument("--iters", type=int, default=50000, help="the last iteration of this leg")
    ap.add_argument("--height", type=int, default=756)
    ap.add_argument("--width", type=int, default=1008)
    ap.add_argument("--train_num", type=int, default=11)
    ap.add_argument("--video_frames", type=int, default=30)
    ap.add_argument("--sweep", action="store_true", help="test and QA of every 10k checkpoint after training")
    ap.add_argument("--device", default="all", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).absolute()
    db_root = workdir / "data/databases"
    db_dir = db_root / "NeRF_LLFF/data"
    gt_path = workdir / "gt_geometry.npz"
    device = device_from_arg(args.device)

    def write():
        gt = write_synthetic_database(db_root, scene_name="synth01", num_frames=6, train_frames=TRAIN_FRAMES,
                                      val_frames=(2,), height=args.height, width=args.width,
                                      resolution_suffix="_down4", with_visibility_prior=False)
        np.savez_compressed(gt_path, depths=gt["depths"], extrinsics=gt["extrinsics"],
                            intrinsics=gt["intrinsics"])
        create_spiral_video_poses(db_dir, set_num=2, num_frames=args.video_frames)

    write_database_once(db_dir, "synthetic database (no hand-written priors)", write)
    hand_dir = db_dir / "all/visibility_prior/VW02/synth01"
    print(f"hand-written priors present: {hand_dir.exists()}", flush=True)

    t1 = time.perf_counter()
    directions = main_visibility(["--database", "NeRF_LLFF", "--gen_nums", "2", "--root_dirpath", str(workdir),
                                  "--device", args.device])
    gen_wall = time.perf_counter() - t1
    n_pairs = len(TRAIN_FRAMES) * (len(TRAIN_FRAMES) - 1) // 2
    print(f"PRIOR GENERATION WALL CLOCK: {gen_wall:.1f}s ({n_pairs} unordered pairs, both directions each)",
          flush=True)

    stats = check_masks(db_dir, gt_path, TRAIN_FRAMES)
    print("MASK_GEOMETRY_STATS:", json.dumps(stats), flush=True)

    leg = run_demo_leg(workdir, nerf_llff, "PRIORGEN DEMO1A", train_num=args.train_num, set_num=2,
                       scene_ids=["synth01"], iters=args.iters, device=device)

    # the prior loss after 30k, against the generated masks
    vpl = read_scalars(workdir / f"runs/training/train{args.train_num:04}/synth01/logs/scalars.jsonl").get(
        "train/VisibilityPriorLoss01", {})
    post = sorted((s, v) for s, v in vpl.items() if s >= 30000)
    if post:
        print(f"VPL@30k={post[0][1]:.4f} VPL@end={post[-1][1]:.4f} (steps {post[0][0]}..{post[-1][0]})", flush=True)

    if args.sweep:
        from vipnerf_tpu_torch.protocol.checkpoint_sweep import print_table, sweep

        print_table(sweep(workdir, database="NeRF_LLFF", scene="synth01", train_num=args.train_num, set_num=2,
                          step=10000, max_iter=args.iters, device=device))

    summary = {"gen_wall_s": round(gen_wall, 1), "prior_s_per_direction": [d["seconds"] for d in directions],
               **leg}
    print("SUMMARY:", json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
