"""The RealEstate-10K protocol run on the port (counterpart of
tools/run_realestate_50k.py): demo1a's surface (train 1, set02, 2 input
views, sparse depth, 2048 + 2048 rays, NDC with recentring and bd_factor
0.75 over the loader's fixed [1, 100] bounds, RMSE/PSNR/SSIM/LPIPS QA) on
a synthetic RealEstate-layout scene 00000 at the extractor's 576x1024, with
train views (0, 5), validation view 2 and the original trajectory as its
video track (`db_builders.real_estate.create_original_video_poses`).

Restart-safe, and run in legs of growing `--iters` (protocol/common.py).

    python -m vipnerf_tpu_torch.protocol.run_realestate_50k --workdir W [--iters 50000] [--device cpu]
"""

import argparse
import json
from pathlib import Path

from vipnerf_tpu_torch.apps import real_estate
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.db_builders.real_estate import create_original_video_poses
from vipnerf_tpu_torch.protocol.common import DEVICE_HELP, run_demo_leg, write_database_once
from vipnerf_tpu_torch.utils.device import device_from_arg

TRAIN_NUM = 1  # demo1a's train and test number


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.run_realestate_50k",
                                 description="demo1a on a synthetic RealEstate-10K scene")
    ap.add_argument("--workdir", default="protocol_runs/re10k_50k")
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50000, help="the last iteration of this leg")
    ap.add_argument("--device", default="all", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).absolute()
    db_root = workdir / "data/databases"
    db_dir = db_root / "RealEstate10K/data"

    def write():
        # the default rig (cameras at radius 3 inside a shell of radius 6,
        # z-depths ~2-9) lies inside the loader's fixed bounds [1, 100]
        write_synthetic_database(db_root, dataset="RealEstate10K", scene_name="00000", num_frames=6,
                                 train_frames=(0, 5), val_frames=(2,), height=args.height, width=args.width)
        create_original_video_poses(db_dir, set_num=2)

    write_database_once(db_dir, "synthetic RealEstate database", write)
    # demo1a's call, the scene list swapped for the synthetic scene
    leg = run_demo_leg(workdir, real_estate, "REALESTATE DEMO1A", train_num=TRAIN_NUM, set_num=2, scene_ids=[0],
                       iters=args.iters, device=device_from_arg(args.device))
    print("SUMMARY:", json.dumps(leg), flush=True)
    return leg


if __name__ == "__main__":
    main()
