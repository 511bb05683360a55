"""The NeRF-LLFF protocol run on the port (counterpart of
tools/run_demo1a_200k.py): demo1a's surface (train 11, set02, 2 input
views, sparse depth, 2048 + 2048 rays, NDC, the visibility prior from 30k,
validation and checkpoints every 10k, 200k iterations) on the synthetic
LLFF-layout scene synth01 at the _down4 protocol size 756x1008, with train
views (0, 5), validation view 2 and the spiral video track of
`db_builders.nerf_llff.create_spiral_video_poses`.

Restart-safe, and run in legs of growing `--iters` (protocol/common.py).

    python -m vipnerf_tpu_torch.protocol.run_demo1a_200k --workdir W [--iters 200000] [--device cpu]
"""

import argparse
import json
from pathlib import Path

from vipnerf_tpu_torch.apps import nerf_llff
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.db_builders.nerf_llff import create_spiral_video_poses
from vipnerf_tpu_torch.protocol.common import DEVICE_HELP, run_demo_leg, write_database_once
from vipnerf_tpu_torch.utils.device import device_from_arg

TRAIN_NUM = 11  # demo1a's train and test number


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.run_demo1a_200k",
                                 description="demo1a on a synthetic NeRF-LLFF scene")
    ap.add_argument("--workdir", default="protocol_runs/demo1a_200k")
    ap.add_argument("--iters", type=int, default=200000, help="the last iteration of this leg")
    ap.add_argument("--height", type=int, default=756)
    ap.add_argument("--width", type=int, default=1008)
    ap.add_argument("--video_frames", type=int, default=30, help="spiral track length (demo1a's is 120)")
    ap.add_argument("--device", default="all", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).absolute()
    db_root = workdir / "data/databases"
    db_dir = db_root / "NeRF_LLFF/data"

    def write():
        write_synthetic_database(db_root, scene_name="synth01", num_frames=6, train_frames=(0, 5),
                                 val_frames=(2,), height=args.height, width=args.width,
                                 resolution_suffix="_down4")
        create_spiral_video_poses(db_dir, set_num=2, num_frames=args.video_frames)

    write_database_once(db_dir, "synthetic database", write)
    # demo1a's call, the scene list swapped for the synthetic scene
    leg = run_demo_leg(workdir, nerf_llff, "DEMO1A", train_num=TRAIN_NUM, set_num=2, scene_ids=["synth01"],
                       iters=args.iters, device=device_from_arg(args.device))
    print("SUMMARY:", json.dumps(leg), flush=True)
    return leg


if __name__ == "__main__":
    main()
