"""The DTU protocol run on the port (counterpart of tools/run_dtu_50k.py):
demo1a's surface (train 41, set02, 2 input views, sparse depth, 2048 + 2048
rays, metric-space sampling within the loader's fixed [0.1, 5] bounds, the
masked QA over ObjectMasks) on the seeded synthetic DTU scan at 300x400,
with train views (0, 5) and validation view 2: the 2-view twin of
run_dtu_control.py on the identical scene. Its VW02 prior is the
database writer's, as in the JAX run.

Restart-safe, and run in legs of growing `--iters` (protocol/common.py).

    python -m vipnerf_tpu_torch.protocol.run_dtu_50k --workdir W [--iters 50000] [--device cpu]
"""

import argparse
import json
from pathlib import Path

from vipnerf_tpu_torch.apps import dtu
from vipnerf_tpu_torch.protocol.common import DEVICE_HELP, run_demo_leg, write_dtu_database
from vipnerf_tpu_torch.utils.device import device_from_arg

SET_NUM = 2
TRAIN_NUM = 41  # demo1a's train and test number


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.run_dtu_50k",
                                 description="demo1a on the synthetic DTU scan")
    ap.add_argument("--workdir", default="protocol_runs/dtu_50k")
    ap.add_argument("--height", type=int, default=300)
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--video_frames", type=int, default=20)
    ap.add_argument("--iters", type=int, default=50000, help="the last iteration of this leg")
    ap.add_argument("--device", default="all", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).absolute()
    write_dtu_database(workdir / "data/databases", set_num=SET_NUM, train_frames=(0, 5), val_frames=(2,),
                       height=args.height, width=args.width, video_frames=args.video_frames,
                       with_visibility_prior=True)
    # demo1a's call, the scan list swapped for the synthetic scan
    leg = run_demo_leg(workdir, dtu, "DTU DEMO1A", train_num=TRAIN_NUM, set_num=SET_NUM, scene_ids=[21],
                       iters=args.iters, device=device_from_arg(args.device))
    print("SUMMARY:", json.dumps(leg), flush=True)
    return leg


if __name__ == "__main__":
    main()
