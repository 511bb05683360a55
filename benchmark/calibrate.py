"""The readings that the limits of a cell's check are set from, in one
process on the GPU: the program on a dozen seeds or more, the control (the
program in the lower-precision mode the configuration does not state,
`f32_heads: false`, the bf16-heads instance of K1) and each fault planted
under the timed path, each on its own seeds, by default without a window
(training stops after its warm chunk, which holds the checked steps):

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control 3 \\
        --fault half_batch=3 --fault state_unchanged=3

One JSON line per run: what ran, its seed and every number the check
reads. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import cells, common  # noqa: E402

CONTROL = {"f32_heads": False}
SEED_BASE = 3_000_000_000


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", action="append", default=[], help="name=count")
    p.add_argument("--seconds", type=float, default=-1.0,
                   help="the window; below 0, none (a training run stops after its warm chunks)")
    p.add_argument("--first-seed", type=int, default=SEED_BASE)
    args = p.parse_args(argv)
    common.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    device = torch.device("cuda", 0)
    plan = [("program", None, None, args.seeds), ("control", None, CONTROL, args.control)]
    for spec in args.fault:
        name, count = spec.split("=")
        plan.append((f"fault:{name}", name, None, int(count)))
    seed = args.first_seed
    for label, fault, overrides, count in plan:
        for _ in range(count):
            t0 = time.perf_counter()
            result = cells.run_cell(bench, cell, seed, args.seconds, False, device, t0, fault, overrides)
            print(json.dumps({"run": label, "seed": seed, "numbers": result["checks"]["numbers"],
                              "detail": result["checks"]["detail"], "setup_s": result["setup_s"],
                              "seconds": time.perf_counter() - t0}), flush=True)
            seed += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
