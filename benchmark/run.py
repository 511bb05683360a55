"""One run of one cell of the benchmark of `vipnerf_tpu_torch` on the
NVIDIA GPU(s) of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs CUDA and as many devices as the cell asks for; without them it
exits non-zero and prints no result (it never runs on the CPU). Set-up
builds what the cell uses, makes its inputs and weights from the seed and
warms up; the window measures for `--seconds`; the check compares what the
window produced with the plain reference. The last line of standard output
is the result as JSON; the numbers compared, each beside its limit, are the
last lines of standard error and the result's last key.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import cells, common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    common.prepare_environment()
    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA device(s); this machine has {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = cells.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), device, T0)
    line = cells.result_line(bench, cell, result, bool(args.trace))
    found = common.forbidden_modules_loaded()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print(cells.window_line(result), file=sys.stderr)
    print("\n".join(cells.check_lines(result, line)), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
