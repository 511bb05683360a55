"""Quality against iteration (counterpart of tools/checkpoint_sweep.py): the
test-only surface of demo4 (test, then QA) once per saved checkpoint
Model_Iter{it:06}.tar of a training run, every `--step` iterations up to
`--max_iter`, each into its own test directory test{base + it / step:04}
(test0901, test0902, ...), then the iteration -> scores table: one
`SWEEP_TABLE:` JSON line and the same as a Markdown table.

    python -m vipnerf_tpu_torch.protocol.checkpoint_sweep --workdir W --database DTU --scene 21 \\
        --set_num 3 --train_num 42 --step 10000 --max_iter 10000 [--device cpu]

Restart-safe: the tester skips the frames it has rendered, so a second
call does only the work left.
"""

import argparse
import json
import os
import time
from pathlib import Path

from vipnerf_tpu_torch.apps.configs import build_test_configs
from vipnerf_tpu_torch.protocol.common import DEVICE_HELP
from vipnerf_tpu_torch.utils.device import device_from_arg


def sweep(workdir: Path, *, database: str, scene: str, train_num: int, set_num: int, step: int,
          max_iter: int, test_num_base: int = 900, device="all") -> list:
    """Test and score every checkpoint; returns the table's rows."""
    if database == "NeRF_LLFF":
        from vipnerf_tpu_torch.apps.nerf_llff import ENTRY_NAME, app
        scene_key, res_suffix, scene_ids = "scene_names", "_down4", [scene]
    elif database == "RealEstate10K":
        from vipnerf_tpu_torch.apps.real_estate import ENTRY_NAME, app
        scene_key, res_suffix, scene_ids = "scene_nums", None, [int(scene)]
    else:
        from vipnerf_tpu_torch.apps.dtu import ENTRY_NAME, app
        scene_key, res_suffix, scene_ids = "scene_nums", None, [int(scene)]

    ckpt_dir = Path(workdir) / f"runs/training/train{train_num:04}"
    results = []
    for it in range(step, max_iter + 1, step):
        if not list(ckpt_dir.glob(f"*/saved_models/Model_Iter{it:06}.tar")):
            print(f"iter {it}: no checkpoint, skipping", flush=True)
            continue
        test_num = test_num_base + it // step
        t0 = time.perf_counter()
        test_configs = build_test_configs(
            entry_name=ENTRY_NAME,
            test_num=test_num,
            train_num=train_num,
            set_num=set_num,
            database=database,
            database_dirpath=f"{database}/data",
            num_iterations=it,
            scene_key=scene_key,
            scene_ids=scene_ids,
            resolution_suffix=res_suffix,
            device=device,
        )
        app.start_testing(test_configs)
        qa_path = Path(workdir) / f"runs/testing/test{test_num:04}/QA_Scores.json"
        scores = json.loads(qa_path.read_text()).get("predicted_frames", {}) if qa_path.exists() else {}
        results.append({"iter": it, "wall_s": round(time.perf_counter() - t0, 1), **scores})
        print(f"iter {it}: {scores} ({results[-1]['wall_s']}s)", flush=True)
    return results


def print_table(results: list) -> None:
    print("SWEEP_TABLE:", json.dumps(results), flush=True)
    if results:
        keys = [k for k in results[0] if k not in ("iter", "wall_s")]
        print("| iter | " + " | ".join(keys) + " |", flush=True)
        print("|---" * (len(keys) + 1) + "|", flush=True)
        for r in results:
            print("| " + str(r["iter"]) + " | " + " | ".join(str(r.get(k)) for k in keys) + " |", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.checkpoint_sweep",
                                 description="test and QA of every saved checkpoint of a run")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--train_num", type=int, default=11)
    ap.add_argument("--scene", default="synth01")
    ap.add_argument("--database", default="NeRF_LLFF", choices=["NeRF_LLFF", "RealEstate10K", "DTU"])
    ap.add_argument("--set_num", type=int, default=2)
    ap.add_argument("--step", type=int, default=10000)
    ap.add_argument("--max_iter", type=int, default=200000)
    ap.add_argument("--test_num_base", type=int, default=900)
    ap.add_argument("--device", default="all", help=DEVICE_HELP)
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).absolute()
    os.chdir(workdir)
    print_table(sweep(workdir, database=args.database, scene=args.scene, train_num=args.train_num,
                      set_num=args.set_num, step=args.step, max_iter=args.max_iter,
                      test_num_base=args.test_num_base, device=device_from_arg(args.device)))


if __name__ == "__main__":
    main()
