"""Snapshot a protocol run's evidence for committing (counterpart of
tools/evidence_snapshot.py, whose output it writes byte for byte): each
test directory's QA_Scores.json, Configs.json and frame- and scene-wise
CSVs; each scene's logs/scalars.jsonl cut to every Nth step plus every
validation/* line and the first and last step of each tag; each training
run's Configs.json as TrainConfigs_train{NNNN}.json.

    python -m vipnerf_tpu_torch.protocol.evidence_snapshot <run_root> <out_dir> [--stride 100]

<run_root> is the directory holding runs/{training,testing}.
"""

import argparse
import json
import shutil
from pathlib import Path


def downsample_scalars(src: Path, dst: Path, stride: int) -> int:
    """Keep validation/* lines and train lines whose step % stride == 0
    (plus the first and last step seen per tag)."""
    kept = 0
    last_lines = {}
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            tag, step = rec.get("tag", ""), rec.get("step", 0)
            last_lines[tag] = line
            if tag.startswith("validation") or step % stride == 0 or step == 1:
                out.write(line)
                kept += 1
                last_lines.pop(tag, None)
        # final step per tag, if not already a multiple of stride
        for line in last_lines.values():
            out.write(line)
            kept += 1
    return kept


def snapshot(run_root: Path, out_dir: Path, stride: int) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    for qa_json in sorted(run_root.glob("runs/testing/*/QA_Scores.json")):
        test_dir = qa_json.parent
        dst = out_dir / test_dir.name
        dst.mkdir(parents=True, exist_ok=True)
        shutil.copy2(qa_json, dst / "QA_Scores.json")
        if (test_dir / "Configs.json").exists():
            shutil.copy2(test_dir / "Configs.json", dst / "Configs.json")
        qa_dir = test_dir / "QA_Scores"
        if qa_dir.exists():
            shutil.copytree(qa_dir, dst / "QA_Scores", dirs_exist_ok=True)
        print(f"QA snapshot: {dst}")
    for scalars in sorted(run_root.glob("runs/training/*/*/logs/scalars.jsonl")):
        scene = scalars.parent.parent.name
        train = scalars.parent.parent.parent.name
        dst = out_dir / f"scalars_{train}_{scene}_every{stride}.jsonl"
        kept = downsample_scalars(scalars, dst, stride)
        print(f"scalars snapshot: {dst} ({kept} lines)")
    for cfg in sorted(run_root.glob("runs/training/*/Configs.json")):
        train = cfg.parent.name
        dst = out_dir / f"TrainConfigs_{train}.json"
        shutil.copy2(cfg, dst)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.protocol.evidence_snapshot",
                                     description="snapshot a run's evidence for committing")
    parser.add_argument("run_root", type=Path)
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--stride", type=int, default=100)
    args = parser.parse_args(argv)
    snapshot(args.run_root, args.out_dir, args.stride)


if __name__ == "__main__":
    main()
