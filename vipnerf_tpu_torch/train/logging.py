"""Training scalars as JSON lines (counterpart of vipnerf_tpu/train/logging.py
`ScalarLogger`, without TensorBoard): one record
{"tag": ..., "value": ..., "step": ...} per scalar in logs/scalars.jsonl."""

import json
from pathlib import Path
from typing import Dict


class ScalarLogger:
    def __init__(self, logs_dirpath: Path):
        self.logs_dirpath = Path(logs_dirpath)
        self.logs_dirpath.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logs_dirpath / "scalars.jsonl", "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")

    def add_scalars(self, prefix: str, scalars: Dict[str, float], step: int):
        for key, value in scalars.items():
            self.add_scalar(f"{prefix}/{key}", value, step)

    def flush(self):
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
