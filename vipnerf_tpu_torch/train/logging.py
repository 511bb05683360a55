"""Training scalars (counterpart of vipnerf_tpu/train/logging.py
`ScalarLogger`): one record {"tag": ..., "value": ..., "step": ...} per
scalar in logs/scalars.jsonl, always; and, as the JAX package does, the same
scalars and a wall-time text tag per group as TensorBoard events in logs/
where `torch.utils.tensorboard` imports (it needs the tensorboard package;
where that is missing, the JSON lines are the record).
`export_plots` draws each series to a PNG where matplotlib is installed."""

import collections
import datetime
import json
from pathlib import Path
from typing import Dict, Optional


class ScalarLogger:
    def __init__(self, logs_dirpath: Path):
        self.logs_dirpath = Path(logs_dirpath)
        self.logs_dirpath.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logs_dirpath / "scalars.jsonl", "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(self.logs_dirpath.as_posix())

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, prefix: str, scalars: Dict[str, float], step: int):
        if self._tb is not None:
            now = datetime.datetime.now().strftime("%d/%m/%Y %I:%M:%S %p")
            self._tb.add_text(f"{prefix}/Time", now, step)
        for key, value in scalars.items():
            self.add_scalar(f"{prefix}/{key}", value, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """The logger of a rank that does not write (rank 0 writes the run's
    scalars)."""

    def add_scalar(self, tag: str, value: float, step: int):
        pass

    def add_scalars(self, prefix: str, scalars: Dict[str, float], step: int):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def export_plots(logs_dirpath: Path, save_dirpath: Optional[Path] = None):
    """Plot every series of logs/scalars.jsonl to {prefix}_{name}.png in
    `save_dirpath` (default: the logs dir). Needs matplotlib, which the GPU
    machine does not have: there it raises ImportError, and the scalars stay
    readable in scalars.jsonl."""
    logs_dirpath = Path(logs_dirpath)
    jsonl = logs_dirpath / "scalars.jsonl"
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            f"export_plots needs matplotlib, which is not installed (the GPU machine has none); "
            f"the logged scalars are in {jsonl}, one JSON record per line"
        ) from e
    matplotlib.use("Agg")
    from matplotlib import pyplot

    save_dirpath = Path(save_dirpath) if save_dirpath else logs_dirpath
    if not jsonl.exists():
        return
    series = collections.defaultdict(list)
    for line in jsonl.read_text().splitlines():
        rec = json.loads(line)
        series[rec["tag"]].append((rec["step"], rec["value"]))
    for tag, points in series.items():
        points.sort()
        prefix, *rest = tag.split("/")
        pyplot.figure()
        pyplot.plot([p[0] for p in points], [p[1] for p in points])
        pyplot.title(tag)
        pyplot.savefig(save_dirpath / f"{prefix}_{'_'.join(rest)}.png")
        pyplot.close()
