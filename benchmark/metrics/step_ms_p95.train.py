"""step_ms_p95.train: the 95th percentile, over the window's training steps,
of each step's interval on the device's stream, in ms: from the end of the
step before it in its chunk (a chunk's first step: from its own start) to
its own end, which follows its `train.adam` with nothing queued between,
as the program's tracer timed them (`vipnerf_tpu_torch/utils/tracing.py`:
`train.step` spans). The window's steps are the `steps` iterations just
before the last `trace_steps`; None without such spans."""

import numpy as np


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    steps = {s["attrs"]["it"]: s for s in tracing.snapshot()["spans"] if s["name"] == "train.step"}
    if not steps:
        return None
    end = max(steps) + 1 - c["trace_steps"]
    intervals = []
    for it in range(end - c["steps"], end):
        step, before = steps.get(it), steps.get(it - 1)
        if step is None or step["device_ms"] is None:
            return None
        same_chunk = before is not None and before["parent"] == step["parent"] and before["device_ms"]
        intervals.append(step["device_ms"][1] - (before["device_ms"][1] if same_chunk else step["device_ms"][0]))
    return float(np.quantile(intervals, 0.95, method="higher"))
