"""sec_views_ms_per_step.train: the median, over the window's training steps,
of the device-stream ms of the step's secondary-view geometry (the spans
`rays.<level>.sec_dirs` inside the step's render: the other views' origins
and their directions to the samples, summed over levels and sub-batches),
as the program's tracer timed it (`vipnerf_tpu_torch/utils/tracing.py`).
The window's steps are the `steps` iterations just before the last
`trace_steps`. None where the tracer's counter `vis.sec_view_points` shows
that no point went through K1's view branch for another view, or without
such spans (a program that does not record them)."""

import numpy as np

COUNTER = "vis.sec_view_points"


def _is_sec_span(name: str) -> bool:
    return name.startswith("rays.") and name.endswith(".sec_dirs")


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    snap = tracing.snapshot()
    if not snap.get("counts", {}).get(COUNTER):
        return None
    spans = snap["spans"]
    steps = {s["attrs"]["it"]: s["id"] for s in spans if s["name"] == "train.step"}
    if not steps:
        return None
    parent = {s["id"]: s["parent"] for s in spans}
    step_ids = set(steps.values())
    per_step = {}
    for s in spans:
        if not _is_sec_span(s["name"]):
            continue
        if s["device_ms"] is None or s["device_ms"][0] is None:
            return None
        up = s["parent"]
        while up is not None and up not in step_ids:
            up = parent.get(up)
        if up is not None:
            per_step[up] = per_step.get(up, 0.0) + s["device_ms"][1] - s["device_ms"][0]
    end = max(steps) + 1 - c["trace_steps"]
    window = [per_step.get(steps.get(it)) for it in range(end - c["steps"], end)]
    if any(v is None for v in window):
        return None
    return float(np.median(window))
