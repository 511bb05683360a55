"""trunk_bwd_ms_per_step.train: the median, over the window's training steps,
of the device-stream ms of the shipped mode's trunk backward (the spans
`k1.trunk_backward`: the trunk's recompute and its eight layers'
gradients, summed over the step's levels and sub-batches), as the program's
tracer timed it (`vipnerf_tpu_torch/utils/tracing.py`). The spans open in
autograd's device thread, so a span belongs to the step whose host interval
holds it. The window's steps are the `steps` iterations just before the
last `trace_steps`. None without such spans (a program that does not
record them)."""

import bisect

import numpy as np

SPAN = "k1.trunk_backward"


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    steps = sorted((s["start_ns"], s["end_ns"], s["attrs"]["it"]) for s in spans if s["name"] == "train.step")
    ours = [s for s in spans if s["name"] == SPAN]
    if not steps or not ours:
        return None
    starts = [s[0] for s in steps]
    per_step = {}
    for s in ours:
        if s["device_ms"] is None or s["device_ms"][0] is None:
            return None
        i = bisect.bisect_right(starts, s["start_ns"]) - 1  # the last step that began before it
        if i >= 0 and s["end_ns"] <= steps[i][1]:
            it = steps[i][2]
            per_step[it] = per_step.get(it, 0.0) + s["device_ms"][1] - s["device_ms"][0]
    end = max(s[2] for s in steps) + 1 - c["trace_steps"]
    window = [per_step.get(it) for it in range(end - c["steps"], end)]
    if any(v is None for v in window):
        return None
    return float(np.median(window))
