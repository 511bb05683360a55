"""forward_ms_per_step.train: the median, over the window's training steps,
of the device-stream ms of the step's render (`train.forward`, summed over
its sub-batches), as the program's tracer timed it
(`vipnerf_tpu_torch/utils/tracing.py`). The window's steps are the `steps`
iterations just before the last `trace_steps`; None without such spans.
`backward_ms_per_step.train` is this reader on `train.backward`."""

import numpy as np

PHASE = "train.forward"


def read(run, phase=PHASE):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    steps = {s["attrs"]["it"]: s["id"] for s in spans if s["name"] == "train.step"}
    if not steps:
        return None
    per_step = {}
    for s in spans:
        if s["name"] == phase:
            if s["device_ms"] is None:
                return None
            per_step[s["parent"]] = per_step.get(s["parent"], 0.0) + s["device_ms"][1] - s["device_ms"][0]
    end = max(steps) + 1 - c["trace_steps"]
    window = [per_step.get(steps.get(it)) for it in range(end - c["steps"], end)]
    if any(v is None for v in window):
        return None
    return float(np.median(window))
