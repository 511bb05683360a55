"""frame_host_ms.render: the median, over the window's frames, of a frame's
host ms at its two ends, `render.prepare` (the frame's rays) plus
`render.outputs` (its outputs rearranged on the host), as the program's
tracer recorded them (`vipnerf_tpu_torch/utils/tracing.py`): both follow
the previous copy to the host, when the device's queue is empty. The
window's frames are the `frames` frames just before the last
`trace_frames`; None without such spans."""

import numpy as np


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "render" or not c.get("frames"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    frames = {s["attrs"]["frame"]: s["id"] for s in spans if s["name"] == "render.frame"}
    if not frames:
        return None
    ends = {}
    for s in spans:
        if s["name"] in ("render.prepare", "render.outputs"):
            ends[s["parent"]] = ends.get(s["parent"], 0) + s["end_ns"] - s["start_ns"]
    last = max(frames) + 1 - c["trace_frames"]
    window = [ends.get(frames.get(f)) for f in range(last - c["frames"], last)]
    if any(v is None for v in window):
        return None
    return 1e-6 * float(np.median(window))
