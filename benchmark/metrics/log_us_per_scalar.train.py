"""log_us_per_scalar.train: the host us the trainer's scalar logging takes
per scalar between the window's chunks: the `train.log` spans that follow
each window chunk with a window chunk after it (the pairs that
`chunk_boundary_ms.train` spans), their host time summed over the
`add_scalar` calls they made (the span's attribute `scalars`), as the
program's tracer recorded them (`vipnerf_tpu_torch/utils/tracing.py`).
The window's chunks are those of the `steps` iterations just before the
last `trace_steps`. None without such spans, or where a span carries no
`scalars` (a program that does not count them)."""


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    steps = [s["attrs"]["it"] for s in spans if s["name"] == "train.step"]
    if not steps:
        return None
    end = max(steps) + 1 - c["trace_steps"]
    chunks = sorted(s["attrs"]["it"] for s in spans if s["name"] == "train.chunk"
                    and end - c["steps"] <= s["attrs"]["it"] < end)
    logs = {s["attrs"]["it"]: s for s in spans if s["name"] == "train.log"}
    pairs = [logs.get(it) for it in chunks[:-1]]
    if not pairs or any(s is None or not s["attrs"].get("scalars") for s in pairs):
        return None
    return 1e-3 * sum(s["end_ns"] - s["start_ns"] for s in pairs) / sum(s["attrs"]["scalars"] for s in pairs)
