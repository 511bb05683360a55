"""chunk_boundary_ms.train: the host ms between one training chunk and the
next, averaged over consecutive pairs of the window's chunks: from the end
of a chunk's `train.chunk.read` (its loss scalars on the host) to the start
of the next chunk's first `train.step`, as the program's tracer recorded
them (`vipnerf_tpu_torch/utils/tracing.py`). It covers the scalars'
logging, the next index draw and its copy, while the device has nothing
queued. The window's chunks are those of the `steps` iterations just before
the last `trace_steps`, so the boundary into the traced chunk is left out;
None without such spans."""


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    try:
        from vipnerf_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    steps = [s for s in spans if s["name"] == "train.step"]
    if not steps:
        return None
    end = max(s["attrs"]["it"] for s in steps) + 1 - c["trace_steps"]
    chunks = sorted((s for s in spans if s["name"] == "train.chunk"
                     and end - c["steps"] <= s["attrs"]["it"] < end), key=lambda s: s["attrs"]["it"])
    reads = {s["parent"]: s for s in spans if s["name"] == "train.chunk.read"}
    firsts = {}
    for s in steps:
        if s["parent"] not in firsts or s["start_ns"] < firsts[s["parent"]]["start_ns"]:
            firsts[s["parent"]] = s
    gaps = [firsts[b["id"]]["start_ns"] - reads[a["id"]]["end_ns"] for a, b in zip(chunks, chunks[1:])
            if a["id"] in reads and b["id"] in firsts]
    if not gaps or len(gaps) != len(chunks) - 1:
        return None
    return 1e-6 * sum(gaps) / len(gaps)
