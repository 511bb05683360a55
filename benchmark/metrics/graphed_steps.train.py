"""graphed_steps.train: the share, in %, of the window's training steps that
ran as a replay of the step's CUDA graph, as the program's tracer recorded
them (`vipnerf_tpu_torch/utils/tracing.py`): a replayed step's `train.step`
span carries the attribute `graph` (`vipnerf_tpu_torch/train/step.py`
`GraphedStep`). The window's steps are the `steps` iterations just before
the last `trace_steps`. 0 for a program whose steps carry no such
attribute; None without the window's step spans."""


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
    window = [steps.get(it) for it in range(end - c["steps"], end)]
    if any(s is None for s in window):
        return None
    return 100.0 * sum(bool(s["attrs"].get("graph")) for s in window) / len(window)
