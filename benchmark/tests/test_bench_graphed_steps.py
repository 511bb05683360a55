"""The reader of `graphed_steps.train` (`metrics/graphed_steps.train.py`) on
tracer snapshots built by hand: the share of the window's steps whose
`train.step` span carries `graph`, the traced steps left out, 0 for a
program whose steps carry no such attribute, None where the window's step
spans are missing."""

import pytest

from harness import cells


def step_spans(first, n, graphed=()):
    """`n` `train.step` spans from iteration `first`, those in `graphed`
    marked as replays of the step's graph."""
    spans = []
    for i, it in enumerate(range(first, first + n)):
        attrs = {"it": it, **({"graph": True} if it in graphed else {})}
        spans.append({"name": "train.step", "id": i + 1, "parent": None, "start_ns": i, "end_ns": i + 1,
                      "attrs": attrs, "device_ms": None})
    return spans


@pytest.fixture
def tracer(monkeypatch):
    """The program's tracer, its snapshot replaced by one built here."""
    from vipnerf_tpu_torch.utils import tracing

    holder = {}
    monkeypatch.setattr(tracing, "snapshot", lambda: holder["snapshot"])
    return holder


def train_run(steps, trace_steps):
    return {"counts": {"kind": "train", "steps": steps, "trace_steps": trace_steps}}


@pytest.mark.parametrize("graphed, share", [
    ((), 0.0),  # the parent: no step carries `graph`
    (set(range(30000, 30020)) - {30005, 30010}, 80.0),  # two eager steps in the window
    (set(range(30015, 30020)), 0.0),  # only the traced steps are replays
    (set(range(30000, 30020)), 100.0),
])
def test_graphed_steps_is_the_share_of_window_steps_replayed(tracer, graphed, share):
    tracer["snapshot"] = {"spans": step_spans(30000, 20, graphed), "counts": {}}
    run = train_run(10, 5)  # the window: iterations 30005-30014
    assert cells.reader("graphed_steps.train")(run) == pytest.approx(share)


@pytest.mark.parametrize("spans, run", [
    (step_spans(30000, 20), train_run(25, 0)),  # a step of the window missing
    ([], train_run(10, 5)),  # no step spans at all
    (step_spans(30000, 20), {"counts": {"kind": "render", "frames": 4}}),
    (step_spans(30000, 20), {"counts": {"kind": "train", "steps": 0, "trace_steps": 0}}),
])
def test_graphed_steps_reads_none_without_the_window_steps(tracer, spans, run):
    tracer["snapshot"] = {"spans": spans, "counts": {}}
    assert cells.reader("graphed_steps.train")(run) is None
