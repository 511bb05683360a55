"""The reader of `log_us_per_scalar.train` on tracer snapshots built by hand:
the host time of the `train.log` spans between consecutive window chunks
over the scalars they logged (their attribute `scalars`); the last window
chunk's log (where the window closes and the trace begins) and the traced
chunks' are left out; None with fewer than two window chunks, where a span
carries no `scalars` (a program that does not count them), without the
spans, and where the program has no tracer."""

import sys

import pytest

from harness import cells

MS = 1_000_000  # ns per ms
READ = cells.reader("log_us_per_scalar.train")


def snapshot(chunks=4, steps=5, log_ms=(2.0, 3.0, 5.0, 7.0), scalars=(60, 60, 60, 60)):
    """`chunks` chunks of `steps` steps from iteration 30000; after chunk c
    its `train.log` takes log_ms[c] host ms and logs scalars[c] scalars
    (None: no attribute)."""
    spans, ids, t = [], [0], 0.0

    def add(name, start, end, parent=None, **attrs):
        ids[0] += 1
        spans.append({"name": name, "id": ids[0], "parent": parent, "start_ns": int(start * MS),
                      "end_ns": int(end * MS), "attrs": attrs, "device_ms": None})
        return ids[0]

    for c in range(chunks):
        first = 30000 + c * steps
        chunk = add("train.chunk", t, t + steps + 1, it=first, steps=steps)
        for j in range(steps):
            add("train.step", t + j, t + j + 1, chunk, it=first + j)
        add("train.chunk.read", t + steps, t + steps + 1, chunk)
        t += steps + 1
        attrs = {"it": first} if scalars[c] is None else {"it": first, "scalars": scalars[c]}
        add("train.log", t, t + log_ms[c], **attrs)
        t += log_ms[c]
    return {"spans": spans, "counts": {}}


@pytest.fixture
def tracer(monkeypatch):
    from vipnerf_tpu_torch.utils import tracing

    holder = {}
    monkeypatch.setattr(tracing, "snapshot", lambda: holder["snapshot"])
    return holder


def run(steps, trace_steps):
    return {"counts": {"kind": "train", "steps": steps, "trace_steps": trace_steps}}


@pytest.mark.parametrize("steps, trace_steps, want_us", [
    (10, 5, 1e3 * 3.0 / 60),  # window chunks 1-2, chunk 3 traced: chunk 1's log alone
    (15, 5, 1e3 * (2.0 + 3.0) / 120),  # window chunks 0-2: the logs of chunks 0 and 1
    (15, 0, 1e3 * (3.0 + 5.0) / 120),  # no traced chunk: window chunks 1-3
])
def test_the_logs_between_window_chunks_over_their_scalars(tracer, steps, trace_steps, want_us):
    tracer["snapshot"] = snapshot()
    assert READ(run(steps, trace_steps)) == pytest.approx(want_us)


def test_logs_of_unequal_size_weigh_by_their_scalars(tracer):
    tracer["snapshot"] = snapshot(log_ms=(1.0, 4.0, 2.0, 9.0), scalars=(20, 80, 40, 10))
    assert READ(run(15, 5)) == pytest.approx(1e3 * (1.0 + 4.0) / 100)


@pytest.mark.parametrize("snap, counts", [
    ({"scalars": (None, None, None, None)}, (15, 5)),  # a program that does not count its scalars
    ({"scalars": (60, None, 60, 60)}, (15, 5)),  # one log of the window without them
    ({}, (5, 5)),  # one window chunk: no log between two
    ({"chunks": 0}, (10, 5)),  # no spans
])
def test_reads_none_without_logs_that_carry_their_scalars(tracer, snap, counts):
    tracer["snapshot"] = snapshot(**snap)
    assert READ(run(*counts)) is None


def test_a_render_run_or_no_window_reads_none(tracer):
    tracer["snapshot"] = snapshot()
    assert READ({"counts": {"kind": "render", "frames": 4, "trace_frames": 1}}) is None
    assert READ(run(0, 5)) is None
    assert READ({}) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    import vipnerf_tpu_torch.utils

    monkeypatch.delattr(vipnerf_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "vipnerf_tpu_torch.utils.tracing", None)
    assert READ(run(10, 5)) is None
