"""The readers of the per-layer metrics that come from the program's spans
(`metrics/step_ms_p95.train.py`, `forward_ms_per_step.train.py`,
`backward_ms_per_step.train.py`, `chunk_boundary_ms.train.py`,
`frame_host_ms.render.py`), on tracer snapshots built by hand with known
intervals: each selects the window's steps or frames by their attributes
and the run's counts, leaves the traced ones out, and reads None where the
program recorded no such spans."""

import numpy as np
import pytest
import torch

from bench_support import SEED, tiny_config, tiny_mix
from harness import cells, render

MS = 1_000_000  # ns per ms


class Snapshot:
    """Spans as the program's tracer records them."""

    def __init__(self):
        self.spans, self.ids = [], 0

    def add(self, name, start_ms, end_ms, parent=None, device_ms=None, **attrs):
        self.ids += 1
        self.spans.append({"name": name, "id": self.ids, "parent": parent, "start_ns": int(start_ms * MS),
                           "end_ns": int(end_ms * MS), "attrs": attrs, "device_ms": device_ms})
        return self.ids


def training_snapshot(chunks=4, steps=5, boundary_ms=(7.0, 9.0, 11.0, 13.0)):
    """`chunks` chunks of `steps` steps from iteration 30000: step j of a
    chunk takes 10 + j ms on the device (forward 3 + j, backward 4 ms), the
    device starts each chunk 0.5 ms after the host; chunk c's boundary into
    the next is boundary_ms[c] ms of host time."""
    snap, t = Snapshot(), 0.0
    for c in range(chunks):
        first = 30000 + c * steps
        chunk = snap.add("train.chunk", t, 0, it=first, steps=steps)
        snap.add("train.chunk.indices", t, t + 1, chunk)
        snap.add("train.chunk.copy", t + 1, t + 2, chunk)
        host = dev = t + 2
        dev += 0.5
        for j in range(steps):
            # the program times a step's start only for its chunk's first
            step = snap.add("train.step", host, host + 1, chunk, [dev if j == 0 else None, dev + 10 + j],
                            it=first + j)
            snap.add("train.gather", host, host + 0.1, step)
            snap.add("train.forward", host, host + 0.2, step, [dev + 1, dev + 4 + j])
            snap.add("train.losses", host, host + 0.3, step)
            snap.add("train.backward", host, host + 0.4, step, [dev + 4 + j, dev + 8 + j])
            snap.add("train.adam", host, host + 0.5, step)
            host, dev = host + 1, dev + 10 + j
        snap.add("train.chunk.read", host, dev + 0.1, chunk)
        snap.spans[chunk - 1]["end_ns"] = int((dev + 0.1) * MS)
        t = dev + 0.1 + boundary_ms[c]
    return {"spans": snap.spans, "counts": {}}


def frames_snapshot(frames=6, prepare=(2.0, 3.0, 4.0, 5.0, 6.0, 100.0), outputs=1.0):
    """`frames` frames numbered from 1, three tiles each; frame i spends
    prepare[i] ms in render.prepare and `outputs` in render.outputs."""
    snap, t = Snapshot(), 0.0
    for i in range(frames):
        frame = snap.add("render.frame", t, t + 50, frame=i + 1)
        snap.add("render.prepare", t, t + prepare[i], frame)
        for tile in range(3):
            snap.add("render.tile", t + 10 + tile, t + 11 + tile, frame, tile=tile)
        snap.add("render.gather", t + 20, t + 40, frame)
        snap.add("render.outputs", t + 40, t + 40 + outputs, frame)
        t += 60
    return {"spans": snap.spans, "counts": {}}


@pytest.fixture
def tracer(monkeypatch):
    """The program's tracer, its snapshot replaced by one built here."""
    from vipnerf_tpu_torch.utils import tracing

    holder = {}
    monkeypatch.setattr(tracing, "snapshot", lambda: holder["snapshot"])
    return holder


def train_run(steps, trace_steps):
    return {"counts": {"kind": "train", "steps": steps, "trace_steps": trace_steps}}


def test_step_interval_runs_from_the_step_before_or_the_chunk_start(tracer):
    tracer["snapshot"] = training_snapshot()
    # the window: chunks 1 and 2 (10 steps), chunk 3 traced; each step's
    # interval is 10 + j ms from the step before, the chunk's first from its
    # own start; p95 of [10..14, 10..14] with method "higher" is 14
    value = cells.reader("step_ms_p95.train")(train_run(10, 5))
    assert value == pytest.approx(14.0)
    tracer["snapshot"] = training_snapshot(steps=20, chunks=3, boundary_ms=(1, 1, 1))
    intervals = [10.0 + j for j in range(20)]
    want = float(np.quantile(intervals, 0.95, method="higher"))
    assert cells.reader("step_ms_p95.train")(train_run(20, 20)) == pytest.approx(want)


def test_forward_and_backward_are_medians_of_the_window_steps(tracer):
    tracer["snapshot"] = training_snapshot()
    run = train_run(10, 5)
    assert cells.reader("forward_ms_per_step.train")(run) == pytest.approx(np.median([3 + j for j in range(5)] * 2))
    assert cells.reader("backward_ms_per_step.train")(run) == pytest.approx(4.0)


def test_a_forward_over_sub_batches_is_summed():
    snap = training_snapshot(chunks=2, steps=2, boundary_ms=(1, 1))
    for s in list(snap["spans"]):
        if s["name"] == "train.forward":
            snap["spans"].append(dict(s, id=s["id"] + 10_000))  # a second sub-batch's forward
    from vipnerf_tpu_torch.utils import tracing

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "snapshot", lambda: snap)
        assert cells.reader("forward_ms_per_step.train")(train_run(2, 2)) == pytest.approx(2 * 3.5)


def test_chunk_boundary_averages_the_window_pairs_only(tracer):
    tracer["snapshot"] = training_snapshot()
    # window chunks 1 and 2: one pair, the boundary out of chunk 1 (9 ms) plus
    # the next chunk's index draw and copy before its first step (2 ms); the
    # boundary into the traced chunk 3 is left out
    assert cells.reader("chunk_boundary_ms.train")(train_run(10, 5)) == pytest.approx(11.0)
    assert cells.reader("chunk_boundary_ms.train")(train_run(15, 5)) == pytest.approx(((7 + 2) + (9 + 2)) / 2)
    assert cells.reader("chunk_boundary_ms.train")(train_run(5, 5)) is None  # one window chunk: no pair


def test_frame_host_ms_reads_the_window_frames_ends(tracer):
    tracer["snapshot"] = frames_snapshot()
    run = {"counts": {"kind": "render", "frames": 4, "trace_frames": 1}}
    # window: frames 2-5 (prepare 3, 4, 5, 6 ms, outputs 1 ms); frame 6 is traced
    assert cells.reader("frame_host_ms.render")(run) == pytest.approx(np.median([4, 5, 6, 7]))


@pytest.mark.parametrize("name,kind", [("step_ms_p95.train", "train"), ("forward_ms_per_step.train", "train"),
                                       ("backward_ms_per_step.train", "train"),
                                       ("chunk_boundary_ms.train", "train"), ("frame_host_ms.render", "render")])
def test_no_spans_or_no_device_intervals_read_none(tracer, name, kind):
    counts = {"kind": kind, "steps": 10, "trace_steps": 5, "frames": 4, "trace_frames": 1}
    tracer["snapshot"] = {"spans": [], "counts": {}}
    assert cells.reader(name)({"counts": counts}) is None
    other = {"kind": "render" if kind == "train" else "train", "steps": 10, "trace_steps": 5, "frames": 4,
             "trace_frames": 1}
    tracer["snapshot"] = training_snapshot() if kind == "render" else frames_snapshot()
    assert cells.reader(name)({"counts": other}) is None
    assert cells.reader(name)({}) is None
    if kind == "train" and name != "chunk_boundary_ms.train":  # a CPU run: no device intervals
        snap = training_snapshot()
        for s in snap["spans"]:
            s["device_ms"] = None
        tracer["snapshot"] = snap
        assert cells.reader(name)({"counts": counts}) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    """A parent commit's program has no `utils.tracing`: the readers read
    None and do not raise."""
    import sys

    import vipnerf_tpu_torch.utils

    monkeypatch.delattr(vipnerf_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "vipnerf_tpu_torch.utils.tracing", None)
    run = {"counts": {"kind": "train", "steps": 10, "trace_steps": 5}}
    for name in ("step_ms_p95.train", "forward_ms_per_step.train", "backward_ms_per_step.train",
                 "chunk_boundary_ms.train"):
        assert cells.reader(name)(run) is None
    assert cells.reader("frame_host_ms.render")({"counts": {"kind": "render", "frames": 4, "trace_frames": 1}}) is None


def test_a_cpu_render_run_reads_its_window_frames():
    """The render harness on the CPU at a tiny size with its traced segment:
    frame_host_ms.render reads the program's spans of the window's frames,
    which the harness counted."""
    from vipnerf_tpu_torch.utils import tracing

    tracing.reset()
    cfg, mix = tiny_config("dtu_3view"), tiny_mix("render")
    mix["trace_seconds"] = 0.0  # one traced frame
    result = render.run(None, cfg, mix, SEED, 0.0, True, torch.device("cpu"), 0.0, None)
    c = result["counts"]
    assert c["frames"] >= 1 and c["trace_frames"] == 1
    frames = [s for s in tracing.snapshot()["spans"] if s["name"] == "render.frame"]
    assert len(frames) == mix["warm_frames"] + c["frames"] + c["trace_frames"]
    value = cells.reader("frame_host_ms.render")(result)
    assert value is not None and 0 < value < 1e3 * max(result["window_parts_s"])
