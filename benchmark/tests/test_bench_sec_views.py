"""The reader of `sec_views_ms_per_step.train` on tracer snapshots built by
hand: the window's steps, each the sum of its `rays.<level>.sec_dirs`
device intervals found under its `train.step` (through `train.forward`,
and a profiler's `rays.<level>.points` where one is open); None where the
counter `vis.sec_view_points` shows no other view, where the program
recorded no such spans or no device intervals, and where the program has
no tracer. And the cell that reads it at three other views,
`llff_4view.train_s4`, run by the harness on the CPU at a tiny size with
two scenes: correct under its limits, the control further from the
reference, the counter at points x 3 for every step."""

import pytest
import torch

from bench_support import SEED, tiny_config, tiny_mix
from harness import cells, checks, train

MS = 1_000_000  # ns per ms
COUNTS = {"vis.sec_view_points": 12_582_912, "k1.launches.fused_mlp_bf16_f32h": 40}


def snapshot(chunks=3, steps=4, sec_ms=(0.5, 1.25), under_points=False, counts=COUNTS):
    """`chunks` chunks of `steps` steps from iteration 30000; step j's
    forward holds a coarse and a fine `sec_dirs` span of sec_ms[0] + j and
    sec_ms[1] + j device ms (under `rays.<level>.points` with
    `under_points`)."""
    spans, ids = [], [0]

    def add(name, parent=None, device_ms=None, **attrs):
        ids[0] += 1
        spans.append({"name": name, "id": ids[0], "parent": parent, "start_ns": ids[0] * MS,
                      "end_ns": ids[0] * MS + MS, "attrs": attrs, "device_ms": device_ms})
        return ids[0]

    dev = 0.0
    for c in range(chunks):
        chunk = add("train.chunk", it=30000 + c * steps, steps=steps)
        for j in range(steps):
            step = add("train.step", chunk, [None, dev + 20], it=30000 + c * steps + j)
            forward = add("train.forward", step, [dev, dev + 10])
            for level, ms in zip(("coarse", "fine"), sec_ms):
                parent = add(f"rays.{level}.points", forward) if under_points else forward
                add(f"rays.{level}.sec_dirs", parent, [dev + 1, dev + 1 + ms + j])
            add("train.backward", step, [dev + 10, dev + 19])
            dev += 20
    return {"spans": spans, "counts": dict(counts)}


@pytest.fixture
def tracer(monkeypatch):
    from vipnerf_tpu_torch.utils import tracing

    holder = {}
    monkeypatch.setattr(tracing, "snapshot", lambda: holder["snapshot"])
    return holder


def run(steps=8, trace_steps=4):
    return {"counts": {"kind": "train", "steps": steps, "trace_steps": trace_steps}}


READ = cells.reader("sec_views_ms_per_step.train")


@pytest.mark.parametrize("under_points", [False, True])
def test_the_median_of_the_window_steps_summed_levels(tracer, under_points):
    tracer["snapshot"] = snapshot(under_points=under_points)
    # window: chunks 0 and 1 (8 steps, j = 0..3 twice), chunk 2 traced;
    # a step's two spans sum to 0.5 + 1.25 + 2 j ms: median of 1.75, 3.75, 5.75, 7.75 (twice)
    assert READ(run()) == pytest.approx(4.75)
    assert READ(run(steps=4)) == pytest.approx(4.75)  # chunk 1 alone


def test_no_other_view_reads_none(tracer):
    tracer["snapshot"] = snapshot(counts={"k1.launches.fused_mlp_bf16_f32h": 40})
    assert READ(run()) is None
    tracer["snapshot"] = snapshot(counts={"vis.sec_view_points": 0})
    assert READ(run()) is None


def test_missing_spans_or_device_intervals_read_none(tracer):
    snap = snapshot()
    snap["spans"] = [s for s in snap["spans"] if not s["name"].endswith(".sec_dirs")]
    tracer["snapshot"] = snap
    assert READ(run()) is None  # a parent program: the counter may be there, the spans not
    snap = snapshot()
    for s in snap["spans"]:
        s["device_ms"] = None  # a CPU run
    tracer["snapshot"] = snap
    assert READ(run()) is None
    tracer["snapshot"] = snapshot()
    assert READ({"counts": {"kind": "render", "frames": 4, "trace_frames": 1}}) is None
    assert READ({}) is None


def test_a_program_without_the_tracer_reads_none(monkeypatch):
    import sys

    import vipnerf_tpu_torch.utils

    monkeypatch.delattr(vipnerf_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "vipnerf_tpu_torch.utils.tracing", None)
    assert READ(run()) is None


def test_the_four_view_cell_runs_on_the_cpu():
    from vipnerf_tpu_torch.utils import tracing

    cfg, mix = tiny_config("llff_4view"), tiny_mix("train_batched")
    mix["scenes"] = 2
    limits = checks.load_limits("llff_4view.train_s4")
    tracing.reset()
    sound = train.run(None, cfg, mix, SEED, 0.0, False, torch.device("cpu"), 0.0, None)
    assert checks.judge(sound["checks"], limits), sound["checks"]
    c = sound["counts"]
    assert c["n_sec"] == 3 and c["scenes"] == 2
    steps = len([s for s in tracing.snapshot()["spans"] if s["name"] == "train.step"])
    points = sum(c["points_per_step"].values())
    assert tracing.counts()["vis.sec_view_points"] == steps * points * 3
    assert READ(dict(sound, counts=dict(c, trace_steps=0))) is None  # the CPU times no device interval
    cfg["program_overrides"] = {"f32_heads": False}
    control = train.run(None, cfg, mix, SEED, 0.0, False, torch.device("cpu"), 0.0, None)
    number = "rgb_gap_median_first"
    assert control["checks"]["numbers"][number] > 3 * sound["checks"]["numbers"][number]
