"""The port's tracer (`vipnerf_tpu_torch/utils/tracing.py`) on the CPU: spans
nest and name their parents, the ring keeps the newest, a span closed by an
exception still records, nothing opens a `record_function` without a
profiler and every span does under one, counters and merged snapshots; and
the spans the program records where its work happens: one CPU chunk of a
tiny training run, one `predict_frame`, and one library build."""

import copy
import math
import time

import pytest
import torch

from tests.test_e2e_training import small_train_configs
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.kernels import build
from vipnerf_tpu_torch.train.trainer import start_training
from vipnerf_tpu_torch.utils import tracing


class Closed(Exception):
    """Stands in for a caller's exception that ends a loop from inside it."""


def by_name(records, name):
    return [r for r in records if r["name"] == name]


def children(records, parent, name=None):
    return sorted((r for r in records if r["parent"] == parent["id"] and name in (None, r["name"])),
                  key=lambda r: r["start_ns"])


def test_spans_nest_and_name_their_parents():
    t = tracing.Tracer()
    with t.span("outer", it=3) as outer:
        with t.span("inner", tile=0):
            pass
        with t.span("inner", tile=1):
            pass
    with t.span("next"):
        pass
    records = t.snapshot()["spans"]
    assert [r["name"] for r in records] == ["inner", "inner", "outer", "next"]  # the order they closed
    o, n = by_name(records, "outer")[0], by_name(records, "next")[0]
    assert o["id"] == outer.id and o["parent"] is None and o["attrs"] == {"it": 3} and n["parent"] is None
    inner = children(records, o)
    assert [r["attrs"]["tile"] for r in inner] == [0, 1]
    assert o["start_ns"] <= inner[0]["start_ns"] <= inner[0]["end_ns"] <= inner[1]["start_ns"] <= o["end_ns"]
    assert all(r["device_ms"] is None for r in records)  # no device given: no timing events


def test_a_span_on_the_cpu_records_no_device_interval():
    t = tracing.Tracer()
    with t.span("train.step", torch.device("cpu"), it=0):
        pass
    t.collect()
    assert t.snapshot()["spans"][0]["device_ms"] is None and t._pending == []


def test_the_ring_keeps_the_newest_spans():
    """Each name keeps its newest `capacity` spans: a long run's steps push
    out older steps, never its chunks."""
    t = tracing.Tracer(capacity=4)
    for c in range(3):
        with t.span("train.chunk", it=c):
            for i in range(5):
                with t.span("s", i=5 * c + i):
                    pass
    records = t.snapshot()["spans"]
    assert [r["attrs"]["i"] for r in by_name(records, "s")] == [11, 12, 13, 14]
    assert [r["attrs"]["it"] for r in by_name(records, "train.chunk")] == [0, 1, 2]
    assert [r["name"] for r in records] == ["train.chunk"] * 2 + ["s"] * 4 + ["train.chunk"]  # the order they closed
    # a 60 s window of every cell's steps, chunks, frames and tiles (LLFF frames: 94 tiles each)
    assert tracing.CAPACITY >= 20_000


def test_a_span_closed_by_an_exception_still_records():
    t = tracing.Tracer()
    with pytest.raises(Closed):
        with t.span("train.chunk", it=0):
            with t.span("train.chunk.read"):
                raise Closed()
    records = t.snapshot()["spans"]
    assert [r["name"] for r in records] == ["train.chunk.read", "train.chunk"]
    assert records[0]["parent"] == records[1]["id"] and records[1]["end_ns"] >= records[0]["end_ns"]
    with t.span("after"):  # the stack unwound: the next span is a root
        pass
    assert t.snapshot()["spans"][-1]["parent"] is None


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: calls.append(name))
    t = tracing.Tracer()
    assert not tracing.profiling()
    with t.span("a"):
        with t.detail("rays.sample"):
            pass
    assert calls == []
    assert [r["name"] for r in t.snapshot()["spans"]] == ["a"]  # a detail span records only under a profiler


def test_the_profiler_flag_the_tracer_reads():
    """The tracer reads torch's private `_is_profiler_enabled` on every span:
    it must exist, and be set exactly while a session records."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert torch.autograd.profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.profiling() is True
    assert tracing.profiling() is False


def test_spans_appear_in_a_cpu_profiler_session():
    t = tracing.Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("unit.outer"):
            with t.detail("unit.inner"):
                torch.ones(8).add_(1)
    names = {e.name for e in prof.events()}
    assert {"unit.outer", "unit.inner"} <= names
    records = t.snapshot()["spans"]
    assert [r["name"] for r in records] == ["unit.inner", "unit.outer"]
    assert records[0]["parent"] == records[1]["id"]


def test_counters_and_reset():
    t = tracing.Tracer()
    t.count("k1.launches.fused_mlp_bf16")
    t.count("k1.launches.fused_mlp_bf16")
    t.count("k1.launches.heads_bwd_points", 3)
    t.count("jpeg.decodes")
    assert t.counts("k1.") == {"k1.launches.fused_mlp_bf16": 2, "k1.launches.heads_bwd_points": 3}
    assert t.snapshot()["counts"]["jpeg.decodes"] == 1
    t.add("kernels.build", 10, 20, library="raystream")
    t.reset()
    assert t.snapshot() == {"spans": [], "counts": {}}


def test_an_interval_measured_elsewhere_joins_the_open_span():
    t = tracing.Tracer()
    with t.span("outer"):
        t.add("kernels.build", 100, 250, library="raystream")
    build_rec, outer = t.snapshot()["spans"]
    assert build_rec["parent"] == outer["id"] and build_rec["end_ns"] - build_rec["start_ns"] == 150
    assert build_rec["attrs"] == {"library": "raystream"}


def test_a_merged_snapshot_keeps_its_tree_under_new_ids():
    rank = tracing.Tracer()
    with rank.span("train.chunk", it=0, steps=2):
        for j in range(2):
            with rank.span("train.step", it=j):
                pass
    rank.count("k1.launches.fused_mlp_bf16", 4)
    launcher = tracing.Tracer()
    launcher.count("k1.launches.fused_mlp_bf16", 1)
    with launcher.span("app.training") as app:
        launcher.merge(rank.snapshot())
    records = launcher.snapshot()["spans"]
    chunk = by_name(records, "train.chunk")[0]
    assert chunk["parent"] == app.id
    assert [r["attrs"]["it"] for r in children(records, chunk, "train.step")] == [0, 1]
    assert len({r["id"] for r in records}) == len(records) == 4
    assert launcher.counts() == {"k1.launches.fused_mlp_bf16": 5}


def test_a_cpu_chunk_traces_every_step(tmp_path):
    """Three steps in one chunk: `train.chunk` with its index draw, copy,
    three `train.step`s (`it` 0-2, each with gather, forward, losses,
    backward and Adam, in that order) and the scalars' read."""
    torch.set_num_threads(2)
    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=6,
                             train_frames=(0, 5), val_frames=(2,), height=16, width=20)
    cfg = small_train_configs(tmp_path, num_iterations=3)
    cfg.update(device="cpu", seed=1, scan_steps=3, validation_interval=1000, model_save_interval=1000)
    cfg["data_loader"].update(num_rays=32, sparse_depth={"dirname": "DE02", "num_rays": 16})
    tracing.reset()
    start_training(copy.deepcopy(cfg))
    records = tracing.snapshot()["spans"]
    (chunk,) = by_name(records, "train.chunk")
    assert chunk["attrs"] == {"it": 0, "steps": 3}
    assert [r["name"] for r in children(records, chunk)] == (
        ["train.chunk.indices", "train.chunk.copy"] + ["train.step"] * 3 + ["train.chunk.read"])
    steps = children(records, chunk, "train.step")
    assert [s["attrs"]["it"] for s in steps] == [0, 1, 2]
    for step in steps:
        assert [r["name"] for r in children(records, step)] == [
            "train.gather", "train.forward", "train.losses", "train.backward", "train.adam"]
        assert step["device_ms"] is None
    # the scalars' logging: each step's losses, TotalLoss and the learning rate
    logged = 3 * (len(cfg["losses"]) + 2)
    assert [r["attrs"] for r in by_name(records, "train.log")] == [{"it": 0, "scalars": logged}]
    counts = tracing.counts()
    assert counts["train.log.scalars"] == logged
    assert counts["train.rays.nerf"] == 3 * 32 and counts["train.rays.sparse_depth"] == 3 * 16
    assert by_name(records, "app.training") == []  # start_training outside an app: no stage span


def test_a_cpu_frame_traces_its_tiles(tmp_path):
    from tests.test_torch_render import H, W, configs, rig
    from vipnerf_tpu_torch.infer.tester import NerfTester

    poses, model_configs = rig()
    tester = NerfTester(configs(True), dict(model_configs), {"device": "cpu", "chunk_size": 50}, tmp_path)
    tracing.reset()
    for _ in range(2):
        tester.predict_frame(poses[0])
    records = tracing.snapshot()["spans"]
    frames = by_name(records, "render.frame")
    assert [f["attrs"]["frame"] for f in frames] == [1, 2]
    tiles = math.ceil(H * W / 50)
    for frame in frames:
        names = [r["name"] for r in children(records, frame)]
        assert names == ["render.prepare"] + ["render.tile"] * tiles + ["render.gather", "render.outputs"]
        assert [r["attrs"]["tile"] for r in children(records, frame, "render.tile")] == list(range(tiles))
        assert frame["device_ms"] is None


def test_a_library_build_is_a_span(tmp_path, monkeypatch):
    """A compilation (the host raystream library, with g++) records a
    `kernels.build` span; loading the library records nothing more."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_loaded", {})
    tracing.reset()
    t0 = time.perf_counter_ns()
    build.build_all(["raystream"])
    build.load("raystream")
    records = tracing.snapshot()["spans"]
    (built,) = by_name(records, "kernels.build")
    assert built["attrs"] == {"library": "raystream"} and t0 <= built["start_ns"] < built["end_ns"]
    assert "raystream" in build._loaded and tracing.counts() == {}
    build.build_all(["raystream"])  # built already: no span
    assert len(by_name(tracing.snapshot()["spans"], "kernels.build")) == 1


def test_detail_spans_name_render_rays_phases_under_a_profiler():
    from tests.test_torch_render import configs, make_batch
    from vipnerf_tpu_torch.models import vip_nerf as t_vn

    cfg = configs(False)
    model = t_vn.ViPNeRF(cfg).eval()
    _, batch = make_batch(16, 3, False)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        t_vn.render_rays(model, cfg, batch, train=False)
    names = [r["name"] for r in sorted(tracing.snapshot()["spans"], key=lambda r: r["start_ns"])]
    assert names == ["rays.sample", "rays.coarse.points", "rays.coarse.mlp", "rays.coarse.composite",
                     "rays.resample", "rays.fine.points", "rays.fine.mlp", "rays.fine.composite"]
    tracing.reset()
    with torch.no_grad():
        t_vn.render_rays(model, cfg, batch, train=False)
    assert tracing.snapshot()["spans"] == []
