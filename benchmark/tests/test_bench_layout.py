"""The benchmark is driven by data: every cell finds its configuration,
its mix, its metrics' readers and its limits by name, a new one is found
without an edit, and BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil

import pytest

from bench_support import BENCH_DIR, ROOT
from harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return cells.load_benchmark()


@pytest.mark.parametrize("cell", [c["name"] for c in bench()["workloads"]])
def test_every_cell_resolves_its_files_by_name(cell):
    b = bench()
    entry = cells.workload(b, cell)
    cfg = cells.load_config(b, entry["config"])
    assert cfg["name"] == entry["config"]
    mix = cells.load_traffic(entry["traffic"])
    assert (BENCH_DIR / "harness" / f"{mix['driver']}.py").exists()
    metrics = cells.per_layer(b, cell)
    assert metrics, "every cell reports a per-layer metric"
    for m in metrics:
        assert callable(cells.reader(m["name"]))
    e2e = {m["name"] for m in cells.end_to_end(b, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in metrics:
        assert m["moves"] in e2e
    assert cells.checks.load_limits(cell)


def test_benchmark_json_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in b["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric and a cell
    as new files and new entries: the copy finds each by its name."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    cfg = json.loads((ROOT / b["configs"][0]["file"]).read_text())
    cfg["name"] = "dummy_cfg"
    (tmp_path / "benchmark/configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(json.dumps({"driver": "render", "chunk_size": 1}))
    (tmp_path / "benchmark/metrics/dummy_metric.py").write_text("def read(run):\n    return 42.0\n")
    (tmp_path / "benchmark/limits/dummy_cfg.dummy_mix.json").write_text(json.dumps({"limits": {"depth_gap": 1}}))
    b["configs"].append({"name": "dummy_cfg", "source": "x", "file": "benchmark/configs/dummy_cfg.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg", "traffic": "dummy_mix",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "x", "moves": "render_rays_per_s", "workloads": ["dummy_cfg.dummy_mix"]})
    b["end_to_end"][1]["workloads"].append("dummy_cfg.dummy_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    copy = cells.load_benchmark(tmp_path)
    cell = cells.workload(copy, "dummy_cfg.dummy_mix")
    assert cells.load_config(copy, cell["config"], tmp_path)["name"] == "dummy_cfg"
    assert cells.load_traffic(cell["traffic"], tmp_path / "benchmark")["chunk_size"] == 1
    assert [m["name"] for m in cells.per_layer(copy, cell["name"])] == ["dummy_metric"]
    assert cells.reader("dummy_metric", tmp_path / "benchmark")({}) == 42.0
    assert "render_rays_per_s" in {m["name"] for m in cells.end_to_end(copy, cell["name"])}
