"""The benchmark is driven by data: a cell of `BENCHMARK.json` names its
configuration and its traffic mix, and each metric has a reader, each in a
file of its own that is found by its name:

- `benchmark/configs/<config>.json` (the `file` of the configuration);
- `benchmark/traffic/<mix>.json`, whose `driver` names the harness module
  that runs that kind of traffic (`harness/<driver>.py`: `train`, `render`);
- `benchmark/metrics/<metric>.py`, a per-layer metric's reader, `read(run)`
  returning a number or None;
- `benchmark/limits/<cell>.json`, the limits of the cell's check.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries; no file that is there needs an edit.
"""

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from harness import checks, common


def load_benchmark(root: Optional[Path] = None) -> Dict[str, Any]:
    return json.loads(((root or common.ROOT) / "BENCHMARK.json").read_text())


def workload(bench, name: str) -> Dict[str, Any]:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"run.py: no workload {name!r} in BENCHMARK.json")


def load_config(bench, name: str, root: Optional[Path] = None) -> Dict[str, Any]:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads(((root or common.ROOT) / entry["file"]).read_text())


def load_traffic(name: str, bench_dir: Optional[Path] = None) -> Dict[str, Any]:
    return json.loads(((bench_dir or common.BENCH_DIR) / "traffic" / f"{name}.json").read_text())


def applies(metric, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench, cell_name: str) -> List[Dict[str, Any]]:
    return [m for m in bench["end_to_end"] if applies(m, cell_name)]


def per_layer(bench, cell_name: str) -> List[Dict[str, Any]]:
    """The per-layer metrics read in this cell: listed for it, or without a
    list and moving an end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(name: str, bench_dir: Optional[Path] = None) -> Callable[[Dict[str, Any]], Optional[float]]:
    path = (bench_dir or common.BENCH_DIR) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def run_cell(bench, cell, seed: int, seconds: float, traced: bool, device, t0: float,
             fault: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One run of `cell`; `overrides` replaces keys of the model block of
    the program's configs only (the lower-precision control): the reference
    keeps the configuration's."""
    cfg = load_config(bench, cell["config"])
    cfg["program_overrides"] = dict(overrides or {})
    mix = load_traffic(cell["traffic"])
    driver = importlib.import_module(f"harness.{mix['driver']}")
    return driver.run(cell, cfg, mix, seed, seconds, traced, device, t0, fault)


def result_line(bench, cell, result: Dict[str, Any], traced: bool) -> Dict[str, Any]:
    """The run's last line: `correct` from the check, the cell's end-to-end
    metrics (per-layer with --trace 1), the device, and each number compared
    beside its limit."""
    limits = checks.load_limits(cell["name"])
    correct = checks.judge(result["checks"], limits) and result["failed"] == 0
    metrics = {}
    if traced:
        for m in per_layer(bench, cell["name"]):
            value = reader(m["name"])(result)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result["metrics"], setup_s=result["setup_s"])
        for m in end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = dict(result["device"])
    line = {"correct": bool(correct), "attempted": int(result["attempted"]), "failed": int(result["failed"]),
            "metrics": metrics, "device": device}
    profile = result.get("profile")
    if traced and profile:
        device["busy_s"], device["window_s"] = profile["busy_s"], profile["window_s"]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in profile["device_ops"]],
                             "idle_gaps": profile["idle_gaps"]}
    numbers = result["checks"]["numbers"]
    line["checks"] = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    return line


def check_lines(result: Dict[str, Any], line: Dict[str, Any]) -> List[str]:
    """The readings not compared first, then each number compared beside its limit."""
    out = [f"reading {name}: {value!r} (not compared)" for name, value in result["checks"]["numbers"].items()
           if name not in line["checks"]]
    return out + [f"check {name}: {c['value']!r} (limit {c['limit']!r})" for name, c in line["checks"].items()]


def window_line(result: Dict[str, Any]) -> str:
    """The window's parts (training chunks or frames): count, and the
    shortest, median and longest in seconds."""
    parts = sorted(result["window_parts_s"])
    if not parts:
        return "window: no parts"
    return (f"window: {result['window_s']:.3f} s in {len(parts)} parts; part s min {parts[0]:.4f} "
            f"median {parts[len(parts) // 2]:.4f} max {parts[-1]:.4f}; set-up {result['setup_s']:.2f} s")
