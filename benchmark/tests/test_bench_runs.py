"""Runs of the harness on the CPU at a tiny size, past its look for a
card: a sound run comes out correct under each cell's limits; the
lower-precision control reads further from the reference than the
program; each fault that a cell can have, planted under the timed path,
comes out not correct. And run.py itself, without a card, exits non-zero
and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_support import BENCH_DIR, ROOT, SEED, tiny_config, tiny_mix
from harness import cells, checks, render, train

CPU = torch.device("cpu")
# kind -> (cell whose limits judge the run, its configuration, its mix)
CELLS = {"train": ("llff_2view.train", "llff_2view", "train"),
         "batched": ("dtu_3view.train_s4", "dtu_3view", "train_batched"),
         "render": ("dtu_3view.render", "dtu_3view", "render")}


def run(kind, fault=None, overrides=None, config=None):
    name, default, mix = CELLS[kind]
    cfg = tiny_config(config or default)
    cfg["program_overrides"] = dict(overrides or {})
    driver = render if kind == "render" else train
    result = driver.run(None, cfg, tiny_mix(mix), SEED, 0.0, False, CPU, 0.0, fault)
    return result, checks.judge(result["checks"], checks.load_limits(name))


@pytest.mark.parametrize("kind", ["train", "batched", "render"])
def test_a_sound_run_is_correct_and_the_control_reads_further(kind):
    sound, correct = run(kind)
    assert correct, sound["checks"]
    control, _ = run(kind, overrides={"f32_heads": False})
    number = "depth_gap" if kind == "render" else "rgb_gap_median_first"
    assert control["checks"]["numbers"][number] > 3 * sound["checks"]["numbers"][number]


@pytest.mark.parametrize("kind,fault", [("train", "half_batch"), ("train", "state_unchanged"),
                                        ("batched", "half_batch"), ("batched", "state_unchanged"),
                                        ("render", "answer_altered")])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    result, correct = run(kind, fault=fault)
    assert not correct, result["checks"]


def test_llff_render_and_dtu_training_run_on_the_cpu():
    for kind, config in (("render", "llff_2view"), ("train", "dtu_3view")):
        result, _ = run(kind, config=config)
        assert result["attempted"] >= 1 and result["failed"] == 0


def test_run_py_without_a_card_exits_non_zero_naming_it():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "llff_2view.train", "--seed",
                           str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and proc.stdout.strip() == ""


def test_run_py_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dtu_3view.render", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_result_line_carries_the_checks_last():
    result = {"metrics": {"render_rays_per_s": 1.0, "frame_ms_p95": 2.0, "peak_gib": 3.0}, "setup_s": 4.0,
              "attempted": 5, "failed": 0, "device": {"platform": "gpu", "kind": "x", "count": 1,
                                                       "memory_peak_bytes": 6},
              "checks": {"numbers": {"rgb_off_share": 0.0, "depth_gap": 0.0}, "detail": {}}}
    line = cells.result_line(cells.load_benchmark(), {"name": "dtu_3view.render"}, result, False)
    assert list(line)[-1] == "checks" and line["correct"]
    assert set(line["metrics"]) == {"render_rays_per_s", "frame_ms_p95", "peak_gib", "setup_s"}
