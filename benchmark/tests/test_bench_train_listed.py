"""The driver of `llff_2view_vp.train_s8` (`harness/train_listed.py`) and its
reference (`reference/listed_losses.py`) on the CPU at a tiny size:

- the cell's mix names the driver, and `run_cell` dispatches to it;
- the four-loss reference cannot check a configuration without the
  sparse-depth loss, and the listed-loss reference with all four losses
  listed is the four-loss reference bit for bit;
- a sound run of two scenes in lockstep is correct under the cell's limits,
  counts no sparse-depth ray, and leaves the harness's reference as it
  found it; the lower-precision control reads further from the reference,
  and each fault planted under the timed path is not correct.
"""

import pytest
import torch

from bench_support import SEED, tiny_config, tiny_mix
from harness import cells, checks, common, train, train_listed
from reference import driver, listed_losses

CELL = "llff_2view_vp.train_s8"
CPU = torch.device("cpu")


def tiny_cell():
    cfg, mix = tiny_config("llff_2view_vp"), tiny_mix("train_s8")
    mix.update(scenes=2, scan_steps=4)
    return cfg, mix


def run(fault=None, overrides=None):
    from vipnerf_tpu_torch.utils import tracing

    cfg, mix = tiny_cell()
    cfg["program_overrides"] = dict(overrides or {})
    tracing.reset()
    result = train_listed.run(None, cfg, mix, SEED, 0.0, False, CPU, 0.0, fault)
    steps = sum(s["name"] == "train.step" for s in tracing.snapshot()["spans"])
    return result, checks.judge(result["checks"], checks.load_limits(CELL)), dict(tracing.counts("train."),
                                                                                  steps=steps)


def test_the_cell_dispatches_to_its_driver(monkeypatch):
    bench = cells.load_benchmark()
    cell = cells.workload(bench, CELL)
    mix = cells.load_traffic(cell["traffic"])
    assert mix["driver"] == "train_listed" and mix["scenes"] == 8
    assert "sparse_depth" not in cells.load_config(bench, cell["config"])["train_configs"]["data_loader"]
    seen = {}

    def fake_run(cell_, cfg, mix_, seed, seconds, traced, device, t0, fault):
        seen.update(cell=cell_["name"], config=cfg["name"], mix=mix_, overrides=cfg["program_overrides"],
                    fault=fault)
        return "result"

    monkeypatch.setattr(train_listed, "run", fake_run)
    got = cells.run_cell(bench, cell, SEED, 1.0, False, CPU, 0.0, "half_batch", {"f32_heads": False})
    assert got == "result"
    assert seen == {"cell": CELL, "config": "llff_2view_vp", "mix": mix, "overrides": {"f32_heads": False},
                    "fault": "half_batch"}


def _first_steps(name, root):
    cfg, mix = tiny_config(name), tiny_mix("train")
    gt = train.scene_inputs(cfg, root, SEED, 0)
    weights = common.seeded_weights(cfg["train_configs"]["model"], SEED, CPU)[0]
    g = torch.Generator().manual_seed(SEED)
    h, w = cfg["scene"]["height"], cfg["scene"]["width"]
    n = cfg["train_configs"]["data_loader"]["num_rays"] + cfg["train_configs"]["data_loader"].get(
        "sparse_depth", {}).get("num_rays", 0)
    steps = [{"indices": torch.randint(0, 2 * h * w, (n,), generator=g), "iter": mix["start_iter"] + j}
             for j in range(2)]
    return cfg, mix, gt, weights, steps


def test_the_four_loss_reference_cannot_check_the_ablation(tmp_path):
    cfg, mix, gt, weights, steps = _first_steps("llff_2view_vp", tmp_path)
    with pytest.raises(KeyError, match="SparseDepthMSE01"):
        driver.train_steps(cfg, mix, gt, weights, steps[:1], SEED, CPU)
    ref = listed_losses.train_steps(cfg, mix, gt, weights, steps[:1], SEED, CPU)
    assert list(ref["losses"][0]) == ["MSE01", "VisibilityLoss01", "VisibilityPriorLoss01", "TotalLoss"]


def test_with_every_loss_listed_it_is_the_four_loss_reference(tmp_path):
    cfg, mix, gt, weights, steps = _first_steps("llff_2view", tmp_path)
    want = driver.train_steps(cfg, mix, gt, weights, steps, SEED, CPU, 2, 1)
    got = listed_losses.train_steps(cfg, mix, gt, weights, steps, SEED, CPU, 2, 1)
    assert got["losses"] == want["losses"]
    for key in ("grad1", "params_after"):
        assert got[key].keys() == want[key].keys()
        assert all(torch.equal(got[key][k], want[key][k]) for k in want[key]), key
    for a, b in zip(got["outputs"], want["outputs"], strict=True):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_a_sound_run_is_correct_and_the_control_reads_further():
    sound, correct, counts = run()
    assert correct, sound["checks"]
    assert checks.driver is driver  # the harness's reference put back
    cfg, mix = tiny_cell()
    assert counts["train.rays.sparse_depth"] == 0
    assert counts["train.rays.nerf"] == counts["steps"] * mix["scenes"] * cfg["train_configs"]["data_loader"][
        "num_rays"]
    assert sound["attempted"] >= 1 and sound["failed"] == 0
    control, _, _ = run(overrides={"f32_heads": False})
    number = "rgb_gap_median_first"
    assert control["checks"]["numbers"][number] > 3 * sound["checks"]["numbers"][number]


@pytest.mark.parametrize("fault", ["half_batch", "state_unchanged"])
def test_a_broken_timed_path_is_not_correct(fault):
    result, correct, _ = run(fault=fault)
    assert not correct, result["checks"]
    assert checks.driver is driver
