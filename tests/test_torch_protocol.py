"""The port's protocol drivers (vipnerf_tpu_torch/protocol/) against the JAX
package's tools/ drivers they copy, on the CPU at a small size.

- Databases: each of run_dtu_control, run_dtu_50k, run_priorgen_50k,
  run_realestate_50k and run_demo1a_200k builds its workdir, the JAX tool's
  `main()` run from its file with runpy and the port's driver with
  `--device cpu`, the dataset app's `_run_full` a no-op on both sides. The
  trees are compared file for file: PNGs pixel for pixel, CSVs as numbers
  (within 1e-12) or as tables, .npz arrays exactly, JSON parsed; the
  generated visibility weights within 1e-5 (tests/test_torch_priors.py's
  tolerance), their masks equal wherever the weight is 1e-5 or more from
  0.5, their PNGs within one grey level; priorgen's MASK_GEOMETRY_STATS
  within 2 pixels' share of each rate.
- evidence_snapshot writes the tool's bytes for a forged run tree.
- checkpoint_sweep: two JAX checkpoints of seeded parameters at a narrow
  width, written by the JAX package's `save_checkpoint` and carried to the
  port by `utils.jax_ckpt.import_run`, swept by both; each score of the
  SWEEP_TABLE within 0.05 of the tool's (dB for PSNR, grey levels for
  RMSE, 1e-3 for SSIM): the two render the same weights through f32 MLPs,
  and the scores are of 8-bit frames.
- The 30k seam: the same seeded narrow model saved at iteration 29,998 by
  both packages and resumed for 4 steps (deterministic: no perturbation,
  no sigma noise) on the same batches; TotalLoss and VisibilityPriorLoss01
  within 1e-4 relative step for step, the prior's weight switching on at
  iter_num 30000 on both, the learning rate equal within 1e-12 relative.
- The JAX run's figures the DTU control holds the port to are those of
  its committed evidence; the bands and the leg's bookkeeping.
"""

import contextlib
import io
import json
import math
import re
import runpy
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import imageio.v2 as imageio
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tests.test_torch_jax_ckpt import JaxSide, adam_state, jax_batch
from tests.test_torch_losses import step_batch, torch_tree
from vipnerf_tpu.apps import dtu as j_dtu
from vipnerf_tpu.apps import nerf_llff as j_nerf_llff
from vipnerf_tpu.apps import real_estate as j_real_estate
from vipnerf_tpu.train import checkpoints as j_ckpt
from vipnerf_tpu.train.lr_schedules import get_lr_schedule as j_lr_schedule
from vipnerf_tpu_torch.apps import dtu, nerf_llff, real_estate
from vipnerf_tpu_torch.apps.common import DatasetApp
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.protocol import (
    checkpoint_sweep,
    common,
    evidence_snapshot,
    run_demo1a_200k,
    run_dtu_50k,
    run_dtu_control,
    run_priorgen_50k,
    run_realestate_50k,
)
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
from vipnerf_tpu_torch.utils import jax_ckpt, tracing
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params
from vipnerf_tpu_torch.utils.io import read_png

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
EVIDENCE = ROOT / "protocol_evidence/dtu_control_3view"
TOL_W = 1e-5  # the visibility weights, as tests/test_torch_priors.py holds them
TOL_STATS_PIXELS = 2  # MASK_GEOMETRY_STATS: each rate within this many pixels' share
TOL_SWEEP = {"PSNR": 0.05, "RMSE": 0.05, "SSIM": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: idle ones spin on the cores of other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# the persistent compilation cache the tools/ drivers select when they are
# imported: a directory of their own outside the checkout
TOOLS_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
TOOLS_CACHE_DIR = Path("/tmp/vipnerf_tpu_cache")


def cache_entries() -> set:
    return set(TOOLS_CACHE_DIR.iterdir()) if TOOLS_CACHE_DIR.exists() else set()


def run_tool(monkeypatch, name, argv):
    """A tools/ driver's main(), run from its file as a script; its stdout.
    The driver's updates of the compilation cache are dropped, so the tests'
    own cache stays in effect and nothing is written to the tools' one."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    monkeypatch.setattr(sys, "path", list(sys.path))
    update = jax.config.update

    def update_all_but_the_cache(key, value):
        if key not in TOOLS_CACHE_KEYS:
            update(key, value)

    monkeypatch.setattr(jax.config, "update", update_all_but_the_cache)
    cache = {key: getattr(jax.config, key) for key in TOOLS_CACHE_KEYS}
    entries = cache_entries()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(TOOLS / name), run_name="__main__")
    assert {key: getattr(jax.config, key) for key in TOOLS_CACHE_KEYS} == cache
    assert cache_entries() <= entries, f"{name} wrote to {TOOLS_CACHE_DIR}"
    return out.getvalue()


def run_port(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv + ["--device", "cpu"])
    return out.getvalue()


def assert_trees_match(t_dir: Path, j_dir: Path):
    """Every file of the JAX tree in the port's, as the module docstring says."""
    j_files = sorted(p.relative_to(j_dir) for p in j_dir.rglob("*") if p.is_file())
    assert j_files, j_dir
    assert j_files == sorted(p.relative_to(t_dir) for p in t_dir.rglob("*") if p.is_file())
    weights = {}
    for rel in j_files:
        a, b = t_dir / rel, j_dir / rel
        parts = rel.parts
        if "visibility_weights" in parts and rel.suffix == ".npy":
            ta, jb = np.load(a), np.load(b)
            assert ta.dtype == jb.dtype == np.float32, str(rel)
            np.testing.assert_allclose(ta, jb, atol=TOL_W, rtol=0, err_msg=str(rel))
            weights[rel.stem] = jb
        elif "visibility_weights" in parts:
            diff = np.abs(read_png(a).astype(int) - imageio.imread(b).astype(int))
            assert diff.max() <= 1, str(rel)
        elif "visibility_masks" in parts:
            continue  # against the weights below
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(read_png(a), imageio.imread(b), str(rel))
        elif rel.suffix == ".json":
            ta, jb = json.loads(a.read_text()), json.loads(b.read_text())
            if "generator" in jb:
                assert ta.pop("generator") == jb.pop("generator").replace("vipnerf_tpu.", "vipnerf_tpu_torch.")
            assert ta == jb, str(rel)
        elif rel.suffix == ".csv" and not b.read_text()[:1].isdigit() and b.read_text()[:1] != "-":
            pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b), obj=str(rel))
        elif rel.suffix == ".csv":
            np.testing.assert_allclose(np.loadtxt(a, delimiter=","), np.loadtxt(b, delimiter=","),
                                       rtol=0, atol=1e-12, err_msg=str(rel))
        elif rel.suffix == ".npz":
            ta, jb = np.load(a), np.load(b)
            assert sorted(ta.files) == sorted(jb.files)
            for key in jb.files:
                np.testing.assert_array_equal(ta[key], jb[key], f"{rel}:{key}")
        else:
            assert a.read_bytes() == b.read_bytes(), str(rel)
    for rel in j_files:
        if "visibility_masks" in rel.parts and rel.suffix == ".npy":
            w = weights[rel.stem]
            clear = np.abs(w - 0.5) >= TOL_W
            tm = np.load(t_dir / rel)
            np.testing.assert_array_equal(tm[clear], np.load(j_dir / rel)[clear], str(rel))
            np.testing.assert_array_equal(read_png(t_dir / rel.with_suffix(".png")) > 0, tm, str(rel))
    return j_files


def stats_line(text: str) -> dict:
    return json.loads(re.search(r"^MASK_GEOMETRY_STATS: (.*)$", text, re.M).group(1))


DRIVERS = {
    # name: (port module, app module pair, argv, files that must be there)
    "run_dtu_control": (run_dtu_control, (dtu, j_dtu), ["--height", "24", "--width", "32", "--video_frames", "4"],
                        ["DTU/data/all/visibility_prior/VW03/00021/visibility_weights/0002_0005.npy",
                         "DTU/data/all/database_data/00021/ObjectMasks/0005.png",
                         "DTU/data/train_test_sets/set03/video_poses01/VideoFrameNums.csv"]),
    "run_dtu_50k": (run_dtu_50k, (dtu, j_dtu), ["--height", "24", "--width", "32", "--video_frames", "4"],
                    ["DTU/data/all/visibility_prior/VW02/00021/visibility_masks/0000_0005.png",
                     "DTU/data/all/estimated_depths/DE02/00021/estimated_depths/0005.csv",
                     "DTU/data/train_test_sets/set02/video_poses01/00021.csv"]),
    "run_priorgen_50k": (run_priorgen_50k, (nerf_llff, j_nerf_llff),
                         ["--height", "48", "--width", "64", "--video_frames", "4", "--iters", "10"],
                         ["NeRF_LLFF/data/all/visibility_prior/VW02/synth01/visibility_weights/0005_0000.npy",
                          "NeRF_LLFF/data/train_test_sets/set02/video_poses01/synth01.csv"]),
    "run_realestate_50k": (run_realestate_50k, (real_estate, j_real_estate), ["--height", "24", "--width", "32"],
                           ["RealEstate10K/data/test/database_data/00000/rgb/0005.png",
                            "RealEstate10K/data/train_test_sets/set02/video_poses01/00000.csv"]),
    "run_demo1a_200k": (run_demo1a_200k, (nerf_llff, j_nerf_llff),
                        ["--height", "24", "--width", "32", "--video_frames", "4", "--iters", "10"],
                        ["NeRF_LLFF/data/all/database_data/synth01/rgb_down4/0005.png",
                         "NeRF_LLFF/data/train_test_sets/set02/video_poses01/VideoFrameNums.csv"]),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_builds_the_tools_workdir(name, tmp_path, monkeypatch):
    module, (t_app, j_app), argv, expected = DRIVERS[name]
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(j_app, "_run_full", lambda *a, **k: calls["jax"].append((a, k)))
    monkeypatch.setattr(t_app, "_run_full", lambda *a, **k: calls["torch"].append((a, k)))
    monkeypatch.chdir(tmp_path)
    j_out = run_tool(monkeypatch, f"{name}.py", ["--workdir", str(tmp_path / "jax"), *argv])
    t_out = run_port(module.main, ["--workdir", str(tmp_path / "torch"), *argv])

    files = assert_trees_match(tmp_path / "torch", tmp_path / "jax")
    for rel in expected:
        assert Path("data/databases", rel) in files, rel
    # the same demo call, the device and, where the JAX app fixes it, the length apart
    (j_args, j_kw), = calls["jax"]
    (t_args, t_kw), = calls["torch"]
    assert t_args == j_args and t_kw.pop("device") == "cpu"
    t_kw.pop("seed", None)
    if "num_iterations" not in j_kw:
        assert t_kw.pop("num_iterations") == 50000
    assert t_kw == j_kw
    if name == "run_priorgen_50k":
        t_stats, j_stats = stats_line(t_out), stats_line(j_out)
        assert t_stats.keys() == j_stats.keys() == {"0000_0005", "0005_0000"}
        for pair, stats in j_stats.items():
            for key, value in stats.items():
                assert abs(t_stats[pair][key] - value) <= TOL_STATS_PIXELS / (48 * 64) + 1e-4, (pair, key)


def test_a_second_call_rebuilds_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(dtu, "_run_full", lambda *a, **k: None)
    monkeypatch.chdir(tmp_path)
    argv = ["--workdir", str(tmp_path / "w"), "--height", "24", "--width", "32", "--video_frames", "4"]
    run_port(run_dtu_control.main, argv)
    stamp = {p: p.stat().st_mtime_ns for p in (tmp_path / "w").rglob("*") if p.is_file()}
    text = run_port(run_dtu_control.main, argv)
    assert "generating" not in text and "pair" not in text
    again = {p: p.stat().st_mtime_ns for p in (tmp_path / "w").rglob("*") if p.is_file()}
    assert again.keys() == stamp.keys()
    # the generator writes its Configs.json on every call; nothing else is written again
    assert [p.name for p in stamp if stamp[p] != again[p]] in ([], ["Configs.json"])


# ------------------------------------------------------------ snapshot

def forge_run(root: Path):
    rng = np.random.default_rng(3)
    run = root / "runs/training/train0042"
    (run / "00021/logs").mkdir(parents=True)
    (run / "Configs.json").write_text(json.dumps({"train_num": 42, "seed": 0}, indent=4))
    lines = []
    for step in range(1, 538):
        for tag in ("train/MSE01", "train/TotalLoss", "train/lr"):
            lines.append(json.dumps({"tag": tag, "value": float(rng.uniform()), "step": step}))
        if step % 250 == 0:
            lines.append(json.dumps({"tag": "validation/val_images/MSE01", "value": 0.05, "step": step}))
        if step == 300:
            lines.append("not json {")
    lines.append(json.dumps({"tag": "train/late", "value": 1.0, "step": 333}))
    (run / "00021/logs/scalars.jsonl").write_text("\n".join(lines) + "\n")
    test = root / "runs/testing/test0042"
    (test / "QA_Scores/predicted_frames").mkdir(parents=True)
    (test / "QA_Scores.json").write_text(json.dumps({"predicted_frames": {"PSNR05": 30.1}}, indent=4))
    (test / "Configs.json").write_text(json.dumps({"test_num": 42}))
    (test / "QA_Scores/predicted_frames/PSNR05_FrameWise.csv").write_text("scene_num,pred_frame_num,PSNR05\n21,1,30\n")


def test_evidence_snapshot_writes_the_tools_bytes(tmp_path, monkeypatch):
    forge_run(tmp_path / "run")
    run_tool(monkeypatch, "evidence_snapshot.py", [str(tmp_path / "run"), str(tmp_path / "jax"), "--stride", "100"])
    with contextlib.redirect_stdout(io.StringIO()):
        evidence_snapshot.main([str(tmp_path / "run"), str(tmp_path / "torch"), "--stride", "100"])
    j_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert len(j_files) == 5
    assert j_files == sorted(p.relative_to(tmp_path / "torch") for p in (tmp_path / "torch").rglob("*") if p.is_file())
    for rel in j_files:
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), str(rel)
    kept = (tmp_path / "torch/scalars_train0042_00021_every100.jsonl").read_text().splitlines()
    assert len(kept) == 3 * (1 + 5) + 2 + 3 + 1  # steps 1 and 100-500, validations, each tag's last, the late tag


# --------------------------------------------------------------- sweep

@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """A DTU database (set03, 24x32) and a JAX run of two checkpoints of
    seeded narrow parameters, swept by the tool and, carried to the port,
    by the port's sweep."""
    from vipnerf_tpu.apps.configs import build_train_configs as j_build_train_configs
    from vipnerf_tpu.data.loaders import get_data_loader
    from vipnerf_tpu.data.preprocessor import get_data_preprocessor
    from vipnerf_tpu.utils.config import save_configs, save_model_configs

    root = tmp_path_factory.mktemp("sweep")
    src = root / "src"
    with contextlib.redirect_stdout(io.StringIO()):
        common.write_dtu_database(src / "data/databases", set_num=3, train_frames=(0, 2, 5), val_frames=(3,),
                                  height=24, width=32, video_frames=4, with_visibility_prior=True)
    cfg = j_build_train_configs(train_num=42, scene_ids=[21], set_num=3, num_iterations=20, num_rays=128,
                                sparse_depth=True, **j_dtu._COMMON)
    for level in ("coarse_mlp", "fine_mlp"):
        cfg["model"][level].update(netdepth=6, netwidth=32, points_positional_encoding_degree=4,
                                   views_positional_encoding_degree=2)
    cfg["model"]["coarse_mlp"]["num_samples"], cfg["model"]["fine_mlp"]["num_samples"] = 16, 32
    cfg["model"].update(bf16_matmuls=False, f32_heads=False)
    cfg["data_loader"]["visibility_prior"]["masks_dirname"] = "VW02"
    run = src / "runs/training/train0042"
    (run / "00021").mkdir(parents=True)
    save_configs(run, cfg)
    cfg["data_loader"]["scene_id"] = "00021"
    raw = get_data_loader(cfg, src / "data" / cfg["database_dirpath"], mode="train").load_data()
    save_model_configs(run / "00021", get_data_preprocessor(cfg, mode="train", raw_data_dict=raw).get_model_configs())
    side = JaxSide(cfg)
    for it, seed in ((10, 1), (20, 2)):
        params = j_vn_init(cfg, seed)
        j_ckpt.save_checkpoint(run / "00021/saved_models", it, params, side.tx.init(params))
    for name in ("jax", "torch"):
        shutil.copytree(src, root / name)
    with contextlib.redirect_stdout(io.StringIO()):
        jax_ckpt.import_run(root / "torch/runs/training/train0042/00021/saved_models")
    return root


def j_vn_init(cfg, seed):
    from vipnerf_tpu.models import vip_nerf as j_vn

    return j_vn.init_params(jax.random.PRNGKey(seed), cfg)


def sweep_table(text: str):
    return json.loads(re.search(r"^SWEEP_TABLE: (.*)$", text, re.M).group(1))


def test_checkpoint_sweep_matches_the_tool(swept, monkeypatch):
    monkeypatch.setenv("VIPNERF_LPIPS_WEIGHTS", str(swept / "absent.npz"))
    monkeypatch.chdir(swept)
    argv = ["--database", "DTU", "--scene", "21", "--set_num", "3", "--train_num", "42", "--step", "10",
            "--max_iter", "30"]
    j_text = run_tool(monkeypatch, "checkpoint_sweep.py", ["--workdir", str(swept / "jax"), *argv])
    t_text = run_port(checkpoint_sweep.main, ["--workdir", str(swept / "torch"), *argv])
    j_rows, t_rows = sweep_table(j_text), sweep_table(t_text)
    assert [r["iter"] for r in t_rows] == [r["iter"] for r in j_rows] == [10, 20]
    assert "iter 30: no checkpoint, skipping" in t_text
    for t_row, j_row in zip(t_rows, j_rows):
        assert set(t_row) == set(j_row)
        assert t_row["MaskedPSNR05"] is not None and t_row["LPIPS05"] is None
        for key, value in j_row.items():
            if key in ("iter", "wall_s") or value is None:
                continue
            tol = next(t for k, t in TOL_SWEEP.items() if k in key)
            assert abs(t_row[key] - value) <= tol, (j_row["iter"], key, t_row[key], value)
    assert (swept / "torch/runs/testing/test0902/QA_Scores.json").exists()
    assert "| iter | RMSE05 |" in t_text


# ---------------------------------------------------------------- seam

SEAM_START, SEAM_STEPS = 29998, 4


def seam_configs():
    from tests.test_e2e_training import small_train_configs

    cfg = small_train_configs("/nonexistent")
    cfg["model"].update(perturb=False, raw_noise_std=0.0)
    cfg["optimizer"]["lr_initial"] = 5e-4
    cfg["losses"] = [l if l["name"] != "VisibilityPriorLoss01" else
                     {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0, "30000": 0.001}}
                     for l in cfg["losses"]]
    return cfg


def test_resume_across_the_30k_seam_matches_jax(tmp_path):
    import jax.numpy as jnp

    cfg = seam_configs()
    side = JaxSide(cfg)
    params = side.template
    opt_state = side.tx.init(params)
    opt_state = jax.tree_util.tree_map(
        lambda x: jnp.full_like(x, SEAM_START) if x.dtype == jnp.int32 and x.ndim == 0 else x, opt_state)
    assert int(adam_state(opt_state).count) == SEAM_START
    j_path = j_ckpt.save_checkpoint(tmp_path / "jax", SEAM_START, params, opt_state)

    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = make_optimizer(cfg, model.parameters())
    optimizer.count.fill_(SEAM_START)
    t_path = checkpoints.save_checkpoint(tmp_path / "torch", SEAM_START, model, optimizer)

    it, params, opt_state = side.load(j_path)
    model = t_vn.ViPNeRF(cfg)
    optimizer = make_optimizer(cfg, model.parameters())
    assert it == checkpoints.load_checkpoint(t_path, model, optimizer) == SEAM_START
    t_step = make_train_step(cfg, t_vn.render_rays, LossComputer(cfg), optimizer)
    j_schedule = j_lr_schedule(cfg)
    for i in range(SEAM_START, SEAM_START + SEAM_STEPS):
        batch = step_batch(i)
        t_lr, j_lr = float(optimizer.schedule(int(optimizer.count[0]))), float(j_schedule(int(adam_state(opt_state).count)))
        params, opt_state, sj = side.step(params, opt_state, jax_batch(i), jax.random.PRNGKey(0))
        st = t_step(model, torch_tree(batch), None)
        np.testing.assert_allclose(t_lr, j_lr, rtol=1e-12, err_msg=f"lr at {i}")
        np.testing.assert_allclose(st["TotalLoss"].item(), float(sj["TotalLoss"]), rtol=1e-4, err_msg=str(i))
        vpl = st["VisibilityPriorLoss01"].item()
        np.testing.assert_allclose(vpl, float(sj["VisibilityPriorLoss01"]), rtol=1e-4, err_msg=str(i))
        rest = sum(w * st[k].item() for k, w in (("MSE01", 1), ("VisibilityLoss01", 0.1), ("SparseDepthMSE01", 0.1)))
        switched = abs(st["TotalLoss"].item() - rest - 0.001 * vpl) < 1e-6 * abs(st["TotalLoss"].item())
        assert switched == (i >= 30000), i
    assert int(optimizer.count[0]) == int(adam_state(opt_state).count) == SEAM_START + SEAM_STEPS


# ----------------------------------------------------------- reference

def test_jax_figures_are_the_committed_evidence():
    """The constants run_dtu_control holds the port to, read back from
    protocol_evidence/dtu_control_3view/ as they are defined there."""
    scalars = common.read_scalars(EVIDENCE / "scalars_train0042_00021_every100.jsonl")
    qa = json.loads((EVIDENCE / "test0901/QA_Scores.json").read_text())["predicted_frames"]
    sweep = sweep_table((EVIDENCE / "checkpoint_sweep.jsonl").read_text())[0]
    assert sweep["iter"] == 10000
    for key, value in run_dtu_control.JAX_QA_10K.items():
        assert qa[key] == sweep[key] == value
    for (lo, hi), value in run_dtu_control.JAX_MSE_WINDOWS.items():
        assert run_dtu_control.window_median(scalars["train/MSE01"], lo, hi) == value
    for step, value in run_dtu_control.JAX_MSE_AT.items():
        assert scalars["train/MSE01"][step] == value
    assert scalars["validation/val_images/MSE01"][10000] == run_dtu_control.JAX_VAL_MSE_10K
    assert scalars["validation/train_images/MSE01"][10000] == run_dtu_control.JAX_TRAIN_IMAGES_MSE_10K
    for step, value in run_dtu_control.JAX_LR.items():
        assert scalars["train/lr"][step] == value
        np.testing.assert_allclose(value, 5e-4 * 0.1 ** ((step - 1) / 250000), rtol=1e-12)


@pytest.mark.parametrize("seed,masked_psnr", [("", 31.107), ("seed1", 34.9698), ("seed2", 32.9577),
                                               ("seed1_k1_f32h", 36.4572)],
                         ids=["seed0", "seed1", "seed2", "seed1_k1_f32h"])
def test_committed_port_evidence_against_the_jax_run(seed, masked_psnr):
    """The port's committed 10k legs (shipped mode, on an H100; seeds 0-2
    through the module MLP, seed 1 again through K1's bf16_f32h instance):
    the comparison each driver printed, recomputed from the committed
    snapshot. Seed 0's masked PSNR misses the 2 dB band below, the K1 leg's
    above it, seeds 1 and 2 through the module are inside it; every
    train/MSE01 window and the LR are inside theirs."""
    port = ROOT / "vipnerf_tpu_torch/protocol/evidence/dtu_control_3view_10k" / seed
    scalars = common.read_scalars(port / "scalars_train0042_00021_every100.jsonl")
    qa = json.loads((port / "test0042/QA_Scores.json").read_text())
    if not seed:  # the sweep's test of the same checkpoint
        assert qa == json.loads((port / "test0901/QA_Scores.json").read_text())
    out = run_dtu_control.compare_with_jax(scalars, qa, 10000)
    assert [w["steps"] for w in out["mse_windows"]] == [list(w) for w in run_dtu_control.JAX_MSE_WINDOWS]
    assert all(w["within"] for w in out["mse_windows"])
    assert out["lr_10000"]["rel_diff"] == 0.0
    assert max(scalars["train/TotalLoss"]) == 10000 and len(scalars["train/TotalLoss"]) == 101
    assert out["qa_10k"]["MaskedPSNR05"]["port"] == masked_psnr
    assert out["within_bands"] is (abs(masked_psnr - 33.8623) <= 2.0)


def reference_scalars(lr_shift=0.0):
    steps = range(1, 10001)
    return {"train/MSE01": {s: 0.01 for s in steps},
            "train/lr": {s: 5e-4 * 0.1 ** ((s - 1) / 250000) * (1 + lr_shift) for s in steps},
            "validation/val_images/MSE01": {10000: 0.05}}


@pytest.mark.parametrize("mse_ratio,lr_shift,masked_psnr,within", [
    (1.2, 0.0, 33.0, True),
    (1.2, 0.0, 31.5, False),  # 2.36 dB below the JAX run
    (1.2, 2e-6, 33.0, False),  # the LR 2e-6 relative off
    (1.6, 0.0, 33.0, False),  # MSE medians 1.6x the JAX run's
], ids=["inside", "psnr", "lr", "mse"])
def test_comparison_bands(mse_ratio, lr_shift, masked_psnr, within):
    scalars = reference_scalars(lr_shift)
    for (lo, hi), ref in run_dtu_control.JAX_MSE_WINDOWS.items():
        for s in range(lo, hi + 1):
            scalars["train/MSE01"][s] = mse_ratio * ref
    qa = {"predicted_frames": {"MaskedPSNR05": masked_psnr, "PSNR05": 29.0, "MaskedSSIM05": 0.97}}
    out = run_dtu_control.compare_with_jax(scalars, qa, 10000)
    assert out["within_bands"] is within
    assert [w["ratio"] for w in out["mse_windows"]] == pytest.approx([mse_ratio] * 4)
    assert out["qa_10k"]["MaskedPSNR05"]["port"] == masked_psnr
    assert out["lr_10000"]["within"] is (lr_shift == 0.0)
    first_half = {tag: {s: v for s, v in series.items() if s <= 5000} for tag, series in scalars.items()}
    short = run_dtu_control.compare_with_jax(first_half, qa, 5000)  # a leg to 5000: three windows, no QA
    assert "qa_10k" not in short and "lr_10000" not in short
    assert [w["steps"] for w in short["mse_windows"]] == [[100, 1000], [1000, 2000], [4000, 5000]]


def test_leg_figures_read_the_trainer_lines():
    """The figures of a leg come from the trainer's chunk spans and the
    app's stage spans: the median over full chunks only."""
    tracer = tracing.Tracer()
    t = 0
    for steps, seconds in ((100, 9.0), (100, 9.4), (50, 4.0)):
        tracer.add("train.chunk", t, t + int(seconds * 1e9), it=0, steps=steps)
        t += int(seconds * 1e9)
    tracer.add("app.training", 0, int(30e9))
    leg = common.leg_figures(tracer.snapshot()["spans"], 300)
    assert leg["ms_per_step_median"] == pytest.approx(92.0) and leg["full_chunks"] == 2
    assert leg["ms_per_step_range"] == pytest.approx([90.0, 94.0])
    assert leg["steps_per_s_over_training"] == pytest.approx(10.0)
    assert leg["stage_s"] == {"training": pytest.approx(30.0)}
    tracer.reset()
    empty = common.leg_figures(tracer.snapshot()["spans"], 0)
    assert empty["full_chunks"] == 0 and empty["ms_per_step_median"] is None and empty["stage_s"] == {}


def test_each_leg_of_one_process_reports_its_own_rate(tmp_path, monkeypatch):
    """Two legs of run_dtu_control in one process, as chip_smoke's phase 8
    runs them: 200 steps, then a resume at 29,950 to 30,050. Each summary
    counts its own leg's steps over its own training seconds; the prior's
    directions are timed in the first leg and skipped in the second."""
    legs = {200: (0, 20.0), 30050: (29950, 4.0)}  # iters: (first step - 1, training seconds)

    def run_full(train_num, set_num, *, num_iterations, **kwargs):
        start, seconds = legs[num_iterations]
        logs = Path(f"runs/training/train{train_num:04}/00021/logs")  # the driver runs from its workdir
        logs.mkdir(parents=True, exist_ok=True)
        with (logs / "scalars.jsonl").open("a") as f:
            for step in range(start + 1, num_iterations + 1):
                f.write(json.dumps({"tag": "train/TotalLoss", "value": 0.1, "step": step}) + "\n")
        t0, chunks = clock["ns"], (num_iterations - start) // 100  # the leg's spans on a fake clock
        tracing.add("app.training", t0, t0 + int(seconds * 1e9))
        for i in range(chunks):
            chunk_ns = int(seconds * 1e9 / ((num_iterations - start) / 100))
            tracing.add("train.chunk", t0 + i * chunk_ns, t0 + (i + 1) * chunk_ns, it=start + 100 * i, steps=100)
        clock["ns"] = t0 + int(seconds * 1e9)

    clock = {"ns": time.perf_counter_ns()}
    monkeypatch.setattr(common, "time", SimpleNamespace(perf_counter=time.perf_counter,
                                                        perf_counter_ns=lambda: clock["ns"]))
    monkeypatch.setattr(dtu, "_run_full", run_full)
    monkeypatch.chdir(tmp_path)
    argv = ["--workdir", str(tmp_path / "w"), "--height", "24", "--width", "32", "--video_frames", "4",
            "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        first = run_dtu_control.main(argv + ["--iters", "200"])
        second = run_dtu_control.main(argv + ["--iters", "30050"])
    assert first["steps"] == 200 and second["steps"] == 100
    assert first["steps_per_s_over_training"] == 200 / 20.0 and second["steps_per_s_over_training"] == 100 / 4.0
    assert first["ms_per_step_median"] == pytest.approx(100.0) and second["ms_per_step_median"] == pytest.approx(40.0)
    assert first["full_chunks"] == 2 and second["full_chunks"] == 1
    assert len(first["prior_s_per_direction"]) == 6 and first["prior_devices"] == ["cpu"]
    assert second["prior_s_per_direction"] == [] and second["prior_devices"] == []


def test_a_longer_leg_moves_the_earlier_tests_aside(tmp_path):
    test = tmp_path / "runs/testing/test0042"
    test.mkdir(parents=True)
    (test / "Configs.json").write_text(json.dumps({"model_name": "Model_Iter005000.tar"}))
    assert common.retire_stale_testing(tmp_path, 42, 5000) is None and test.exists()
    with contextlib.redirect_stdout(io.StringIO()):
        moved = common.retire_stale_testing(tmp_path, 42, 10000)
    assert moved == tmp_path / "runs/testing/test0042_Model_Iter005000" and not test.exists()
    assert common.retire_stale_testing(tmp_path, 42, 10000) is None


def test_a_one_frame_video_list_writes_one_frame(tmp_path, monkeypatch):
    """VideoFrameNums.csv of one number: np.loadtxt gives a 0-d array, which
    indexed the frame stack as one frame's rows (the JAX package's app
    writes H frames of one row there); the port keeps it a list."""
    written = {}
    monkeypatch.setattr("vipnerf_tpu_torch.apps.common.save_video",
                        lambda path, frames: written.setdefault(Path(path).name, frames.shape))
    monkeypatch.setattr("vipnerf_tpu_torch.apps.common.tester_mod.start_testing",
                        lambda cfg, scenes, suffix: tmp_path / "runs/testing/test0001")
    monkeypatch.setattr("vipnerf_tpu_torch.apps.common.read_image", lambda p: np.zeros((6, 8, 3), np.uint8))
    sets = tmp_path / "data/databases/DTU/data/train_test_sets/set02"
    (sets / "video_poses01").mkdir(parents=True)
    (sets / "TestVideosData.csv").write_text("scene_num,pred_frame_num\n21,1\n")
    np.savetxt(sets / "video_poses01/00021.csv", np.tile(np.eye(4).reshape(1, 16), (3, 1)), delimiter=",")
    np.savetxt(sets / "video_poses01/VideoFrameNums.csv", np.arange(0, 2, 2), delimiter=",")
    (tmp_path / "runs/testing/test0001/00021_video01").mkdir(parents=True)
    app = DatasetApp("DTU", "scene_num", "all", root_dirpath=tmp_path)
    app.start_testing_videos({"test_num": 1, "test_set_num": 2, "database_dirpath": "DTU/data",
                              "scene_nums": [21], "train_num": 1, "model_name": "Model_Iter000001.tar"})
    assert written == {"PredictedVideo.mp4": (1, 6, 8, 3)}


# ------------------------------------------------------------ trajectory

TRAJ_STEPS = 100
TRAJ_LOSSES = ("MSE01", "VisibilityLoss01", "SparseDepthMSE01", "VisibilityPriorLoss01")
TRAJ_MODES = {"shipped": (True, True), "f32": (False, False)}  # (bf16_matmuls, f32_heads)
# Measured on the CPU at two threads: the first step's loss terms within 1.1e-7 (f32) and 1.0e-5 (shipped: the
# bf16 trunk rounds apart from XLA's), growing with the steps to at most 7.7e-4 (f32) and 3.6e-4; the parameters'
# distance from the JAX run's, over their change from the start, 1.5e-2 (f32) and 7.7e-3 (Adam scales the
# rounding noise of near-zero gradients up to the learning rate).
TRAJ_TOL_FIRST = {"shipped": 1e-4, "f32": 1e-6}
TRAJ_TOL_STEP = 5e-3
TRAJ_TOL_PARAMS = 5e-2


@pytest.fixture(scope="module")
def dtu_scan(tmp_path_factory):
    """The DTU control's database at 24x32: set03, train views (0, 2, 5),
    validation view 3, object masks, sparse depths DE03 and VW03 from the
    port's generator (DTU's policy)."""
    from vipnerf_tpu_torch.priors.cli import main_visibility

    root = tmp_path_factory.mktemp("dtu_traj")
    with contextlib.redirect_stdout(io.StringIO()):
        common.write_dtu_database(root / "data/databases", set_num=3, train_frames=(0, 2, 5), val_frames=(3,),
                                  height=24, width=32, video_frames=4, with_visibility_prior=False)
        main_visibility(["--database", "DTU", "--gen_nums", "3", "--root_dirpath", str(root), "--device", "cpu"])
    return root


@pytest.mark.parametrize("mode", sorted(TRAJ_MODES))
def test_dtu_control_trajectory_matches_jax(dtu_scan, mode):
    """The DTU control's seed-0 miss at 10k, held against the step:
    demo1b's configs (metric space, 3 views, sparse depth, VW03) at
    width 32 and 128 + 128 rays, perturbation and sigma noise off, 100
    steps of the port's train step against the JAX package's from the same
    weights on the same native-raystream batches, in the shipped mode (bf16
    trunk, f32 heads) and in f32. Every step's four loss terms and the
    final parameters agree to rounding (the tolerances above)."""
    from vipnerf_tpu.apps.configs import build_train_configs as j_build_train_configs
    from vipnerf_tpu.data.loaders import get_data_loader as j_get_data_loader
    from vipnerf_tpu.data.preprocessor import get_data_preprocessor as j_get_data_preprocessor
    from vipnerf_tpu.models import vip_nerf as j_vn
    from vipnerf_tpu_torch.data.loaders import get_data_loader
    from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor

    cfg = j_build_train_configs(train_num=42, scene_ids=[21], set_num=3, num_iterations=TRAJ_STEPS, num_rays=128,
                                sparse_depth=True, sparse_depth_rays=128, **j_dtu._COMMON)
    assert cfg["data_loader"]["visibility_prior"]["masks_dirname"] == "VW03" and not cfg["data_loader"]["ndc"]
    for level in ("coarse_mlp", "fine_mlp"):
        cfg["model"][level]["netwidth"] = 32
    cfg["model"]["coarse_mlp"]["num_samples"], cfg["model"]["fine_mlp"]["num_samples"] = 16, 32
    bf16, f32_heads = TRAJ_MODES[mode]
    cfg["model"].update(perturb=False, raw_noise_std=0.0, bf16_matmuls=bf16, f32_heads=f32_heads)
    cfg["root_dirpath"], cfg["device"] = str(dtu_scan), "cpu"
    cfg["data_loader"]["scene_id"] = "00021"
    db = dtu_scan / "data" / cfg["database_dirpath"]

    jprep = j_get_data_preprocessor(cfg, mode="train", raw_data_dict=j_get_data_loader(cfg, db, mode="train").load_data())
    tprep = get_data_preprocessor(cfg, mode="train", device=torch.device("cpu"),
                                  raw_data_dict=get_data_loader(cfg, db, mode="train").load_data())
    nerf, sd = tprep.get_index_chunk(0, TRAJ_STEPS)
    j_nerf, j_sd = jprep.get_index_chunk(0, TRAJ_STEPS)
    np.testing.assert_array_equal(nerf, j_nerf)
    np.testing.assert_array_equal(sd, j_sd)

    side = JaxSide(cfg)
    params = init = j_vn.init_params(jax.random.PRNGKey(0), cfg)
    opt_state = side.tx.init(params)
    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    step = make_train_step(cfg, t_vn.render_rays, LossComputer(cfg), make_optimizer(cfg, model.parameters()))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for it in range(TRAJ_STEPS):
            jb = jprep.gather_batch(jax.numpy.asarray(nerf[it]), jax.numpy.asarray(sd[it]), it)
            params, opt_state, sj = side.step(params, opt_state, jb, jax.random.PRNGKey(0))
            st = step(model, tprep.gather_batch(torch.from_numpy(nerf[it]), torch.from_numpy(sd[it]), it), None)
            for name in TRAJ_LOSSES:
                np.testing.assert_allclose(st[name].item(), float(sj[name]), err_msg=f"{name} at step {it}",
                                           rtol=TRAJ_TOL_FIRST[mode] if it == 0 else TRAJ_TOL_STEP)
    finally:
        torch.set_num_threads(threads)
    want, start = (state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, p)) for p in (params, init))
    got = model.state_dict()
    dist = math.sqrt(sum(float(((got[k] - want[k]) ** 2).sum()) for k in want))
    moved = math.sqrt(sum(float(((want[k] - start[k]) ** 2).sum()) for k in want))
    assert dist <= TRAJ_TOL_PARAMS * moved, (dist, moved)
