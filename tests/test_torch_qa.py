"""The port's QA against the JAX package: RMSE, PSNR and SSIM with and
without an object mask, LPIPS(AlexNet) on random weights, the scene-wise
grouper, and the runner end to end (QA_Scores.json, the frame-wise and
scene-wise CSVs, the incremental merge with an earlier CSV, a missing
prediction, DTU's masked metrics).

Tolerances: the metrics 1e-9 (the same numpy and scipy code on both sides);
LPIPS 1e-5 (torch's and XLA's f32 convolutions sum in other orders);
scores and CSVs equal, since both round to 4 decimals the same numbers.
"""

import json
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from vipnerf_tpu.data.synthetic import make_dtu_scene as j_make_dtu_scene
from vipnerf_tpu.data.synthetic import write_synthetic_database as j_write_database
from vipnerf_tpu.qa import grouper as j_grouper
from vipnerf_tpu.qa import lpips_jax as j_lpips
from vipnerf_tpu.qa import metrics as j_metrics
from vipnerf_tpu.qa import runner as j_runner
from vipnerf_tpu_torch.qa import grouper, lpips, metrics, runner
from vipnerf_tpu_torch.utils.io import read_csv_columns, save_image

H, W = 24, 32


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: idle ones spin on the cores of other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("name", ["compute_rmse", "compute_psnr", "compute_ssim"])
def test_metrics_match_jax(name, masked):
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    pred = np.clip(gt.astype(int) + rng.integers(-30, 31, gt.shape), 0, 255).astype(np.uint8)
    args = (gt, pred, rng.uniform(size=(40, 50)) > 0.4) if masked else (gt, pred)
    ours, ref = getattr(metrics, name)(*args), getattr(j_metrics, name)(*args)
    assert isinstance(ours, float) and np.isfinite(ours)
    assert ours == pytest.approx(ref, abs=1e-9, rel=0)


# ------------------------------------------------------------------ LPIPS

_CONVS = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3), (256, 256, 3)]


def random_lpips_weights(path, seed=0):
    rng = np.random.default_rng(seed)
    params = {}
    for i, (out_ch, in_ch, k) in enumerate(_CONVS):
        params[f"conv{i}_w"] = rng.normal(0, 0.1, (out_ch, in_ch, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.1, (out_ch,)).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 0.1, (1, out_ch, 1, 1))).astype(np.float32)
    np.savez(path, **params)
    return params


def test_lpips_matches_jax(tmp_path, monkeypatch):
    weights = tmp_path / "lpips_alex.npz"
    params = random_lpips_weights(weights)
    rng = np.random.default_rng(1)
    gt = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    pred = np.clip(gt.astype(int) + rng.integers(-40, 41, gt.shape), 0, 255).astype(np.uint8)

    ref = j_lpips.LpipsAlex(params).distance(gt, pred)
    model = lpips.LpipsAlex(params)
    assert isinstance(model, torch.nn.Module)
    assert model.distance(gt, pred) == pytest.approx(ref, abs=1e-5, rel=0)
    assert model.distance(gt, gt) == 0.0

    monkeypatch.setenv("VIPNERF_LPIPS_WEIGHTS", str(weights))
    assert lpips.default_weights_path() == j_lpips.default_weights_path() == weights
    ours, theirs = metrics.LpipsMetric(torch.device("cpu")), j_metrics.LpipsMetric()
    assert ours.available and theirs.available
    mask = rng.uniform(size=(64, 64)) > 0.5
    assert ours(gt, pred, mask) == pytest.approx(theirs(gt, pred, mask), abs=1e-5, rel=0)
    assert ours(gt, pred) == pytest.approx(ref, abs=1e-5, rel=0)


def test_lpips_scores_none_without_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("VIPNERF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    assert lpips.load_default_lpips(torch.device("cpu")) is None
    metric = metrics.LpipsMetric(torch.device("cpu"))
    assert not metric.available
    assert metric(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3), np.uint8)) is None
    monkeypatch.delenv("VIPNERF_LPIPS_WEIGHTS")
    assert lpips.default_weights_path() == j_lpips.default_weights_path().resolve()


# ---------------------------------------------------------------- grouper

def test_grouper_matches_pandas_groupby():
    """Grouped by every column but the last two, keys sorted, NaN skipped in
    the mean, the metric rounded to 4 decimals."""
    rng = np.random.default_rng(2)
    n = 23
    table = {"scene_name": rng.choice(["room", "fern", "horns"], n), "split": rng.choice([2, 1], n),
             "pred_frame_num": rng.integers(0, 40, n), "PSNR02": rng.uniform(10, 30, n)}
    table["PSNR02"][[3, 7]] = np.nan
    ours = grouper.get_grouped_qa_scores(table)
    ref = j_grouper.get_grouped_qa_scores(pd.DataFrame(table))
    assert list(ours) == list(ref.columns) == ["scene_name", "split", "PSNR02"]
    for col in ref.columns:
        if ref[col].dtype.kind == "f":
            np.testing.assert_allclose(ours[col], ref[col].to_numpy(), atol=1e-12, rtol=0)
        else:
            np.testing.assert_array_equal(ours[col], ref[col].to_numpy())


# ----------------------------------------------------------------- runner

def write_predictions(db_dir, gt_images, pred_root, scene_dir, frames, seed):
    rng = np.random.default_rng(seed)
    out = pred_root / scene_dir / "predicted_frames"
    out.mkdir(parents=True, exist_ok=True)
    for f in frames:
        img = np.clip(gt_images[f].astype(int) + rng.integers(-20, 21, gt_images[f].shape), 0, 255)
        save_image(out / f"{f:04}.png", img.astype(np.uint8))


def assert_qa_dirs_equal(t_root, j_root):
    assert json.loads((t_root / "QA_Scores.json").read_text()) == json.loads((j_root / "QA_Scores.json").read_text())
    j_csvs = sorted(p.relative_to(j_root) for p in (j_root / "QA_Scores").rglob("*.csv"))
    assert j_csvs == sorted(p.relative_to(t_root) for p in (t_root / "QA_Scores").rglob("*.csv"))
    for rel in j_csvs:
        j_table = pd.read_csv(j_root / rel)
        pd.testing.assert_frame_equal(pd.read_csv(t_root / rel), j_table, check_exact=False, atol=1e-12, rtol=0)
        ours = read_csv_columns(t_root / rel)
        assert list(ours) == list(j_table.columns)
        for col in j_table.columns:
            np.testing.assert_array_equal(ours[col], j_table[col].to_numpy(), err_msg=str(rel))
    return j_csvs


@pytest.fixture
def no_lpips_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("VIPNERF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))


def test_runner_matches_jax_on_llff_with_an_incremental_merge(tmp_path, no_lpips_weights):
    """Two scenes whose rows the frames CSV lists out of order. The first run
    misses one prediction; the second scores it and merges it into the
    earlier CSVs (the union sorted by scene and frame)."""
    db_root = tmp_path / "data/databases"
    images = {}
    for seed, scene in enumerate(("synthB", "synthA")):
        images[scene] = j_write_database(db_root, scene_name=scene, num_frames=5, train_frames=(0, 4),
                                         val_frames=(1,), height=H, width=W, seed=seed,
                                         with_visibility_prior=False, with_sparse_depth=False)["images"]
    db_dir = db_root / "NeRF_LLFF/data"
    frames_csv = db_dir / "train_test_sets/set02/TestVideosData.csv"
    assert read_csv_columns(frames_csv)["scene_name"].tolist() == ["synthB", "synthB", "synthA", "synthA"]

    preds = {"jax": tmp_path / "jax/test0001", "torch": tmp_path / "torch/test0001"}
    for k, seed in (("synthB", 0), ("synthA", 1)):
        write_predictions(db_dir, images[k], tmp_path / "src", k, [2, 3] if k == "synthA" else [2], seed)
    for root in preds.values():
        shutil.copytree(tmp_path / "src", root)

    j_res = j_runner.run_all_qa("NeRF_LLFF", preds["jax"], db_dir, frames_csv)
    t_res = runner.run_all_qa("NeRF_LLFF", preds["torch"], db_dir, frames_csv, device="cpu")
    assert t_res == j_res and t_res["LPIPS"] is None and np.isfinite(t_res["PSNR"])
    csvs = assert_qa_dirs_equal(preds["torch"], preds["jax"])
    assert len(csvs) == 6  # RMSE, PSNR, SSIM: frame-wise and scene-wise
    scores = json.loads((preds["torch"] / "QA_Scores.json").read_text())["predicted_frames"]
    assert scores["LPIPS02"] is None and set(scores) == {"RMSE02", "PSNR02", "SSIM02", "LPIPS02"}
    first = read_csv_columns(preds["torch"] / "QA_Scores/predicted_frames/PSNR02_FrameWise.csv")
    assert list(zip(first["scene_name"], first["pred_frame_num"])) == [("synthB", 2), ("synthA", 2), ("synthA", 3)]

    write_predictions(db_dir, images["synthB"], tmp_path / "late", "synthB", [3], 2)
    for root in preds.values():
        shutil.copytree(tmp_path / "late", root, dirs_exist_ok=True)
    j_res = j_runner.run_all_qa("NeRF_LLFF", preds["jax"], db_dir, frames_csv)
    t_res = runner.run_all_qa("NeRF_LLFF", preds["torch"], db_dir, frames_csv, device="cpu")
    assert t_res == j_res
    assert_qa_dirs_equal(preds["torch"], preds["jax"])
    merged = read_csv_columns(preds["torch"] / "QA_Scores/predicted_frames/PSNR02_FrameWise.csv")
    assert list(zip(merged["scene_name"], merged["pred_frame_num"])) == [
        ("synthA", 2), ("synthA", 3), ("synthB", 2), ("synthB", 3)]
    scene_wise = read_csv_columns(preds["torch"] / "QA_Scores/predicted_frames/PSNR02_SceneWise.csv")
    assert scene_wise["scene_name"].tolist() == ["synthA", "synthB"]


def test_runner_matches_jax_on_dtu_masked(tmp_path, no_lpips_weights):
    """DTU's masked metrics over ObjectMasks; test frame 2 has no mask, so
    only the unmasked metrics score it. Driven through each runner's CLI."""
    db_root = tmp_path / "data/databases"
    scene, ring = j_make_dtu_scene()
    gt = j_write_database(db_root, dataset="DTU", scene_name="1", num_frames=4, train_frames=(0, 3),
                          val_frames=(), height=H, width=W, scene=scene, with_visibility_prior=False,
                          with_sparse_depth=False, **ring)
    db_dir = db_root / "DTU/data"
    masks_dir = db_dir / "all/database_data/00001/ObjectMasks"
    masks_dir.mkdir()
    save_image(masks_dir / "0001.png", (gt["depths"][1] < np.percentile(gt["depths"][1], 40)).astype(np.uint8) * 255)
    write_predictions(db_dir, gt["images"], tmp_path / "src", "00001", [1, 2], 3)
    preds = {"jax": tmp_path / "jax/test0041", "torch": tmp_path / "torch/test0041"}
    for root in preds.values():
        shutil.copytree(tmp_path / "src", root)

    frames_csv = db_dir / "train_test_sets/set02/TestVideosData.csv"
    argv = ["--database", "DTU", "--database_dirpath", str(db_dir), "--frames_datapath", str(frames_csv)]
    runner.main(argv + ["--pred_videos_dirpath", str(preds["torch"]), "--device", "cpu"])
    monkey_argv = ["runner"] + argv + ["--pred_videos_dirpath", str(preds["jax"])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.argv", monkey_argv)
        j_runner.main()
    csvs = assert_qa_dirs_equal(preds["torch"], preds["jax"])
    assert len(csvs) == 12
    scores = json.loads((preds["torch"] / "QA_Scores.json").read_text())["predicted_frames"]
    assert scores["MaskedLPIPS05"] is None and np.isfinite(scores["MaskedPSNR05"])
    masked = read_csv_columns(preds["torch"] / "QA_Scores/predicted_frames/MaskedRMSE05_FrameWise.csv")
    assert masked["pred_frame_num"].tolist() == [1]
    assert read_csv_columns(preds["torch"] / "QA_Scores/predicted_frames/RMSE05_FrameWise.csv")[
        "pred_frame_num"].tolist() == [1, 2]


def test_runner_skips_missing_dirs(tmp_path, capsys):
    assert runner.start_qa("RMSE", metrics.compute_rmse, "NeRF_LLFF", tmp_path / "absent", tmp_path,
                           tmp_path / "frames.csv") is None
    assert "pred_videos_dirpath does not exist" in capsys.readouterr().out


def test_downsampled_ground_truth_matches_jax(tmp_path):
    """--downsampling_factor: the ground truth is area-downscaled and rounded
    to uint8 before it is scored."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (H * 2, W * 2, 3), dtype=np.uint8)
    np.testing.assert_array_equal(runner._downsample_uint8(image, 2), j_runner._downsample_uint8(image, 2))
