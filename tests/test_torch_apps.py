"""The port's dataset apps against the JAX package: every demo's configs,
`build_scenes_data`, `rescale_image` against OpenCV, `save_video`,
`export_plots`, and the NeRF_LLFF app end to end on the CPU at a tiny config
(train, test with its QA subprocess, both video tracks).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from vipnerf_tpu.apps import dtu as j_dtu
from vipnerf_tpu.apps import nerf_llff as j_nerf_llff
from vipnerf_tpu.apps import real_estate as j_real_estate
from vipnerf_tpu.data.synthetic import make_camera_ring
from vipnerf_tpu.data.synthetic import make_dtu_scene as j_make_dtu_scene
from vipnerf_tpu.data.synthetic import write_synthetic_database as j_write_database
from vipnerf_tpu.utils.io import rescale_image as j_rescale_image
from vipnerf_tpu_torch.apps import common, dtu, nerf_llff, real_estate
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.train.logging import export_plots
from vipnerf_tpu_torch.utils.io import read_image, read_png, rescale_image, save_video

# the TPU memory knobs the port does not read
DROPPED_MODEL_KEYS = ("remat", "netchunk_map", "netchunk_map_infer")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: idle ones spin on the cores of other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- configs

def recorded_calls(module, monkeypatch):
    """Run the demos of an app module with its DatasetApp's entry points
    replaced by a recorder: the (method, configs) of every call."""
    calls = []
    for method in ("start_training", "start_testing", "start_testing_videos", "start_testing_static_videos"):
        monkeypatch.setattr(module.app, method, lambda cfg, _m=method, **kw: calls.append((_m, cfg)))
    for name in ("demo1a", "demo1b", "demo1c", "demo1d", "demo1e", "demo1f", "demo2", "demo4"):
        module.DEMOS[name]()
    return calls


@pytest.mark.parametrize("ours,theirs", [(nerf_llff, j_nerf_llff), (real_estate, j_real_estate), (dtu, j_dtu)],
                         ids=["nerf_llff", "real_estate", "dtu"])
def test_demo_configs_match_jax(ours, theirs, monkeypatch):
    """Equal but for the dropped TPU keys and the `.tar` checkpoints."""
    mine, ref = recorded_calls(ours, monkeypatch), recorded_calls(theirs, monkeypatch)
    assert [m for m, _ in mine] == [m for m, _ in ref] and len(ref) > 24
    for (method, cfg), (_, ref_cfg) in zip(mine, ref):
        ref_cfg = json.loads(json.dumps(ref_cfg))
        if "model" in ref_cfg:
            for key in DROPPED_MODEL_KEYS:
                assert key in ref_cfg["model"] and key not in cfg["model"]
                del ref_cfg["model"][key]
            assert cfg["scan_steps"] == 100
            assert cfg["model"]["bf16_matmuls"] and cfg["model"]["f32_heads"]
        if "model_name" in ref_cfg:
            assert ref_cfg["model_name"].endswith(".ckpt")
            ref_cfg["model_name"] = ref_cfg["model_name"][:-5] + ".tar"
        assert json.loads(json.dumps(cfg)) == ref_cfg, method
    assert ours.ENTRY_NAME == theirs.ENTRY_NAME and ours.SCENES == theirs.SCENES
    assert (ours.app.dataset, ours.app.scene_key, ours.app.split_dir) == (
        theirs.app.dataset, theirs.app.scene_key, theirs.app.split_dir)


@pytest.mark.parametrize("module", ["nerf_llff", "real_estate", "dtu"])
def test_apps_run_as_modules(module, tmp_path):
    """`python -m vipnerf_tpu_torch.apps.<app> demo2` resumes a run that is
    not there: the error is reported with its traceback and the exit status
    is 1."""
    res = subprocess.run([sys.executable, "-m", f"vipnerf_tpu_torch.apps.{module}", "demo2"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parents[1])})
    assert res.returncode == 1
    assert "Program started at" in res.stdout and "Error: " in res.stdout and "Traceback" in res.stderr


def test_batch_scenes_names_the_multi_device_slice(tmp_path, monkeypatch):
    """`batch_scenes` goes to the batched trainer (trained end to end in
    tests/test_torch_multi_scene.py, over two CPU ranks in
    tests/test_torch_parallel.py), with the device list as given: two CPU
    ranks pass through, and the QA subprocess gets them as "cpu,cpu";
    [0, 1] without CUDA raises instead of falling back to the CPU."""
    calls = []
    monkeypatch.setattr(common.multi_scene, "start_training_batched", calls.append)
    monkeypatch.setattr(common.trainer_mod, "start_training", lambda cfg: calls.append(None) or {})
    app = common.DatasetApp("NeRF_LLFF", "scene_name", "all", root_dirpath=tmp_path)
    app.start_training({"train_num": 1, "batch_scenes": True, "device": ["cpu", "cpu"]})
    assert calls == [{"train_num": 1, "batch_scenes": True, "device": ["cpu", "cpu"],
                      "root_dirpath": str(tmp_path)}]
    app.start_training({"train_num": 1})
    assert calls[-1] is None
    assert common._device_arg(["cpu", "cpu"]) == "cpu,cpu" and common._device_arg([0, 1]) == "0,1"
    from vipnerf_tpu_torch.utils.device import device_from_arg, resolve_device

    assert device_from_arg("cpu,cpu") == ["cpu", "cpu"] and device_from_arg("0,1") == [0, 1]
    assert resolve_device(["cpu", "cpu"]) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device([0, 1])


@pytest.mark.parametrize("dataset", ["NeRF_LLFF", "DTU"])
def test_build_scenes_data_matches_jax(tmp_path, dataset):
    from vipnerf_tpu.apps.common import DatasetApp as JDatasetApp

    db_root = tmp_path / "data/databases"
    kwargs = dict(num_frames=6, train_frames=(0, 2, 5), val_frames=(1,), height=12, width=16,
                  with_visibility_prior=False, with_sparse_depth=False)
    if dataset == "DTU":
        scene, ring = j_make_dtu_scene()
        for name in ("21", "8"):
            j_write_database(db_root, dataset="DTU", scene_name=name, scene=scene, **ring, **kwargs)
        app_args = ("DTU", "scene_num", "all")
        configs = {"test_set_num": 2, "database_dirpath": "DTU/data"}
        chosen, chosen_dir = {"scene_nums": [21]}, "00021"
    else:
        for name in ("synthB", "synthA"):
            j_write_database(db_root, scene_name=name, resolution_suffix="_down4", **kwargs)
        app_args = ("NeRF_LLFF", "scene_name", "all")
        configs = {"test_set_num": 2, "database_dirpath": "NeRF_LLFF/data", "resolution_suffix": "_down4"}
        chosen, chosen_dir = {"scene_names": ["synthB"]}, "synthB"
    for extra in ({}, chosen):  # every scene of the test set, or the configs' own
        cfg = {**configs, **extra}
        ours = common.DatasetApp(*app_args, root_dirpath=tmp_path).build_scenes_data(cfg)
        ref = JDatasetApp(*app_args, root_dirpath=tmp_path).build_scenes_data(cfg)
        assert list(ours) == list(ref)
        for scene_dir, data in ref.items():
            assert ours[scene_dir]["output_dirname"] == data["output_dirname"] == scene_dir
            assert list(ours[scene_dir]["frames_data"]) == list(data["frames_data"]) == [0, 2, 3, 4, 5]
            for f, fd in data["frames_data"].items():
                mine = ours[scene_dir]["frames_data"][f]
                assert mine.keys() == fd.keys() and mine["is_train_frame"] == fd["is_train_frame"]
                for key in ("extrinsic", "intrinsic"):
                    np.testing.assert_array_equal(mine[key], fd[key])
    assert list(ours) == [chosen_dir]


# ------------------------------------------------------------ image and I/O

@pytest.mark.parametrize("factor", [2, 4, 1.5])
def test_rescale_image_matches_opencv(factor):
    """OpenCV's INTER_AREA (anti-aliased) and INTER_LINEAR downscale of a
    756x1008x3 frame, through the JAX package's cv2 call."""
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (756, 1008, 3)).astype(np.float32)
    for anti_aliasing in (True, False):
        ours = rescale_image(image, factor, anti_aliasing=anti_aliasing)
        ref = j_rescale_image(image, factor, anti_aliasing=anti_aliasing)
        assert ours.shape == ref.shape == (int(756 / factor), int(1008 / factor), 3)
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    mask = (rng.uniform(size=(756, 1008)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(rescale_image(mask, factor), cv2.resize(
        mask, (int(1008 / factor), int(756 / factor)), interpolation=cv2.INTER_AREA), atol=1e-6, rtol=0)


def test_save_video_writes_a_frame_directory(tmp_path, capsys):
    frames = np.random.default_rng(0).integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    assert save_video(tmp_path / "out/PredictedVideo.mp4", frames) is None
    written = sorted((tmp_path / "out/PredictedVideo_frames").iterdir())
    assert [p.name for p in written] == ["0000.png", "0001.png", "0002.png"]
    for frame, path in zip(frames, written):
        np.testing.assert_array_equal(read_png(path), frame)
    assert "PredictedVideo_frames" in capsys.readouterr().out


def test_export_plots(tmp_path, monkeypatch):
    logs = tmp_path / "logs"
    logs.mkdir()
    records = [{"tag": "train/TotalLoss", "value": 1.0 / (s + 1), "step": s} for s in range(5)]
    records += [{"tag": "validation/val_images/MSE01", "value": 0.1, "step": 4}]
    (logs / "scalars.jsonl").write_text("".join(json.dumps(r) + "\n" for r in records))
    export_plots(logs)
    assert sorted(p.name for p in logs.glob("*.png")) == ["train_TotalLoss.png", "validation_val_images_MSE01.png"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on the GPU machine
    with pytest.raises(ImportError, match="scalars.jsonl"):
        export_plots(logs)


# -------------------------------------------------------------- end to end

def tiny_train_configs():
    return {
        "train_num": 2,
        "database": "NeRF_LLFF",
        "database_dirpath": "databases/NeRF_LLFF/data",
        "data_loader": {
            "data_loader_name": "NerfLlffDataLoader01",
            "data_preprocessor_name": "DataPreprocessor01",
            "train_set_num": 2,
            "scene_names": ["synth01"],
            "resolution_suffix": "",
            "recenter_camera_poses": True,
            "bd_factor": 0.75,
            "spherify": False,
            "ndc": False,
            "batching": True,
            "downsampling_factor": 1,
            "num_rays": 128,
            "precrop_fraction": 1,
            "precrop_iterations": -1,
            "visibility_prior": {"load_masks": True, "load_weights": False, "masks_dirname": "VW02"},
            "sparse_depth": {"dirname": "DE02", "num_rays": 64},
        },
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": {
                "num_samples": 8, "netdepth": 2, "netwidth": 16,
                "points_positional_encoding_degree": 2, "views_positional_encoding_degree": 1,
                "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
            },
            "chunk": 4096, "lindisp": False, "netchunk": 16384,
            "perturb": True, "raw_noise_std": 0.0, "white_bkgd": False,
        },
        "losses": [{"name": "MSE01", "weight": 1}],
        "optimizer": {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 5e-4,
                      "lr_decay": 250, "beta1": 0.9, "beta2": 0.999},
        "resume_training": True,
        "num_iterations": 20,
        "scan_steps": 20,
        "validation_interval": 20,
        "validation_chunk_size": 1024,
        "validation_save_loss_maps": False,
        "model_save_interval": 20,
        "seed": 0,
        "device": "cpu",
    }


def test_nerf_llff_app_end_to_end(tmp_path, monkeypatch):
    """Train, test with QA in its own process, and both video tracks, as the
    JAX package's tests/test_apps_videos.py drives its app."""
    monkeypatch.setenv("VIPNERF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=4,
                             train_frames=(0, 3), val_frames=(1,), height=24, width=32)
    poses_dir = tmp_path / "data/databases/NeRF_LLFF/data/train_test_sets/set02/video_poses01"
    poses_dir.mkdir()
    np.savetxt(poses_dir / "synth01.csv", make_camera_ring(4, spread_deg=20.0).reshape(4, 16), delimiter=",")
    np.savetxt(poses_dir / "VideoFrameNums.csv", np.array([0, 2]), delimiter=",")

    app = common.DatasetApp("NeRF_LLFF", "scene_name", "all", root_dirpath=tmp_path)
    app.start_training(tiny_train_configs())
    scene_train = tmp_path / "runs/training/train0002/synth01"
    assert (scene_train / "saved_models/Model_Iter000020.tar").exists()

    test_configs = {"test_num": 2, "test_set_num": 2, "train_num": 2, "model_name": "Model_Latest.tar",
                    "database_dirpath": "databases/NeRF_LLFF/data", "device": "cpu", "chunk_size": 1024}
    out = app.start_testing(test_configs)
    assert out == tmp_path / "runs/testing/test0002"
    scene = out / "synth01"
    for rel in ("predicted_frames/0002.png", "predicted_depths/0002.npy", "predicted_depths_variance/0002.npy",
                "predicted_frames/0000.png", "predicted_visibilities/0000_0003.npy",
                "predicted_visibilities/0003_0000.npy"):
        assert (scene / rel).exists(), rel
    assert "root_dirpath" not in json.loads((out / "Configs.json").read_text())
    scores = json.loads((out / "QA_Scores.json").read_text())["predicted_frames"]
    assert set(scores) == {"RMSE02", "PSNR02", "SSIM02", "LPIPS02"} and scores["LPIPS02"] is None
    assert all(np.isfinite(scores[k]) for k in ("RMSE02", "PSNR02", "SSIM02"))
    assert (out / "QA_Scores/predicted_frames/PSNR02_SceneWise.csv").exists()

    app.start_testing_videos(test_configs)
    app.start_testing_static_videos(test_configs)
    for suffix, name in (("_video01", "PredictedVideo"), ("_video01_static_camera", "StaticCameraVideo")):
        track = out / f"synth01{suffix}"
        for f in range(3):  # track rows 1..3
            assert read_image(track / f"predicted_frames/{f:04}.png").shape == (24, 32, 3)
        video = sorted((track / f"{name}_frames").iterdir())
        assert [p.name for p in video] == ["0000.png", "0001.png"]  # VideoFrameNums 0, 2
        np.testing.assert_array_equal(read_png(video[1]), read_png(track / "predicted_frames/0002.png"))
    static = out / "synth01_video01_static_camera/predicted_frames"
    moving = out / "synth01_video01/predicted_frames"
    assert not np.array_equal(read_png(static / "0002.png"), read_png(moving / "0002.png"))
