"""The port's `start_training` end to end on the CPU, at the small config of
tests/test_e2e_training.py (32x40 synthetic LLFF scene, 6x32 MLPs, 16+32
samples, 256 + 128 rays, 1200 iterations): the run tree with `.tar`
checkpoints, falling losses, held-out PSNR above 20 dB against the ground
truth through `start_testing`, resume (optimizer state included), a resume
that renders a missing boundary validation again, and a resume from a
minimal config.

The seed is 1, not the JAX test's 0: torch draws other initial weights from
a seed than jax.random, and at this width the port's seed-0 draw starts with
a fine MLP whose sigma is 0 everywhere, which raw_noise_std 0 never revives.
"""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_e2e_training import small_train_configs
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
from vipnerf_tpu_torch.infer.tester import start_testing
from vipnerf_tpu_torch.train.trainer import Trainer, start_training
from vipnerf_tpu_torch.utils import tracing
from vipnerf_tpu_torch.utils.io import read_image


def port_configs(root, num_iterations=1200, **extra):
    cfg = small_train_configs(root, num_iterations=num_iterations)
    cfg.update({"device": "cpu", "seed": 1, **extra})
    return cfg


def scalars(scene_dir):
    return [json.loads(line) for line in (scene_dir / "logs/scalars.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads: the steps are too small for more to pay, and the
    spinning of idle ones takes the cores of the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, two_threads):
    root = tmp_path_factory.mktemp("train")
    gt = write_synthetic_database(root / "data/databases", scene_name="synth01", num_frames=6,
                                  train_frames=(0, 5), val_frames=(2,), height=32, width=40)
    start_training(port_configs(root))
    return root, gt


def test_run_tree_contract(trained):
    root, _ = trained
    train_dir = root / "runs/training/train0001"
    scene = train_dir / "synth01"
    assert (train_dir / "Configs.json").exists()
    assert json.loads((scene / "ModelConfigs.json").read_text())["resolution"] == [32, 40]
    saved = scene / "saved_models"
    assert sorted(p.name for p in saved.iterdir()) == [
        "Model_Iter000600.tar", "Model_Iter001200.tar", "Model_Latest.tar"]
    assert os.readlink(saved / "Model_Latest.tar") == "Model_Iter001200.tar"
    state = torch.load(saved / "Model_Iter001200.tar", weights_only=True)
    assert state["iteration_num"] == 1200
    assert int(next(iter(state["optimizer_state_dict"]["state"].values()))["step"]) == 1200
    for it in (600, 1200):
        for f, mode in ((0, "train"), (5, "train"), (2, "val")):
            for level in ("coarse", "fine"):
                assert (scene / f"samples/predicted_frames/{f:04}_{level}_Iter{it:05}.png").exists()
                assert (scene / f"samples/predicted_depths/{f:04}_{level}_Iter{it:05}.npy").exists()
                if mode == "train":
                    other = 5 - f
                    assert (scene / f"samples/predicted_visibilities/{f:04}_{other:04}_{level}_Iter{it:05}.npy").exists()
    assert list((scene / "samples/Losses").glob("MSE01_fine_0002_Iter01200.npy"))
    tags = {s["tag"] for s in scalars(scene)}
    assert {"train/TotalLoss", "train/lr", "validation/train_images/MSE01",
            "validation/val_images/TotalLoss"} <= tags
    assert "validation/val_images/VisibilityPriorLoss01" not in tags  # no secondary views there


def test_losses_fall_and_held_out_psnr(trained):
    root, gt = trained
    rec = scalars(root / "runs/training/train0001/synth01")
    total = [s["value"] for s in rec if s["tag"] == "train/TotalLoss"]
    assert len(total) == 1200 and np.isfinite(total).all()
    assert np.mean(total[-10:]) < np.mean(total[:10])
    lr = [s["value"] for s in rec if s["tag"] == "train/lr"]
    np.testing.assert_allclose(lr[:2], [2e-3, 2e-3 * 0.1 ** (1 / 250000)], rtol=1e-9)

    db = root / "data/databases/NeRF_LLFF/data/all/database_data/synth01"
    extr = np.loadtxt(db / "CameraExtrinsics.csv", delimiter=",").reshape(-1, 4, 4)
    intr = np.loadtxt(db / "CameraIntrinsics.csv", delimiter=",").reshape(-1, 3, 3)
    test_configs = {"test_num": 1, "train_num": 1, "model_name": "Model_Latest.tar",
                    "root_dirpath": str(root), "device": "cpu", "chunk_size": 1024}
    frames = {f: {"extrinsic": extr[f], "intrinsic": intr[f], "is_train_frame": False} for f in (1, 3, 4)}
    out = start_testing(test_configs, {"synth01": {"output_dirname": "synth01", "frames_data": frames}})
    for f in frames:
        pred = read_image(out / f"synth01/predicted_frames/{f:04}.png").astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / np.mean((pred - gt["images"][f]) ** 2))
        assert psnr > 20, f"frame {f}: {psnr:.2f} dB"


def test_resume_training(trained, capsys):
    root, _ = trained
    start_training(port_configs(root, 1260, model_save_interval=60))
    assert "Resuming Training from iteration 1201" in capsys.readouterr().out
    scene = root / "runs/training/train0001/synth01"
    saved = scene / "saved_models"
    assert os.readlink(saved / "Model_Latest.tar") == "Model_Iter001260.tar"
    state = torch.load(saved / "Model_Iter001260.tar", weights_only=True)
    assert int(next(iter(state["optimizer_state_dict"]["state"].values()))["step"]) == 1260
    steps = [s["step"] for s in scalars(scene) if s["tag"] == "train/TotalLoss"]
    assert steps == list(range(1, 1261))


def test_resume_from_a_minimal_config(trained):
    """Only {train_num, resume_training, root_dirpath}: everything else comes
    from the saved Configs.json, merged into the live dict."""
    root, _ = trained
    minimal = {"train_num": 1, "resume_training": True, "root_dirpath": str(root)}
    start_training(minimal)
    assert minimal["num_iterations"] == 1260 and minimal["device"] == "cpu"
    assert minimal["data_loader"]["scene_names"] == ["synth01"]
    saved = json.loads((root / "runs/training/train0001/Configs.json").read_text())
    assert "root_dirpath" not in saved and saved["seed"] == 1


def test_resume_regenerates_missing_boundary_validation(trained):
    """A checkpoint is written before its boundary's validation; a resume
    finding that validation incomplete (all of it, or one file of it) renders
    it again."""
    root, _ = trained
    cfg = lambda: port_configs(root, 40, train_num=7, validation_interval=40,  # noqa: E731
                               model_save_interval=40)
    start_training(cfg())
    samples = root / "runs/training/train0007/synth01/samples"
    boundary = sorted((samples / "predicted_frames").glob("*_Iter00040.png"))
    assert len(boundary) == 6  # 3 frames x 2 levels
    for p in boundary:
        p.unlink()
    start_training(cfg())
    assert all(p.exists() for p in boundary)
    victim = samples / "predicted_depths_variance/0002_fine_Iter00040.npy"
    victim.unlink()
    start_training(cfg())
    assert victim.exists()


def test_validation_complete_requires_all_artifacts(tmp_path):
    """Every file of the boundary, the NDC ones in NDC mode, is required."""
    fake = SimpleNamespace(
        configs={"model": {"coarse_mlp": {"predict_visibility": False}}, "data_loader": {"ndc": False}},
        train_data_preprocessor=SimpleNamespace(frame_nums=[0], mode="train"),
        val_data_preprocessor=SimpleNamespace(frame_nums=[1], mode="validation"),
    )
    files = [f"{kind}/{f:04}_coarse_Iter00600.{ext}" for f in (0, 1)
             for kind, ext in (("predicted_frames", "png"), ("predicted_depths", "npy"),
                               ("predicted_depths_variance", "npy"))]
    for rel in files[:-1]:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).touch()
    assert not Trainer._validation_complete(fake, 600, tmp_path)
    (tmp_path / files[-1]).touch()
    assert Trainer._validation_complete(fake, 600, tmp_path)
    fake.configs["data_loader"]["ndc"] = True
    assert not Trainer._validation_complete(fake, 600, tmp_path)


def test_unported_options_raise(trained):
    """More than one device is ported (the profiler hook too:
    tests/test_torch_guards.py): [0, 1] without CUDA raises instead of
    falling back to the CPU, and two CPU ranks train, rank 0 writing the
    run tree (held against one rank in tests/test_torch_parallel.py)."""
    root, _ = trained
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            start_training(port_configs(root, 20, train_num=9, device=[0, 1]))
    t0 = time.perf_counter_ns()
    start_training(port_configs(root, 20, train_num=9, device=["cpu", "cpu"], model_save_interval=20,
                                validation_interval=20))
    # rank 0's chunk spans, merged into this process's tracer
    chunks = [r for r in tracing.snapshot()["spans"] if r["name"] == "train.chunk" and r["start_ns"] >= t0]
    assert sum(r["attrs"]["steps"] for r in chunks) == 20
    scene = root / "runs/training/train0009/synth01"
    assert (scene / "saved_models/Model_Iter000020.tar").exists()
    assert max(r["step"] for r in scalars(scene) if r["tag"] == "train/TotalLoss") == 20
