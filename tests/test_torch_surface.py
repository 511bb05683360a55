"""The rest of the JAX package's surface in the port: the `fast_encoding`
key of a level's MLP config, `spherify_poses`, and the TensorBoard scalars.

- `fast_encoding` (the double-angle recurrence of
  vipnerf_tpu/core/encoding.py) against the JAX function at degree 10 and 4
  on seeded points in [-pi, pi]: within 2^degree x 1e-7 absolute, since the
  recurrence amplifies the last-ulp difference of the two frameworks' sin
  and cos by about 2^degree; `render_rays` with the key set in both levels
  against the JAX package's within test_torch_render.py's 5e-4; K1's input
  preparation reads the same key as the module MLP, and the two paths agree
  within 1e-5 in f32 (summation order).
- `spherify_poses` against the JAX function within 1e-10 (float64 on both
  sides). The train preprocessor with `spherify: True` is held against the
  JAX preprocessor in tests/test_torch_train_data.py.
- TensorBoard: a stand-in `torch.utils.tensorboard` records the calls; the
  port's logger makes the JAX logger's calls on the same logs, and without
  the module it writes the JSON lines alone.
"""

import copy
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import assert_outputs_close, both_models, configs, jax_render, make_batch
from vipnerf_tpu.core import encoding as j_enc
from vipnerf_tpu.core import poses as j_poses
from vipnerf_tpu.train import logging as j_logging
from vipnerf_tpu_torch.core import encoding as t_enc
from vipnerf_tpu_torch.core import poses as t_poses
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.train import logging as t_logging


@pytest.mark.parametrize("degree", [10, 4])
def test_fast_encoding_matches_jax(degree):
    x = np.random.default_rng(degree).uniform(-np.pi, np.pi, (4096, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: j_enc.positional_encoding(v, degree, fast=True))(jnp.asarray(x)))
    got = t_enc.positional_encoding(torch.from_numpy(x), degree, fast=True).numpy()
    assert got.shape == want.shape == (4096, 3 * (1 + 2 * degree))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** degree * 1e-7)
    exact = t_enc.positional_encoding(torch.from_numpy(x), degree).numpy()
    assert np.abs(got - exact).max() > 0  # the recurrence, not the exact encoding


def test_render_rays_with_fast_encoding_matches_jax():
    cfg = configs(False)
    exact_cfg = copy.deepcopy(cfg)
    for level in ("coarse_mlp", "fine_mlp"):
        cfg["model"][level]["fast_encoding"] = True
    params, model = both_models(cfg)
    b_np, b_t = make_batch(24, 3, False, via_poses=True)
    out_j = jax_render(params, cfg, b_np, sec_views_vis=True, retraw=True)
    with torch.no_grad():
        out_t = t_vn.render_rays(model, cfg, b_t, train=False, sec_views_vis=True, retraw=True)
        exact_model = t_vn.ViPNeRF(exact_cfg)  # the port's MLPs read the key from their own config
        exact_model.load_state_dict(model.state_dict())
        exact = t_vn.render_rays(exact_model, exact_cfg, b_t, train=False, sec_views_vis=True, retraw=True)
    assert_outputs_close(out_t, out_j, 5e-4, 5e-4)
    assert not torch.equal(out_t["raw_rgb_coarse"], exact["raw_rgb_coarse"])


@pytest.mark.parametrize("fast", [False, True])
def test_k1_input_preparation_reads_fast_encoding(monkeypatch, fast):
    cfg = {"num_samples": 0, "netdepth": 8, "netwidth": 256, "points_positional_encoding_degree": 10,
           "views_positional_encoding_degree": 4, "use_view_dirs": True, "view_dependent_rgb": True,
           "predict_visibility": True, "fast_encoding": fast}
    mlp = NeRFMLP(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)), dim=-1)
    vd2 = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 2, 3)).astype(np.float32)), dim=-1)
    seen = []
    real = k1.positional_encoding

    def spy(x, degree, fast=False):
        seen.append(fast)
        return real(x, degree, fast)

    monkeypatch.setattr(k1, "positional_encoding", spy)
    with torch.no_grad():
        fused = k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=torch.float32)
        module = mlp(pts, vd, vd2)
    assert seen == [fast] * 3  # points, primary view, secondary views
    for key in ("sigma", "rgb", "visibility", "visibility2"):
        torch.testing.assert_close(fused[key], module[key], rtol=1e-5, atol=1e-5, msg=key)


def random_c2w(n, seed):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = q, rng.normal(0, 2.0, 3) + [0, 0, 1.0]
        poses.append(pose)
    return np.stack(poses)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spherify_poses_matches_jax(seed):
    poses, bds = random_c2w(7, seed), np.array([0.8, 6.5])
    want = j_poses.spherify_poses(poses.copy(), bds.copy())
    got = t_poses.spherify_poses(poses.copy(), bds.copy())
    assert got[0].shape == (7, 3, 5) and got[1].shape == (120, 3, 5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_preprocess_poses_spherifies_like_jax():
    w2c = np.linalg.inv(random_c2w(6, 3))
    kw = dict(train_mode=True, bounds=np.array([1.2, 9.0]), bd_factor=0.75, recenter=True, spherify=True)
    want, got = j_poses.preprocess_poses(w2c, **kw), t_poses.preprocess_poses(w2c, **kw)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6 if key == "poses" else 1e-10,
                                   err_msg=key)
    with pytest.raises(ValueError, match="bounds"):
        t_poses.preprocess_poses(w2c, train_mode=True, spherify=True)


class RecordingWriter:
    calls = []
    queues = []

    def __init__(self, logdir, max_queue=10):
        self.calls.append(("init", logdir))
        self.queues.append(max_queue)

    def add_scalar(self, tag, value, step):
        self.calls.append(("add_scalar", tag, float(value), int(step)))

    def add_text(self, tag, text, step):
        self.calls.append(("add_text", tag, int(step)))  # the text is the wall time

    def flush(self):
        self.calls.append(("flush",))

    def close(self):
        self.calls.append(("close",))


def drive(logger_cls, logs_dir):
    logger = logger_cls(logs_dir)
    logger.add_scalars("train", {"TotalLoss": 0.25, "MSE01": 0.125, "lr": 5e-4}, 1)
    logger.add_scalar("validation/train_images/MSE01", np.float32(0.5), 600)
    logger.add_scalars("train", {"TotalLoss": 0.2}, 2)
    logger.close()
    return [json.loads(line) for line in (logs_dir / "scalars.jsonl").read_text().splitlines()]


def test_tensorboard_scalars_match_the_jax_logger(monkeypatch, tmp_path):
    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = RecordingWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    calls = {}
    records = {}
    for name, cls in (("jax", j_logging.ScalarLogger), ("torch", t_logging.ScalarLogger)):
        RecordingWriter.calls = []
        records[name] = drive(cls, tmp_path / name / "logs")
        calls[name] = [c if c[0] != "init" else ("init",) for c in RecordingWriter.calls]
        assert RecordingWriter.calls[0] == ("init", str(tmp_path / name / "logs"))
    assert calls["torch"] == calls["jax"]
    assert sum(c[0] == "add_scalar" for c in calls["torch"]) == 5
    # the port's writer queues a chunk's events instead of waiting for each one's write
    assert RecordingWriter.queues[-1] == t_logging.TB_QUEUE >= 8 * 100 * 5
    assert records["torch"] == records["jax"]


def test_no_tensorboard_writes_the_json_lines_alone(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # its import raises ImportError
    records = drive(t_logging.ScalarLogger, tmp_path / "logs")
    assert [r["tag"] for r in records] == ["train/TotalLoss", "train/MSE01", "train/lr",
                                          "validation/train_images/MSE01", "train/TotalLoss"]
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == ["scalars.jsonl"]
