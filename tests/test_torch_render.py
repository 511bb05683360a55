"""The port's serving path against the JAX package: render_rays, the tiled
renderer, NerfTester.predict_frame and start_testing, plus the checkpoint,
PNG and device contracts they rest on.

Both sides get the same weights (JAX init -> `state_dict_from_jax_params`)
and the same numpy inputs; sampling is deterministic (train=False).
Tolerances: f32 paths 5e-4 absolute and relative (the fine depths come from
an inverse CDF whose cumsum rounds differently in the two frameworks, ~1e-6,
and the MLP's positional encoding amplifies a shifted sample); the
bf16 flagship 3e-2 absolute on colours and acc and relative on depths (a
bf16 product can round one step apart, which moves the fine samples);
uint8 images within 1 level.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipnerf_tpu.models import vip_nerf as j_vn
from vipnerf_tpu_torch.infer.renderer import TiledRenderer
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params
from vipnerf_tpu_torch.utils.device import resolve_device
from vipnerf_tpu_torch.utils.io import write_png


def mlp_cfg(samples, depth=6, width=32, pe=(4, 2)):
    return {
        "num_samples": samples, "netdepth": depth, "netwidth": width,
        "points_positional_encoding_degree": pe[0],
        "views_positional_encoding_degree": pe[1],
        "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
    }


def configs(ndc, coarse=8, fine=16, flagship=False, **model):
    kw = dict(depth=8, width=256, pe=(10, 4)) if flagship else {}
    cfg = {
        "data_loader": {"ndc": ndc, "data_preprocessor_name": "DataPreprocessor01",
                        "batching": True, "bd_factor": 0.75, "downsampling_factor": 1,
                        "num_rays": 32},
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": mlp_cfg(coarse, **kw), "fine_mlp": mlp_cfg(fine, **kw),
            "chunk": 1024, "lindisp": False, "netchunk": 4096, "perturb": True,
            "raw_noise_std": 1.0, "white_bkgd": False,
        },
        "seed": 0,
    }
    cfg["model"].update(model)
    return cfg


def both_models(cfg, seed=0):
    params = j_vn.init_params(jax.random.PRNGKey(seed), cfg)
    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return params, model.eval()


def make_batch(nr, nf, ndc, seed=0, via_poses=False):
    rng = np.random.default_rng(seed)
    b = {
        "rays_o": rng.normal(0, 0.2, (nr, 3)),
        "rays_d": rng.normal(0, 0.2, (nr, 3)) + [0, 0, -1.0],
        "near": np.full((nr, 1), 1.0), "far": np.full((nr, 1), 6.0),
    }
    b["view_dirs"] = b["rays_d"] / np.linalg.norm(b["rays_d"], axis=-1, keepdims=True)
    if ndc:
        b["rays_o_ndc"] = rng.uniform(-1, 1, (nr, 3))
        b["rays_d_ndc"] = rng.uniform(-1, 1, (nr, 3))
        b["near_ndc"], b["far_ndc"] = np.zeros((nr, 1)), np.ones((nr, 1))
    if via_poses:
        poses = np.tile(np.eye(4), (nf, 1, 1))
        poses[:, :3, 3] = rng.normal(0, 0.3, (nf, 3))
        b["poses"] = poses
        b["pixel_id"] = np.stack([rng.integers(0, nf, nr)] + [rng.integers(0, 8, nr)] * 2, 1)
    else:
        b["rays_o2"] = rng.normal(0, 0.3, (nr, nf - 1, 3))
    b = {k: np.asarray(v, np.int32 if k == "pixel_id" else np.float32) for k, v in b.items()}
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def jax_render(params, cfg, b_np, **kw):
    """JAX render_rays under jit (eager dispatch compiles every op)."""
    fn = jax.jit(lambda p, b: j_vn.render_rays(p, cfg, b, train=False, **kw))
    return fn(params, {k: jnp.asarray(v) for k, v in b_np.items()})


def assert_outputs_close(out_t, out_j, atol, rtol):
    assert set(out_t) == set(out_j)
    for k in out_j:
        np.testing.assert_allclose(out_t[k].detach().numpy(), np.asarray(out_j[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("ndc", [False, True])
@pytest.mark.parametrize("nf", [2, 3])
@pytest.mark.parametrize("retraw", [False, True])
def test_render_rays_matches_jax(ndc, nf, retraw):
    cfg = configs(ndc)
    params, model = both_models(cfg)
    b_np, b_t = make_batch(24, nf, ndc, via_poses=(nf == 3))
    out_j = jax_render(params, cfg, b_np, sec_views_vis=True, retraw=retraw)
    with torch.no_grad():
        out_t = t_vn.render_rays(model, cfg, b_t, train=False, sec_views_vis=True, retraw=retraw)
    assert ("raw_sigma_fine" in out_t) == retraw and ("weights_fine" in out_t) == retraw
    assert out_t["visibility2_fine"].shape == (24, nf - 1)
    assert_outputs_close(out_t, out_j, 5e-4, 5e-4)


def test_render_rays_flagship_bf16_matches_jax():
    """8x256, 64+128 samples, bf16 matmuls with bf16 heads: the port runs K1
    (its plain version on the CPU), JAX runs apply_mlp in bf16."""
    cfg = configs(True, 64, 128, flagship=True, bf16_matmuls=True, f32_heads=False)
    assert t_vn.uses_fused_mlp(cfg["model"]["fine_mlp"], True, False)
    params, model = both_models(cfg)
    b_np, b_t = make_batch(6, 3, True)
    out_j = jax_render(params, cfg, b_np, sec_views_vis=True)
    with torch.no_grad():
        out_t = t_vn.render_rays(model, cfg, b_t, train=False, sec_views_vis=True)
    assert_outputs_close(out_t, out_j, 3e-2, 3e-2)


def test_training_render_draws_from_the_generator():
    cfg = configs(False)
    _, model = both_models(cfg)
    _, b_t = make_batch(16, 3, False, via_poses=True)
    with torch.no_grad():
        runs = [t_vn.render_rays(model, cfg, b_t, train=True, generator=torch.Generator().manual_seed(s))
                for s in (1, 1, 2)]
        with pytest.raises(ValueError):
            t_vn.render_rays(model, cfg, b_t, train=True)
    assert torch.equal(runs[0]["rgb_fine"], runs[1]["rgb_fine"])
    assert not torch.equal(runs[0]["rgb_fine"], runs[2]["rgb_fine"])
    assert "raw_visibility2_fine" in runs[0]


def test_tiled_renderer_is_tile_size_invariant():
    cfg = configs(True)
    _, model = both_models(cfg)
    _, b_t = make_batch(100, 3, True)
    renderer = TiledRenderer(t_vn.render_rays, cfg)
    outs = [renderer.render(model, b_t, chunk_size=c, sec_views_vis=True)[0] for c in (100, 32, 7)]
    assert outs[0]["rgb_fine"].shape == (100, 3) and outs[0]["visibility2_fine"].shape == (100, 2)
    for other in outs[1:]:
        assert set(other) == set(outs[0])
        for k in outs[0]:
            np.testing.assert_allclose(other[k], outs[0][k], atol=1e-6, rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError):  # losses need a loss computer
        renderer.render(model, b_t, with_losses=True)
    # the losses of a full-image batch (every ray on the nerf stream, as in
    # validation) do not depend on the tile size either: pad rays are
    # excluded and tiles weighted by their real rays. f32, 1e-6 relative
    from vipnerf_tpu_torch.losses import LossComputer

    lcfg = dict(cfg, losses=[{"name": "MSE01", "weight": 1}, {"name": "VisibilityLoss01", "weight": 0.1},
                             {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0.001}}])
    rgb = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (100, 3)).astype(np.float32))
    lb = dict(b_t, iter_num=5, indices_mask_nerf=torch.ones(100, dtype=torch.bool), target_rgb=rgb)
    loss_renderer = TiledRenderer(t_vn.render_rays, lcfg, loss_computer=LossComputer(lcfg))
    losses = [loss_renderer.render(model, lb, chunk_size=c, sec_views_vis=True, with_losses=True)[1]
              for c in (100, 32, 7)]
    assert set(losses[0]) == {"MSE01", "VisibilityLoss01", "VisibilityPriorLoss01", "TotalLoss"}
    for other in losses[1:]:
        np.testing.assert_allclose(other["TotalLoss"], losses[0]["TotalLoss"], rtol=1e-6)
        for k in ("MSE01", "VisibilityLoss01", "VisibilityPriorLoss01"):
            np.testing.assert_allclose(other[k]["loss_value"], losses[0][k]["loss_value"], rtol=1e-6)


# ----------------------------------------------------------- tester level

H, W = 12, 16


def look_at_w2c(centre, target=np.array([0.0, 0.0, 5.0])):
    z = (target - centre) / np.linalg.norm(target - centre)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    w2c = np.eye(4)
    w2c[:3, :3] = np.stack([x, np.cross(z, x), z])
    w2c[:3, 3] = -w2c[:3, :3] @ centre
    return w2c


def rig():
    centres = [(-0.3, 0.0, 0.0), (0.0, 0.1, 0.0), (0.3, -0.1, 0.0), (0.1, 0.2, 0.0)]
    poses = np.stack([look_at_w2c(np.array(c)) for c in centres])
    from vipnerf_tpu_torch.core.poses import preprocess_poses

    pp = preprocess_poses(poses, train_mode=True, bounds=np.array([1.5, 12.0]), bd_factor=0.75)
    model_configs = {
        "resolution": [H, W],
        "intrinsic": [[14.0, 0, W / 2], [0, 14.0, H / 2], [0, 0, 1]],
        "near": float(pp["bounds"][0] * 0.75), "far": float(pp["bounds"][1]),
        "near_ndc": 0.0, "far_ndc": 1.0,
        "translation_scale": float(pp["sc"]), "average_pose": pp["average_pose"].tolist(),
    }
    return poses, model_configs


def test_predict_frame_matches_jax_tester(tmp_path):
    from vipnerf_tpu.infer.tester import NerfTester as JaxTester
    from vipnerf_tpu_torch.infer.tester import NerfTester

    cfg = configs(True)
    params, model = both_models(cfg)
    poses, model_configs = rig()
    jt = JaxTester(json.loads(json.dumps(cfg)), dict(model_configs), {"device": [0]}, tmp_path)
    jt.params = params
    tt = NerfTester(json.loads(json.dumps(cfg)), dict(model_configs),
                    {"device": "cpu", "chunk_size": 50}, tmp_path)
    tt.model.load_state_dict(model.state_dict())
    for sec in (None, [poses[2], poses[3]]):
        pj = jt.predict_frame(poses[0], secondary_poses=sec)
        pt = tt.predict_frame(poses[0], secondary_poses=sec)
        assert set(pt) == set(pj)
        assert np.abs(pt["image"].astype(int) - pj["image"].astype(int)).max() <= 1
        for k in set(pj) - {"image"}:
            # metric depth variance squares z_metric ~ 1/(1-z'): a fine sample
            # shifted by the cumsum rounding moves it ~1e-3 relative
            rtol = 5e-3 if k == "depth_var" else 5e-4
            np.testing.assert_allclose(pt[k], pj[k], atol=5e-4, rtol=rtol, err_msg=k)
    assert pt["visibility2"].shape == (2, H, W)


def write_run(root, cfg, model_configs, model):
    train_dir = root / "runs/training/train0003"
    (train_dir / "scene").mkdir(parents=True)
    (train_dir / "Configs.json").write_text(json.dumps(cfg))
    (train_dir / "scene/ModelConfigs.json").write_text(json.dumps(model_configs))
    return checkpoints.save_checkpoint(train_dir / "scene/saved_models", 7, model)


def test_start_testing_end_to_end(tmp_path, monkeypatch):
    from vipnerf_tpu_torch.infer import tester as tester_mod

    cfg = configs(True)
    _, model = both_models(cfg)
    poses, model_configs = rig()
    write_run(tmp_path, cfg, model_configs, model)
    test_configs = {"test_num": 2, "train_num": 3, "model_name": "Model_Latest.tar",
                    "root_dirpath": str(tmp_path), "device": "cpu", "chunk_size": 64}
    train = [True, False, True, True]
    scenes = {"scene": {"output_dirname": "scene", "frames_data": {
        i: {"extrinsic": poses[i], "is_train_frame": train[i]} for i in range(4)}}}

    calls = []
    real = tester_mod.NerfTester.predict_frame
    monkeypatch.setattr(tester_mod.NerfTester, "predict_frame",
                        lambda self, *a: calls.append(a[2]) or real(self, *a))
    out = tester_mod.start_testing(test_configs, scenes, save_depth=True, save_visibility=True)
    scene = out / "scene"
    assert len(calls) == 4 and calls[1] is None and len(calls[0]) == 2
    for i in range(4):
        assert (scene / f"predicted_frames/{i:04}.png").exists()
        for name in (f"{i:04}.npy", f"{i:04}_ndc.npy", f"{i:04}.png"):
            assert (scene / "predicted_depths" / name).exists()
        assert np.isfinite(np.load(scene / f"predicted_depths/{i:04}.npy")).all()
    vis = sorted(p.name for p in (scene / "predicted_visibilities").glob("*.npy"))
    assert vis == [f"{i:04}_{j:04}.npy" for i in (0, 2, 3) for j in (0, 2, 3) if i != j]
    v = np.load(scene / "predicted_visibilities/0000_0002.npy")
    assert v.shape == (H, W) and (v >= 0).all() and (v <= 1).all()

    calls.clear()
    tester_mod.start_testing(test_configs, scenes, save_depth=True, save_visibility=True)
    assert calls == []  # every output exists: nothing renders
    (scene / "predicted_visibilities/0002_0003.npy").unlink()
    tester_mod.start_testing(test_configs, scenes, save_depth=True, save_visibility=True)
    assert len(calls) == 1 and (scene / "predicted_visibilities/0002_0003.npy").exists()

    test_configs["preview"] = True
    assert tester_mod.effective_output_suffix(test_configs) == "_preview"
    assert tester_mod.start_testing(dict(test_configs, train_num=9), scenes) is None


def test_tester_preview_and_sample_overrides(tmp_path):
    """`preview: true` renders the 32+8 budget, `preview: N` the coarse field
    alone; num_samples_* override the quadrature; the model keeps both MLPs."""
    from vipnerf_tpu_torch.infer.renderer import PREVIEW_BUDGET
    from vipnerf_tpu_torch.infer.tester import NerfTester

    cfg = configs(True, 64, 128)
    _, model_configs = rig()
    cases = [({"preview": True}, PREVIEW_BUDGET), ({"preview": 4}, (4, None)),
             ({"num_samples_coarse": 16, "num_samples_fine": 24}, (16, 24))]
    for extra, (coarse, fine) in cases:
        t = NerfTester(json.loads(json.dumps(cfg)), dict(model_configs),
                       {"device": "cpu", **extra}, tmp_path)
        rc = t.renderer.configs["model"]
        assert rc["coarse_mlp"]["num_samples"] == coarse
        assert (rc["fine_mlp"]["num_samples"] if "fine_mlp" in rc else None) == fine
        assert hasattr(t.model, "fine_model")
    assert cfg["model"]["fine_mlp"]["num_samples"] == 128  # the caller's configs are untouched


def test_save_test_configs_merges_scene_lists(tmp_path):
    from vipnerf_tpu_torch.infer.tester import save_test_configs

    save_test_configs(tmp_path, {"test_num": 1, "scene_names": ["a"], "root_dirpath": "x"})
    save_test_configs(tmp_path, {"test_num": 1, "scene_names": ["b"]})
    saved = json.loads((tmp_path / "Configs.json").read_text())
    assert saved == {"test_num": 1, "scene_names": ["a", "b"]}


def test_checkpoint_contract(tmp_path):
    cfg = configs(False)
    _, model = both_models(cfg)
    d = tmp_path / "saved_models"
    checkpoints.save_checkpoint(d, 5, model)
    p9 = checkpoints.save_checkpoint(d, 9, model)
    checkpoints.save_checkpoint(d, 7, model)  # older: Latest stays at 9
    latest = d / "Model_Latest.tar"
    assert latest.is_symlink() and os.readlink(latest) == "Model_Iter000009.tar"
    assert checkpoints.latest_checkpoint(d) == latest and checkpoints.checkpoint_iteration(latest) == 9
    state = torch.load(p9, weights_only=True)
    assert set(state) == {"iteration_num", "model_state_dict", "optimizer_state_dict"}
    other = t_vn.ViPNeRF(cfg, torch.Generator().manual_seed(1))
    assert checkpoints.load_checkpoint(latest, other) == 9
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)
    # the port writes the DataParallel prefix of the reference's checkpoints;
    # a checkpoint with bare keys loads too
    assert all(k.startswith("module.") for k in state["model_state_dict"])
    bare = dict(state, iteration_num=11,
                model_state_dict={k.removeprefix("module."): v for k, v in state["model_state_dict"].items()})
    torch.save(bare, d / "Model_Iter000011.tar")
    assert checkpoints.load_checkpoint(d / "Model_Iter000011.tar", other) == 11


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (4, 6, 4)])
def test_png_writer_round_trips(tmp_path, shape):
    import imageio.v2 as imageio

    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)


def test_device_resolution_never_falls_back_quietly():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(NotImplementedError):
        resolve_device([0, 1])
    if torch.cuda.is_available():
        assert resolve_device("all") == torch.device("cuda", 0)
    else:
        for sel in ("all", None, [0]):
            with pytest.raises(RuntimeError):
                resolve_device(sel)
