"""Batched multi-scene training (`train/multi_scene.py`) on the CPU, on the
two-scene 24x32 database of tests/test_multi_scene.py, at a small width and
deterministic (perturb off, raw_noise_std 0):

- the port's `MultiSceneTrainer` against the JAX package's after K steps
  from the same converted initial parameters, every scene's parameters;
- the port's S = 2 against its own single-scene `Trainer`, scene by scene;
- per-scene gradient clipping against optax vmapped over the scenes, and
  against a norm over the stacked tensors, which must differ;
- resume from the checkpoint every scene has, and the validation catch-up;
- the apps' `batch_scenes` flag;
- the scene axis of the model: K1's plain version and autograd for stacked
  weights against per-scene calls, and a stacked render (each scene's own
  poses for the secondary views) against per-scene renders.

Tolerances are stated at each test.
"""

import copy
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from vipnerf_tpu.data.synthetic import SphereScene, write_synthetic_database
from vipnerf_tpu.train.multi_scene import MultiSceneTrainer as JMultiSceneTrainer
from vipnerf_tpu.train.step import make_optimizer as j_make_optimizer
from vipnerf_tpu_torch.apps.common import DatasetApp
from vipnerf_tpu_torch.core.scene_linear import scene_matmul
from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.data.synthetic_rig import flagship_mlp_config
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays, stack_models, unstack_model
from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer, start_training_batched
from vipnerf_tpu_torch.train.step import make_optimizer
from vipnerf_tpu_torch.train.trainer import Trainer
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

SCENES = ["synth01", "synth02"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = tmp_path_factory.mktemp("ms")
    for i, name in enumerate(SCENES):
        write_synthetic_database(root / "data/databases", scene_name=name, num_frames=6, train_frames=(0, 5),
                                 val_frames=(2,), height=24, width=32, scene=SphereScene(seed=10 + i),
                                 with_sparse_depth=True, with_visibility_prior=True)
    return root


def configs_for(root, **extra):
    cfg = {
        "train_num": 7, "database": "NeRF_LLFF", "database_dirpath": "databases/NeRF_LLFF/data",
        "root_dirpath": str(root), "device": "cpu",
        "data_loader": {
            "data_loader_name": "NerfLlffDataLoader01", "data_preprocessor_name": "DataPreprocessor01",
            "train_set_num": 2, "scene_names": list(SCENES), "resolution_suffix": "",
            "recenter_camera_poses": True, "bd_factor": 0.75, "spherify": False, "ndc": False,
            "batching": True, "downsampling_factor": 1, "num_rays": 128,
            "precrop_fraction": 1, "precrop_iterations": -1,
            "visibility_prior": {"load_masks": True, "load_weights": False, "masks_dirname": "VW02"},
            "sparse_depth": {"dirname": "DE02", "num_rays": 64},
        },
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": {"num_samples": 8, "netdepth": 6, "netwidth": 32,
                           "points_positional_encoding_degree": 4, "views_positional_encoding_degree": 2,
                           "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True},
            "chunk": 4096, "lindisp": False, "netchunk": 16384,
            "perturb": False, "raw_noise_std": 0.0, "white_bkgd": False,
        },
        "losses": [{"name": "MSE01", "weight": 1}, {"name": "VisibilityLoss01", "weight": 0.1},
                   {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0.001}},
                   {"name": "SparseDepthMSE01", "weight": 0.1}],
        "optimizer": {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 5e-4, "lr_decay": 250,
                      "beta1": 0.9, "beta2": 0.999},
        "resume_training": True, "num_iterations": 6, "validation_interval": 3,
        "validation_chunk_size": 1024, "model_save_interval": 3, "seed": 0,
    }
    cfg.update(extra)
    return cfg


def port_trainer(root, cfg):
    return MultiSceneTrainer(cfg, SCENES, root / "data" / cfg["database_dirpath"], verbose_log=False)


def scene_state(model, i):
    return {k: v.detach().clone() for k, v in unstack_model(model, i).state_dict().items()}


def test_matches_the_jax_trainer(db):
    """K = 6 steps of both packages' trainers (2 chunks of 3), from the JAX
    trainer's initial parameters, on the same (native) index streams: every
    scene's parameters within 1e-4 (Adam's normalised steps of 5e-4 carry
    last-ulp differences of the two frameworks' products and sums; the
    losses within 1e-4 relative)."""
    cfg = configs_for(db, scan_steps=3)
    jcfg = {k: v for k, v in copy.deepcopy(cfg).items() if k != "device"}  # every JAX CPU device
    jt = JMultiSceneTrainer(jcfg, SCENES, db / "data/databases/NeRF_LLFF/data")
    tt = port_trainer(db, cfg)
    params0 = jax.device_get(jt.params)
    models = [ViPNeRF(cfg) for _ in SCENES]
    for i, m in enumerate(models):
        m.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(lambda x: np.asarray(x[i]), params0)))
    stack_models(models, into=tt.model)
    j_last = jt.train(6, validation_interval=0, model_save_interval=0, log_scalars=False)
    t_last = tt.train(6, validation_interval=0, model_save_interval=0, log_scalars=False)
    assert t_last["TotalLoss"].shape == (2,)
    np.testing.assert_allclose(t_last["TotalLoss"], np.asarray(j_last["TotalLoss"]), rtol=1e-4)
    params = jax.device_get(jt.params)
    for i in range(2):
        want = state_dict_from_jax_params(jax.tree_util.tree_map(lambda x: np.asarray(x[i]), params))
        got = scene_state(tt.model, i)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-4, err_msg=f"scene {i} {k}")
        moved = max((got[k] - models[i].state_dict()[k]).abs().max().item() for k in got)
        assert moved > 1e-3


def test_matches_single_scene_trainers(db, tmp_path):
    """S = 2 batched against the single-scene `Trainer` on each scene alone,
    same seed, same index streams: every parameter within 1e-5 after 6
    steps (batched against plain products, f32)."""
    cfg = configs_for(db, train_num=3, validation_interval=6, model_save_interval=6)
    tt = port_trainer(db, cfg)
    tt.train(6, validation_interval=0, model_save_interval=0, log_scalars=False)
    for i, scene in enumerate(SCENES):
        scfg = copy.deepcopy(cfg)
        scfg["data_loader"]["scene_id"] = scene
        db_dir = db / "data" / cfg["database_dirpath"]
        prep = get_data_preprocessor(scfg, "train", get_data_loader(scfg, db_dir, "train").load_data())
        val = get_data_preprocessor(scfg, "validation", get_data_loader(scfg, db_dir, "validation").load_data(),
                                    model_configs=prep.get_model_configs())
        model = ViPNeRF(scfg, torch.Generator().manual_seed(0))
        trainer = Trainer(scfg, prep.get_model_configs(), prep, val, model, LossComputer(scfg),
                          tmp_path / scene, verbose_log=False)
        trainer.train()
        trainer.logger.close()
        assert (tmp_path / scene / "saved_models/Model_Iter000006.tar").exists()
        got = scene_state(tt.model, i)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=f"{scene} {k}")


def test_clipping_is_per_scene(db):
    """grad_clip_norm with one scene's gradients far above the limit and the
    other's below: Adam's first moments equal optax's clip+adam vmapped over
    the scenes (1e-6 relative), and differ from clipping by the norm of the
    stacked tensors, which would scale the small scene's gradients too."""
    cfg = configs_for(db)
    cfg["optimizer"]["grad_clip_norm"] = 1.0
    model = ViPNeRF(cfg, scenes=2)
    opt = make_optimizer(cfg, model.parameters(), scenes=2)
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=p.shape).astype(np.float32) * np.array([10.0, 1e-3], np.float32).reshape(2, *[1] * (p.dim() - 1))
             for p in model.parameters()]
    for p, g in zip(model.parameters(), grads):
        p.grad = torch.from_numpy(g.copy())
    opt.step()
    mu = opt.exp_avg.numpy()

    tx = j_make_optimizer(cfg)
    params = [jax.numpy.asarray(p.detach().numpy()) for p in model.parameters()]
    state = jax.vmap(tx.init)(params)
    _, state = jax.vmap(lambda g, s, p: tx.update(g, s, p, loss=0.0))([jax.numpy.asarray(g) for g in grads],
                                                                       state, params)
    adam = [x for x in jax.tree_util.tree_leaves(state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState)]
    want = np.concatenate([np.asarray(m).reshape(2, -1) for m in adam[0].mu], axis=1)
    np.testing.assert_allclose(mu, want, rtol=1e-6, atol=1e-12)

    flat = np.concatenate([g.reshape(2, -1) for g in grads], axis=1)
    stacked_scale = min(1.0, 1.0 / np.linalg.norm(flat))
    assert np.abs(mu[1] - 0.1 * flat[1] * stacked_scale).max() > 1e-3 * np.abs(mu[1]).max()
    np.testing.assert_allclose(mu[1], 0.1 * flat[1], rtol=1e-6)  # the small scene is not clipped


def test_resume_from_the_common_checkpoint_and_catch_up(db, capsys):
    """Both scenes checkpoint at 3 and 6; with scene 2's iteration-6
    checkpoint gone the run resumes at 3 for both and writes 6 again; a
    missing file of the boundary-6 validation is rendered again on resume."""
    cfg = configs_for(db, train_num=5)
    start_training_batched(copy.deepcopy(cfg))
    run = db / "runs/training/train0005"
    for scene in SCENES:
        saved = run / f"{scene}/saved_models"
        assert os.readlink(saved / "Model_Latest.tar") == "Model_Iter000006.tar"
        state = torch.load(saved / "Model_Iter000006.tar", weights_only=True)
        assert int(state["optimizer_state_dict"]["state"][0]["step"]) == 6
        assert json.loads((run / f"{scene}/ModelConfigs.json").read_text())["resolution"] == [24, 32]
        steps = [json.loads(x)["step"] for x in (run / f"{scene}/logs/scalars.jsonl").read_text().splitlines()
                 if json.loads(x)["tag"] == "train/TotalLoss"]
        assert steps == list(range(1, 7))
    saved2 = run / "synth02/saved_models"
    (saved2 / "Model_Iter000006.tar").unlink()
    (saved2 / "Model_Latest.tar").unlink()
    (saved2 / "Model_Latest.tar").symlink_to("Model_Iter000003.tar")
    capsys.readouterr()
    start_training_batched(copy.deepcopy(cfg))
    assert "Resuming multi-scene training from iteration 4" in capsys.readouterr().out
    assert os.readlink(saved2 / "Model_Latest.tar") == "Model_Iter000006.tar"

    victim = run / "synth02/samples/predicted_depths/0000_coarse_Iter00006.npy"
    assert victim.exists()
    victim.unlink()
    start_training_batched(copy.deepcopy(cfg))
    assert victim.exists()


def test_app_batch_scenes_flag(db):
    """`batch_scenes: true` sends the app's start_training to the batched
    trainer: both scenes' checkpoints and logs, the run's Configs.json."""
    cfg = configs_for(db, train_num=8, num_iterations=3, batch_scenes=True)
    del cfg["root_dirpath"]
    DatasetApp("NeRF_LLFF", "scene_name", "all", root_dirpath=db).start_training(cfg)
    run = db / "runs/training/train0008"
    assert (run / "Configs.json").exists()
    for scene in SCENES:
        assert (run / f"{scene}/saved_models/Model_Iter000003.tar").exists()
        assert (run / f"{scene}/logs/scalars.jsonl").exists()


def test_profiler_traces_the_batched_run(db):
    """The `profiler` hook of the batched trainer: 4 steps in chunks of 2,
    window [0, 1): only the chunk [0, 2) is traced, into the run's
    logs/profile, as a Chrome trace."""
    cfg = configs_for(db, train_num=9, num_iterations=4, validation_interval=4, model_save_interval=4,
                      scan_steps=2, profiler={"start_iter": 0, "num_iters": 1})
    start_training_batched(cfg)
    profile = db / "runs/training/train0009/logs/profile"
    assert [p.name for p in profile.iterdir()] == ["chunk_000000-000002.json"]
    assert json.loads((profile / "chunk_000000-000002.json").read_text())["traceEvents"]


def test_scene_matmul_matches_bmm_and_its_gradients():
    """`scene_matmul` (per-scene weight gradients) against torch.bmm's own
    autograd, in f64: the same product and gradients within 1e-12."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 50, 7), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((3, 5, 7), generator=g, dtype=torch.float64, requires_grad=True)
    up = torch.randn((3, 50, 5), generator=g, dtype=torch.float64)
    got = scene_matmul(x, w)
    gx, gw = torch.autograd.grad((got * up).sum(), (x, w))
    want = torch.bmm(x, w.transpose(1, 2))
    wx, ww = torch.autograd.grad((want * up).sum(), (x, w))
    for a, b in ((got, want), (gx, wx), (gw, ww)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_stacked_k1_plain_version_and_gradients():
    """The stacked flagship MLP through K1's plain version (the CPU path)
    against each scene's own MLP: the same outputs in both working types
    (exactly: the plain version loops over the scenes), and through autograd
    each scene gets its own gradient (the recompute's batched products
    against plain ones, 1e-5 relative)."""
    cfg = flagship_mlp_config(8)
    singles = [NeRFMLP(cfg, torch.Generator().manual_seed(s)) for s in range(2)]
    stacked = NeRFMLP(cfg, scenes=2)
    with torch.no_grad():
        for name, p in stacked.named_parameters():
            p.copy_(torch.stack([dict(m.named_parameters())[name] for m in singles]))
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((2, 50, 3), generator=g)
    vd = torch.nn.functional.normalize(torch.randn((2, 50, 3), generator=g), dim=-1)
    vd2 = torch.nn.functional.normalize(torch.randn((2, 50, 2, 3), generator=g), dim=-1)
    for dtype in (torch.float32, torch.bfloat16):
        weights = k1.prepare_weights(stacked, dtype)
        assert weights.scenes == 2 and weights.w_flat.numel() == 2 * k1.W_NUMEL
        singles_w = [k1.prepare_weights(m, dtype) for m in singles]  # each scene's pack in turn
        assert torch.equal(weights.w_flat, torch.cat([w.w_flat for w in singles_w]))
        assert torch.equal(weights.b_flat, torch.cat([w.b_flat for w in singles_w]))
        out = k1.apply_fused_mlp(stacked, pts, vd, vd2, dtype=dtype)
        for s, mlp in enumerate(singles):
            for key, v in k1.apply_fused_mlp(mlp, pts[s], vd[s], vd2[s], dtype=dtype).items():
                assert torch.equal(out[key][s], v), (dtype, key)
    out = k1.apply_fused_mlp(stacked, pts, vd, vd2, dtype=torch.float32)
    sum(v.square().sum() for v in out.values()).backward()
    for s, mlp in enumerate(singles):
        one = k1.apply_fused_mlp(mlp, pts[s], vd[s], vd2[s], dtype=torch.float32)
        sum(v.square().sum() for v in one.values()).backward()
        for name, p in mlp.named_parameters():
            torch.testing.assert_close(dict(stacked.named_parameters())[name].grad[s], p.grad,
                                       rtol=1e-5, atol=1e-7)


def test_stacked_render_takes_each_scenes_poses(db):
    """A stacked render of two scenes' gathered batches against each scene's
    model on its own batch: the same outputs (1e-5), visibility included,
    whose secondary origins come from each scene's own poses."""
    cfg = configs_for(db)
    tt = port_trainer(db, cfg)
    with torch.no_grad():
        for p in tt.model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(3)))
    nerf, sd = (torch.from_numpy(r).to(tt.device) for r in tt._index_rows(0, 1))
    prep0 = tt.preprocessors[0]
    batch = prep0.gather_batch(nerf[:, 0], sd[:, 0], 0, cache=tt.cache, near=tt.near, far=tt.far)
    out = render_rays(tt.model, cfg, batch, train=False, sec_views_vis=True)
    nr = batch["rays_o"].shape[0] // 2
    for i, prep in enumerate(tt.preprocessors):
        local = prep.gather_batch(nerf[i, 0] - i * tt.rays_per_scene, sd[i, 0] - i * tt.rays_per_scene, 0)
        one = render_rays(unstack_model(tt.model, i), cfg, local, train=False, sec_views_vis=True)
        for k, v in one.items():
            torch.testing.assert_close(out[k][i * nr:(i + 1) * nr], v, rtol=1e-5, atol=1e-5, msg=k)
    assert not torch.allclose(tt.cache["poses"][0], tt.cache["poses"][1])
