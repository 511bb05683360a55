"""The port's losses, LossComputer, LR schedules and train step against the
JAX package, on the same numpy inputs.

Tolerances: loss values and their gradients 1e-6 relative (f32, the same
formulas); LR schedules 1e-12 relative (float64 on both sides but for the
JAX mip schedule's float32: 1e-6); K Adam steps of the narrow model against
optax 1e-4 absolute on the parameters (f32, summation order compounded over
the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipnerf_tpu.losses import LossComputer as JLossComputer
from vipnerf_tpu.losses import functions as jf
from vipnerf_tpu.models import vip_nerf as j_vn
from vipnerf_tpu.train import lr_schedules as jlr
from vipnerf_tpu.train.step import make_optimizer as j_make_optimizer
from vipnerf_tpu.train.step import make_train_step as j_make_train_step
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.losses import functions as tf
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.train import lr_schedules as tlr
from vipnerf_tpu_torch.train.step import clip_by_global_norm, make_optimizer, make_train_step
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

NR, NS, NF = 40, 12, 3
CONFIGS = {"model": {"coarse_mlp": {}, "fine_mlp": {}}}


def loss_inputs(seed=0, with_vis2=True, ray_valid=False):
    """Outputs and batch fields every loss reads, as numpy arrays."""
    rng = np.random.default_rng(seed)
    mask_nerf = np.arange(NR) < 28
    out, batch = {}, {
        "indices_mask_nerf": mask_nerf,
        "indices_mask_sparse_depth": ~mask_nerf,
        "target_rgb": np.where(mask_nerf[:, None], rng.uniform(0, 1, (NR, 3)), -1.0),
        "sparse_depth_values": np.where(mask_nerf[:, None], -1.0, rng.uniform(1, 5, (NR, 1))),
        "dense_depth_values": rng.uniform(1, 5, (NR, 1)),
        "visibility_prior_masks": rng.integers(0, 2, (NR, NF - 1)).astype(np.float64),
        "rays_o": rng.normal(size=(NR, 3)),
        "iter_num": 7,
    }
    if ray_valid:
        batch["ray_valid"] = np.arange(NR) < 33
    for s in ("coarse", "fine"):
        out[f"rgb_{s}"] = rng.uniform(0, 1, (NR, 3))
        out[f"depth_{s}"] = rng.uniform(1, 5, (NR,))
        out[f"raw_visibility_{s}"] = rng.uniform(0, 1, (NR, NS, 1))
        out[f"visibility_{s}"] = rng.uniform(0, 1, (NR, NS))
        if with_vis2:
            out[f"visibility2_{s}"] = rng.uniform(0, 1, (NR, NF - 1))
            out[f"raw_visibility2_{s}"] = rng.uniform(0, 1, (NR, NS, NF - 1, 1))
    cast = lambda v: v.astype(np.float32) if isinstance(v, np.ndarray) and v.dtype == np.float64 else v  # noqa: E731
    return {k: cast(v) for k, v in out.items()}, {k: cast(v) for k, v in batch.items()}


def torch_tree(tree, grad_keys=()):
    return {k: (torch.tensor(v, requires_grad=k in grad_keys) if isinstance(v, np.ndarray) else v)
            for k, v in tree.items()}


LOSSES = {
    "MSE01": (jf.mse, tf.mse, ["rgb_coarse", "rgb_fine"]),
    "VisibilityLoss01": (jf.visibility_loss, tf.visibility_loss,
                         ["raw_visibility_coarse", "visibility_coarse", "raw_visibility_fine",
                          "visibility_fine"]),
    "VisibilityPriorLoss01": (jf.visibility_prior_loss, tf.visibility_prior_loss,
                              ["visibility2_coarse", "visibility2_fine"]),
    "SparseDepthMSE01": (jf.sparse_depth_mse, tf.sparse_depth_mse, ["depth_fine"]),
    "DenseDepthMSE01": (jf.dense_depth_mse, tf.dense_depth_mse, ["depth_coarse", "depth_fine"]),
}


@pytest.mark.parametrize("ray_valid", [False, True], ids=["train_batch", "tiled_render"])
@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_gradients_match_jax(name, ray_valid):
    """Value, loss maps and the gradient towards every output the loss reads:
    the VisibilityLoss01 gradients check both stop-gradient directions (the
    MLP's visibility learns from the transmittance, and the transmittance
    from the MLP's visibility, each with the other held fixed)."""
    j_fn, t_fn, keys = LOSSES[name]
    out, batch = loss_inputs(seed=1, ray_valid=ray_valid)
    j_loss = j_fn(CONFIGS, {})
    t_loss = t_fn(CONFIGS, {})

    def value_j(outs):
        return j_loss({k: jnp.asarray(v) for k, v in batch.items()}, {**out, **outs})["loss_value"]

    val_j, g_j = jax.value_and_grad(value_j)({k: jnp.asarray(out[k]) for k in keys})
    t_out = torch_tree(out, keys)
    res_t = t_loss(torch_tree(batch), t_out, return_loss_maps=True)
    res_t["loss_value"].backward()
    np.testing.assert_allclose(res_t["loss_value"].item(), float(val_j), rtol=1e-6)
    for k in keys:
        np.testing.assert_allclose(t_out[k].grad.numpy(), np.asarray(g_j[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    maps_j = j_loss({k: jnp.asarray(v) for k, v in batch.items()}, out, True)["loss_maps"]
    assert set(res_t["loss_maps"]) == set(maps_j)
    for k, v in maps_j.items():
        np.testing.assert_allclose(res_t["loss_maps"][k].detach().numpy(), np.asarray(v), rtol=1e-6)


def test_visibility_loss_gradient_directions():
    """Each side of VisibilityLoss01 is pulled towards the other: d/d(pred) =
    sign(pred - target) / (nr * ns) for one half, d/d(target) the opposite."""
    out, batch = loss_inputs(seed=2)
    t_out = torch_tree(out, ["raw_visibility_fine", "visibility_fine"])
    cfg = {"model": {"fine_mlp": {}}}
    tf.visibility_loss(cfg, {})(torch_tree(batch), t_out)["loss_value"].backward()
    sign = np.sign(out["raw_visibility_fine"][..., 0] - out["visibility_fine"])
    np.testing.assert_allclose(t_out["raw_visibility_fine"].grad.numpy()[..., 0], sign / (NR * NS), rtol=1e-6)
    np.testing.assert_allclose(t_out["visibility_fine"].grad.numpy(), -sign / (NR * NS), rtol=1e-6)


def test_masked_means_and_missing_inputs():
    out, batch = loss_inputs(seed=3, with_vis2=False)
    tb, to = torch_tree(batch), torch_tree(out)
    # no visibility2 (a validation-view render): the prior loss is skipped
    assert tf.visibility_prior_loss(CONFIGS, {})(tb, to) is None
    # an empty mask gives 0, not NaN
    tb["indices_mask_sparse_depth"] = torch.zeros(NR, dtype=torch.bool)
    assert tf.sparse_depth_mse(CONFIGS, {})(tb, to)["loss_value"].item() == 0.0
    # a full-image batch has no sparse-depth stream
    del tb["indices_mask_sparse_depth"]
    assert tf.sparse_depth_mse(CONFIGS, {})(tb, to)["loss_value"].item() == 0.0


@pytest.mark.parametrize("iter_num", [0, 9, 10, 29, 30, 1000])
def test_loss_computer_matches_jax(iter_num):
    """Constant and staged weights, the None-skip and TotalLoss."""
    configs = {
        "model": {"coarse_mlp": {}, "fine_mlp": {}},
        "losses": [
            {"name": "MSE01", "weight": 1},
            {"name": "VisibilityLoss01", "weight": 0.1},
            {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0, "10": 0.001, "30": 0.01}},
            {"name": "SparseDepthMSE01", "weight": 0.1},
        ],
    }
    for with_vis2 in (True, False):
        out, batch = loss_inputs(seed=4, with_vis2=with_vis2)
        batch["iter_num"] = iter_num
        lj = JLossComputer(configs).compute_losses({k: jnp.asarray(v) for k, v in batch.items()}, out)
        lt = LossComputer(configs).compute_losses(torch_tree(batch), torch_tree(out))
        assert set(lt) == set(lj)
        assert ("VisibilityPriorLoss01" in lt) == with_vis2
        np.testing.assert_allclose(lt["TotalLoss"].item(), float(lj["TotalLoss"]), rtol=1e-6)
    lc = LossComputer(configs)
    assert [lc.get_loss_weight("VisibilityPriorLoss01", i) for i in (0, 9, 10, 30)] == [0, 0, 0.001, 0.01]


def test_loss_computer_rejects_bad_configs():
    with pytest.raises(RuntimeError):
        LossComputer({"model": {}, "losses": [{"name": "NoSuchLoss", "weight": 1}]})
    with pytest.raises(RuntimeError):  # staged weights need a '0' stage
        LossComputer({"model": {}, "losses": [{"name": "MSE01", "iter_weights": {"5": 1.0}}]})


@pytest.mark.parametrize("opt", [
    {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 5e-4, "lr_decay": 250},
    {"lr_decayer_name": "MipNeRFLearningRateDecayer01", "lr_initial": 5e-4, "lr_final": 5e-6,
     "lr_decay_steps": 2500, "lr_decay_mult": 0.01},
    {"lr_decayer_name": "MipNeRFLearningRateDecayer01", "lr_initial": 1e-3, "lr_final": 1e-5},
])
def test_lr_schedules_match_jax(opt):
    configs = {"optimizer": opt, "num_iterations": 200000}
    sj, st = jlr.get_lr_schedule(configs), tlr.get_lr_schedule(configs)
    for step in (0, 1, 100, 2499, 2500, 30000, 199999, 250000):
        np.testing.assert_allclose(st(step), float(sj(step)), rtol=1e-6)
    with pytest.raises(RuntimeError):
        tlr.get_lr_schedule({"optimizer": {"lr_decayer_name": "Nope"}})


def test_grad_clip_matches_optax():
    import optax

    rng = np.random.default_rng(5)
    grads = [rng.normal(size=(7, 3)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        clip_by_global_norm(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ------------------------------------------------------------ train step

def narrow_configs(**extra):
    mlp = {"netdepth": 4, "netwidth": 32, "points_positional_encoding_degree": 4,
           "views_positional_encoding_degree": 2, "use_view_dirs": True,
           "view_dependent_rgb": True, "predict_visibility": True}
    cfg = {
        "data_loader": {"ndc": False},
        "model": {"name": "VipNeRF01", "coarse_mlp": dict(mlp, num_samples=8),
                  "fine_mlp": dict(mlp, num_samples=8), "chunk": 1024, "lindisp": False,
                  "netchunk": 4096, "perturb": False, "raw_noise_std": 0.0, "white_bkgd": False},
        "losses": [{"name": "MSE01", "weight": 1}, {"name": "VisibilityLoss01", "weight": 0.1},
                   {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0.001}},
                   {"name": "SparseDepthMSE01", "weight": 0.1}],
        "optimizer": {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 5e-3,
                      "lr_decay": 1, "beta1": 0.9, "beta2": 0.99},
        "seed": 0,
    }
    cfg.update(extra)
    return cfg


def step_batch(it, nr=32, nf=3):
    rng = np.random.default_rng(100 + it)
    mask = np.arange(nr) < nr // 2
    rays_d = rng.normal(0, 0.3, (nr, 3)) + [0, 0, -1.0]
    poses = np.tile(np.eye(4), (nf, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.3, (nf, 3))
    b = {
        "rays_o": rng.normal(0, 0.1, (nr, 3)), "rays_d": rays_d,
        "view_dirs": rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True),
        "near": np.full((nr, 1), 1.0), "far": np.full((nr, 1), 4.0),
        "target_rgb": np.where(mask[:, None], rng.uniform(0, 1, (nr, 3)), -1.0),
        "sparse_depth_values": np.where(mask[:, None], -1.0, rng.uniform(1.5, 3.5, (nr, 1))),
        "visibility_prior_masks": rng.integers(0, 2, (nr, nf - 1)),
        "poses": poses,
        "pixel_id": np.stack([rng.integers(0, nf, nr)] + [rng.integers(0, 8, nr)] * 2, 1),
    }
    b = {k: np.asarray(v, np.int32 if k == "pixel_id" else np.float32) for k, v in b.items()}
    b.update(indices_mask_nerf=mask, indices_mask_sparse_depth=~mask, iter_num=it)
    return b


def test_adam_steps_match_optax():
    """K steps from the same parameters on the same batches: the port's
    train step (torch Adam, LR schedule(it), clipping) against the JAX train
    step (optax)."""
    cfg = narrow_configs()
    cfg["optimizer"]["grad_clip_norm"] = 0.05
    params = j_vn.init_params(jax.random.PRNGKey(0), cfg)
    tx = j_make_optimizer(cfg)
    opt_state = tx.init(params)
    j_step = jax.jit(j_make_train_step(cfg, j_vn.render_rays, JLossComputer(cfg), tx))
    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    t_step = make_train_step(cfg, t_vn.render_rays, LossComputer(cfg), make_optimizer(cfg, model.parameters()))
    for it in range(6):
        b = step_batch(it)
        params, opt_state, sj = j_step(params, opt_state, {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                                          for k, v in b.items()}, jax.random.PRNGKey(0))
        st = t_step(model, torch_tree(b), None)
        np.testing.assert_allclose(st["TotalLoss"].item(), float(sj["TotalLoss"]), rtol=1e-4)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4, err_msg=k)


def test_sub_batches_sum_gradients_and_scalars():
    """sub_batch_size: gradients of the sub-batches are summed before one
    step (so a per-sub-batch mean loss gives twice the full batch's
    gradient for two halves of equal loss), scalars summed; the step equals
    JAX's sub-batched step."""
    cfg = narrow_configs(sub_batch_size=16)
    params = j_vn.init_params(jax.random.PRNGKey(1), cfg)
    tx = j_make_optimizer(cfg)
    j_step = jax.jit(j_make_train_step(cfg, j_vn.render_rays, JLossComputer(cfg), tx))
    b = step_batch(3)
    # both halves hold both streams
    order = np.r_[0:8, 16:24, 8:16, 24:32]
    b = {k: (v[order] if isinstance(v, np.ndarray) and v.shape[:1] == (32,) else v) for k, v in b.items()}
    new_params, _, sj = j_step(params, tx.init(params), {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                                         for k, v in b.items()}, jax.random.PRNGKey(0))
    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    st = make_train_step(cfg, t_vn.render_rays, LossComputer(cfg),
                         make_optimizer(cfg, model.parameters()))(model, torch_tree(b), None)
    for k in sj:
        np.testing.assert_allclose(st[k].item(), float(sj[k]), rtol=1e-5, err_msg=k)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, new_params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)
    with pytest.raises(ValueError):
        make_train_step(narrow_configs(sub_batch_size=5), t_vn.render_rays, LossComputer(cfg),
                        make_optimizer(cfg, model.parameters()))(model, torch_tree(b), None)


def test_loss_guard_is_not_ported_yet():
    """The guard is ported now (tests/test_torch_guards.py holds it against
    optax): `optimizer.loss_guard` wraps Adam, and a step whose loss spikes
    past the warmup leaves the parameters and Adam's count as they were."""
    cfg = narrow_configs()
    cfg["optimizer"]["loss_guard"] = {"warmup": 1}
    model = t_vn.ViPNeRF(cfg)
    opt = make_optimizer(cfg, model.parameters())
    for loss in (1.0, 100.0):
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        before = [p.detach().clone() for p in model.parameters()]
        opt.step(loss=torch.tensor(loss))
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
    assert int(opt.state_dict()["state"][0]["step"]) == 1
