"""K1's gradient (kernels/fused_mlp.py `FusedRaw`) and the training render's
gradients against the JAX package.

- `FusedRaw` through `apply_fused_mlp` against `jax.grad` of
  `fm.apply_fused_mlp` run in interpret mode, as tests/test_fused_mlp.py runs
  it: every parameter and pts/view dirs. f32: 3e-4 of each tensor's largest
  gradient, as that test states; bf16: both sides differentiate bf16
  products, rounded at other places in the two frameworks (parameters: up to
  2.5 % measured, so 4e-2 of the largest gradient and of the norm; the
  inputs' gradients pass the bf16-cast PE's sin/cos, up to 7.8 % at the
  largest element and 2.8 % of the norm measured, so 1e-1 and 3e-2).
- A training render through K1 gives every parameter the module MLP's
  gradient (this failed while K1 dropped its gradients): f32 1e-5 relative.
- One full-width (8x256) training render's losses and gradients with bf16
  heads against `jax.grad` of the JAX render on the same batch (perturb
  off, no sigma noise): losses 1e-2 relative, gradients 5e-2 of each
  tensor's largest in RMS (bf16 products round one step apart and move the
  fine samples).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vipnerf_tpu.losses import LossComputer as JaxLossComputer
from vipnerf_tpu.models import vip_nerf as j_vn
from vipnerf_tpu.models.mlp import init_mlp_params
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))
import fused_mlp as fm  # noqa: E402

CFG = {
    "num_samples": 0, "netdepth": 8, "netwidth": 256,
    "points_positional_encoding_degree": 10, "views_positional_encoding_degree": 4,
    "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    params = init_mlp_params(jax.random.PRNGKey(0), CFG)
    mlp = NeRFMLP(CFG)
    mlp.load_state_dict(state_dict_from_jax_params(to_np(params)))
    return params, mlp


def inputs(n, n_sec, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    return pts, unit(rng.normal(size=(n, 3))), unit(rng.normal(size=(n, n_sec, 3)))


def mlp_loss(out, lib):
    return (lib.sum(out["rgb"] ** 2) + lib.sum(out["sigma"]) + lib.sum(out["visibility"] * 0.5)
            + lib.sum(out["visibility2"] * 0.25))


def assert_grads_close(got: torch.Tensor, want: np.ndarray, max_rel: float, rms_rel: float, name):
    got = got.detach().float().numpy()
    scale = np.abs(want).max() + 1e-12
    assert np.abs(got - want).max() <= max_rel * scale, name
    assert np.linalg.norm(got - want) <= rms_rel * np.linalg.norm(want) + 1e-12, name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_raw_gradients_match_jax_pallas(models, dtype):
    params, mlp = models
    t_dt, j_dt = DTYPES[dtype]
    pts, vd, vd2 = inputs(fm.TILE, 2, seed=1)

    def loss_j(p, a, b, c):
        return mlp_loss(fm.apply_fused_mlp(p, CFG, a, b, c, dtype=j_dt), jnp)

    with pltpu.force_tpu_interpret_mode():
        g_j = jax.jit(jax.grad(loss_j, argnums=(0, 1, 2, 3)))(
            params, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(vd2))
    t_in = [torch.from_numpy(a).requires_grad_() for a in (pts, vd, vd2)]
    mlp.zero_grad(set_to_none=True)
    mlp_loss(k1.apply_fused_mlp(mlp, *t_in, dtype=t_dt), torch).backward()

    f32 = dtype == "f32"
    want = state_dict_from_jax_params(to_np(g_j[0]))
    for name, p in mlp.named_parameters():
        assert p.grad is not None, name
        assert_grads_close(p.grad, want[name].numpy(), 3e-4 if f32 else 4e-2,
                           3e-4 if f32 else 4e-2, name)
    for t, g, name in zip(t_in, g_j[1:], ("pts", "view_dirs", "view_dirs2")):
        assert_grads_close(t.grad, np.asarray(g), 3e-4 if f32 else 1e-1, 3e-4 if f32 else 3e-2, name)


@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_raw_recompute_matches_raw_xla_and_the_plain_version(models, n_sec):
    """The backward's recompute: f32 1e-6 against `_raw_xla` and K1's plain
    version (summation order)."""
    params, mlp = models
    pts, vd, vd2 = inputs(256, max(n_sec, 1), seed=2)
    xe, ve, ve2, ns = k1.encode_inputs(torch.from_numpy(pts), torch.from_numpy(vd),
                                       torch.from_numpy(vd2[:, :n_sec]) if n_sec else None,
                                       torch.float32)
    with torch.no_grad():
        out = k1.raw_recompute(k1.module_params(mlp), xe, ve, ve2, ns)
    plain = k1.fused_mlp_reference(k1.prepare_weights(mlp, torch.float32).layers, xe, ve, ve2, ns)
    ref = np.asarray(fm._raw_xla(params, *(jnp.asarray(t.numpy()) for t in (xe, ve, ve2)), ns,
                                 jnp.float32))
    assert out.shape == (256, k1.NOUT)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.numpy()[:, :5 + ns], ref[:, :5 + ns], atol=1e-6)


def test_packing_follows_every_optimizer_step(models):
    """After an Adam step the next K1 forward packs the updated weights: its
    output equals that of a fresh module holding them."""
    _, mlp0 = models
    mlp = NeRFMLP(CFG)
    mlp.load_state_dict(mlp0.state_dict())
    opt = torch.optim.Adam(mlp.parameters(), lr=1e-2)
    pts, vd, vd2 = (torch.from_numpy(a) for a in inputs(64, 2, seed=3))
    for _ in range(2):
        opt.zero_grad()
        mlp_loss(k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=torch.float32), torch).backward()
        opt.step()
        fresh = NeRFMLP(CFG)
        fresh.load_state_dict(mlp.state_dict())
        with torch.no_grad():
            got = k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=torch.float32)["rgb"]
            want = k1.apply_fused_mlp(fresh, pts, vd, vd2, dtype=torch.float32)["rgb"]
        assert torch.equal(got, want)


# ------------------------------------------------------- training renders

def flagship_configs(bf16: bool, f32_heads: bool = False, coarse=16, fine=32, **model):
    mlp = dict(CFG)
    cfg = {
        "data_loader": {"ndc": True},
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": dict(mlp, num_samples=coarse), "fine_mlp": dict(mlp, num_samples=fine),
            "chunk": 1024, "lindisp": False, "netchunk": 4096, "perturb": True,
            "raw_noise_std": 1.0, "white_bkgd": False, "bf16_matmuls": bf16, "f32_heads": f32_heads,
        },
        "losses": [
            {"name": "MSE01", "weight": 1},
            {"name": "VisibilityLoss01", "weight": 0.1},
            {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0, "10": 0.001}},
            {"name": "SparseDepthMSE01", "weight": 0.1},
        ],
        "seed": 0,
    }
    cfg["model"].update(model)
    return cfg


def train_batch(n_nerf=24, n_sd=8, nf=3, seed=0):
    """A training batch in gather_batch's layout: [nerf; sparse-depth] rays
    of a forward-facing NDC scene, stream masks, -1 fills off-stream."""
    rng = np.random.default_rng(seed)
    nr = n_nerf + n_sd
    rays_d = np.concatenate([rng.normal(0, 0.2, (nr, 2)), -np.ones((nr, 1))], 1)
    rays_o = np.concatenate([rng.normal(0, 0.1, (nr, 2)), np.zeros((nr, 1))], 1)
    mask_nerf = np.arange(nr) < n_nerf
    poses = np.tile(np.eye(4), (nf, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.2, (nf, 3))
    b = {
        "rays_o": rays_o, "rays_d": rays_d,
        "view_dirs": rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True),
        "rays_o_ndc": np.concatenate([rng.uniform(-0.5, 0.5, (nr, 2)), -np.ones((nr, 1))], 1),
        "rays_d_ndc": np.concatenate([rng.uniform(-0.2, 0.2, (nr, 2)), 2 * np.ones((nr, 1))], 1),
        "near": np.full((nr, 1), 1.0), "far": np.full((nr, 1), 8.0),
        "near_ndc": np.zeros((nr, 1)), "far_ndc": np.ones((nr, 1)),
        "target_rgb": np.where(mask_nerf[:, None], rng.uniform(0, 1, (nr, 3)), -1.0),
        "sparse_depth_values": np.where(mask_nerf[:, None], -1.0, rng.uniform(2, 6, (nr, 1))),
        "visibility_prior_masks": np.where(mask_nerf[:, None], rng.integers(0, 2, (nr, nf - 1)), -1.0),
        "poses": poses,
        "pixel_id": np.stack([rng.integers(0, nf, nr), rng.integers(0, 8, nr), rng.integers(0, 8, nr)], 1),
    }
    b = {k: np.asarray(v, np.int32 if k == "pixel_id" else np.float32) for k, v in b.items()}
    b["indices_mask_nerf"] = mask_nerf
    b["indices_mask_sparse_depth"] = ~mask_nerf
    b["iter_num"] = 20
    return b


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v for k, v in b.items()}


def torch_grads(model, cfg, batch, seed=5):
    model.zero_grad(set_to_none=True)
    out = t_vn.render_rays(model, cfg, batch, train=True, generator=torch.Generator().manual_seed(seed))
    losses = LossComputer(cfg).compute_losses(batch, out)
    losses["TotalLoss"].backward()
    return losses, {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_training_render_through_k1_gives_every_parameter_its_gradient(bf16):
    """K1's training render and the module MLP's, same weights, batch and
    generator (perturbed samples; no sigma noise, which the module adds in
    bf16 and K1's epilogue in f32, as in the JAX package): every parameter
    gets a gradient, and it is the module path's (f32: 1e-5 relative, the
    same arithmetic in another order; bf16: 3e-2 relative RMS)."""
    cfg = flagship_configs(bf16, raw_noise_std=0.0)
    assert t_vn.uses_fused_mlp(cfg["model"]["fine_mlp"], bf16, False)
    model = t_vn.ViPNeRF(cfg)
    batch = torch_batch(train_batch())
    _, g_k1 = torch_grads(model, cfg, batch)
    dispatch = t_vn.uses_fused_mlp
    t_vn.uses_fused_mlp = lambda *a: False
    try:
        _, g_mod = torch_grads(model, cfg, batch)
    finally:
        t_vn.uses_fused_mlp = dispatch
    assert len(g_k1) == 48
    for name, g in g_mod.items():
        assert g_k1[name] is not None, f"{name} got no gradient through K1"
        if bf16:
            assert (g_k1[name] - g).norm() <= 3e-2 * g.norm(), name
        else:
            torch.testing.assert_close(g_k1[name], g, rtol=1e-5, atol=1e-5 * g.abs().max().item(), msg=name)


def test_full_width_training_render_matches_jax_bf16_heads():
    """8x256, bf16 matmuls with bf16 heads, the four losses: the port's
    render runs K1 (its plain version here, and its recompute in the
    backward); the JAX render runs apply_mlp in bf16."""
    cfg = flagship_configs(True, perturb=False, raw_noise_std=0.0)
    params = j_vn.init_params(jax.random.PRNGKey(0), cfg)
    model = t_vn.ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(to_np(params)))
    b = train_batch(seed=1)
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in b.items()}

    def total_j(p):
        out = j_vn.render_rays(p, cfg, jb, train=True)
        losses = JaxLossComputer(cfg).compute_losses(jb, out)
        return losses["TotalLoss"], losses

    (_, l_j), g_j = jax.jit(jax.value_and_grad(total_j, has_aux=True))(params)
    l_t, g_t = torch_grads(model, cfg, torch_batch(b))
    for name in ("MSE01", "VisibilityLoss01", "VisibilityPriorLoss01", "SparseDepthMSE01"):
        np.testing.assert_allclose(l_t[name]["loss_value"].item(), float(l_j[name]["loss_value"]),
                                   rtol=1e-2, err_msg=name)
    np.testing.assert_allclose(l_t["TotalLoss"].item(), float(l_j["TotalLoss"]), rtol=1e-2)
    want = state_dict_from_jax_params(to_np(g_j))
    assert set(want) == set(g_t)
    for name, g in g_t.items():
        w = want[name].numpy()
        assert np.linalg.norm(g.numpy() - w) <= 5e-2 * np.linalg.norm(w) + 1e-12, name
