"""The port's MLP module and weight converter against the JAX package.

The same JAX-initialised weights go to both sides through
`state_dict_from_jax_params`. Tolerances: f32 1e-5 absolute (summation
order); bf16 modes 8e-3 absolute on the post-activation outputs -- the two
frameworks round each bf16 product after summing in different orders, which
can move a value by one bf16 step (2^-8 near 0.5 after a sigmoid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipnerf_tpu.models.mlp import apply_mlp, init_mlp_params
from vipnerf_tpu.utils.reference_ckpt import convert_model_state
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF
from vipnerf_tpu_torch.utils.convert import (
    jax_params_from_state_dict,
    state_dict_from_jax_params,
)

TOL = {"f32": 1e-5, "bf16": 8e-3, "bf16_f32_heads": 8e-3}
MODES = {"f32": (False, False), "bf16": (True, False), "bf16_f32_heads": (True, True)}


def mlp_cfg(depth=6, width=32, pe=(4, 2)):
    return {
        "num_samples": 8, "netdepth": depth, "netwidth": width,
        "points_positional_encoding_degree": pe[0],
        "views_positional_encoding_degree": pe[1],
        "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
    }


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def both_models(cfg, seed=0):
    params = init_mlp_params(jax.random.PRNGKey(seed), cfg)
    mlp = NeRFMLP(cfg)
    mlp.load_state_dict(state_dict_from_jax_params(np_tree(params)))
    return params, mlp


def inputs(n, n_sec, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    vd2 = None
    if n_sec:
        vd2 = rng.normal(size=(n, n_sec, 3)).astype(np.float32)
        vd2 /= np.linalg.norm(vd2, axis=-1, keepdims=True)
    return pts, vd, vd2


def compare(cfg, mlp, params, n, n_sec, mode):
    bf16, f32_heads = MODES[mode]
    pts, vd, vd2 = inputs(n, n_sec)
    fn = jax.jit(lambda p, *a: apply_mlp(p, cfg, *a, bf16_matmuls=bf16, f32_heads=f32_heads))
    ref = fn(params, jnp.asarray(pts), jnp.asarray(vd), None if vd2 is None else jnp.asarray(vd2))
    with torch.no_grad():
        out = mlp(torch.from_numpy(pts), torch.from_numpy(vd),
                  None if vd2 is None else torch.from_numpy(vd2),
                  bf16_matmuls=bf16, f32_heads=f32_heads)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == torch.float32
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=TOL[mode], err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n_sec", [0, 1, 2])
def test_mlp_small_width(mode, n_sec):
    cfg = mlp_cfg()
    params, mlp = both_models(cfg)
    compare(cfg, mlp, params, 64, n_sec, mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_mlp_flagship_width(mode):
    cfg = mlp_cfg(8, 256, (10, 4))
    params, mlp = both_models(cfg)
    compare(cfg, mlp, params, 300, 2, mode)


def test_mlp_view_independent_rgb():
    cfg = dict(mlp_cfg(), view_dependent_rgb=False)
    params, mlp = both_models(cfg)
    compare(cfg, mlp, params, 32, 1, "f32")


def test_mlp_rejects_view_outputs_without_view_dirs():
    with pytest.raises(RuntimeError):
        NeRFMLP(dict(mlp_cfg(), use_view_dirs=False))


def test_sigma_noise_from_generator():
    mlp = NeRFMLP(mlp_cfg())
    pts, vd, _ = inputs(64, 0)
    pts, vd = torch.from_numpy(pts), torch.from_numpy(vd)
    with torch.no_grad():
        clean = mlp(pts, vd)["sigma"]
        a = mlp(pts, vd, raw_noise_std=1.0, generator=torch.Generator().manual_seed(3))["sigma"]
        b = mlp(pts, vd, raw_noise_std=1.0, generator=torch.Generator().manual_seed(3))["sigma"]
    assert torch.equal(a, b) and not torch.equal(a, clean)


def test_seeded_init_bounds_and_determinism():
    cfg = mlp_cfg()
    a = NeRFMLP(cfg, torch.Generator().manual_seed(5))
    b = NeRFMLP(cfg, torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    layer = a.pts_linears[1]
    assert layer.weight.abs().max() <= 1 / np.sqrt(layer.in_features)


def flagship_configs():
    return {"model": {"coarse_mlp": mlp_cfg(8, 256, (10, 4)), "fine_mlp": mlp_cfg(8, 256, (10, 4))}}


def test_state_dict_keys_are_the_reference_keys():
    sd = ViPNeRF(flagship_configs()).state_dict()
    keys = list(sd)
    assert keys[0] == "coarse_model.pts_linears.0.weight"
    # registration order of the reference MLP (the order Adam's state uses)
    order = ["pts_linears", "views_linears", "pts_output_linear", "feature_linear",
             "views_output_linear"]
    coarse = [k.split(".")[1] for k in keys if k.startswith("coarse_model.")]
    assert [m for i, m in enumerate(coarse) if i == 0 or coarse[i - 1] != m] == order
    assert sd["coarse_model.pts_linears.5.weight"].shape == (256, 319)
    assert sd["fine_model.views_linears.0.weight"].shape == (128, 283)


def test_converter_cross_checks_reference_ckpt():
    """convert_model_state of the JAX package, applied to the port's
    state_dict, reproduces the JAX params exactly; both directions of the
    port's converter round-trip exactly."""
    from vipnerf_tpu.models.vip_nerf import init_params

    cfg = {"model": {"coarse_mlp": mlp_cfg(), "fine_mlp": mlp_cfg()}}
    params = np_tree(init_params(jax.random.PRNGKey(2), cfg))
    model = ViPNeRF(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    via_reference = convert_model_state(model.state_dict())
    via_port = jax_params_from_state_dict(model.state_dict())
    for tree in (via_reference, via_port):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)
    prefixed = {f"module.{k}": v for k, v in model.state_dict().items()}
    for a, b in zip(jax.tree_util.tree_leaves(jax_params_from_state_dict(prefixed)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
