"""K1 (vipnerf_tpu_torch/kernels/fused_mlp.py): its plain version and the
wrapper's CPU dispatch against the JAX package's fused MLP.

References: `fm._raw_xla` (the XLA recompute equivalent to the Pallas
kernel) for n_sec 0..3, and `fm.apply_fused_mlp` run under
`pltpu.force_tpu_interpret_mode()` as tests/test_fused_mlp.py runs it.
Tolerances: f32 1e-6 absolute on raw outputs (summation order); bf16 one
bf16 step at |x| <= 1 (4e-3), since each product is rounded to bf16 after an
f32 sum whose order may differ; 2e-5 after the sigmoids against the Pallas
kernel, as tests/test_fused_mlp.py states for apply_mlp.

The kernel itself runs only on the card: tests/test_torch_kernels_cuda.py.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vipnerf_tpu.models.mlp import init_mlp_params
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))
import fused_mlp as fm  # noqa: E402

CFG = {
    "num_samples": 0, "netdepth": 8, "netwidth": 256,
    "points_positional_encoding_degree": 10, "views_positional_encoding_degree": 4,
    "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
}
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-6), "bf16": (torch.bfloat16, jnp.bfloat16, 4e-3)}


@pytest.fixture(scope="module")
def models():
    params = init_mlp_params(jax.random.PRNGKey(0), CFG)
    mlp = NeRFMLP(CFG)
    mlp.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return params, mlp


def inputs(n, n_sec, seed=0):
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    unit = lambda a: torch.nn.functional.normalize(torch.from_numpy(a.astype(np.float32)), dim=-1)  # noqa: E731
    vd = unit(rng.normal(size=(n, 3)))
    vd2 = unit(rng.normal(size=(n, n_sec, 3))) if n_sec else None
    return pts, vd, vd2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_plain_and_cpu_dispatch_match_raw_xla(models, dtype, n_sec):
    params, mlp = models
    t_dt, j_dt, tol = DTYPES[dtype]
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(256, n_sec), t_dt)
    weights = k1.prepare_weights(mlp, t_dt)
    before = k1.fused_mlp_raw.launches
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    assert k1.fused_mlp_raw.launches == before  # a CPU tensor never launches
    plain = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns)
    assert torch.equal(out, plain)
    assert out.shape == (256, k1.NOUT) and out.dtype == t_dt
    assert not out[:, 5 + n_sec:].any()

    j = lambda t: jnp.asarray(t.float().numpy()).astype(j_dt)  # noqa: E731
    ref = np.asarray(fm._raw_xla(params, j(xe), j(ve), j(ve2), n_sec, j_dt)).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy()[:, :5 + n_sec], ref[:, :5 + n_sec], atol=tol)


def test_apply_fused_mlp_matches_pallas_interpret(models):
    """The whole entry point (PE, padding, plain K1, epilogues) against the
    Pallas kernel in interpret mode, f32, one TILE of points, 2 secondary views."""
    params, mlp = models
    pts, vd, vd2 = inputs(fm.TILE, 2, seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = fm.apply_fused_mlp(params, CFG, jnp.asarray(pts.numpy()), jnp.asarray(vd.numpy()),
                                 jnp.asarray(vd2.numpy()), dtype=jnp.float32)
    out = k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=torch.float32)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=2e-5, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_fused_mlp_matches_module(models, dtype):
    """K1's entry point and the nn.Module agree (f32: 1e-5; bf16: the
    module's bf16 matmul rounds in another order, one bf16 step 8e-3)."""
    _, mlp = models
    pts, vd, vd2 = inputs(128, 1, seed=2)
    bf16 = dtype == torch.bfloat16
    with torch.no_grad():
        ref = mlp(pts, vd, vd2, bf16_matmuls=bf16)
    out = k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=dtype)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=8e-3 if bf16 else 1e-5)


def test_ragged_tail(models):
    _, mlp = models
    weights = k1.prepare_weights(mlp, torch.bfloat16)
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(2048 + 37, 2, seed=3), torch.bfloat16)
    full = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    head = k1.fused_mlp_raw(weights, xe[:37].contiguous(), ve[:37].contiguous(),
                            ve2[:37].contiguous(), ns)
    assert torch.equal(head, full[:37])
    assert k1.fused_mlp_raw(weights, xe[:0], ve[:0], ve2[:0], ns).shape == (0, k1.NOUT)


def test_wrapper_rejects_what_the_kernel_does_not_take(models):
    _, mlp = models
    w16 = k1.prepare_weights(mlp, torch.bfloat16)
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(64, 2), torch.bfloat16)
    with pytest.raises(TypeError):  # dtype differs from the weights'
        k1.fused_mlp_raw(w16, xe.float(), ve.float(), ve2.float(), ns)
    with pytest.raises(TypeError):  # a dtype K1 has no instance for
        half = k1.FusedWeights(w16.layers, w16.w_flat.half(), w16.b_flat, torch.float16)
        k1.fused_mlp_raw(half, xe.half(), ve.half(), ve2.half(), ns)
    with pytest.raises(ValueError):  # width
        k1.fused_mlp_raw(w16, xe[:, :63].contiguous(), ve, ve2, ns)
    with pytest.raises(ValueError):  # ve2 holds 2 views, n_sec says 1
        k1.fused_mlp_raw(w16, xe, ve, ve2, 1)
    with pytest.raises(ValueError):  # n_sec beyond the kernel's 3
        k1.fused_mlp_raw(w16, xe, ve, torch.zeros(64, 128, dtype=torch.bfloat16), 4)
    with pytest.raises(ValueError):  # rows differ
        k1.fused_mlp_raw(w16, xe, ve[:32], ve2, ns)
    with pytest.raises(ValueError):  # not contiguous
        k1.fused_mlp_raw(w16, xe, torch.zeros(32, 64, dtype=torch.bfloat16).t(), ve2, ns)
    with pytest.raises(ValueError):  # not the flagship
        k1.apply_fused_mlp(NeRFMLP(dict(CFG, netwidth=128)), *inputs(8, 0))


def test_packing_layout(models):
    _, mlp = models
    layers = k1.pack_layers(mlp, torch.float32)
    assert [tuple(w.shape) for w, _ in layers] == list(k1.LAYER_SHAPES)
    w5 = mlp.pts_linears[5].weight
    assert torch.equal(layers[5][0][:, :63], w5[:, :63]) and not layers[5][0][:, 63].any()
    assert torch.equal(layers[5][0][:, 64:], w5[:, 63:])
    assert not layers[k1.SIGMA][0][1:].any() and not layers[k1.VIEW_OUT][0][4:].any()
    # fragment order: lane 4g+t of tile (nt, kt) holds W[8nt+g, 16kt+2t+{0,1,8,9}]
    w = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32)
    frag = k1._fragment_order(w).reshape(2, 2, 32, 4)
    nt, kt, g, t = 1, 1, 3, 2
    expect = [w[8 * nt + g, 16 * kt + 2 * t + j] for j in (0, 1, 8, 9)]
    assert frag[nt, kt, 4 * g + t].tolist() == [float(x) for x in expect]
    w_flat, b_flat = k1.kernel_buffers(layers, torch.float32)
    assert w_flat.numel() == k1.W_NUMEL and b_flat.numel() == k1.B_NUMEL


def test_prepare_weights_repacks_after_an_update(models):
    _, mlp = models
    first = k1.prepare_weights(mlp, torch.float32)
    assert k1.prepare_weights(mlp, torch.float32) is first
    with torch.no_grad():
        mlp.feature_linear.bias.add_(0.0)
    assert k1.prepare_weights(mlp, torch.float32) is not first
