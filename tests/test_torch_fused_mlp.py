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
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), atol=2e-5, err_msg=k)


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
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k].numpy(), atol=8e-3 if bf16 else 1e-5)


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
    # buffer lengths against the byte table, for both instances
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        w_flat, b_flat = k1.kernel_buffers(k1.pack_layers(mlp, dtype), dtype)
        assert w_flat.numel() == k1.W_NUMEL and b_flat.numel() == k1.B_NUMEL
        assert w_flat.numel() * size == sum(k1.LAYER_BYTES[dtype])


def _inverse_bf16_image(flat, rows, cols):
    """A (rows, cols) weight from its bf16 image, written from the hardware's
    definition: K-slabs of 64 columns (the last one 32), K-major rows of
    2*kw bytes; the 128-byte swizzle XORs address bits 4-6 with bits 7-9,
    the 64-byte one bits 4-5 with bits 7-8."""
    out = torch.empty(rows, cols, dtype=flat.dtype)
    n = torch.arange(rows)[:, None]
    base = 0
    for k0 in range(0, cols, 64):
        kw = min(64, cols - k0)
        k = torch.arange(kw)[None, :]
        plain = n * (2 * kw) + 2 * k  # byte offset without swizzle
        mask = 7 if kw == 64 else 3
        swz = plain ^ (((plain >> 7) & mask) << 4)
        out[:, k0:k0 + kw] = flat[base // 2 + swz // 2]
        base += 2 * rows * kw
    return out


@pytest.mark.parametrize("layer", range(len(k1.LAYER_SHAPES)))
def test_bf16_slab_image_inverts_to_the_weight(models, layer):
    """Each layer's swizzled K-slab image (the 64-byte-swizzled 32-wide view
    slab of layer 10 included) maps back to its (out, in) weight exactly."""
    _, mlp = models
    layers = k1.pack_layers(mlp, torch.bfloat16)
    w_flat, _ = k1.kernel_buffers(layers, torch.bfloat16)
    rows, cols = k1.LAYER_SHAPES[layer]
    start = sum(k1.LAYER_BYTES[torch.bfloat16][:layer]) // 2
    image = w_flat[start:start + rows * cols]
    w = layers[layer][0]
    assert torch.equal(_inverse_bf16_image(image, rows, cols), w)


def test_f32_slab_layout_round_trips(models):
    """f32 layers are W^T row-major: slab s of a layer holds rows
    [s*KS, (s+1)*KS) of W^T, 16 KB at most (a whole 8-wide head)."""
    _, mlp = models
    layers = k1.pack_layers(mlp, torch.float32)
    w_flat, _ = k1.kernel_buffers(layers, torch.float32)
    start = 0
    for (w, _), (rows, cols) in zip(layers, k1.LAYER_SHAPES):
        seg = w_flat[start:start + rows * cols]
        ks = k1.f32_slab_rows(rows, cols)
        assert cols % ks == 0 and ks * rows <= k1.F32_SLAB
        for s in range(cols // ks):
            assert torch.equal(seg[s * ks * rows:(s + 1) * ks * rows], w.t()[s * ks:(s + 1) * ks].reshape(-1))
        start += rows * cols


def test_dispatch_routes_each_precision_mode():
    """The f32 instance beats the cuBLAS f32 chain on the card, so
    `bf16_matmuls: False` stays on K1; bf16 with f32 heads (the shipped
    default) has no instance and runs the module MLP."""
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp

    assert uses_fused_mlp(CFG, bf16_matmuls=True, f32_heads=False)
    assert uses_fused_mlp(CFG, bf16_matmuls=False, f32_heads=False)
    assert uses_fused_mlp(CFG, bf16_matmuls=False, f32_heads=True)
    assert not uses_fused_mlp(CFG, bf16_matmuls=True, f32_heads=True)
    assert not uses_fused_mlp(dict(CFG, netwidth=128), bf16_matmuls=False, f32_heads=False)


def test_launch_counts_per_instance(models):
    _, mlp = models
    k1.reset_launch_counts()
    assert k1.fused_mlp_raw.launches == 0
    assert k1.fused_mlp_raw.launches_by_instance == {"fused_mlp_bf16": 0, "fused_mlp_f32": 0}
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(16, 1), torch.float32)
    k1.fused_mlp_raw(k1.prepare_weights(mlp, torch.float32), xe, ve, ve2, ns)
    assert k1.fused_mlp_raw.launches_by_instance == {"fused_mlp_bf16": 0, "fused_mlp_f32": 0}


def test_prepare_weights_repacks_after_an_update(models):
    _, mlp = models
    first = k1.prepare_weights(mlp, torch.float32)
    assert k1.prepare_weights(mlp, torch.float32) is first
    with torch.no_grad():
        mlp.feature_linear.bias.add_(0.0)
    assert k1.prepare_weights(mlp, torch.float32) is not first
