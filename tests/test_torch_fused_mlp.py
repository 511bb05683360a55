"""K1 (vipnerf_tpu_torch/kernels/fused_mlp.py): its plain version and the
wrapper's CPU dispatch against the JAX package's fused MLP.

References: `fm._raw_xla` (the XLA recompute equivalent to the Pallas
kernel) for n_sec 0..3, and `fm.apply_fused_mlp` run under
`pltpu.force_tpu_interpret_mode()` as tests/test_fused_mlp.py runs it.
Tolerances: f32 1e-6 absolute on raw outputs (summation order); bf16 one
bf16 step at |x| <= 1 (4e-3), since each product is rounded to bf16 after an
f32 sum whose order may differ; 2e-5 after the sigmoids against the Pallas
kernel, as tests/test_fused_mlp.py states for apply_mlp.

The shipped mode (bf16 trunk, f32 heads: the bf16_f32h instance) has no
Pallas kernel: its reference is `apply_mlp(bf16_matmuls=True,
f32_heads=True)`, held at 1e-4 on the post-activation outputs (measured
6e-8: both round the same f32 sums of the trunk to bf16 here; a trunk
rounding that lands one bf16 step apart would move an output by ~1e-3).
PE(dir) rounded to bf16 moves the outputs by less than that tolerance, so
`test_f32_heads_view_encoding_is_never_rounded` pins it exactly.

The kernel itself runs only on the card: tests/test_torch_kernels_cuda.py.
"""

import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vipnerf_tpu.models.mlp import apply_mlp, init_mlp_params
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, pytest.param("bf16_f32h", id="bf16_f32h")])
def test_apply_fused_mlp_matches_module(models, dtype):
    """K1's entry point and the nn.Module agree in each precision mode (f32:
    1e-5; bf16: the module's bf16 matmul rounds in another order, one bf16
    step 8e-3; bf16 with f32 heads: the same trunk roundings, 8e-3)."""
    _, mlp = models
    pts, vd, vd2 = inputs(128, 1, seed=2)
    f32_heads = dtype == "bf16_f32h"
    dtype = torch.bfloat16 if f32_heads else dtype
    bf16 = dtype == torch.bfloat16
    with torch.no_grad():
        ref = mlp(pts, vd, vd2, bf16_matmuls=bf16, f32_heads=f32_heads)
    out = k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=dtype, f32_heads=f32_heads)
    for k in out:
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k].float().numpy(), atol=8e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_f32_heads_plain_and_entry_point_match_jax_apply_mlp(models, n_sec):
    """The bf16_f32h instance's plain version (the wrapper on CPU tensors)
    and `apply_fused_mlp(..., f32_heads=True)` against the JAX package's
    `apply_mlp(bf16_matmuls=True, f32_heads=True)`, 8x256, 256 points, the
    post-activation outputs: 1e-4 (see the module docstring)."""
    params, mlp = models
    pts, vd, vd2 = inputs(256, n_sec, seed=4)
    ref = apply_mlp(params, CFG, jnp.asarray(pts.numpy()), jnp.asarray(vd.numpy()),
                    None if vd2 is None else jnp.asarray(vd2.numpy()), bf16_matmuls=True, f32_heads=True)
    out = k1.apply_fused_mlp(mlp, pts, vd, vd2, dtype=torch.bfloat16, f32_heads=True)
    assert set(out) == set(ref)
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True)
    weights = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    raw = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    assert raw.dtype == torch.float32 and raw.shape == (256, k1.NOUT) and not raw[:, 5 + ns:].any()
    assert torch.equal(raw, k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns))
    plain = {"sigma": torch.relu(raw[:, :1]), "rgb": torch.sigmoid(raw[:, 1:4]),
             "visibility": torch.sigmoid(raw[:, 4:5])}
    if n_sec:
        plain["visibility2"] = torch.sigmoid(raw[:, 5:5 + n_sec])[..., None]
    for k, v in plain.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), atol=1e-4, err_msg=k)


def test_f32_heads_scene_axis_equals_single_scenes():
    """A stacked MLP of S = 2 scenes through the bf16_f32h instance's plain
    version equals each scene's own call, exactly, and its packed weights
    are the two scenes' packs one after the other."""
    singles = [NeRFMLP(CFG, torch.Generator().manual_seed(20 + s)) for s in range(2)]
    stacked = NeRFMLP(CFG, scenes=2)
    with torch.no_grad():
        for name, p in stacked.named_parameters():
            p.copy_(torch.stack([dict(m.named_parameters())[name] for m in singles]))
    weights = k1.prepare_weights(stacked, torch.bfloat16, f32_heads=True)
    packs = [k1.prepare_weights(m, torch.bfloat16, f32_heads=True) for m in singles]
    assert weights.scenes == 2 and torch.equal(weights.w_flat, torch.cat([w.w_flat for w in packs]))
    pts, vd, vd2 = inputs(2 * 96, 2, seed=5)
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True)
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    for s, r in enumerate((slice(0, 96), slice(96, 192))):
        assert torch.equal(out[r], k1.fused_mlp_raw(packs[s], xe[r].contiguous(), ve[r].contiguous(),
                                                    ve2[r].contiguous(), ns))
    batched = k1.apply_fused_mlp(stacked, pts.reshape(2, 96, 3), vd.reshape(2, 96, 3),
                                 vd2.reshape(2, 96, 2, 3), dtype=torch.bfloat16, f32_heads=True)
    for s, mlp in enumerate(singles):
        one = k1.apply_fused_mlp(mlp, pts[96 * s:96 * (s + 1)], vd[96 * s:96 * (s + 1)],
                                 vd2[96 * s:96 * (s + 1)], dtype=torch.bfloat16, f32_heads=True)
        for k, v in one.items():
            assert torch.equal(batched[k][s], v), k


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
    w_f32h = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    with pytest.raises(TypeError):  # bf16 PE(dir) for the f32 heads
        k1.fused_mlp_raw(w_f32h, xe, ve, ve2, ns)
    xe_h, ve_h, ve2_h, _ = k1.encode_inputs(*inputs(64, 2), torch.bfloat16, f32_heads=True)
    with pytest.raises(TypeError):  # f32 PE(dir) for the bf16 heads
        k1.fused_mlp_raw(w16, xe_h, ve_h, ve2_h, ns)
    with pytest.raises(ValueError):  # a bf16 pack's bytes where bf16_f32h's belong
        k1.fused_mlp_raw(w_f32h._replace(w_flat=w16.w_flat), xe_h, ve_h, ve2_h, ns)


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
        assert w_flat.numel() * size == k1.PACK_BYTES[dtype, dtype]


def test_f32_heads_packing(models):
    """bf16_f32h's pack: the trunk (layers 0-7) as bf16's swizzled slabs,
    then the heads (8-11) as f32's W^T, byte for byte, 1,404,928 bytes; its
    biases f32, bf16-rounded in the trunk only; cached apart from the bf16
    pack of the same weights."""
    _, mlp = models
    w16 = k1.prepare_weights(mlp, torch.bfloat16)
    w32 = k1.prepare_weights(mlp, torch.float32)
    mixed = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    assert mixed is not w16 and mixed.mode == (torch.bfloat16, torch.float32)
    assert k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True) is mixed
    assert k1.prepare_weights(mlp, torch.bfloat16) is w16 and w16.mode == (torch.bfloat16, torch.bfloat16)
    assert k1.PACK_BYTES[mixed.mode] == 1404928 == mixed.w_flat.numel() and mixed.w_flat.dtype == torch.uint8
    trunk = 2 * k1.TRUNK_NUMEL
    assert torch.equal(mixed.w_flat[:trunk], w16.w_flat[:k1.TRUNK_NUMEL].view(torch.uint8))
    assert torch.equal(mixed.w_flat[trunk:], w32.w_flat[k1.TRUNK_NUMEL:].view(torch.uint8))
    bias_trunk = sum(n for n, _ in k1.LAYER_SHAPES[:k1.FEATURE])
    assert torch.equal(mixed.b_flat[:bias_trunk], w16.b_flat[:bias_trunk])
    assert torch.equal(mixed.b_flat[bias_trunk:], w32.b_flat[bias_trunk:])
    assert [w.dtype for w, _ in mixed.layers] == [torch.bfloat16] * 8 + [torch.float32] * 4


def test_f32_heads_view_encoding_is_never_rounded():
    """With f32 heads, ve and ve2 are the f32 PE(dir) exactly (JAX's f32
    concatenation): no bf16 step in the view branch's input; xe is bf16."""
    pts, vd, vd2 = inputs(64, 3, seed=6)
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True)
    xe32, ve32, ve2_32, _ = k1.encode_inputs(pts, vd, vd2, torch.float32)
    assert xe.dtype == torch.bfloat16 and torch.equal(xe, xe32.to(torch.bfloat16))
    assert ve.dtype == ve2.dtype == torch.float32 and ns == 3
    assert torch.equal(ve, ve32) and torch.equal(ve2, ve2_32)
    assert not torch.equal(ve, ve.to(torch.bfloat16).float())  # a bf16 cast would show


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
    """Every precision mode of the flagship config runs K1, each through its
    own instance: bf16 with f32 heads (the shipped default) through
    bf16_f32h; f32 whatever f32_heads says (it matters only with bf16). A
    config other than the flagship runs the module MLP in every mode."""
    from vipnerf_tpu_torch.models.vip_nerf import uses_fused_mlp

    assert uses_fused_mlp(CFG, bf16_matmuls=True, f32_heads=True) == "fused_mlp_bf16_f32h"
    assert uses_fused_mlp(CFG, bf16_matmuls=True, f32_heads=False) == "fused_mlp_bf16"
    assert uses_fused_mlp(CFG, bf16_matmuls=False, f32_heads=False) == "fused_mlp_f32"
    assert uses_fused_mlp(CFG, bf16_matmuls=False, f32_heads=True) == "fused_mlp_f32"
    for bf16, f32_heads in itertools.product((False, True), repeat=2):
        assert uses_fused_mlp(dict(CFG, netwidth=128), bf16_matmuls=bf16, f32_heads=f32_heads) is None


def test_launch_counts_per_instance(models):
    _, mlp = models
    k1.reset_launch_counts()
    assert k1.fused_mlp_raw.launches == 0
    zero = {"fused_mlp_bf16": 0, "fused_mlp_f32": 0, "fused_mlp_bf16_f32h": 0}
    assert k1.fused_mlp_raw.launches_by_instance == zero
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(16, 1), torch.float32)
    k1.fused_mlp_raw(k1.prepare_weights(mlp, torch.float32), xe, ve, ve2, ns)
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(16, 1), torch.bfloat16, f32_heads=True)
    k1.fused_mlp_raw(k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True), xe, ve, ve2, ns)
    assert k1.fused_mlp_raw.launches_by_instance == zero  # CPU tensors launch nothing


def test_prepare_weights_repacks_after_an_update(models):
    _, mlp = models
    first = k1.prepare_weights(mlp, torch.float32)
    assert k1.prepare_weights(mlp, torch.float32) is first
    with torch.no_grad():
        mlp.feature_linear.bias.add_(0.0)
    assert k1.prepare_weights(mlp, torch.float32) is not first
