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

bf16_f32h computes its f32 heads on the card from products of bf16 parts
(`k1.split_bf16`: three parts that sum to each f32 operand exactly). The
packer tests hold those parts and their slab images to the hardware's
layout; `_emulate_split_heads` repeats the kernel's arithmetic in numpy
(parts rounded to nearest even on the bits, exact products, each wgmma k16
step's sum rounded to f32 toward zero, in the kernel's order) and is held
against the JAX package's f32 heads on the JAX trunk's own h, raw and after
`apply_mlp(bf16_matmuls=True, f32_heads=True)`'s activations, within
chip_smoke's heads-only tolerances (`TOL_HEADS_MAX` 3e-5 of the largest
output, `TOL_HEADS_RMS` 3e-6 RMS; measured at most 1.4e-6 and 9.5e-7 raw),
which a one-pass TF32 emulation misses by more than 10x. The truncating
accumulation is what puts the card's heads ~1e-6 from plain f32 heads on
the same h: sums rounded to nearest read ~7x less.

The kernel itself runs only on the card: tests/test_torch_kernels_cuda.py.
"""

import ast
import itertools
import re
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
from vipnerf_tpu_torch.utils import tracing
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "experiments"))
import fused_mlp as fm  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import TOL_HEADS_MAX, TOL_HEADS_RMS  # noqa: E402
from vipnerf_tpu.models import mlp as jax_mlp  # noqa: E402

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
    before = k1.launches()
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    assert k1.launches() == before  # a CPU tensor never launches
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


def _chain_before_the_kernel(pts, vd, vd2, dtype, fast, f32_heads):
    """`encode_inputs` as it was written before the encode kernel: the torch
    chain, literally, on per-point directions."""
    pe = k1.positional_encoding
    head = torch.float32 if f32_heads else dtype
    n_sec = vd2.shape[1] if vd2 is not None else 0
    xe = torch.nn.functional.pad(pe(pts, 10, fast), (0, 1)).to(dtype)
    ve = torch.nn.functional.pad(pe(vd, 4, fast), (0, 5)).to(head)
    ve2 = torch.nn.functional.pad(pe(vd2.reshape(-1, 3), 4, fast), (0, 5)).reshape(len(pts), -1).to(head) \
        if n_sec else ve
    return xe, ve, ve2, n_sec


ENCODE_MODES = {"bf16": (torch.bfloat16, False), "f32": (torch.float32, False), "bf16_f32h": (torch.bfloat16, True)}


@pytest.mark.parametrize("mode", list(ENCODE_MODES))
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_encode_inputs_on_cpu_is_the_torch_chain(mode, n_sec, fast):
    """CPU tensors take `encode_reference`, which is the chain as it was,
    bit for bit, in every mode, n_sec and `fast_encoding`; they launch and
    count nothing."""
    dtype, f32_heads = ENCODE_MODES[mode]
    pts, vd, vd2 = inputs(301, n_sec, seed=n_sec)
    pts = pts * 40  # arguments up to 2^9 * 40: the sines' range reduction is exercised too
    tracing.reset()
    got = k1.encode_inputs(pts, vd, vd2, dtype, fast, f32_heads)
    want = _chain_before_the_kernel(pts, vd, vd2, dtype, fast, f32_heads)
    assert got[3] == want[3] == n_sec
    for g, w, name in zip(got[:3], want[:3], ("xe", "ve", "ve2")):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous(), name
        assert torch.equal(g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32),
                           w.view(torch.int16 if w.dtype == torch.bfloat16 else torch.int32)), name
    if not n_sec:
        assert got[2] is got[1]
    assert tracing.counts("k1.") == {}


@pytest.mark.parametrize("samples", [1, 64, 192])
def test_encode_reads_a_ray_direction_for_its_samples(samples):
    """view_dirs with one row per ray (R rows for R * samples points) encode
    as the same directions copied out to every sample."""
    rays = 3
    pts, vd, vd2 = inputs(rays * samples, 2, seed=samples)
    per_ray = vd[::samples].contiguous()
    copied = per_ray[:, None, :].expand(rays, samples, 3).reshape(-1, 3)
    for dtype, f32_heads in ENCODE_MODES.values():
        got = k1.encode_inputs(pts, per_ray, vd2, dtype, f32_heads=f32_heads)
        want = k1.encode_inputs(pts, copied, vd2, dtype, f32_heads=f32_heads)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)


def test_apply_fused_mlp_takes_per_ray_directions(models):
    """The renderer hands K1 one direction per ray: the same outputs as
    directions copied out to every sample, stacked scenes too."""
    _, mlp = models
    pts, vd, vd2 = inputs(4 * 16, 2, seed=5)
    per_ray = vd[::16].contiguous()
    copied = per_ray.repeat_interleave(16, 0)
    with torch.no_grad():
        got = k1.apply_fused_mlp(mlp, pts, per_ray, vd2, dtype=torch.bfloat16, f32_heads=True)
        want = k1.apply_fused_mlp(mlp, pts, copied, vd2, dtype=torch.bfloat16, f32_heads=True)
    for key in want:
        assert torch.equal(got[key], want[key]), key


BAD_ENCODE = {
    "pts width": (lambda p, v, v2: (p[:, :2], v, v2), ValueError),
    "pts rank": (lambda p, v, v2: (p[None], v, v2), ValueError),
    "dirs not dividing": (lambda p, v, v2: (p, v[:5], v2), ValueError),
    "dirs width": (lambda p, v, v2: (p, v[:, :2], v2), ValueError),
    "no dirs for points": (lambda p, v, v2: (p, v[:0], v2), ValueError),
    "dirs2 rows": (lambda p, v, v2: (p, v, v2[:4]), ValueError),
    "dirs2 rank": (lambda p, v, v2: (p, v, v2.reshape(len(p), -1)), ValueError),
    "n_sec 4": (lambda p, v, v2: (p, v, torch.cat([v2, v2], 1)), ValueError),
    "f64 pts": (lambda p, v, v2: (p.double(), v, v2), TypeError),
    "bf16 dirs": (lambda p, v, v2: (p, v.bfloat16(), v2), TypeError),
    "f16 dirs2": (lambda p, v, v2: (p, v, v2.half()), TypeError),
    "dirs on another device": (lambda p, v, v2: (p, v.to("meta"), v2), ValueError),
    "dirs2 on another device": (lambda p, v, v2: (p, v, v2.to("meta")), ValueError),
    "not cuda or cpu": (lambda p, v, v2: (p.to("meta"), v.to("meta"), v2.to("meta")), ValueError),
}


@pytest.mark.parametrize("case", list(BAD_ENCODE))
def test_encode_rejects_what_the_kernel_does_not_take(case):
    """The wrapper's checks raise before anything runs, on either device."""
    edit, error = BAD_ENCODE[case]
    pts, vd, vd2 = inputs(64, 2)
    tracing.reset()
    with pytest.raises(error):
        k1.encode_inputs(*edit(pts, vd, vd2), torch.bfloat16, f32_heads=True)
    assert tracing.counts("k1.") == {}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_encode_rejects_a_mode_k1_lacks(dtype):
    with pytest.raises(TypeError):
        k1.encode_inputs(*inputs(8, 0), dtype)


def test_encode_keeps_the_gradient_of_tracked_inputs():
    """On CPU tensors, inputs that autograd tracks take the torch chain, so
    PE stays differentiable: d xe / d pts is the chain's."""
    pts, vd, vd2 = inputs(16, 1)
    pts = pts.clone().requires_grad_()
    xe, _, _, _ = k1.encode_inputs(pts, vd, vd2, torch.float32)
    xe.sum().backward()
    want = pts.detach().clone().requires_grad_()
    k1.positional_encoding(want, 10).sum().backward()
    assert torch.equal(pts.grad, want.grad)


def test_encode_of_no_points():
    xe, ve, ve2, ns = k1.encode_inputs(*(t[:0] for t in inputs(4, 2)), torch.bfloat16, f32_heads=True)
    assert (xe.shape, ve.shape, ve2.shape, ns) == ((0, 64), (0, 32), (0, 64), 2)
    assert xe.dtype == torch.bfloat16 and ve.dtype == ve2.dtype == torch.float32


def _c_lookups(path):
    """(library, entry) of every `vipnerf_*` C entry that a module's
    functions look up: each function's `build.load("<library>")` and the
    `vipnerf_*` names in it, as attributes or strings."""
    found = set()
    for fn in ast.walk(ast.parse(path.read_text())):
        if not isinstance(fn, ast.FunctionDef):
            continue
        nodes = list(ast.walk(fn))
        libs = {n.args[0].value for n in nodes if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "load" and n.args and isinstance(n.args[0], ast.Constant)}
        names = {n.attr for n in nodes if isinstance(n, ast.Attribute) and n.attr.startswith("vipnerf_")}
        names |= {n.value for n in nodes if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and re.fullmatch(r"vipnerf_\w+", n.value) and not n.value.startswith("vipnerf_tpu")}
        if names:
            assert len(libs) == 1, (path.name, fn.name, libs)
            found |= {(next(iter(libs)), name) for name in names}
    return found


def test_every_bound_c_entry_is_in_its_source():
    """Every `vipnerf_*` C entry the port's wrappers look up (K1's instances
    through `_entry`, by their `INSTANCE` names) is declared `extern "C"` in
    the source that `build.SOURCES` maps its library to, and every source
    listed there exists."""
    from vipnerf_tpu_torch.kernels import build

    for source in build.SOURCES.values():
        assert (build.CSRC_DIR / source).is_file(), source
    lookups = set().union(*(_c_lookups(path) for path in sorted(build.PKG_DIR.rglob("*.py"))))
    lookups |= {("fused_mlp", "vipnerf_" + name) for name in k1.INSTANCE.values()}
    assert {("fused_mlp_bwd", "vipnerf_heads_bwd_points"), ("fused_mlp", "vipnerf_k1_encode")} <= lookups
    for lib, name in sorted(lookups):
        assert lib in build.SOURCES, (lib, name)
        src = (build.CSRC_DIR / build.SOURCES[lib]).read_text()
        assert re.search(r'extern "C" [\w ]+\b' + name + r"\(", src), (lib, name)


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
    then the heads (8-11) as the stream of their three bf16 parts,
    1,615,872 bytes; its biases f32, bf16-rounded in the trunk only; cached
    apart from the bf16 pack of the same weights."""
    _, mlp = models
    w16 = k1.prepare_weights(mlp, torch.bfloat16)
    w32 = k1.prepare_weights(mlp, torch.float32)
    mixed = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    assert mixed is not w16 and mixed.mode == (torch.bfloat16, torch.float32)
    assert k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True) is mixed
    assert k1.prepare_weights(mlp, torch.bfloat16) is w16 and w16.mode == (torch.bfloat16, torch.bfloat16)
    assert k1.PACK_BYTES[mixed.mode] == 1615872 == mixed.w_flat.numel() and mixed.w_flat.dtype == torch.uint8
    assert k1.PACK_BYTES[mixed.mode] == 2 * k1.TRUNK_NUMEL + 3 * 2 * k1.HEAD_NUMEL
    trunk = 2 * k1.TRUNK_NUMEL
    assert torch.equal(mixed.w_flat[:trunk], w16.w_flat[:k1.TRUNK_NUMEL].view(torch.uint8))
    heads = [w for w, _ in mixed.layers[k1.FEATURE:]]
    parts = [[k1.split_bf16(w)[p] for w in heads] for p in range(3)]
    assert torch.equal(mixed.w_flat[trunk:], k1.heads_image(parts).view(torch.uint8))
    bias_trunk = sum(n for n, _ in k1.LAYER_SHAPES[:k1.FEATURE])
    assert torch.equal(mixed.b_flat[:bias_trunk], w16.b_flat[:bias_trunk])
    assert torch.equal(mixed.b_flat[bias_trunk:], w32.b_flat[bias_trunk:])
    assert [w.dtype for w, _ in mixed.layers] == [torch.bfloat16] * 8 + [torch.float32] * 4
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(mixed.layers[k1.FEATURE:], w32.layers[k1.FEATURE:]))


def _round_bits(x, drop):
    """x rounded to nearest even, keeping 23 - drop mantissa bits (16: bf16,
    13: TF32), on the bits of the f32 values."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + (1 << (drop - 1)) - 1 + ((u >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    return (u & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _split3(x):
    """Three bf16-valued parts of f32 x, each the rounding of what the parts
    before it leave (the kernel's and the packer's split)."""
    p0 = _round_bits(x, 16)
    rest = (np.asarray(x, np.float32) - p0).astype(np.float32)
    p1 = _round_bits(rest, 16)
    return p0, p1, _round_bits(rest - p1, 16)


@pytest.mark.parametrize("layer", [k1.FEATURE, k1.SIGMA, k1.VIEW, k1.VIEW_OUT])
def test_split_bf16_parts_sum_back_exactly(models, layer):
    """Each head layer's three bf16 parts sum back to its f32 weight exactly
    in f32, equal the parts rounded on the bits, and shrink by 2^8 each; the
    same for f32 values of every magnitude the heads meet."""
    _, mlp = models
    w = k1.pack_layers(mlp, torch.bfloat16, torch.float32)[layer][0]
    rng = np.random.default_rng(layer)
    wide = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(-12, 6, 4096)).astype(np.float32))
    for x in (w, wide):
        parts = k1.split_bf16(x)
        assert all(p.dtype == torch.bfloat16 for p in parts)
        total = (parts[0].float() + parts[1].float()) + parts[2].float()
        assert torch.equal(total, x)
        for p, q in zip(parts, _split3(x.numpy())):
            np.testing.assert_array_equal(p.float().numpy(), q)
        big = x.abs() > 0
        assert (parts[1].float().abs()[big] <= 2.0 ** -8 * x.abs()[big]).all()
        assert (parts[2].float().abs()[big] <= 2.0 ** -16 * x.abs()[big]).all()


def _stream_parts(stream):
    """(W8, W9, W10, W11) of each part from the heads' stream, read by the
    layout the heads kernel's bulk copies and descriptors assume: sigma's
    parts (8 x 256, 4 KB each), then per half of the feature's 256 rows six
    32 KB chunks of W8 (part p, K-columns [128 sp, 128 sp + 128), p and sp
    in order) and three of W10 (part p, the half's feature columns), then
    W10's PE(dir) columns (128 x 32, 64-byte swizzle) and W11 (8 x 128) of
    each part."""
    w8 = torch.empty(3, 256, 256, dtype=stream.dtype)
    w9 = torch.empty(3, 8, 256, dtype=stream.dtype)
    w10 = torch.empty(3, 128, 288, dtype=stream.dtype)
    w11 = torch.empty(3, 8, 128, dtype=stream.dtype)
    at = 0

    def take(rows, cols):
        nonlocal at
        block = _inverse_bf16_image(stream[at:at + rows * cols], rows, cols)
        at += rows * cols
        return block

    for p in range(3):
        w9[p] = take(8, 256)
    for hf in range(2):
        rows = slice(128 * hf, 128 * hf + 128)
        for p in range(3):
            for sp in range(2):
                w8[p, rows, 128 * sp:128 * sp + 128] = take(128, 128)
        for p in range(3):
            w10[p, :, rows] = take(128, 128)
    for p in range(3):
        w10[p, :, 256:] = take(128, 32)
    for p in range(3):
        w11[p] = take(8, 128)
    assert at == stream.numel()
    return w8, w9, w10, w11


@pytest.mark.parametrize("layer", [k1.FEATURE, k1.SIGMA, k1.VIEW, k1.VIEW_OUT])
def test_f32_heads_stream_inverts_to_the_parts(models, layer):
    """Each split slab image of the heads' stream maps back to its bf16 part
    exactly, and the parts to the f32 weight."""
    _, mlp = models
    mixed = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    stream = mixed.w_flat[2 * k1.TRUNK_NUMEL:].view(torch.bfloat16)
    got = _stream_parts(stream)[layer - k1.FEATURE]
    w = mixed.layers[layer][0]
    for p, part in enumerate(k1.split_bf16(w)):
        assert torch.equal(got[p], part)
    assert torch.equal((got[0].float() + got[1].float()) + got[2].float(), w)


def test_stream_bytes_follow_the_pack(models):
    """`k1.stream_bytes`, the L2 bytes chip_smoke prints beside each time,
    from the packs themselves: a tile (the f32 kernel's 64-row block) reads
    its instance's whole pack, bf16_f32h's trunk writes
    h to `h_scratch` and its heads read it back, each secondary view
    replays the view layers (bf16_f32h: its stream's per-view chunk, as
    `_stream_parts` reads it), and the bytes follow the tiles of each scene."""
    _, mlp = models
    w16 = k1.prepare_weights(mlp, torch.bfloat16)
    w32 = k1.prepare_weights(mlp, torch.float32)
    mixed = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    _, _, w10, w11 = _stream_parts(mixed.w_flat[2 * k1.TRUNK_NUMEL:].view(torch.bfloat16))
    h_trip = 2 * k1.h_scratch(128, 1, "cpu").numel() * 2
    view16 = 2 * sum(w16.layers[i][0].numel() for i in (k1.VIEW, k1.VIEW_OUT))
    tile = {"fused_mlp_bf16": (128, w16.w_flat.numel() * 2, view16),
            "fused_mlp_f32": (64, w32.w_flat.numel() * 4, 2 * view16),
            "fused_mlp_bf16_f32h": (128, mixed.w_flat.numel() + h_trip,
                                    3 * 2 * (w10[0, :, k1.WIDTH:].numel() + w11[0].numel()))}
    for name, (rows, pack, view) in tile.items():
        assert k1.stream_bytes(name, rows, 0) == pack, name
        assert k1.stream_bytes(name, rows, 2) == pack + 2 * view, name
        for ns in (0, 3):
            assert k1.stream_bytes(name, 2 * 3 * 128, ns, scenes=2) == 6 * k1.stream_bytes(name, 128, ns), name
            assert k1.stream_bytes(name, rows + 1, ns) == k1.stream_bytes(name, 2 * rows, ns), name
    with pytest.raises(ValueError):
        k1.stream_bytes("fused_mlp", 128, 0)


def test_f32_heads_pack_follows_an_update(models):
    """An optimizer's in-place update repacks the bf16_f32h weights, and the
    new pack is the split of the new weights."""
    _, mlp = models
    first = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    assert k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True) is first
    with torch.no_grad():
        mlp.views_linears[0].weight.mul_(1.5)
    try:
        again = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
        assert again is not first and not torch.equal(again.w_flat, first.w_flat)
        stream = again.w_flat[2 * k1.TRUNK_NUMEL:].view(torch.bfloat16)
        w10 = _stream_parts(stream)[2]
        want = torch.nn.functional.pad(mlp.views_linears[0].weight.detach(), (0, 5))
        assert torch.equal((w10[0].float() + w10[1].float()) + w10[2].float(), want)
    finally:
        with torch.no_grad():
            mlp.views_linears[0].weight.div_(1.5)


def _block_fma(acc, a, b, toward_zero):
    """acc + a b^T as the tensor cores take it, one wgmma k16 step per 16
    columns of a (n, k) and b (m, k): the 16 products of bf16 values exact,
    summed with the accumulator in f64, the sum rounded to f32, to nearest
    even or (`toward_zero`) toward zero."""
    acc = np.asarray(acc, np.float32)
    for k0 in range(0, a.shape[1], 16):
        prod = a[:, None, k0:k0 + 16].astype(np.float64) * b[None, :, k0:k0 + 16].astype(np.float64)
        total = prod.sum(-1) + acc
        acc = total.astype(np.float32)
        if toward_zero:
            acc = np.where(np.abs(acc) > np.abs(total), np.nextafter(acc, np.float32(0)), acc)
    return acc


def _emulate_split_heads(params, h, enc_views, n_sec, toward_zero=True, one_pass_tf32=False, drop=None):
    """The bf16_f32h heads kernel's arithmetic in numpy on h (the trunk's
    output, bf16-valued f32), its k16 steps in the kernel's order
    (`_block_fma`; `toward_zero`: the truncating accumulation that the
    card's error reads as): sigma and the feature as h times each of the
    weight's three bf16 parts, part after part; g = feature W10[:256] from
    the part products i + j <= 2, once per point; per view g plus the six
    PE(dir) products, bias, ReLU, then the six products of the hidden
    layer's and W11's parts. With `one_pass_tf32`, each f32 operand is
    instead rounded once to TF32 (a single pass), which the kernel must not
    do; `drop` ("w8", "w9", "w10", "w11", "f", "pe" or "hv") leaves that
    operand's third part out. Returns the raw (n, 5 + n_sec) outputs:
    sigma, rgb, vis, then each secondary view's vis."""
    def w(name, i=None):
        layer = params[name] if i is None else params[name][i]
        return np.asarray(layer["w"], np.float32).T, np.asarray(layer["b"], np.float32)

    def parts(x, name):
        if one_pass_tf32:
            return [_round_bits(x, 13)]
        p = list(_split3(x))
        return p[:2] if name == drop else p

    def fma(acc, ap, bp):  # acc + the part products i + j <= 2, i (A's part) outer
        for i, ai in enumerate(ap):
            for bj in bp[:3 - i]:
                acc = _block_fma(acc, ai, bj, toward_zero)
        return acc

    w8, b8 = w("feature_linear")
    w9, b9 = w("pts_output_linear")
    w10, b10 = w("views_linears", 0)
    w11, b11 = w("views_output_linear")
    n = h.shape[0]
    sigma, feature = np.zeros((n, 1), np.float32), np.zeros((n, 256), np.float32)
    for p9 in parts(w9, "w9"):
        sigma = _block_fma(sigma, h, p9, toward_zero)
    for p8 in parts(w8, "w8"):
        feature = _block_fma(feature, h, p8, toward_zero)
    cols = [sigma + b9]
    f_parts = parts(feature + b8, "f")
    g = np.zeros((n, 128), np.float32)
    for half in (slice(0, 128), slice(128, 256)):
        for p, w10p in enumerate(parts(w10[:, half], "w10")):  # W10's part outer, 16 columns at a time
            for k0 in range(0, 128, 16):
                ks = slice(k0, k0 + 16)
                g = fma(g, [fp[:, half][:, ks] for fp in f_parts[:3 - p]], [w10p[:, ks]])
    for v in range(1 + n_sec):
        hv = fma(g, parts(enc_views[v], "pe"), parts(w10[:, 256:], "w10"))
        hv_parts, w11_parts = parts(np.maximum(hv + b10, 0), "hv"), parts(w11, "w11")
        out = np.zeros((n, w11.shape[0]), np.float32)
        for k0 in range(0, 128, 16):  # k16 step outer, the six part products inner
            ks = slice(k0, k0 + 16)
            out = fma(out, [hp[:, ks] for hp in hv_parts], [wp[:, ks] for wp in w11_parts])
        out = out + b11
        cols.append(out if v == 0 else out[:, 3:4])
    return np.concatenate(cols, axis=1)


def _jax_raw_heads(params, h, enc_views, n_sec):
    """The raw heads as apply_mlp(bf16_matmuls=True, f32_heads=True) computes
    them on h, with the JAX package's own f32 dense layer, before the
    activations."""
    dense = lambda x, layer: np.asarray(jax_mlp._dense(jnp.asarray(x), layer, False))  # noqa: E731
    feature = dense(h, params["feature_linear"])
    cols = [dense(h, params["pts_output_linear"])]
    for v in range(1 + n_sec):
        hv = np.maximum(dense(np.concatenate([feature, enc_views[v]], axis=1), params["views_linears"][0]), 0)
        out = dense(hv, params["views_output_linear"])
        cols.append(out if v == 0 else out[:, 3:4])
    return np.concatenate(cols, axis=1)


def _jax_trunk_and_views(params, pts, vd, vd2):
    """h as apply_mlp(bf16_matmuls=True, f32_heads=True) computes it (the
    same JAX ops: bf16 dense layers, the skip concat, the f32 upcast) and the
    f32 PE of each view direction."""
    enc = jax_mlp.positional_encoding(jnp.asarray(pts), CFG["points_positional_encoding_degree"])
    h = enc
    for i, layer in enumerate(params["pts_linears"]):
        h = jax.nn.relu(jax_mlp._dense(h, layer, True))
        if i == 4:
            h = jnp.concatenate([enc, h], axis=-1)
    deg = CFG["views_positional_encoding_degree"]
    views = [np.asarray(jax_mlp.positional_encoding(jnp.asarray(vd), deg))]
    if vd2 is not None:
        views += [np.asarray(jax_mlp.positional_encoding(jnp.asarray(vd2[:, j]), deg)) for j in range(vd2.shape[1])]
    return np.asarray(h.astype(jnp.float32)), views


def _rel_errors(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max(), np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _heads_case(params, n, n_sec):
    """(h, the PE of each view, the JAX package's raw f32 heads) of n seeded
    points."""
    pts, vd, vd2 = (None if t is None else t.numpy() for t in inputs(n, n_sec, seed=7))
    h, views = _jax_trunk_and_views(params, pts, vd, vd2)
    return h, views, _jax_raw_heads(params, h, views, n_sec)


@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_split_heads_emulation_matches_jax_f32_heads(models, n_sec):
    """The heads kernel's split arithmetic, emulated on the JAX trunk's h
    with the card's truncating accumulation, against the JAX package's f32
    heads on the same h: raw, as chip_smoke compares the card's, and after
    the activations against `apply_mlp(bf16_matmuls=True, f32_heads=True)`
    itself, within the heads-only tolerances. A one-pass TF32 emulation of
    the same heads misses both by more than 10x (measured 12x and 80x), so
    the card's check tells the two apart."""
    params, _ = models
    pts, vd, vd2 = (None if t is None else t.numpy() for t in inputs(512, n_sec, seed=7))
    h, views, ref_raw = _heads_case(params, 512, n_sec)
    raw = _emulate_split_heads(params, h, views, n_sec)
    rel_max, rel_rms = _rel_errors(raw, ref_raw)
    assert rel_max <= TOL_HEADS_MAX and rel_rms <= TOL_HEADS_RMS, (rel_max, rel_rms)

    ref = apply_mlp(params, CFG, jnp.asarray(pts), jnp.asarray(vd), None if vd2 is None else jnp.asarray(vd2),
                    bf16_matmuls=True, f32_heads=True)
    sig = lambda x: 1 / (1 + np.exp(-x.astype(np.float64)))  # noqa: E731
    got = [np.maximum(raw[:, :1], 0), sig(raw[:, 1:4]), sig(raw[:, 4:5])] + [sig(raw[:, 5:])] * (n_sec > 0)
    want = [np.asarray(ref[k]).reshape(len(pts), -1) for k in ("sigma", "rgb", "visibility", "visibility2")
            if k in ref]
    rel_max, rel_rms = _rel_errors(np.concatenate(got, axis=1), np.concatenate(want, axis=1))
    assert rel_max <= TOL_HEADS_MAX and rel_rms <= TOL_HEADS_RMS, (rel_max, rel_rms)

    tf32_max, tf32_rms = _rel_errors(_emulate_split_heads(params, h, views, n_sec, one_pass_tf32=True), ref_raw)
    assert tf32_max > 10 * TOL_HEADS_MAX and tf32_rms > 10 * TOL_HEADS_RMS, (tf32_max, tf32_rms)


# ||tensor-core heads - plain heads|| / ||plain heads|| on the card (plain f32
# heads on the same h, chip_smoke's `check_heads_against_plain`), over every
# shape chip_smoke checks (n_sec 0-3, ragged, path shapes, S = 2 and 4): H100
# 80GB HBM3 at 700 W
CARD_HEADS_RMS = (8.43e-7, 1.37e-6)


@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_truncating_accumulation_accounts_for_the_card_heads_error(models, n_sec):
    """Why the card's tensor-core heads sit ~1e-6 (RMS) from plain f32 heads,
    some 7x the f32 rounding of a sum: each k16 step's f32 sum truncates
    (rounds toward zero). With that accumulation the emulation lands within
    2x of the card's band (measured 8.8e-7 to 9.5e-7 here); with sums
    rounded to nearest it reads under a quarter of it (1.2e-7 to 1.4e-7)."""
    params, _ = models
    h, views, ref = _heads_case(params, 512, n_sec)
    _, rz = _rel_errors(_emulate_split_heads(params, h, views, n_sec), ref)
    _, rn = _rel_errors(_emulate_split_heads(params, h, views, n_sec, toward_zero=False), ref)
    assert CARD_HEADS_RMS[0] / 2 <= rz <= 2 * CARD_HEADS_RMS[1], rz
    assert rn <= CARD_HEADS_RMS[0] / 4, rn


@pytest.mark.parametrize("drop", ["w8", "w9", "w10", "w11", "f", "pe", "hv"])
def test_a_missing_third_part_hides_in_the_truncation(models, drop):
    """What the heads-only check cannot see: a split that leaves out one
    operand's third part (2^-17 of it) moves the heads by less than 2.5x the
    truncating accumulation's own error and stays within TOL_HEADS_* (worst
    measured: W10's, 1.7e-6 RMS against 8.9e-7 with all parts). The check
    tells an f32-accurate split from a single bf16 or TF32 pass, not a
    three-part split from a two-part one."""
    params, _ = models
    h, views, ref = _heads_case(params, 512, 2)
    _, intact = _rel_errors(_emulate_split_heads(params, h, views, 2), ref)
    rel_max, rel_rms = _rel_errors(_emulate_split_heads(params, h, views, 2, drop=drop), ref)
    assert rel_max <= TOL_HEADS_MAX and rel_rms <= min(TOL_HEADS_RMS, 2.5 * intact), (rel_max, rel_rms, intact)


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
    """K1's launches are the tracer's counters, per instance; CPU tensors
    take the plain version and count none."""
    _, mlp = models
    tracing.reset()
    zero = {"fused_mlp_bf16": 0, "fused_mlp_f32": 0, "fused_mlp_bf16_f32h": 0}
    assert k1.launches() == zero
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(16, 1), torch.float32)
    k1.fused_mlp_raw(k1.prepare_weights(mlp, torch.float32), xe, ve, ve2, ns)
    xe, ve, ve2, ns = k1.encode_inputs(*inputs(16, 1), torch.bfloat16, f32_heads=True)
    k1.fused_mlp_raw(k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True), xe, ve, ve2, ns)
    assert k1.launches() == zero  # CPU tensors launch nothing
    assert tracing.counts("k1.") == {}


def test_prepare_weights_repacks_after_an_update(models):
    _, mlp = models
    first = k1.prepare_weights(mlp, torch.float32)
    assert k1.prepare_weights(mlp, torch.float32) is first
    with torch.no_grad():
        mlp.feature_linear.bias.add_(0.0)
    assert k1.prepare_weights(mlp, torch.float32) is not first
