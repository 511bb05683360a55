"""The shipped mode's heads backward (kernels/fused_mlp.py
`heads_backward`, csrc/fused_mlp_bwd.cu) on the CPU.

- `heads_backward_reference` (the plain version of the two kernels) against
  `jax.vjp` of the JAX package's f32 heads, built from
  `vipnerf_tpu/models/mlp.py` `_dense(..., bf16=False)` as `apply_mlp` runs
  them under `f32_heads`, on the same numpy-seeded h, PE(dir), upstream
  gradient and weights, n_sec 0-3 and S = 1, 2: every weight gradient and
  d PE(dir) within 1e-5 of the tensor's largest entry and of its norm (both
  sides f32, summed in other orders; measured at most 1.1e-6), d h (bf16,
  rounded where autograd rounds it) within one bf16 step.
- The same against autograd through the f32 heads of `raw_recompute`
  (`heads_backward_recompute`, the kernels' yardstick on the card): the same
  function, so within 1e-5 likewise.
- `FusedRaw`'s backward in the shipped mode runs `heads_backward_reference`
  on CPU tensors, once per call, and nothing of it in the other modes.
- A numpy emulation of the kernels' arithmetic (`_emulate_points`,
  `_emulate_weights`: bf16 parts, exact products, each mma's sum rounded to
  f32 toward zero as the card's tensor cores do, the per-point kernel's
  fresh accumulator per k16 step, the weight kernel's promotion every
  `PROMOTE` k16 steps into a Kahan sum and its f64 reduction over splits of
  `KSPLIT` points) held to the JAX gradients within chip_smoke's card
  tolerances (`TOL_BWD_*`), and the same emulation with one operand's third
  part dropped, or rounded once to TF32 or bf16, missing them by more than
  10x. Over 786,432 points (a training step's fine launch), the weight
  kernel's emulation without promotion misses them: the witness for the
  interval.
- The exact-sum cases of chip_smoke (`exact_heads_case`): every sum of the
  function is exact in f32, so the plain version in f32 equals itself in f64
  bit for bit, and so does the emulation; with one third part dropped, the
  emulation misses by about 2^-17.
- The shipped mode's training at the flagship width is chaotic: the two
  routes from before the kernels part past chip_smoke's trajectory band
  within 100 CPU steps, with no kernel anywhere.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vipnerf_tpu.models import mlp as jax_mlp
from vipnerf_tpu.models.mlp import init_mlp_params
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.utils.convert import state_dict_from_jax_params

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402

CFG = {
    "num_samples": 0, "netdepth": 8, "netwidth": 256,
    "points_positional_encoding_degree": 10, "views_positional_encoding_degree": 4,
    "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
}
HEADS = ("feature_linear", "pts_output_linear", "views_linears", "views_output_linear")
GRAD_NAMES = ("W8", "b8", "W9", "b9", "W10", "b10", "W11", "b11")
TOL_REF = 1e-5  # two f32 computations of one function


@pytest.fixture(scope="module")
def jax_params():
    return [init_mlp_params(jax.random.PRNGKey(s), CFG) for s in (0, 1)]


def torch_heads(params):
    """The heads' parameters in `module_params` order (W8, b8, W9, b9, W10,
    b10, W11, b11), f32 torch, from one JAX parameter tree."""
    mlp = NeRFMLP(CFG)
    mlp.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return [p.detach() for p in k1.module_params(mlp)[2 * k1.FEATURE:]]


def heads_case(n, n_sec, seed=0):
    """n points: h bf16-valued (the trunk's ReLU output: half zeros), f32
    PE(dir) of each view as K1 pads it (27 + 5 zeros), the upstream
    gradient g (n, 8) (zero past column 5 + n_sec, as K1's output is)."""
    rng = np.random.default_rng(seed)
    h = np.maximum(rng.normal(0, 1, (n, 256)), 0)
    h = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16)
    views = [np.pad(rng.uniform(-1, 1, (n, 27)), ((0, 0), (0, 5))).astype(np.float32) for _ in range(1 + n_sec)]
    g = np.zeros((n, 8), np.float32)
    g[:, :5 + n_sec] = rng.normal(0, 1, (n, 5 + n_sec))
    ve = torch.from_numpy(views[0])
    ve2 = torch.from_numpy(np.concatenate(views[1:], 1)) if n_sec else ve
    return h, ve, ve2, torch.from_numpy(g), views


def jax_heads_vjp(params, h, views, g, n_sec):
    """jax.vjp of the JAX package's f32 heads (`_dense(..., False)` as
    `apply_mlp` runs them with f32_heads) at h (f32) and the views' PE:
    (d h, {layer: {w, b}}, [d pe_v])."""
    def heads(p, x, enc):
        feature = jax_mlp._dense(x, p["feature_linear"], False)
        cols = [jax_mlp._dense(x, p["pts_output_linear"], False)]
        for v, e in enumerate(enc):
            hv = jax.nn.relu(jax_mlp._dense(jnp.concatenate([feature, e], -1), p["views_linears"][0], False))
            out = jax_mlp._dense(hv, p["views_output_linear"], False)
            cols.append(out if v == 0 else out[:, 3:4])
        return jnp.concatenate(cols, -1)

    p = {k: params[k] for k in HEADS}
    enc = [jnp.asarray(v[:, :27]) for v in views]
    _, vjp = jax.vjp(heads, p, jnp.asarray(h), enc)
    dp, dh, denc = vjp(jnp.asarray(g[:, :5 + n_sec]))
    return np.asarray(dh), dp, [np.pad(np.asarray(d), ((0, 0), (0, 5))) for d in denc]


def jax_grads_torch_order(dp):
    """The JAX heads' gradients as torch tensors in `module_params` order."""
    lin = lambda layer: [np.asarray(layer["w"]).T, np.asarray(layer["b"])]  # noqa: E731
    out = lin(dp["feature_linear"]) + lin(dp["pts_output_linear"]) + lin(dp["views_linears"][0]) \
        + lin(dp["views_output_linear"])
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in out]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale_max, scale_rms = np.abs(want).max(), np.linalg.norm(want)
    return (np.abs(got - want).max() / max(scale_max, 1e-30), np.linalg.norm(got - want) / max(scale_rms, 1e-30))


def scene_case(jax_params, scenes, n, n_sec):
    """Per scene its own weights and points: the stacked heads' parameters,
    the inputs of all S blocks, and the JAX vjp of each block."""
    blocks = [heads_case(n, n_sec, seed=10 * s + n_sec) for s in range(scenes)]
    params = [torch_heads(jax_params[s]) for s in range(scenes)]
    stacked = params[0] if scenes == 1 else [torch.stack(t) for t in zip(*params)]
    cat = lambda i: torch.cat([b[i] for b in blocks])  # noqa: E731
    want = [jax_heads_vjp(jax_params[s], blocks[s][0].float().numpy(), blocks[s][4], blocks[s][3].numpy(), n_sec)
            for s in range(scenes)]
    return stacked, (cat(0), cat(1), cat(2), cat(3)), want


@pytest.mark.parametrize("scenes", [1, 2])
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_reference_matches_jax_vjp(jax_params, scenes, n_sec):
    params, (h, ve, ve2, g), want = scene_case(jax_params, scenes, 96, n_sec)
    d_h, grads, d_ve, d_ve2 = k1.heads_backward_reference(params, h, ve, ve2, g, n_sec)
    assert d_h.dtype == torch.bfloat16 and (d_ve2 is None) == (n_sec == 0)
    for s, (dh_j, dp_j, dpe_j) in enumerate(want):
        rows = slice(96 * s, 96 * (s + 1))
        one = (lambda t: t) if scenes == 1 else (lambda t: t[s])  # noqa: E731
        for name, got, w in zip(GRAD_NAMES, grads, jax_grads_torch_order(dp_j)):
            assert tuple(one(got).shape) == tuple(w.shape), name
            assert max(rel(one(got), w)) <= TOL_REF, (name, rel(one(got), w))
        # d h: bf16 of the f32 gradient, one bf16 step of its value at most
        # (and the f32 sums' difference, for an entry that cancels)
        step = np.abs(dh_j) * 2.0 ** -8 + TOL_REF * np.abs(dh_j).max()
        assert (np.abs(d_h[rows].float().numpy() - dh_j) <= step).all()
        assert max(rel(d_ve[rows], dpe_j[0])) <= TOL_REF
        if n_sec:
            assert max(rel(d_ve2[rows], np.concatenate(dpe_j[1:], 1))) <= TOL_REF


@pytest.mark.parametrize("n_sec", [0, 3])
def test_reference_is_the_recompute_gradient(jax_params, n_sec):
    """The plain version against autograd through `raw_recompute`'s f32
    heads (the yardstick), S = 2: the same function."""
    params, (h, ve, ve2, g), _ = scene_case(jax_params, 2, 64, n_sec)
    ref = k1.heads_backward_reference(params, h, ve, ve2, g, n_sec)
    yard = k1.heads_backward_recompute(params, h, ve, ve2, g, n_sec)
    for name, a, b in zip(GRAD_NAMES, ref[1], yard[1]):
        assert a.shape == b.shape and max(rel(a, b)) <= TOL_REF, name
    assert (ref[0].float() - yard[0].float()).abs().max() <= 2.0 ** -8 * yard[0].float().abs().max()
    assert max(rel(ref[2], yard[2])) <= TOL_REF
    assert (ref[3] is None) == (yard[3] is None) == (n_sec == 0)
    if n_sec:
        assert max(rel(ref[3], yard[3])) <= TOL_REF


@pytest.mark.parametrize("scenes", [1, 2])
def test_fused_raw_runs_the_plain_heads_backward_on_the_cpu(monkeypatch, scenes):
    """FusedRaw's backward in the shipped mode reaches the heads backward
    once per call, through `heads_backward_reference` on CPU tensors, and
    gives the old route's gradients (autograd through `raw_recompute`),
    for one MLP and for a stacked one (40 points per scene): the heads' and
    PE(dir)'s within `TOL_REF`, xe's and the trunk's exactly those of
    autograd through the trunk's recompute from the plain version's d h;
    the bf16 and f32 instances never reach it."""
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(3), scenes=scenes if scenes > 1 else None)
    calls = []
    plain = k1.heads_backward_reference

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(k1, "heads_backward_reference", counted)
    rng = np.random.default_rng(4)
    n = 80
    pts = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    vd2 = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(n, 2, 3)).astype(np.float32)), dim=-1)
    for dtype, f32_heads in ((torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, False)):
        calls.clear()
        xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
        inputs = [t.clone().requires_grad_() for t in (xe, ve, ve2)]
        params = k1.module_params(mlp)
        upstream = torch.from_numpy(rng.normal(size=(n, k1.NOUT)).astype(np.float32)).to(ve.dtype)
        out = k1.FusedRaw.apply(k1.prepare_weights(mlp, dtype, f32_heads), ns, *inputs, *params)
        got = torch.autograd.grad(out, inputs + params, upstream)
        assert len(calls) == int(f32_heads)
        ref_in = [t.clone().requires_grad_() for t in (xe, ve, ve2)]
        want = torch.autograd.grad(k1.raw_recompute(params, *ref_in, ns), ref_in + params, upstream)
        trunk = 3 + 2 * k1.FEATURE  # xe, ve, ve2, then the trunk's parameters
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            if not f32_heads:
                assert torch.equal(a, b), i
            elif 0 < i < 3 or i >= trunk:
                assert max(rel(a, b)) <= TOL_REF, i
        if f32_heads:  # xe and the trunk: the plain version's d h through the trunk's recompute
            trunk_in = [t.detach().requires_grad_() for t in [xe] + params[:trunk - 3]]
            h = k1.trunk_recompute(trunk_in[1:], trunk_in[0])
            d_h = plain([p.detach() for p in params[trunk - 3:]], h.detach().reshape(n, -1), ve, ve2,
                        upstream.float(), ns)[0]
            for a, b in zip([got[0], *got[3:trunk]], torch.autograd.grad(h, trunk_in, d_h.reshape(h.shape))):
                assert torch.equal(a, b)


# ------------------------------------------------- the kernels' arithmetic

def _bits_round(x, keep):
    """f32 -> nearest even with `keep` explicit mantissa bits, on the bits."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    drop = 23 - keep
    half, lsb = np.uint64(1 << (drop - 1)), (bits >> np.uint64(drop)) & np.uint64(1)
    bits = ((bits + half - np.uint64(1) + lsb) >> np.uint64(drop)) << np.uint64(drop)
    return bits.astype(np.uint32).view(np.float32)


def split3(x):
    """`k1.split_bf16` in numpy: three bf16-valued f32 parts summing to x."""
    x = np.asarray(x, np.float32)
    p0 = _bits_round(x, 7)
    r = (x - p0).astype(np.float32)
    p1 = _bits_round(r, 7)
    return [p0, p1, _bits_round((r - p1).astype(np.float32), 7)]


def parts(x, mode=None):
    """The parts the kernels multiply: split3; `mode` "drop" leaves the
    third out, "tf32"/"bf16" round once instead (one pass)."""
    if mode == "tf32":
        return [_bits_round(x, 10)]
    if mode == "bf16":
        return [_bits_round(x, 7)]
    p = split3(x)
    return p[:2] if mode == "drop" else p


def rz(total):
    """f64 -> f32 toward zero: the tensor cores' rounding of a sum."""
    out = total.astype(np.float32)
    return np.where(np.abs(out) > np.abs(total), np.nextafter(out, np.float32(0)), out).astype(np.float32)


def pairs(na, nb):
    """The kernels' order of part products a_i b_j, i + j <= 2 (all of them
    for one-pass operands), smallest first."""
    return sorted(((i, j) for i in range(na) for j in range(nb) if i + j <= 2), key=lambda p: (-(p[0] + p[1]), -p[0]))


def _mma_chain(acc, ap, bp, k0):
    """acc after the part products of the k16 step at k0 of a (n, K) and
    b (m, K), each mma's sum rounded toward zero."""
    for i, j in pairs(len(ap), len(bp)):
        prod = ap[i][:, k0:k0 + 16].astype(np.float64) @ bp[j][:, k0:k0 + 16].astype(np.float64).T
        acc = rz(prod + acc)
    return acc


def point_product(a, b, total=None, mode_a=None, mode_b=None, a_exact=False):
    """The per-point kernel's a b^T (a (n, K), b (m, K)): per k16 step the
    part products into a fresh accumulator, then added to the f32 total."""
    ap = [np.asarray(a, np.float32)] if a_exact else parts(a, mode_a)
    bp = parts(b, mode_b)
    total = np.zeros((a.shape[0], b.shape[0]), np.float32) if total is None else total
    for k0 in range(0, a.shape[1], 16):
        total = (total + _mma_chain(np.zeros_like(total, np.float64), ap, bp, k0)).astype(np.float32)
    return total


def _emulate_points(params, h, ve, ve2, g, n_sec, drop=None) -> k1.HeadsIntermediates:
    """The per-point kernel in numpy, its outputs as torch tensors. `drop`
    names the operand whose third part is left out, or "tf32"/"bf16" for
    one pass everywhere."""
    w8, b8, w9, _, w10, b10, w11, _ = (np.asarray(p, np.float32) for p in params)
    one = drop if drop in ("tf32", "bf16") else None
    m = lambda name: "drop" if drop == name else one  # noqa: E731
    h, g = h.float().numpy(), g.numpy()
    views = [ve.numpy()] + [ve2[:, 32 * j:32 * j + 32].numpy() for j in range(n_sec)]
    w10 = np.pad(w10, ((0, 0), (0, 5)))
    feature = (point_product(h, w8, mode_b=m("w8"), a_exact=True) + b8).astype(np.float32)
    G = point_product(feature, w10[:, :256], mode_a=m("feature"), mode_b=m("w10"))
    D = np.zeros((h.shape[0], 128), np.float32)
    hvs, dhvs, dpes = [], [], []
    for v, pe in enumerate(views):
        pre = (point_product(pe, w10[:, 256:], total=G.copy(), mode_a=m("pe"), mode_b=m("w10")) + b10).astype(np.float32)
        d_o = g[:, 1:5] if v == 0 else np.pad(g[:, 4 + v:5 + v], ((0, 0), (3, 0)))
        dh = (d_o[:, :1] * w11[0]).astype(np.float32)
        for j in (1, 2, 3):
            dh = (d_o[:, j:j + 1].astype(np.float64) * w11[j] + dh).astype(np.float32)
        dhv = np.where(pre > 0, dh, 0).astype(np.float32)
        D = (D + dhv).astype(np.float32)
        hvs.append(np.maximum(pre, 0))
        dhvs.append(dhv)
        dpes.append(point_product(dhv, w10[:, 256:].T, mode_a=m("dhv"), mode_b=m("w10")))
    d_feature = point_product(D, w10[:, :256].T, mode_a=m("D"), mode_b=m("w10"))
    d_h = point_product(d_feature, w8.T, mode_a=m("dfeature"), mode_b=m("w8"))
    d_h = (d_h + (g[:, :1] * w9[0]).astype(np.float32)).astype(np.float32)
    t = torch.from_numpy
    return k1.HeadsIntermediates(
        t(d_h).to(torch.bfloat16), t(feature), t(d_feature), t(D), t(np.stack(hvs, 1)), t(np.stack(dhvs, 1)),
        t(dpes[0]), t(np.concatenate(dpes[1:], 1)) if n_sec else None)


def _emulate_weights(x, y, y_exact=False, promote=k1.BWD_PROMOTE, ksplit=k1.BWD_KSPLIT, mode_x=None, mode_y=None):
    """The weight kernel's x^T y over the rows (x (K, M), y (K, N)): splits
    of `ksplit` rows; in each, two accumulators (the (0, 0) part products,
    the others) run `promote` k16 steps (each mma rounded toward zero),
    then their sum joins a Kahan f32 sum; the splits' sums (s - c) add in
    f64. promote=None: the accumulators run the whole split. Returns f32
    (M, N)."""
    k = x.shape[0]
    xp = parts(x, mode_x)
    yp = [np.asarray(y, np.float32)] if y_exact else parts(y, mode_y)
    splits = -(-k // ksplit)
    pad = lambda t: np.pad(t, ((0, splits * ksplit - k), (0, 0))).reshape(splits, ksplit, -1)  # noqa: E731
    xp, yp = [pad(t) for t in xp], [pad(t) for t in yp]
    steps = ksplit // 16
    block = promote or steps
    m, n = x.shape[1], y.shape[1]
    s = np.zeros((splits, m, n), np.float32)
    c = np.zeros_like(s)
    for b0 in range(0, steps, block):
        acc = {True: np.zeros((splits, m, n), np.float64), False: np.zeros((splits, m, n), np.float64)}
        for st in range(b0, min(b0 + block, steps)):
            rows = slice(16 * st, 16 * st + 16)
            for i, j in pairs(len(xp), len(yp)):
                big = (i, j) == (0, 0)
                acc[big] = rz(np.einsum("skm,skn->smn", xp[i][:, rows].astype(np.float64),
                                        yp[j][:, rows].astype(np.float64)) + acc[big])
        yk = ((acc[True].astype(np.float32) + acc[False].astype(np.float32)).astype(np.float32) - c).astype(np.float32)
        t = (s + yk).astype(np.float32)
        c = ((t - s).astype(np.float32) - yk).astype(np.float32)
        s = t
    return (s.astype(np.float64) - c.astype(np.float64)).sum(0).astype(np.float32)


def _emulate_weight_grads(mid: k1.HeadsIntermediates, h, ve, ve2, g, drop=None):
    """The weight-gradient kernel in numpy on the per-point kernel's inputs
    and outputs: the 8 gradients as torch tensors, module shapes (one
    scene). PE(dir) and d o of each (point, view) row are read from ve, ve2
    and g, as the kernel reads them."""
    one = drop if drop in ("tf32", "bf16") else None
    m = lambda name: "drop" if drop == name else one  # noqa: E731
    flat = lambda t: t.reshape(-1, t.shape[-1]).numpy()  # noqa: E731  the (point, view) rows, as the kernel reads them
    colsum = lambda t: t.astype(np.float64).sum(0).astype(np.float32)  # noqa: E731  exact column sums
    pe, d_o = (t.numpy() for t in k1._view_rows(ve, ve2, g, mid.hv.shape[1] - 1))
    h, g = h.float().numpy(), g.numpy()
    feature, d_feature, D = mid.feature.numpy(), mid.d_feature.numpy(), mid.D.numpy()
    grads = [_emulate_weights(d_feature, h, y_exact=True, mode_x=m("dfeature")), colsum(d_feature),
             _emulate_weights(g[:, :1], h, y_exact=True), colsum(g[:, :1]),
             np.concatenate([_emulate_weights(D, feature, mode_x=m("D"), mode_y=m("feature")),
                             _emulate_weights(flat(mid.d_hv), pe, mode_x=m("dhv"), mode_y=m("pe"))], 1),
             colsum(D), _emulate_weights(d_o, flat(mid.hv), mode_x=m("do"), mode_y=m("hv")), colsum(d_o)]
    return [torch.from_numpy(t) for t in grads]


def emulate_heads_backward(params, h, ve, ve2, g, n_sec, drop=None):
    """Both kernels in numpy: (d h, the 8 gradients, d ve, d ve2) and the
    per-point outputs."""
    mid = _emulate_points(params, h, ve, ve2, g, n_sec, drop)
    return (mid.d_h, _emulate_weight_grads(mid, h, ve, ve2, g, drop), mid.d_ve, mid.d_ve2), mid


def _jax_want(jax_params, h, views, g, n_sec):
    """The JAX package's f32 gradients as (d h f32, the 8 gradients, d ve,
    d ve2), torch."""
    dh, dp, dpe = jax_heads_vjp(jax_params, h.float().numpy(), views, g.numpy(), n_sec)
    return (torch.from_numpy(dh), jax_grads_torch_order(dp), torch.from_numpy(dpe[0]),
            torch.from_numpy(np.concatenate(dpe[1:], 1)) if n_sec else None)


def _f64(params):
    return [p.double() for p in params]


# a dropped third part, and where chip_smoke's per-kernel limits see it over
# 10x: the per-point kernel's (field) or the weight kernel's (gradient piece)
DROPS = {"w8": ("points", "feature"), "w10": ("points", "d_feature"), "D": ("points", "d_feature"),
         "dhv": ("points", "d_ve"), "feature": ("weights", "W10f"), "pe": ("weights", "W10p"),
         "dfeature": ("weights", "W8"), "hv": ("weights", "W11"), "do": ("weights", "W11")}


@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
def test_kernel_emulation_matches_jax_within_the_card_tolerances(jax_params, n_sec):
    """The two kernels' arithmetic, emulated, on inputs without ReLU ties
    (`untie_relu`): end to end against the JAX package's f32 gradients
    within `TOL_BWD_MAX`/`TOL_BWD_RMS`/`TOL_BWD_DH_FRAC`; each kernel alone
    against its plain version in f64 on the same inputs within
    `TOL_BWD_POINTS_*` and `TOL_BWD_WEIGHTS_*`. At n_sec 2, one pass of TF32
    or bf16 reads more than 10x over every limit; a dropped third part of
    each operand over 10x the per-kernel limit that `DROPS` names, and
    above the emulation's own error end to end."""
    h, ve, ve2, g, views = heads_case(512, n_sec, seed=20 + n_sec)
    params = torch_heads(jax_params[0])
    g = cs.untie_relu(k1, params, h, ve, ve2, g, n_sec)
    want = _jax_want(jax_params[0], h, views, g, n_sec)
    want_points = k1.heads_points_reference(_f64(params), h, ve.double(), ve2.double(), g.double(), n_sec)

    def errors(drop=None):
        got, mid = emulate_heads_backward(params, h, ve, ve2, g, n_sec, drop)
        mid64 = k1.HeadsIntermediates(*(None if t is None else t.double() if t.dtype == torch.float32 else t
                                        for t in mid))
        weights = cs.weights_errors(got[1], k1.heads_weights_reference(mid64, h, ve, ve2, g))
        return cs.bwd_errors(got, want), cs.points_errors(mid, want_points), weights

    e2e, points, weights = errors()
    print(f"n_sec {n_sec}: end to end {e2e}, per-point kernel {points}, weight kernel {weights}")
    assert e2e["max"] <= cs.TOL_BWD_MAX and e2e["rms"] <= cs.TOL_BWD_RMS and e2e["dh_off"] <= cs.TOL_BWD_DH_FRAC
    assert cs.points_ok(points) and cs.weights_ok(weights)
    if n_sec != 2:
        return
    for drop in ("tf32", "bf16"):
        m_e2e, m_points, m_weights = errors(drop)
        print(f"  one pass of {drop}: end to end {m_e2e}")
        assert min(m_e2e["max"] / cs.TOL_BWD_MAX, m_e2e["rms"] / cs.TOL_BWD_RMS) > 10, drop
        assert m_e2e["dh_off"] > 10 * cs.TOL_BWD_DH_FRAC, drop
        assert all(m_points[f][1] > 10 * cs.TOL_BWD_POINTS_RMS[f] for f in ("feature", "d_feature", "hv")), drop
        assert all(m_weights[w][1] > 10 * cs.TOL_BWD_WEIGHTS_RMS for w in ("W8", "W10f", "W10p", "W11")), drop
    for drop, (kernel, piece) in DROPS.items():
        m_e2e, m_points, m_weights = errors(drop)
        seen = m_points[piece][1] / cs.TOL_BWD_POINTS_RMS[piece] if kernel == "points" \
            else m_weights[piece][1] / cs.TOL_BWD_WEIGHTS_RMS
        in_points = max(m_points[f][1] / cs.TOL_BWD_POINTS_RMS[f] for f in m_points if f != "dh_off")
        in_weights = max(e[1] for e in m_weights.values()) / cs.TOL_BWD_WEIGHTS_RMS
        print(f"  {drop}'s third part dropped: end to end {m_e2e}; {kernel} {piece} {seen:.1f}x its limit; "
              f"worst per-point field {in_points:.1f}x, d h {m_points['dh_off'] / cs.TOL_BWD_DH_FRAC:.1f}x, "
              f"worst gradient {in_weights:.1f}x")
        assert m_e2e["rms"] > 2 * e2e["rms"] and seen > 10, drop


def test_promotion_interval_over_a_training_launch():
    """A weight gradient over 786,432 points (a training step's fine launch),
    d feature-like f32 against h-like bf16 columns: the weight kernel's
    arithmetic with promotion every `BWD_PROMOTE` k16 steps within
    `TOL_BWD_WEIGHTS_*` of the f64 product; one accumulator per split of
    `BWD_KSPLIT` points instead (no promotion) misses them by 10x."""
    rng = np.random.default_rng(5)
    k = 786432
    x = (rng.normal(0, 1, (k, 2)) * rng.uniform(0.5, 1.5, (k, 1))).astype(np.float32)
    y = torch.from_numpy(np.maximum(rng.normal(0.3, 1, (k, 4)), 0).astype(np.float32)).bfloat16().float().numpy()
    exact = torch.from_numpy(x.astype(np.float64).T @ y.astype(np.float64))
    promoted = cs.rel_pair(torch.from_numpy(_emulate_weights(x, y, y_exact=True)), exact)
    unpromoted = cs.rel_pair(torch.from_numpy(_emulate_weights(x, y, y_exact=True, promote=None)), exact)
    print(f"promotion every {k1.BWD_PROMOTE} k16 steps: {promoted}; none: {unpromoted}")
    assert promoted[0] <= cs.TOL_BWD_WEIGHTS_MAX and promoted[1] <= cs.TOL_BWD_WEIGHTS_RMS
    assert unpromoted[1] > 10 * cs.TOL_BWD_WEIGHTS_RMS


def test_kernel_constants_match_the_source():
    """The reduction constants the emulation and chip_smoke use are the
    CUDA source's."""
    src = (Path(k1.__file__).resolve().parent.parent / "csrc/fused_mlp_bwd.cu").read_text()
    assert f"constexpr int PROMOTE = {k1.BWD_PROMOTE};" in src
    assert f"constexpr int KSPLIT = {k1.BWD_KSPLIT};" in src
    assert f"IMG_ELEMS == {k1.BWD_IMG_NUMEL}" in src and f"SMALL_ELEMS == {k1.BWD_SMALL_NUMEL}" in src
    assert cs.BWD == k1.BWD_KERNELS


@pytest.mark.parametrize("case", ["dense", "witness"])
def test_exact_sum_cases(case):
    """chip_smoke's exact-sum inputs: the plain version in f32 equals itself
    in f64 (every sum exact), the emulation equals it bit for bit, and, in
    the witness case, the emulation with the feature's or W8's third part
    dropped misses dW10's feature columns by about 2^-17 of their largest
    entry."""
    params, h, ve, ve2, g, n_sec = cs.exact_heads_case(case, n=200, scenes=1)
    ref = k1.heads_backward_reference(params, h, ve, ve2, g, n_sec)
    f64 = k1.heads_backward_reference(_f64(params), h, ve.double(), ve2.double(), g.double(), n_sec)
    for a, b in zip(ref[1] + [ref[2], ref[3]], f64[1] + [f64[2], f64[3]]):
        assert torch.equal(a.double(), b)
    assert torch.equal(ref[0], f64[0])
    got, _ = emulate_heads_backward(params, h, ve, ve2, g, n_sec)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[1] + [got[2], got[3]], ref[1] + [ref[2], ref[3]]):
        assert torch.equal(a, b)
    if case == "witness":
        for drop in ("feature", "w8"):
            w10 = emulate_heads_backward(params, h, ve, ve2, g, n_sec, drop)[0][1][4]
            miss = cs.rel_pair(w10[:, :256], ref[1][4][:, :256])[0]
            print(f"dropping {drop}'s third part: dW10's feature columns off by {miss:.3g} of their largest entry")
            assert 2.0 ** -20 < miss < 2.0 ** -14


def test_backward_image_is_the_split_weights_and_follows_every_optimizer_step():
    """The heads backward's weight image (`heads_bwd_pack`, in the
    bf16_f32h pack cache): each matrix of `BWD_MATS` as three bf16 parts
    that sum to it exactly (W8, W10's feature and PE(dir) columns, their
    transposes), the f32 biases and small layers beside; after an optimizer
    step the cache holds the image of the new weights."""
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(5))
    opt = torch.optim.Adam(mlp.parameters(), lr=1e-2)
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.uniform(-1, 1, (64, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32)), dim=-1)
    for _ in range(2):
        opt.zero_grad()
        out = k1.apply_fused_mlp(mlp, pts, vd, dtype=torch.bfloat16, f32_heads=True)
        sum(v.square().sum() for v in out.values()).backward()
        opt.step()
        image, small = k1.prepare_weights(mlp, torch.bfloat16, True).heads_bwd
        w8, w10 = mlp.feature_linear.weight.detach(), torch.nn.functional.pad(mlp.views_linears[0].weight.detach(),
                                                                            (0, 5))
        mats = [w8, w10[:, :256], w10[:, 256:], w10[:, :256].t(), w8.t(), w10[:, 256:].t()]
        at = 0
        for (name, rows, cols), want in zip(k1.BWD_MATS, mats):
            parts = image[at:at + 3 * rows * cols].reshape(3, rows, cols).float()
            assert torch.equal((parts[0] + parts[1]) + parts[2], want), name
            at += 3 * rows * cols
        assert at == image.numel() == k1.BWD_IMG_NUMEL
        want_small = torch.cat([mlp.feature_linear.bias, mlp.views_linears[0].bias, mlp.pts_output_linear.weight[0],
                                mlp.views_output_linear.weight.reshape(-1)]).detach()
        assert torch.equal(small, want_small)


def test_trajectory_bands_are_the_protocol_tests():
    """chip_smoke's trajectory bands are tests/test_torch_protocol.py's
    (the shipped mode's first-step band)."""
    import ast

    tree = ast.parse((Path(__file__).resolve().parent / "test_torch_protocol.py").read_text())
    values = {node.targets[0].id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "").startswith("TRAJ_TOL")}
    assert values["TRAJ_TOL_FIRST"]["shipped"] == cs.TRAJ_TOL_FIRST
    assert values["TRAJ_TOL_STEP"] == cs.TRAJ_TOL_STEP and values["TRAJ_TOL_PARAMS"] == cs.TRAJ_TOL_PARAMS


def test_flagship_training_is_chaotic_without_any_kernel(tmp_path):
    """chip_smoke's trajectory on the CPU (`run_trajectories`, the flagship
    width, 128 + 128 rays, 8 + 8 samples, a 48x64 synthetic scene) along
    the two routes from before the backward kernels: K1's plain forward
    with the yardstick backward (autograd through raw_recompute's f32
    heads), and the module MLP. No kernel runs. The two agree at the first
    step within `TRAJ_TOL_FIRST` and the second within 1e-4, then part:
    within 100 steps their loss terms leave `TRAJ_TOL_STEP`. f32 rounding
    alone moves the shipped mode's training past the band, which is why
    chip_smoke holds K1's trajectory to it over `TRAJ_BAND_STEPS` steps."""
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs

    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=5,
                             train_frames=(0, 2, 4), val_frames=(1,), height=48, width=64)
    configs = flagship_training_configs(tmp_path, cs.TRAJ_STEPS)
    configs["data_loader"]["num_rays"] = 128
    configs["data_loader"]["sparse_depth"]["num_rays"] = 128
    for level in ("coarse_mlp", "fine_mlp"):
        configs["model"][level]["num_samples"] = 8
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rig = cs.TrainRig(tmp_path, configs, torch.device("cpu"))
        paths = ("K1, yardstick backward", "module MLP")
        start, runs = cs.run_trajectories(k1, rig, paths)
    finally:
        torch.set_num_threads(threads)
    (old, end_old, _), (mod, end_mod, _) = (runs[p] for p in paths)
    c = cs.trajectory_compare(old, end_old, mod, end_mod, start)
    rel = np.abs(old - mod) / np.abs(mod)
    print(f"the two routes from before the kernels, on the CPU: {c}")
    assert np.isfinite(old).all() and np.isfinite(mod).all()
    assert c["first"] <= cs.TRAJ_TOL_FIRST and rel[1].max() <= 1e-4
    assert c["first_over_tol_step"] is not None and c["later"] > cs.TRAJ_TOL_STEP
