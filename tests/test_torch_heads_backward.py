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
  `_emulate_weights`: bf16 parts, exact products, each wgmma's sum rounded
  to f32 toward zero as the card's tensor cores do, the per-point kernel's
  fresh accumulator per `BWD_CHAIN` k16 steps, the weight kernel's chains
  of `BWD_PROMOTE` k16 steps with their part products ordered by size, the
  Fast2Sum that moves each into the total and leaves the error in the
  accumulator, its f64 shares of `BWD_KSPLIT` points; dW9 and dW11 exact
  in f64) held to the JAX
  gradients within chip_smoke's card tolerances (`TOL_BWD_*`), and the same
  emulation with one operand's third part dropped, or rounded once to TF32
  or bf16, missing them by more than 10x. Over 786,432 points (a training
  step's fine launch), the weight kernel's emulation without promotion
  misses them by more than 10x, and the per-point kernel's with one chain
  over all of K misses the feature's and d feature's limits: the witnesses
  for the interval and the chain length.
- The host-side layout arithmetic of the redesigned kernels: the weight
  stream (`heads_bwd_stream`) inverts to the split weights, the MN-major
  slabs' offsets follow their descriptors' strides, the weight kernel's
  grid covers every point once at ragged sizes and S = 2, and the L2 bytes
  by design follow the stream and the tiles.
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


def point_product(a, b, total=None, mode_a=None, mode_b=None, a_exact=False, chain=k1.BWD_CHAIN):
    """The per-point kernel's a b^T (a (n, K), b (m, K)): per `chain` k16
    steps the part products (each step's smallest first) into a fresh
    accumulator, then added to the f32 total."""
    ap = [np.asarray(a, np.float32)] if a_exact else parts(a, mode_a)
    bp = parts(b, mode_b)
    total = np.zeros((a.shape[0], b.shape[0]), np.float32) if total is None else total
    for c0 in range(0, a.shape[1], 16 * chain):
        acc = np.zeros_like(total, np.float64)
        for k0 in range(c0, min(c0 + 16 * chain, a.shape[1]), 16):
            acc = _mma_chain(acc, ap, bp, k0)
        total = (total + acc).astype(np.float32)
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


def _fast_two_sum(s, x):
    """f32 Fast2Sum, as the kernel promotes: (s + x rounded, x - (that - s))."""
    t = (s + x).astype(np.float32)
    return t, (x - (t - s).astype(np.float32)).astype(np.float32)


def _emulate_weights(x, y, y_exact=False, promote=k1.BWD_PROMOTE, ksplit=k1.BWD_KSPLIT, mode_x=None, mode_y=None,
                     f64=False):
    """The weight kernel's x^T y over the rows (x (K, M), y (K, N)): shares
    of `ksplit` rows; in each, blocks of `promote` k16 steps, each block's
    part products (each wgmma's sum rounded toward zero) by size (every i +
    j = 2 product of its steps, then 1, then the (0, 0) ones) into the
    accumulator, which a Fast2Sum then moves into the f32 total, leaving
    the rounding error in it; the shares (total + accumulator) add in f64.
    promote=None: the accumulator runs the
    whole share, each step's products smallest first, and joins the total
    once. Returns f32 (M, N) (the f64 sum with f64)."""
    k = x.shape[0]
    xp = parts(x, mode_x)
    yp = [np.asarray(y, np.float32)] if y_exact else parts(y, mode_y)
    splits = max(-(-k // ksplit), 1)
    steps = -(-min(ksplit, max(k, 1)) // 16)

    def pad(t):
        return np.pad(t, ((0, splits * ksplit - k), (0, 0))).reshape(splits, ksplit, -1)[:, :16 * steps]

    xp, yp = [pad(t) for t in xp], [pad(t) for t in yp]
    # each share's blocks of rows that hold points (the kernel runs no other)
    live = np.minimum(np.maximum(k - ksplit * np.arange(splits), 0), ksplit)
    per = promote or steps
    blocks = -(-live // (16 * per))
    order = pairs(len(xp), len(yp))
    m, n = x.shape[1], y.shape[1]
    tot = np.zeros((splits, m, n), np.float32)
    acc = np.zeros((splits, m, n), np.float32)

    def step(a, i, j, st):
        rs = slice(16 * st, 16 * st + 16)
        return rz(np.einsum("skm,skn->smn", xp[i][:, rs].astype(np.float64), yp[j][:, rs].astype(np.float64)) + a)

    for b in range(-(-steps // per)):
        sts = range(b * per, min((b + 1) * per, steps))
        a = acc.astype(np.float64)
        if promote is None:
            for st in sts:
                for i, j in order:
                    a = step(a, i, j, st)
        else:
            for cls in (2, 1, 0):
                for st in sts:
                    for i, j in order:
                        if i + j == cls:
                            a = step(a, i, j, st)
        on = (b < blocks)[:, None, None]
        t, e = _fast_two_sum(tot, a.astype(np.float32))
        tot, acc = np.where(on, t, tot), np.where(on, e, acc)
    total = (tot.astype(np.float64) + acc.astype(np.float64)).sum(0)
    return total if f64 else total.astype(np.float32)


def _exact(x, y):
    """x^T y in f64 (every product exact), rounded to f32 once."""
    return (np.asarray(x, np.float64).T @ np.asarray(y, np.float64)).astype(np.float32)


def _emulate_weight_grads(mid: k1.HeadsIntermediates, h, ve, ve2, g, drop=None):
    """The weight-gradient kernel in numpy on the per-point kernel's inputs
    and outputs: the 8 gradients as torch tensors, module shapes (one
    scene). dW10's PE(dir) columns take a share per view; dW9 and dW11 are
    f64 on the CUDA cores, d o read from g as the kernel reads it."""
    one = drop if drop in ("tf32", "bf16") else None
    m = lambda name: "drop" if drop == name else one  # noqa: E731
    colsum = lambda t: t.astype(np.float64).sum(0).astype(np.float32)  # noqa: E731  exact column sums
    n_sec = mid.hv.shape[1] - 1
    pe, d_o = (t.numpy() for t in k1._view_rows(ve, ve2, g, n_sec))
    hv = mid.hv.reshape(-1, mid.hv.shape[-1]).numpy()
    h, g = h.float().numpy(), g.numpy()
    feature, d_feature, D = mid.feature.numpy(), mid.d_feature.numpy(), mid.D.numpy()
    views = 1 + n_sec
    w10p = sum(_emulate_weights(mid.d_hv[:, v].numpy(), pe[v::views], mode_x=m("dhv"), mode_y=m("pe"), f64=True)
               for v in range(views)).astype(np.float32)
    grads = [_emulate_weights(d_feature, h, y_exact=True, mode_x=m("dfeature")), colsum(d_feature),
             _exact(g[:, :1], h), colsum(g[:, :1]),
             np.concatenate([_emulate_weights(D, feature, mode_x=m("D"), mode_y=m("feature")), w10p], 1),
             colsum(D), _exact(d_o, hv), colsum(d_o)]
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
         "dfeature": ("weights", "W8")}


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
        assert all(m_weights[w][1] > 10 * cs.TOL_BWD_WEIGHTS_RMS for w in ("W8", "W10f", "W10p")), drop
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


@pytest.mark.parametrize("promote", [k1.BWD_PROMOTE, 4 * k1.BWD_PROMOTE, None])
def test_promotion_interval_over_a_training_launch(promote):
    """A weight gradient over 786,432 points (a training step's fine launch),
    d feature-like f32 against h-like bf16 columns, through the weight
    kernel's arithmetic: with the kernel's chain of `BWD_PROMOTE` k16 steps
    before each Fast2Sum, within `TOL_BWD_WEIGHTS_*` of the f64 product; a
    chain four times as long reads more; one accumulator per share of
    `BWD_KSPLIT` points (no promotion) misses the RMS limit by more than
    10x."""
    rng = np.random.default_rng(5)
    k = 786432
    x = (rng.normal(0, 1, (k, 2)) * rng.uniform(0.5, 1.5, (k, 1))).astype(np.float32)
    y = torch.from_numpy(np.maximum(rng.normal(0.3, 1, (k, 4)), 0).astype(np.float32)).bfloat16().float().numpy()
    exact = torch.from_numpy(x.astype(np.float64).T @ y.astype(np.float64))
    err = cs.rel_pair(torch.from_numpy(_emulate_weights(x, y, y_exact=True, promote=promote)), exact)
    design = cs.rel_pair(torch.from_numpy(_emulate_weights(x, y, y_exact=True)), exact)
    print(f"a chain of {promote} k16 steps: {err} (the kernel's {k1.BWD_PROMOTE}: {design})")
    if promote == k1.BWD_PROMOTE:
        assert err[0] <= cs.TOL_BWD_WEIGHTS_MAX and err[1] <= cs.TOL_BWD_WEIGHTS_RMS
    elif promote is None:
        assert err[1] > 10 * cs.TOL_BWD_WEIGHTS_RMS
    else:
        assert err[1] > design[1]


@pytest.mark.parametrize("chain", [k1.BWD_CHAIN, 16])
def test_chain_length_of_the_per_point_products(chain):
    """The per-point kernel's products on 2048 points at the flagship
    widths, d feature = D W10f and feature = h W8^T (+ b8), through its
    arithmetic: with a fresh accumulator per `BWD_CHAIN` k16 step, within
    `TOL_BWD_POINTS_RMS` of the f64 products; one chain over all of K (16
    k16 steps, the forward heads' way) misses both limits, the feature's
    and d feature's, by more than 2x."""
    rng = np.random.default_rng(7)
    params = torch_heads(init_mlp_params(jax.random.PRNGKey(2), CFG))
    w8, b8, w10 = (params[i].numpy() for i in (0, 1, 4))
    h = torch.from_numpy(np.maximum(rng.normal(0, 1, (2048, 256)), 0).astype(np.float32)).bfloat16().float().numpy()
    D = (rng.normal(0, 1e-3, (2048, 128)) * (rng.uniform(size=(2048, 128)) < 0.5)).astype(np.float32)
    got = {"feature": (point_product(h, w8, a_exact=True, chain=chain) + b8).astype(np.float32),
           "d_feature": point_product(D, np.ascontiguousarray(w10[:, :256].T), chain=chain)}
    want = {"feature": h.astype(np.float64) @ w8.T.astype(np.float64) + b8,
            "d_feature": D.astype(np.float64) @ w10[:, :256].astype(np.float64)}
    errs = {f: cs.rel_pair(torch.from_numpy(got[f]), torch.from_numpy(want[f])) for f in got}
    print(f"a chain of {chain} k16 steps: {errs}")
    if chain == k1.BWD_CHAIN:
        assert all(e[1] <= cs.TOL_BWD_POINTS_RMS[f] and e[0] <= cs.TOL_BWD_POINTS_MAX for f, e in errs.items())
    else:
        assert all(e[1] > 2 * cs.TOL_BWD_POINTS_RMS[f] for f, e in errs.items())


def test_kernel_constants_match_the_source():
    """The constants the emulation, the wrappers and chip_smoke use are the
    CUDA sources': the redesigned kernels' chain, interval, shares and weight
    stream, and the first design's weight image."""
    csrc = Path(k1.__file__).resolve().parent.parent / "csrc"
    src, first = (csrc / "fused_mlp_bwd.cu").read_text(), (csrc / "fused_mlp_bwd_mma_sync.cu").read_text()
    assert f"constexpr int CHAIN = {k1.BWD_CHAIN};" in src and f"constexpr int PROMOTE = {k1.BWD_PROMOTE};" in src
    assert f"constexpr int KSPLIT = {k1.BWD_KSPLIT};" in src
    assert f"constexpr int KSPLIT_SMALL = {k1.BWD_KSPLIT_SMALL};" in src
    assert f"constexpr int CHUNK = {k1.BWD_CHUNK};" in src
    assert f"constexpr int STREAM_CHUNKS = {k1.BWD_STREAM_CHUNKS};" in src
    assert f"SMALL_ELEMS == {k1.BWD_SMALL_NUMEL}" in src
    assert f"IMG_ELEMS == {k1.BWD_IMG_NUMEL}" in first and f"SMALL_ELEMS == {k1.BWD_SMALL_NUMEL}" in first
    order = ", ".join(f"J_{name[1:].upper() if name != 'small' else 'SMALL'} = {i}"
                      for i, (name, *_) in enumerate(k1.BWD_WEIGHT_JOBS))
    assert f"enum {{ {order}, NJOBS = {len(k1.BWD_WEIGHT_JOBS)} }};" in src
    assert "job_mt(int j) { return j == J_W8 ? 64 : 128; }" in src
    assert "job_nt(int j) { return j == J_W8 ? 256 : (j == J_W10F ? 128 : 32); }" in src
    assert "job_tiles(int j) { return j == J_W8 ? 4 : (j == J_W10F ? 2 : 1); }" in src
    assert cs.BWD == k1.BWD_KERNELS


def test_backward_stream_is_the_split_weights_in_the_kernels_order():
    """`heads_bwd_stream` (the per-point kernel's weight stream, in the
    bf16_f32h pack cache): a permutation of `heads_bwd_pack`'s image; each
    chunk, unswizzled part by part, is the three parts of the block of the
    matrix `bwd_stream_blocks` names; S = 2 packs each scene's in turn."""
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(8), scenes=2)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    image, stream = weights.heads_bwd[0], weights.heads_bwd_stream
    assert stream.numel() * 2 == 2 * k1.BWD_STREAM_CHUNKS * k1.BWD_CHUNK and stream.dtype == torch.bfloat16
    assert torch.equal(k1.bwd_stream_index("cpu").sort().values, torch.arange(k1.BWD_IMG_NUMEL))
    for s in range(2):
        w8 = mlp.feature_linear.weight.detach()[s]
        w10 = torch.nn.functional.pad(mlp.views_linears[0].weight.detach()[s], (0, 5))
        mats = {"w8": w8, "w10f": w10[:, :256], "w10p": w10[:, 256:], "w10ft": w10[:, :256].t(), "w8t": w8.t(),
                "w10pt": w10[:, 256:].t()}
        chunks = stream[s * k1.BWD_IMG_NUMEL:(s + 1) * k1.BWD_IMG_NUMEL].reshape(k1.BWD_STREAM_CHUNKS, 3, -1)
        for chunk, (name, r0, rows, ks) in zip(chunks, k1.bwd_stream_blocks()):
            for p in range(3):
                # each block 64-byte-swizzled: piece c of row n at c ^ (n // 2 % 4)
                blocks = chunk[p].reshape(len(ks), rows, 4, 8)
                n = torch.arange(rows)[:, None]
                c = torch.arange(4)[None, :]
                plain = torch.stack([b[n, c ^ ((n >> 1) & 3)].reshape(rows, 32) for b in blocks], 0)
                want = torch.stack([k1.split_bf16(mats[name][r0:r0 + rows, k0:k0 + 32].contiguous())[p] for k0 in ks])
                assert torch.equal(plain, want), (name, r0, ks, p)


@pytest.mark.parametrize("cols", [256, 128, 64, 32])
def test_mn_major_slab_offsets_follow_the_descriptors(cols):
    """The weight kernel's MN-major slabs (`bwd_mn_offset`, the CUDA
    source's mn_off): every (point, column) of a block lands on its own two
    bytes inside the part; 8 points on, the offset moves by the stride byte
    offset, an atom of columns on by the leading byte offset, as the wgmma
    descriptors say; within a row the 16-byte pieces are the row's columns,
    permuted by the swizzle."""
    lay = k1.bwd_mn_layout(cols)
    offs = np.array([[k1.bwd_mn_offset(k, c, cols) for c in range(cols)] for k in range(k1.BWD_BLOCK)])
    assert offs.min() == 0 and offs.max() == lay["part_bytes"] - 2 and len(np.unique(offs)) == offs.size
    assert (offs % 2 == 0).all()
    assert (offs[8:] - offs[:-8] == lay["sbo"]).all()
    atom = lay["swizzle"] // 2
    if cols > atom:
        assert (offs[:, atom:] - offs[:, :-atom] == lay["lbo"]).all()
    for k in range(k1.BWD_BLOCK):
        row = offs[k, :atom]
        assert sorted(row // 16 % (lay["swizzle"] // 16)) == sorted(list(range(lay["swizzle"] // 16)) * 8)
        assert (row // lay["swizzle"] == row[0] // lay["swizzle"]).all()


@pytest.mark.parametrize("scenes, nps, n_sec", [(1, 786432, 2), (1, 2085, 0), (2, 132 * 128 * 3 + 37, 3), (2, 1, 1)])
def test_weight_kernel_grid_covers_every_point_once(scenes, nps, n_sec):
    """`bwd_weight_grid` (the CUDA source's make_wargs): per job and scene
    its shares cover every point of every output tile once (every view's
    for dW10's PE(dir) columns), the CTAs of the jobs follow each other,
    the scratch is a share's doubles per CTA, and the second launch takes a
    thread per entry of each tile's share."""
    grid = k1.bwd_weight_grid(scenes, nps, n_sec)
    cta = 0
    for name, mt, nt, tiles in k1.BWD_WEIGHT_JOBS:
        job = grid["jobs"][name]
        assert job["cta0"] == cta and job["tiles"] == tiles
        per = k1.BWD_KSPLIT_SMALL if name == "small" else k1.BWD_KSPLIT
        views = 1 + n_sec if name == "dW10p" else 1
        assert job["splits"] % views == 0
        covered = [min(per, nps - per * s) for s in range(job["splits"] // views)]
        assert sum(covered) == nps and min(covered) > 0
        cta += scenes * tiles * job["splits"]
    assert grid["ctas"] == cta
    assert grid["share_entries"] == scenes * sum(j["tiles"] * j["share_doubles"] for j in grid["jobs"].values())
    assert grid["doubles"] == sum(scenes * j["tiles"] * j["splits"] * j["share_doubles"]
                                  for j in grid["jobs"].values())


@pytest.mark.parametrize("scenes, n, n_sec", [(1, 786432, 2), (2, 2 * (2048 + 37), 1)])
def test_l2_bytes_by_design_follow_the_stream_and_the_tiles(scenes, n, n_sec):
    """`bwd_stream_bytes`: the per-point kernel passes over its weight
    stream once per 128-point tile of each scene (48 chunks, one per view,
    one more per view with d PE(dir)); the weight kernel reads each tile's
    columns of its points, at least what `bwd_bytes` says it must read; at
    the training fine shape the redesign moves less than the first design
    does, per kernel."""
    tiles = scenes * -(-(n // scenes) // 128)
    for dve in (False, True):
        assert k1.bwd_stream_bytes("heads_bwd_points", n, n_sec, scenes, dve) == \
            tiles * (48 + (1 + n_sec) * (1 + dve)) * k1.BWD_CHUNK
    weights = k1.bwd_stream_bytes("heads_bwd_weights", n, n_sec, scenes)
    must = k1.bwd_bytes(n, n_sec, scenes)[1] - scenes * 4 * (k1.HEAD_NUMEL + 256 + 1 + 128 + 4)
    assert weights >= must
    if n == 786432:
        for kernel in k1.BWD_KERNELS:
            assert k1.bwd_stream_bytes(kernel, n, n_sec) < k1.bwd_stream_bytes(kernel + "_mma_sync", n, n_sec)


def test_weight_kernel_job_variants_cut_the_source():
    """`kernels/time_bwd_jobs.py` finds each marker it cuts in the weight
    kernel's source: every variant differs from the kernel, each job's alone
    returns early from the other jobs' CTAs, "nochain" runs no wgmma and
    "bare" splits nothing either."""
    from vipnerf_tpu_torch.kernels import time_bwd_jobs

    src = (Path(k1.__file__).resolve().parent.parent / "csrc/fused_mlp_bwd.cu").read_text()
    out = time_bwd_jobs.variants(src)
    assert out["kernel"] == src and len(out) == 9 and len(set(out.values())) == 9
    assert all("if (jb != J_" in v for name, v in out.items() if name != "kernel")
    assert all("cls >= 3" in v for name, v in out.items() if name.startswith(("nochain", "bare")))
    assert all(v.count("i < 0 * ") == 3 for name, v in out.items() if name.startswith("bare"))


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
