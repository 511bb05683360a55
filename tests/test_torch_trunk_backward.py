"""The shipped mode's trunk backward (kernels/fused_mlp.py `trunk_backward`,
csrc/fused_mlp_bwd.cu `trunk_bwd_*`) on the CPU: its plain version, the
layout of the activations it reads, and what its wrappers refuse.

- `trunk_backward_reference` (the trunk's backward written out layer by
  layer in bf16) against `torch.autograd.grad` through `trunk_recompute`, the
  route the CPU keeps: bit for bit, for one scene and a stack of 2, at a
  point count that is no multiple of a tile; the gradients at the module's
  shapes (w0 without its pad column, w5 without the pad between xe's 63
  columns and h's 256), layer 5's xe columns live.
- `FusedRaw`'s backward in the shipped mode on CPU tensors: autograd through
  the recompute, which the reference equals, and no trunk kernel counted.
- `trunk_image`, the slab images the recompute writes, against the
  swizzle's definition element by element, with zero rows past each
  scene's end.
- The card's wrappers raise on CPU tensors and on other modes' weights.
- The benchmark's reader of the trunk backward's span
  (`benchmark/metrics/trunk_bwd_ms_per_step.train.py`) on a snapshot built
  by hand.
"""

import pytest
import torch

from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.utils import tracing

CFG = {
    "num_samples": 0, "netdepth": 8, "netwidth": 256,
    "points_positional_encoding_degree": 10, "views_positional_encoding_degree": 4,
    "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
}


def _mlp(scenes: int, seed: int = 3):
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(seed), scenes=scenes if scenes > 1 else None)
    if scenes > 1:  # the stacked module starts from one draw per scene
        with torch.no_grad():
            for s in range(scenes):
                one = NeRFMLP(CFG, torch.Generator().manual_seed(seed + s))
                for name, p in mlp.named_parameters():
                    p[s].copy_(dict(one.named_parameters())[name])
    return mlp


def _inputs(n: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((n, 3), generator=g) * 2 - 1
    vd = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    xe, ve, ve2, n_sec = k1.encode_inputs(pts, vd, None, torch.bfloat16, f32_heads=True)
    return xe, ve, ve2, n_sec, g


@pytest.mark.parametrize("scenes", [1, 2])
def test_trunk_backward_reference_equals_autograd(scenes):
    n = scenes * 300  # no multiple of a 128-row tile
    mlp = _mlp(scenes)
    xe, _, _, _, g = _inputs(n)
    params = [p.detach() for p in k1.module_params(mlp)[:2 * k1.FEATURE]]
    d_h = torch.randn((n, k1.WIDTH), generator=g).to(torch.bfloat16)
    trunk_in = [p.clone().requires_grad_() for p in params]
    h = k1.trunk_recompute(trunk_in, xe)
    want = torch.autograd.grad(h, trunk_in, d_h.reshape(h.shape))
    got = k1.trunk_backward_reference(params, xe, d_h)
    lead = (scenes,) if scenes > 1 else ()
    shapes = [tuple(s[1:]) for s in k1.trunk_grad_shapes(1)]
    assert [tuple(t.shape) for t in got] == [lead + s for s in shapes]
    assert shapes[0] == (256, 63) and shapes[10] == (256, 319)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and a.shape == b.shape, i
        assert torch.equal(a, b), i
        assert torch.equal(a, a.to(torch.bfloat16).float()), i  # bf16 values, as autograd rounds them
    # layer 5's skip: xe's columns take a gradient of their own
    assert got[10][..., :63].abs().sum() > 0 and got[10][..., 63:].abs().sum() > 0
    assert all(t.abs().sum() > 0 for t in got)


def test_shipped_backward_on_the_cpu_keeps_autograd():
    """FusedRaw in the shipped mode on CPU tensors: the trunk's gradients
    are autograd's through the recompute, which the reference equals from
    the same d h, and no trunk kernel is counted."""
    n = 256
    mlp = _mlp(1, seed=5)
    xe, ve, ve2, n_sec, g = _inputs(n, seed=1)
    params = k1.module_params(mlp)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    upstream = torch.randn((n, k1.NOUT), generator=g)
    tracing.reset()
    out = k1.FusedRaw.apply(weights, n_sec, xe, ve, ve2, *params)
    got = torch.autograd.grad(out, params[:2 * k1.FEATURE], upstream)
    assert k1.launches(k1.TRUNK_KERNELS) == dict.fromkeys(k1.TRUNK_KERNELS, 0)
    detached = [p.detach() for p in params]
    h = k1.trunk_recompute(detached[:2 * k1.FEATURE], xe)
    d_h = k1.heads_backward(weights, detached[2 * k1.FEATURE:], h.contiguous(), ve, ve2, upstream, n_sec)[0]
    want = k1.trunk_backward_reference(detached[:2 * k1.FEATURE], xe, d_h)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("cols,scenes,nps", [(64, 1, 200), (256, 2, 130), (256, 1, 128)])
def test_trunk_image_is_the_swizzled_slab_layout(cols, scenes, nps):
    t = torch.randn((scenes * nps, cols)).to(torch.bfloat16)
    img = k1.trunk_image(t, scenes)
    per = -(-nps // k1.TILE_ROWS) * k1.TILE_ROWS
    assert tuple(img.shape) == (scenes * per, cols)
    flat = img.reshape(-1)
    slabs = cols // 64
    for s in range(scenes):
        for row in range(per):
            b, r = divmod(s * per + row, 64)
            for c in range(0, cols, 8):
                at = (b * slabs + c // 64) * 4096 + r * 64 + ((((c % 64) // 8) ^ (r % 8)) * 8)
                want = t[s * nps + row, c:c + 8] if row < nps else torch.zeros(8, dtype=t.dtype)
                assert torch.equal(flat[at:at + 8], want), (s, row, c)


def test_trunk_kernels_refuse_what_they_do_not_take():
    mlp = _mlp(1)
    xe = _inputs(128)[0]
    with pytest.raises(ValueError, match="cuda"):
        k1.trunk_activations(k1.prepare_weights(mlp, torch.bfloat16, True), xe)
    with pytest.raises(TypeError, match="bf16_f32h"):
        k1.trunk_activations(k1.prepare_weights(mlp, torch.bfloat16), xe)
    with pytest.raises(ValueError, match="contiguous"):
        k1.trunk_activations(k1.prepare_weights(mlp, torch.bfloat16, True), xe.float())


def _metric():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "benchmark/metrics/trunk_bwd_ms_per_step.train.py"
    spec = importlib.util.spec_from_file_location("trunk_bwd_metric", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trunk_bwd_metric_sums_a_steps_spans_by_their_host_interval(monkeypatch):
    """The benchmark's reader of `k1.trunk_backward`: each span (opened in
    autograd's thread, so with no parent) belongs to the step whose host
    interval holds it; a step's spans add up; the median over the window's
    steps; None without the spans, or for a render run."""
    ms = 1_000_000
    spans = []

    def add(name, start, end, device=None, **attrs):
        spans.append({"name": name, "id": len(spans) + 1, "parent": None, "start_ns": int(start * ms),
                      "end_ns": int(end * ms), "attrs": attrs, "device_ms": device})

    for j in range(10):  # steps 30000.. of 10 ms host each; per step 2 levels x (recompute, layers)
        add("train.step", 10 * j, 10 * j + 9, [None, 0.0], it=30000 + j)
        for k, (a, b) in enumerate([(1.0, 1.5), (2.0, 4.0), (5.0, 5.25), (6.0, 6.0 + 0.1 * j)]):
            add(k1.TRUNK_SPAN, 10 * j + a, 10 * j + b, [100.0 * j + a, 100.0 * j + b],
                part="recompute" if k % 2 == 0 else "layers")
    add(k1.TRUNK_SPAN, 200, 201, [0.0, 50.0])  # outside every step
    metric = _metric()
    snap = {"spans": spans, "counts": {}}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    run = {"counts": {"kind": "train", "steps": 6, "trace_steps": 2}}
    # the window: steps 30002..30007; step j's spans sum to 0.5 + 2 + 0.25 + 0.1 j
    assert metric.read(run) == pytest.approx(2.75 + 0.1 * 4.5)
    assert metric.read({"counts": {"kind": "render", "steps": 6}}) is None
    snap["spans"] = [s for s in spans if s["name"] != k1.TRUNK_SPAN]
    assert metric.read(run) is None
