"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where CUDA is absent. The file imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances of the forward are chip_smoke.py's, relative to the plain
outputs' scale (`TOL_REL_MAX` on max|err| / max|plain|, `TOL_REL_RMS` on
the RMS ratio): bf16 1/32 and 2e-3 (kernel and plain version sum in
different orders, so a bf16 rounding can land one step apart and carry on);
f32 1e-5 and 1e-6 (summation order only); bf16_f32h (the shipped mode:
bf16 trunk, f32 heads) 1/256 and 2e-4 (the trunk's bf16 steps only); its
tensor-core heads (split bf16 products) against plain f32 heads on K1's own
h (chip_smoke's `plain_heads`), `TOL_HEADS_MAX` 3e-5 and `TOL_HEADS_RMS`
3e-6 (both f32-accurate, so only summation differs: the tensor cores round
each k16 step's sum toward zero). The scene-batched launch is held
against the plain version looped over the scenes with the same tolerances,
and against each scene's single-scene launch bit for bit. K1's backward on
the card is held against autograd through its recompute there, bit for
bit (in the shipped mode, where the heads' gradient and d h are the two
kernels of csrc/fused_mlp_bwd.cu: the heads' gradients and d PE(dir)
within chip_smoke's `TOL_BWD_YARD_*`, the trunk's gradients, from its own
kernels, within chip_smoke's `TOL_TRUNK_*` of `trunk_backward_reference`
on the kernels' d h, and xe, which takes no gradient there, refused); one
training step on the card against the same step on the CPU (tolerances at
each test). The trunk backward's kernels (chip_smoke's
`check_trunk_backward`) against their plain version at the training
shapes, S = 1, 4, and ragged sizes, h8 bit for bit K1's forward h, two
calls bit for bit, and the inputs they refuse. The heads backward's kernels against
their plain versions in f64 and the yardstick at ragged sizes, n_sec 0-3,
S = 1, 2 (chip_smoke's `check_heads_backward` and its `TOL_BWD_*`), and
bit for bit on chip_smoke's exact-sum cases; against the yardstick
(`heads_backward_recompute`) within `TOL_BWD_YARD_*` at the training
shape too; two launches of each bit for bit the same; the weight
kernel's grid and scratch as `k1.bwd_weight_grid` lays them out; K1 through 100 training steps
at the flagship width, K1 with the yardstick backward and the module MLP,
each pair compared (chip_smoke's `phase_trajectory` and `TRAJ_TOL_*`, the
bands of the port-vs-JAX trajectory in tests/test_torch_protocol.py, held
over its first `TRAJ_BAND_STEPS` steps).
nvJPEG's decode of the committed 4:2:0 fixture against the JAX package's
(libjpeg's) decode of it: at least chip_smoke.py's `JPEG_MIN_PSNR` dB, since
the two differ in the IDCT and the chroma upsampling. chip_smoke's
multi-device pair at a narrow width: two gloo ranks sharing the card
against one process on it, with the JAX mesh's tolerances (f32); and why
that pair runs gloo: two ranks on one card run the port's collectives
(all_reduce, all_gather, barrier) on CUDA tensors through gloo, while NCCL
refuses them.
"""

import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from chip_smoke import JPEG_MIN_PSNR, TOL_HEADS_MAX, TOL_HEADS_RMS, TOL_REL_MAX, TOL_REL_RMS  # noqa: E402
from vipnerf_tpu_torch.kernels import fused_mlp as k1  # noqa: E402
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.utils import tracing

CFG = {
    "num_samples": 0, "netdepth": 8, "netwidth": 256,
    "points_positional_encoding_degree": 10, "views_positional_encoding_degree": 4,
    "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("K1 is a CUDA kernel: it runs only on an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, pytest.param("bf16_f32h", id="bf16_f32h")])
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
# a ragged last tile; with 132 SMs, 3 tiles of 128 per persistent CTA and 37
# rows more, so the loop runs several tiles and ends mid-tile; one point
@pytest.mark.parametrize("n", [2048 + 37, 132 * 128 * 3 + 37, 1])
def test_fused_mlp_matches_plain(device, dtype, n_sec, n):
    f32_heads = dtype == "bf16_f32h"
    dtype = torch.bfloat16 if f32_heads else dtype
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(0)).to(device)
    weights = k1.prepare_weights(mlp, dtype, f32_heads)
    name = k1.INSTANCE[weights.mode]
    g = torch.Generator(device=device).manual_seed(n_sec)
    pts = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=device)) if n_sec else None
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
    before = tracing.counts()
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    torch.cuda.synchronize()
    after = tracing.counts()
    assert after[f"k1.launches.{name}"] == before.get(f"k1.launches.{name}", 0) + 1
    assert out.dtype == ve.dtype
    ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
    err = out.float() - ref
    assert err.abs().max().item() <= TOL_REL_MAX[name] * ref.abs().max().item()
    assert err.norm().item() <= TOL_REL_RMS[name] * ref.norm().item()
    assert torch.isfinite(out).all() and not out[:, 5 + n_sec:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, pytest.param("bf16_f32h", id="bf16_f32h")])
@pytest.mark.parametrize("n", [2048 + 37, 132 * 128 * 3 + 37])
def test_fused_raw_backward_matches_the_recompute(device, dtype, n):
    """K1's autograd.Function on the card: one launch forward, and the
    gradients of autograd through `raw_recompute` on the card, for every
    parameter and for xe/ve/ve2 (the same function, so equal exactly; in
    the shipped mode the heads' part within `TOL_BWD_YARD_*`, the trunk's
    exactly that of the kernels' d h)."""
    f32_heads = dtype == "bf16_f32h"
    dtype = torch.bfloat16 if f32_heads else dtype
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(1)).to(device)
    g = torch.Generator(device=device).manual_seed(2)
    pts = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, 2, 3), generator=g, device=device))
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
    # on the card the shipped mode gives xe no gradient (the encode kernel has none)
    inputs = [t.clone().requires_grad_(not (f32_heads and i == 0)) for i, t in enumerate((xe, ve, ve2))]
    params = k1.module_params(mlp)
    upstream = torch.randn((n, k1.NOUT), generator=g, device=device).to(ve.dtype)
    if f32_heads:  # no ReLU of the heads within rounding of 0 (its side would decide a whole entry)
        with torch.no_grad():
            h = k1.trunk_recompute([p.detach() for p in params[:16]], xe).reshape(n, -1)
        upstream = cs.untie_relu(k1, [p.detach() for p in params[16:]], h, ve, ve2, upstream, ns)
    tracing.reset()
    weights = k1.prepare_weights(mlp, dtype, f32_heads)
    out = k1.FusedRaw.apply(weights, ns, *inputs, *params)
    assert sum(k1.launches().values()) == 1
    wanted = inputs[1:] if f32_heads else inputs
    got = torch.autograd.grad(out, wanted + params, upstream)
    ref_in = [t.clone().requires_grad_() for t in (xe, ve, ve2)]
    want = torch.autograd.grad(k1.raw_recompute(params, *ref_in, ns), ref_in + params, upstream)
    assert sum(k1.launches().values()) == 1  # the backward launches no forward
    assert k1.launches(k1.BWD_KERNELS) == dict.fromkeys(k1.BWD_KERNELS, int(f32_heads))
    assert k1.launches(k1.TRUNK_KERNELS) == dict.fromkeys(k1.TRUNK_KERNELS, int(f32_heads))
    if f32_heads:
        got = (None,) + got
        want = (None,) + want[1:]
    if not f32_heads:
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        return
    trunk = 3 + 2 * k1.FEATURE  # xe, ve, ve2, then the trunk's parameters
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 0:
            continue
        assert torch.isfinite(a).all() and a.dtype == b.dtype and a.shape == b.shape, i
        if 0 < i < 3 or i >= trunk:  # d PE(dir) and the heads' gradients
            a, b = a.double(), b.double()
            assert (a - b).abs().max() <= cs.TOL_BWD_YARD_MAX * b.abs().max(), i
            assert (a - b).norm() <= cs.TOL_BWD_YARD_RMS * b.norm(), i
    # the trunk: its kernels on the kernels' d h (from K1's h, which the
    # trunk's recompute kernel reproduces bit for bit) against the plain
    # version, within chip_smoke's TOL_TRUNK_*
    h8 = k1.trunk_activations(weights, xe).h8
    d_h = k1.heads_backward(weights, [p.detach() for p in params[trunk - 3:]], h8, ve, ve2, upstream.float(), ns)[0]
    plain = k1.trunk_backward_reference([p.detach() for p in params[:trunk - 3]], xe, d_h)
    for (mx, rms), a in zip(cs.grad_ratios(got[3:trunk], plain), got[3:trunk]):
        assert torch.isfinite(a).all() and mx <= cs.TOL_TRUNK_MAX and rms <= cs.TOL_TRUNK_RMS
    with pytest.raises(ValueError, match="xe must not require grad"):
        torch.autograd.grad(k1.FusedRaw.apply(weights, ns, xe.clone().requires_grad_(), ve, ve2, *params),
                            params, upstream)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 2])
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [2048 + 37, 132 * 128 * 3 + 37, 1])
def test_f32h_tensor_core_heads_match_the_plain_heads(device, scenes, n_sec, n):
    """bf16_f32h's heads on tensor cores against plain f32 heads on K1's own
    h (chip_smoke's `plain_heads`: `k1.heads_recompute` on
    `k1.trunk_activations`' h8, TF32 off): within the heads-only
    tolerances, for one scene and for two stacked scenes (n rows each) in
    one launch."""
    singles, stacked = _stacked_mlp(device, scenes)
    mlp = singles[0] if scenes == 1 else stacked
    g = torch.Generator(device=device).manual_seed(7 + n_sec)
    rows = scenes * n
    pts = torch.rand((rows, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((rows, 3), generator=g, device=device))
    vd2 = unit(torch.randn((rows, n_sec, 3), generator=g, device=device)) if n_sec else None
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, torch.bfloat16, f32_heads=True)
    weights = k1.prepare_weights(mlp, torch.bfloat16, f32_heads=True)
    tracing.reset()
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    plain = cs.plain_heads(k1, mlp, weights, xe, ve, ve2, ns)
    torch.cuda.synchronize()
    assert k1.launches() == {**dict.fromkeys(k1.FORWARD, 0), "fused_mlp_bf16_f32h": 1}
    assert torch.isfinite(out).all() and not out[:, 5 + n_sec:].any()
    err = out - plain
    assert err.abs().max().item() <= TOL_HEADS_MAX * plain.abs().max().item()
    assert err.norm().item() <= TOL_HEADS_RMS * plain.norm().item()


def _stacked_mlp(device, scenes):
    """S flagship MLPs with different weights, and the same as one stacked MLP."""
    singles = [NeRFMLP(CFG, torch.Generator().manual_seed(10 + s)).to(device) for s in range(scenes)]
    stacked = NeRFMLP(CFG, scenes=scenes).to(device)
    with torch.no_grad():
        for name, p in stacked.named_parameters():
            p.copy_(torch.stack([dict(m.named_parameters())[name] for m in singles]))
    return singles, stacked


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, pytest.param("bf16_f32h", id="bf16_f32h")])
@pytest.mark.parametrize("scenes,n_per_scene,n_sec", [(1, 2048 + 37, 2), (2, 4096 * 64 + 37, 2),
                                                      (3, 132 * 128 + 5, 0), (4, 129, 3)])
def test_scene_batched_launch(device, dtype, scenes, n_per_scene, n_sec):
    """One launch for S scenes, each on its own weights and its own ragged
    last tile: within the forward tolerances of the plain version looped over
    the scenes, and bit for bit each scene's own single-scene launch."""
    f32_heads = dtype == "bf16_f32h"
    dtype = torch.bfloat16 if f32_heads else dtype
    singles, stacked = _stacked_mlp(device, scenes)
    g = torch.Generator(device=device).manual_seed(scenes)
    n = scenes * n_per_scene
    pts = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=device)) if n_sec else None
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype, f32_heads=f32_heads)
    weights = k1.prepare_weights(stacked, dtype, f32_heads)
    name = k1.INSTANCE[weights.mode]
    before = sum(k1.launches().values())
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    torch.cuda.synchronize()
    assert sum(k1.launches().values()) == before + 1
    ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
    err = out.float() - ref
    assert err.abs().max().item() <= TOL_REL_MAX[name] * ref.abs().max().item()
    assert err.norm().item() <= TOL_REL_RMS[name] * ref.norm().item()
    rows = [slice(s * n_per_scene, (s + 1) * n_per_scene) for s in range(scenes)]
    for s, r in enumerate(rows):
        one = k1.fused_mlp_raw(k1.prepare_weights(singles[s], dtype, f32_heads), xe[r].contiguous(),
                               ve[r].contiguous(), ve2[r].contiguous(), ns)
        torch.testing.assert_close(out[r], one, rtol=0, atol=0)


@pytest.mark.cuda
def test_scene_batched_backward_matches_per_scene(device):
    """The stacked MLP through K1 (f32) forward and backward against each
    scene's own MLP: the same outputs, and each scene's gradient its own
    within 1e-5 of its scale (the recompute's batched products sum in
    another order than the single-scene ones: an entry that nearly cancels
    may differ more, relative to itself)."""
    singles, stacked = _stacked_mlp(device, 2)
    g = torch.Generator(device=device).manual_seed(5)
    pts = torch.rand((2, 3000, 3), generator=g, device=device)
    vd = torch.nn.functional.normalize(torch.randn((2, 3000, 3), generator=g, device=device), dim=-1)
    vd2 = torch.nn.functional.normalize(torch.randn((2, 3000, 2, 3), generator=g, device=device), dim=-1)
    out = k1.apply_fused_mlp(stacked, pts, vd, vd2, dtype=torch.float32)
    sum(v.square().sum() for v in out.values()).backward()
    for s, mlp in enumerate(singles):
        one = k1.apply_fused_mlp(mlp, pts[s], vd[s], vd2[s], dtype=torch.float32)
        for k, v in one.items():
            torch.testing.assert_close(out[k][s], v, rtol=0, atol=0)
        sum(v.square().sum() for v in one.values()).backward()
        for name, p in mlp.named_parameters():  # batched vs single products: summation order
            d = dict(stacked.named_parameters())[name].grad[s] - p.grad
            assert d.norm() <= 1e-5 * p.grad.norm() and d.abs().max() <= 1e-5 * p.grad.abs().max(), name


def _train_batch(nr=48, nf=3, seed=0):
    """A [nerf; sparse-depth] batch of a forward-facing NDC scene."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.arange(nr) < nr // 2
    rays_d = torch.cat([0.2 * torch.randn((nr, 2), generator=g), -torch.ones(nr, 1)], 1)
    poses = torch.eye(4).repeat(nf, 1, 1)
    poses[:, :3, 3] = 0.2 * torch.randn((nf, 3), generator=g)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    return {
        "rays_o": torch.cat([0.1 * torch.randn((nr, 2), generator=g), torch.zeros(nr, 1)], 1),
        "rays_d": rays_d, "view_dirs": torch.nn.functional.normalize(rays_d, dim=-1),
        "rays_o_ndc": torch.cat([u(nr, 2) - 0.5, -torch.ones(nr, 1)], 1),
        "rays_d_ndc": torch.cat([0.4 * u(nr, 2) - 0.2, 2 * torch.ones(nr, 1)], 1),
        "near": torch.ones(nr, 1), "far": torch.full((nr, 1), 8.0),
        "near_ndc": torch.zeros(nr, 1), "far_ndc": torch.ones(nr, 1),
        "target_rgb": torch.where(mask[:, None], u(nr, 3), -1.0),
        "sparse_depth_values": torch.where(mask[:, None], -1.0, 2 + 4 * u(nr, 1)),
        "visibility_prior_masks": torch.where(mask[:, None], (u(nr, nf - 1) > 0.5).float(), -1.0),
        "indices_mask_nerf": mask, "indices_mask_sparse_depth": ~mask,
        "poses": poses, "pixel_id": torch.randint(0, nf, (nr, 3), generator=g, dtype=torch.int32),
        "iter_num": 20,
    }


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(device, monkeypatch):
    """One flagship training step with the f32 instance on the card and with
    its plain version on the CPU, same weights and batch (perturb and sigma
    noise off; 0.5 on the sigma biases, as chip_smoke's serving phase adds,
    so that depth, a ratio over the accumulated weight, is well
    conditioned).

    The gradient comes from K1's backward recompute, whose ReLUs have a
    derivative that jumps at 0: a pre-activation within rounding of 0 that
    falls on the other side on the card drops or adds that point's whole
    share of the unit's gradient. So the card steps twice, once with its own
    ReLU pattern in the recompute and once with the CPU's (y * mask in place
    of relu(y), the mask recorded on the CPU); the entries where the
    patterns differ are counted and printed.

    Each card step: the losses within 1e-4 relative of the CPU's, and every
    parameter moved by Adam's first step (at most lr). Every parameter's
    gradient within 1e-3 of its norm with the CPU's ReLU pattern, and with
    the card's own where no entry of it differs."""
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs
    from vipnerf_tpu_torch.losses import LossComputer
    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays
    from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_training_configs(Path("."), 10)
    cfg["model"].update(bf16_matmuls=False, perturb=False, raw_noise_std=0.0)
    lr = cfg["optimizer"]["lr_initial"]
    raw_recompute, relu = k1.raw_recompute, torch.relu
    cpu_masks, flipped = [], []

    def run(dev, inject=False):
        calls = itertools.count()

        def patterned(y):  # the i-th ReLU of this step's recomputes
            i = next(calls)
            if dev.type == "cpu":
                cpu_masks.append(y.detach() > 0)
                return relu(y)
            mask = cpu_masks[i].to(y.device)
            assert mask.shape == y.shape
            if inject:
                return y * mask
            flipped.append(((y.detach() > 0) != mask).sum().item())
            return relu(y)

        def recompute(*args):
            monkeypatch.setattr(torch, "relu", patterned)
            try:
                return raw_recompute(*args)
            finally:
                monkeypatch.setattr(torch, "relu", relu)

        monkeypatch.setattr(k1, "raw_recompute", recompute)
        model = ViPNeRF(cfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for mlp in model.children():
                mlp.pts_output_linear.bias += 0.5
        model = model.to(dev)
        start = {k: v.detach().clone() for k, v in model.named_parameters()}
        step = make_train_step(cfg, render_rays, LossComputer(cfg), make_optimizer(cfg, model.parameters()))
        batch = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in _train_batch().items()}
        before = sum(k1.launches().values())
        scalars = step(model, batch, torch.Generator(device=dev))
        assert sum(k1.launches().values()) - before == (2 if dev.type == "cuda" else 0)
        return ({k: v.cpu() for k, v in scalars.items()},
                {k: p.grad.cpu() for k, p in model.named_parameters()},
                {k: (p.detach() - start[k]).cpu() for k, p in model.named_parameters()})

    s_cpu, g_cpu, _ = run(torch.device("cpu"))
    own = run(device)
    given = run(device, inject=True)
    print(f"ReLU entries of the recomputes on the other side of 0 on the card: {sum(flipped)} "
          f"of {sum(m.numel() for m in cpu_masks)}, by ReLU call {flipped}")
    for name, (s_gpu, g_gpu, d_gpu) in (("its own ReLU pattern", own), ("the CPU's ReLU pattern", given)):
        rel = max(((g_gpu[k] - g).norm() / g.norm()).item() for k, g in g_cpu.items())
        print(f"card step with {name}: max over parameters of |grad - cpu| / |cpu| = {rel:.3e}")
        for k in s_cpu:
            torch.testing.assert_close(s_gpu[k], s_cpu[k], rtol=1e-4, atol=0)
        for k, d in d_gpu.items():
            assert d.abs().max() <= lr * (1 + 1e-3) and d.abs().max() > 0, k
        if name == "the CPU's ReLU pattern" or sum(flipped) == 0:
            for k, g in g_cpu.items():
                assert (g_gpu[k] - g).norm() <= 1e-3 * g.norm(), (name, k)


@pytest.mark.cuda
def test_nvjpeg_decodes_the_fixture_as_libjpeg_does(device):
    import numpy as np

    from vipnerf_tpu_torch.utils.io import read_image, read_png

    data = Path(__file__).resolve().parent / "data"
    before = tracing.counts().get("jpeg.decodes", 0)
    got = read_image(data / "synth_1008x756.jpg", device).astype(np.float64)
    want = read_png(data / "synth_1008x756_decoded.png").astype(np.float64)
    assert tracing.counts()["jpeg.decodes"] == before + 1
    assert got.shape == want.shape == (756, 1008, 3)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((got - want) ** 2))
    print(f"nvJPEG vs libjpeg: max |diff| {np.abs(got - want).max():.0f}, PSNR {psnr:.2f} dB")
    assert psnr >= JPEG_MIN_PSNR


@pytest.mark.cuda
def test_two_gloo_ranks_sharing_the_card_match_one_process(device, tmp_path):
    """10 steps of tests/test_train_step.py's narrow model (perturbation on)
    on two gloo ranks sharing the card, spawned by the port's launcher:
    the ranks' parameters bit for bit equal; TotalLoss within rtol 1e-5 per
    step and the parameters within atol 2e-6 / rtol 1e-5 of one process's
    on the card (the JAX package's tolerances for its mesh)."""
    import numpy as np

    # by file, not as tests.torch_parallel_ranks: a `tests` package installed
    # on the GPU machine shadows this directory
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_parallel_ranks as ranks

    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF
    from vipnerf_tpu_torch.parallel.mesh import run_on_devices

    cfg = ranks.step_configs()
    state = {k: v.detach().numpy() for k, v in ViPNeRF(cfg, torch.Generator().manual_seed(0)).state_dict().items()}
    idx = np.random.default_rng(1).integers(0, 512, (10, 64)).astype(np.int32)
    steps = (cfg, state, ranks.step_cache(), idx)
    index = device.index or 0
    run_on_devices(ranks.joined, {"device": [index, index], "workdir": str(tmp_path), "steps": steps})
    ref_loss, ref_params = ranks.run_steps(*steps, device=device)
    (l0, p0), (l1, p1) = (ranks.load(tmp_path, "joined", r) for r in (0, 1))
    np.testing.assert_array_equal(l0, l1)
    for k in ref_params:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        np.testing.assert_allclose(p0[k], ref_params[k], atol=2e-6, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(l0, ref_loss, rtol=1e-5)


def _collectives_on_one_card(rank: int, backend: str, address: str, index: int, queue) -> None:
    """One of two ranks on cuda:index: each collective the port uses, "ok"
    or the error it raised, to `queue`."""
    import torch.distributed as dist

    dev = torch.device("cuda", index)
    torch.cuda.set_device(dev)
    results = {}
    try:
        dist.init_process_group(backend, init_method=address, rank=rank, world_size=2)
    except (RuntimeError, ValueError) as e:  # what the backend refuses is the result
        queue.put((rank, {"init": str(e).splitlines()[0]}))
        return
    x = torch.ones(4, device=dev)
    for name, run in (("all_reduce", lambda: dist.all_reduce(x)),
                      ("all_gather", lambda: dist.all_gather([torch.empty_like(x) for _ in range(2)], x)),
                      ("barrier", dist.barrier)):
        try:
            run()
            torch.cuda.synchronize(dev)
            results[name] = "ok"
        except (RuntimeError, ValueError) as e:
            results[name] = str(e).splitlines()[0] if str(e) else type(e).__name__
    queue.put((rank, results))
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_two_ranks_on_one_card_need_gloo(device, backend):
    """Two ranks on one card: gloo runs all_reduce, all_gather and the
    barrier on CUDA tensors; NCCL refuses two ranks on one device (an error
    on each rank, or no result within the time given)."""
    import multiprocessing
    import socket
    from queue import Empty

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_collectives_on_one_card, args=(r, backend, address, device.index or 0, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, res = queue.get(timeout=120)
            results[rank] = res
    except Empty:  # a rank hung in the backend
        pass
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
    print(backend, results)
    ok = {"all_reduce": "ok", "all_gather": "ok", "barrier": "ok"}
    if backend == "gloo":
        assert results == {0: ok, 1: ok}
    else:
        assert all(results.get(r) != ok for r in (0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 2])
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2048 + 37, 132 * 128 * 3 + 37])
def test_heads_backward_kernels_match_their_plain_versions(device, scenes, n_sec, n):
    """The shipped mode's heads backward, each kernel against its plain
    version in f64 on the same inputs and both end to end against the
    whole plain version in f64 and the yardstick (chip_smoke's
    `check_heads_backward`: `TOL_BWD_*`), one launch of each kernel."""
    mlp = cs.stacked_mlp(device, scenes)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    g = torch.Generator(device=device).manual_seed(11 + n_sec)
    inputs = cs.heads_inputs(k1, mlp, scenes * n, n_sec, g, device)
    tracing.reset()
    cs.check_heads_backward(k1, weights, *inputs, f"S = {scenes} x {n} points, n_sec {n_sec}")
    assert k1.launches(k1.BWD_KERNELS) == dict.fromkeys(k1.BWD_KERNELS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dense", "witness"])
@pytest.mark.parametrize("scenes", [1, 2])
def test_heads_backward_is_exact_on_the_exact_sum_cases(device, case, scenes):
    """chip_smoke's exact-sum inputs: the kernels equal the plain version in
    f32 bit for bit (and the forward heads on the witness case)."""
    cs.exact_case_on_card(k1, case, scenes, device)
    cs.exact_forward_on_card(k1, device)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes, n_sec, n", [(1, 0, 2048 + 37), (1, 3, 132 * 128 * 3 + 37), (2, 2, 2048 + 37),
                                              (1, 2, 4096 * 64)])
def test_heads_backward_matches_the_recompute(device, scenes, n_sec, n):
    """The kernels against the yardstick (`heads_backward_recompute`:
    autograd through raw_recompute's f32 heads, TF32 off) on the same
    inputs: every gradient and d PE(dir) within `TOL_BWD_YARD_*` (max and
    RMS relative to the yardstick's), d h off its rounding on at most
    `TOL_BWD_YARD_DH_FRAC` of the entries; one launch of each kernel."""
    mlp = cs.stacked_mlp(device, scenes)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    g = torch.Generator(device=device).manual_seed(21 + n_sec)
    params, h, ve, ve2, up, ns = cs.heads_inputs(k1, mlp, scenes * n, n_sec, g, device)
    tracing.reset()
    got = k1.heads_backward(weights, params, h, ve, ve2, up, ns)
    assert not torch.backends.cuda.matmul.allow_tf32
    err = cs.bwd_errors(got, k1.heads_backward_recompute(params, h, ve, ve2, up, ns))
    print(f"S = {scenes} x {n} points, n_sec {n_sec}: the kernels against the recompute {err}")
    assert err["max"] <= cs.TOL_BWD_YARD_MAX and err["rms"] <= cs.TOL_BWD_YARD_RMS
    assert err["dh_off"] <= cs.TOL_BWD_YARD_DH_FRAC
    assert k1.launches(k1.BWD_KERNELS) == dict.fromkeys(k1.BWD_KERNELS, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 2])
def test_heads_backward_kernels_are_reproducible(device, scenes):
    """Two launches of each redesigned kernel on the same inputs give
    bit-identical outputs (chip_smoke's `check_reproducible`: no float
    atomics, the weight kernel's shares summed in a fixed order)."""
    mlp = cs.stacked_mlp(device, scenes)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    g = torch.Generator(device=device).manual_seed(31)
    inputs = cs.heads_inputs(k1, mlp, scenes * (132 * 128 * 3 + 37), 2, g, device)
    cs.check_reproducible(k1, weights, *inputs, f"S = {scenes}")


@pytest.mark.cuda
@pytest.mark.parametrize("scenes, nps, n_sec", [(1, 786432, 2), (1, 2085, 0), (2, 132 * 128 * 3 + 37, 3), (4, 1, 1)])
def test_weight_grid_matches_the_kernel_scratch(device, scenes, nps, n_sec):
    """The weight kernel's share doubles, CTAs and second-launch threads as
    its C entry computes them are `k1.bwd_weight_grid`'s, which the CPU
    tests check."""
    scratch = k1._bwd_fns()[2]
    grid = k1.bwd_weight_grid(scenes, nps, n_sec)
    assert [scratch(scenes, nps, n_sec, w) for w in (1, 2, 3)] == [grid["doubles"], grid["ctas"],
                                                                    grid["share_entries"]]


@pytest.mark.cuda
def test_flagship_trajectory_through_k1_matches_the_module_mlp(device, tmp_path):
    """K1 in the shipped mode (its forward instance and its backward
    kernels) through 100 training steps at the flagship width, 2048 + 2048
    rays, perturbation and sigma noise off, against K1 with the yardstick
    backward and against the module MLP from the same weights on the same
    batches, and those two against each other (chip_smoke's
    `phase_trajectory`): the first step's loss terms within
    `TRAJ_TOL_FIRST`, the next `TRAJ_BAND_STEPS` within `TRAJ_TOL_STEP`
    (the bands of the port-vs-JAX trajectory); the rest printed against the
    bands (`-s`)."""
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs

    write_synthetic_database(tmp_path / "data/databases", scene_name="synth01", num_frames=5,
                             train_frames=(0, 2, 4), val_frames=(1,), height=189, width=252)
    rig = cs.TrainRig(tmp_path, flagship_training_configs(tmp_path, cs.TRAJ_STEPS), device)
    out = cs.phase_trajectory(k1, rig)
    assert out["launches"] == {"fused_mlp_bf16_f32h": 200, "heads_bwd_points": 200, "heads_bwd_weights": 200}


@pytest.mark.cuda
def test_timed_spans_read_their_stream_intervals_back(device):
    """Spans given the card time their interval on its stream: read back
    after a synchronisation, a child's interval lies inside its parent's and
    covers its work, and a span timed at its end alone has no start; the
    events return to the tracer's pool, so later rounds allocate none."""
    t = tracing.Tracer()
    a = torch.randn(4096, 4096, device=device)
    for _ in range(3):
        with t.span("outer", device):
            with t.span("inner", device):
                for _ in range(20):
                    a = a @ a.T / 64.0
        with t.span("after", device, start_event=False):
            a = a @ a.T / 64.0
        torch.cuda.synchronize()
        t.collect()
        pool = len(t._free)
    assert pool == 5 and t._pending == []
    records = t.snapshot()["spans"]
    assert [r["name"] for r in records] == ["inner", "outer", "after"] * 3
    inner, outer, after = records[-3:]
    assert inner["parent"] == outer["id"]
    (i0, i1), (o0, o1), (a0, a1) = inner["device_ms"], outer["device_ms"], after["device_ms"]
    assert o0 <= i0 < i1 <= o1 < a1 and a0 is None
    assert i1 - i0 > 1.0  # twenty 4096^3 products take milliseconds
    assert records[2]["device_ms"][1] <= records[3]["device_ms"][0]  # rounds in order on one timeline


@pytest.mark.cuda
def test_timed_spans_without_a_collect_stay_bounded(device):
    """A caller that never collects (a train step driven by hand) holds at
    most `PENDING` timed spans: the rest are read back as they close."""
    t = tracing.Tracer()
    for _ in range(tracing.PENDING + 10):
        with t.span("train.forward", device):
            pass
    assert len(t._pending) < tracing.PENDING
    torch.cuda.synchronize()
    t.collect()
    assert t._pending == [] and all(r["device_ms"] is not None for r in t.snapshot()["spans"])


ENCODE_MODES = {"bf16": (torch.bfloat16, False), "f32": (torch.float32, False), "bf16_f32h": (torch.bfloat16, True)}


def _encode_points(n, n_sec, seed, device, rays=None):
    """Points up to |x| 4 (sine arguments up to 2^9 x 4), with a few far
    outside, where CUDA's sincosf takes its slow range reduction; unit
    directions, one per point or one per ray."""
    g = torch.Generator(device=device).manual_seed(seed)
    pts = (torch.rand((n, 3), generator=g, device=device) * 2 - 1) * 4
    far = torch.tensor([[300.0, -1000.0, 1e4], [-2.5e5, 7.0, 1e-30]], device=device)
    pts[:min(n, 2)] = far[:min(n, 2)]
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n if rays is None else rays, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=device)) if n_sec else None
    return pts, vd, vd2


def _assert_same_bits(got, want, label):
    """Equal bits, or a report of how far apart (the largest difference and
    how many entries differ)."""
    assert got.dtype == want.dtype and got.shape == want.shape, label
    ints = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    differ = got.view(ints) != want.view(ints)
    if differ.any():
        diff = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"{label}: {int(differ.sum())} of {differ.numel()} entries differ, "
                             f"max|diff| {diff:.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(ENCODE_MODES))
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("n", [0, 1, 2048 + 37, 132 * 128 * 3 + 37])
def test_encode_kernel_matches_the_torch_chain(device, mode, n_sec, fast, n):
    """K1's inputs from the encode kernel: the torch chain's on the card
    (`encode_reference`), bit for bit, one launch a call (none for no
    points)."""
    dtype, f32_heads = ENCODE_MODES[mode]
    pts, vd, vd2 = _encode_points(n, n_sec, 100 * n_sec + n % 97, device)
    before = k1.launches([k1.ENCODE])[k1.ENCODE]
    got = k1.encode_inputs(pts, vd, vd2, dtype, fast, f32_heads)
    torch.cuda.synchronize()
    assert k1.launches([k1.ENCODE])[k1.ENCODE] == before + (1 if n else 0)
    want = k1.encode_reference(pts, vd, vd2, dtype, fast, f32_heads)
    assert got[3] == want[3] == n_sec
    for g, w, name in zip(got[:3], want[:3], ("xe", "ve", "ve2")):
        assert g.is_contiguous()
        _assert_same_bits(g, w, f"{name} {mode} n_sec={n_sec} fast={fast} N={n}")
    if not n_sec:
        assert got[2] is got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(ENCODE_MODES))
@pytest.mark.parametrize("samples", [64, 192])
@pytest.mark.parametrize("fast", [False, True])
def test_encode_kernel_reads_a_ray_direction_per_sample(device, mode, samples, fast):
    """Per-ray directions, read through the sample stride: the chain's
    encoding of the directions copied out to every sample, bit for bit."""
    dtype, f32_heads = ENCODE_MODES[mode]
    rays = 8192 // 64 + 3
    pts, vd, vd2 = _encode_points(rays * samples, 2, samples, device, rays=rays)
    got = k1.encode_inputs(pts, vd, vd2, dtype, fast, f32_heads)
    want = k1.encode_reference(pts, vd.repeat_interleave(samples, 0), vd2, dtype, fast, f32_heads)
    for g, w, name in zip(got[:3], want[:3], ("xe", "ve", "ve2")):
        _assert_same_bits(g, w, f"{name} {mode} samples={samples} fast={fast}")


@pytest.mark.cuda
@pytest.mark.parametrize("tracked", [0, 1, 2])
def test_encode_kernel_rejects_inputs_autograd_tracks(device, tracked):
    """The kernel has no backward: on the card, a tracked pts, view
    direction or secondary view raises before any launch."""
    inputs = list(_encode_points(256, 1, 3, device))
    inputs[tracked] = inputs[tracked].clone().requires_grad_()
    before = k1.launches([k1.ENCODE])[k1.ENCODE]
    with pytest.raises(ValueError, match="require grad"):
        k1.encode_inputs(*inputs, torch.bfloat16, f32_heads=True)
    assert k1.launches([k1.ENCODE])[k1.ENCODE] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_sec", [0, 2])
def test_stacked_k1_through_the_encode_kernel(device, monkeypatch, n_sec):
    """Four scenes in one call, rows scene-major, directions per ray: one
    encode launch feeds the one K1 launch, whose outputs are those of K1 fed
    by the torch chain, bit for bit."""
    _, stacked = _stacked_mlp(device, 4)
    rays, samples = 4 * 37, 64
    pts, vd, vd2 = _encode_points(rays * samples, n_sec, 7, device, rays=rays)
    shaped = (pts.reshape(4, -1, 3), vd, None if vd2 is None else vd2.reshape(4, -1, n_sec, 3))
    mark = tracing.counts()
    with torch.no_grad():
        got = k1.apply_fused_mlp(stacked, *shaped, dtype=torch.bfloat16, f32_heads=True)
    torch.cuda.synchronize()
    encodes = k1.launches([k1.ENCODE])[k1.ENCODE] - mark.get(f"k1.launches.{k1.ENCODE}", 0)
    forward = sum(k1.launches().values()) - sum(mark.get(f"k1.launches.{k}", 0) for k in k1.FORWARD)
    assert encodes == forward == 1
    monkeypatch.setattr(k1, "encode_inputs", k1.encode_reference)
    with torch.no_grad():
        want = k1.apply_fused_mlp(stacked, *shaped, dtype=torch.bfloat16, f32_heads=True)
    for key in want:
        _assert_same_bits(got[key], want[key], key)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,n", [(1, 4096 * 64), (1, 4096 * 192), (4, 4096 * 64), (4, 4096 * 192),
                                      (1, 2048 + 37), (1, 132 * 128 * 3 + 37), (2, 2048 + 37)])
def test_trunk_backward_kernels_match_the_plain_version(device, scenes, n):
    """The shipped mode's trunk backward on the card (chip_smoke's
    `check_trunk_backward`): at a training step's two launch shapes (64 and
    192 samples of 4096 rays a scene, S = 1 and 4) and where a tile is
    ragged, the recompute's h8 bit for bit K1's forward h (and xe's image
    bit for bit), the 16 gradients against `trunk_backward_reference`
    within `TOL_TRUNK_MAX` (2^-5 of the largest entry) and `TOL_TRUNK_RMS`
    (4e-3 of the norm): both round every d to bf16 after f32 sums taken in
    other orders, and the plain version's cuBLAS products run long chains
    over the points, so an entry can land a bf16 step apart and carry on
    down the layers (measured: at most 6.9e-3 and 2.7e-3); two calls bit for
    bit the same (a fixed order, no float atomics)."""
    mlp = cs.stacked_mlp(device, scenes)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    params, xe, d_h = cs.trunk_inputs(k1, mlp, scenes * n, torch.Generator(device=device).manual_seed(n), device)
    tracing.reset()
    cs.check_trunk_backward(k1, weights, params, xe, d_h, f"S = {scenes} x {n} points")
    assert k1.launches(k1.TRUNK_KERNELS) == dict.fromkeys(k1.TRUNK_KERNELS, 2)


@pytest.mark.cuda
def test_trunk_backward_kernels_refuse_what_they_do_not_take(device):
    mlp = cs.stacked_mlp(device, 2)
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    params, xe, d_h = cs.trunk_inputs(k1, mlp, 2 * 300, torch.Generator(device=device).manual_seed(1), device)
    with pytest.raises(ValueError, match="split into 2 scenes"):
        k1.trunk_activations(weights, xe[:301].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        k1.trunk_activations(weights, xe.float())
    with pytest.raises(TypeError, match="bf16_f32h"):
        k1.trunk_activations(k1.prepare_weights(mlp, torch.bfloat16), xe)
    act = k1.trunk_activations(weights, xe)
    for bad in (d_h.float(), d_h[:-2].contiguous(), d_h.t()):
        with pytest.raises(ValueError, match="d_h must be"):
            k1.trunk_backward(weights, act, bad, True)


# ------------------------------------------------ the training step's CUDA graph


GRAPH_STEPS = 5


def _graph_configs(root, scenes=1, prior_at=30000, sparse_depth=True):
    """The flagship training configs in the shipped mode (bf16 trunk, f32
    heads: llff_2view's), for 1 scene or `scenes` in lockstep; without
    `sparse_depth`, demo1d's ablation (1024 NeRF rays, no sparse-depth
    stream or loss: llff_2view_vp's)."""
    from vipnerf_tpu_torch.data.synthetic_rig import flagship_training_configs

    cfg = flagship_training_configs(root, 100, visibility_prior_start_iter=prior_at)
    cfg["model"].update(bf16_matmuls=True, f32_heads=True)
    if not sparse_depth:
        del cfg["data_loader"]["sparse_depth"]
        cfg["data_loader"]["num_rays"] = 1024
        cfg["losses"] = [loss for loss in cfg["losses"] if loss["name"] != "SparseDepthMSE01"]
    if scenes > 1:
        cfg["data_loader"]["scene_names"] = [f"synth{i + 1:02}" for i in range(scenes)]
        cfg.update(batch_scenes=True)
    return cfg


class _GraphRig:
    """A model at llff_2view's step shapes (2048 + 2048 rays, 64 + 128
    samples) on a small synthetic LLFF scene, or `scenes` of them stacked
    (the batched trainer's model and batches), its batches by iteration, and
    steps over it from one saved state."""

    def __init__(self, root, device, scenes=1, prior_at=30000, sparse_depth=True):
        from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
        from vipnerf_tpu_torch.models.vip_nerf import render_rays
        from vipnerf_tpu_torch.parallel.mesh import ShardGenerator

        for i in range(scenes):
            write_synthetic_database(root / "data/databases", scene_name=f"synth{i + 1:02}", num_frames=5,
                                     train_frames=(0, 2, 4), val_frames=(1,), height=189, width=252, seed=i)
        self.cfg, self.scenes, self.device = _graph_configs(root, scenes, prior_at, sparse_depth), scenes, device
        self.render = render_rays
        if scenes == 1:
            rig = cs.TrainRig(root, self.cfg, device)
            self.model, self.loss_computer, self._batch = rig.model, rig.loss_computer, rig.batch
        else:
            from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer

            t = MultiSceneTrainer(self.cfg, self.cfg["data_loader"]["scene_names"],
                                  root / "data" / self.cfg["database_dirpath"], device=device, verbose_log=False)
            self.model, self.loss_computer = t.model, t.loss_computer
            prep = t.preprocessors[0]

            def batch(it):
                nerf, sd = (None if r is None else torch.from_numpy(r).to(device) for r in t._index_rows(it, 1))
                return prep.gather_batch(nerf[:, 0], None if sd is None else sd[:, 0], it, cache=t.cache,
                                         near=t.near, far=t.far)

            self._batch = batch
        self.generator = ShardGenerator(device)
        self.start = [p.detach().clone() for p in self.model.parameters()]
        self.batches = {}

    def batch(self, it):
        """Iteration `it`'s batch, drawn once (the preprocessor's index draw
        moves on at each call): every run sees the same batches."""
        if it not in self.batches:
            self.batches[it] = self._batch(it)
        return {k: v.clone() if torch.is_tensor(v) else v for k, v in self.batches[it].items()}

    def step(self):
        """A fresh optimizer and step from the saved state."""
        from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step

        with torch.no_grad():
            for p, s in zip(self.model.parameters(), self.start):
                p.copy_(s)
        opt = make_optimizer(self.cfg, self.model.parameters(), scenes=None if self.scenes == 1 else self.scenes)
        return make_train_step(self.cfg, self.render, self.loss_computer, opt), opt

    def run(self, fn, its):
        """`fn` over the iterations `its`, the generator seeded per step as
        the trainers seed it; each step's losses."""
        from vipnerf_tpu_torch.train.trainer import step_seed

        batches = [self.batch(it) for it in its]
        out = []
        for it, b in zip(its, batches):
            self.generator.manual_seed(step_seed(7, it))
            out.append({k: v.clone() for k, v in fn(self.model, b, self.generator).items()})
        return out


def _state(rig, opt):
    return ([p.detach().clone() for p in rig.model.parameters()]
            + [opt.exp_avg.clone(), opt.exp_avg_sq.clone(), opt.count.clone()])


def _max_gap(a, b):
    """The largest |a - b| over matching tensors (lists of tensors or of dicts)."""
    flat = lambda xs: [t for x in xs for t in (x.values() if isinstance(x, dict) else [x])]  # noqa: E731
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(flat(a), flat(b), strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("scenes", [1, 2])
def test_graphed_steps_equal_the_eager_steps(device, tmp_path, scenes):
    """From one state, GRAPH_STEPS steps replayed as the step's CUDA graph
    (one eager warm-up, one capture replayed, then replays) against the
    same steps eager, at llff_2view's shapes, one scene and two in
    lockstep: the losses each step returns, the parameters, Adam's moments
    and count, and the generator's state after the steps (its draws: the
    perturbation and the sigma noise). Two eager runs of the same steps are
    compared too: the graph is held bit for bit where they are, and within
    their own gap where they are not (float atomics in autograd's scatter
    kernels sum in any order); both gaps are printed (`-s`)."""
    from vipnerf_tpu_torch.train.step import GraphedStep

    rig = _GraphRig(tmp_path, device, scenes)
    its = list(range(30000, 30000 + GRAPH_STEPS))
    runs = {}
    for name in ("eager", "eager again", "graphed"):
        step, opt = rig.step()
        assert isinstance(step, GraphedStep)
        losses = rig.run(step if name == "graphed" else step.eager, its)
        torch.cuda.synchronize()
        runs[name] = (losses, _state(rig, opt), rig.generator.get_state())
        if name == "graphed":
            assert (step.graph.graph is not None) and step.key is not None
    spread = max(_max_gap(runs["eager"][0], runs["eager again"][0]), _max_gap(runs["eager"][1], runs["eager again"][1]))
    gap = max(_max_gap(runs["eager"][0], runs["graphed"][0]), _max_gap(runs["eager"][1], runs["graphed"][1]))
    print(f"S = {scenes}: graphed against eager, largest gap {gap:.3e}; two eager runs {spread:.3e}")
    assert gap <= spread
    for name in ("eager again", "graphed"):
        assert torch.equal(runs[name][2], runs["eager"][2])  # the same draws, the generator where eager leaves it
    assert runs["graphed"][1][-1].tolist() == [GRAPH_STEPS] * scenes


@pytest.mark.cuda
def test_eight_scenes_without_sparse_depth_replay_the_eager_steps(device, tmp_path):
    """demo1d's step (1024 NeRF rays a scene, no sparse-depth stream, three
    losses: llff_2view_vp's) for 8 scenes in lockstep: the batch carries no
    sparse-depth field, every step after the warm-up is a replay of one
    capture, and the graphed steps are the eager ones, bit for bit where two
    eager runs are, else within their gap (printed with `-s`)."""
    rig = _GraphRig(tmp_path, device, scenes=8, sparse_depth=False)
    batch = rig.batch(30000)
    assert not any("sparse_depth" in k for k in batch) and bool(batch["indices_mask_nerf"].all())
    assert batch["rays_o"].shape[0] == 8 * 1024
    its = list(range(30000, 30000 + GRAPH_STEPS))
    runs = {}
    for name in ("eager", "eager again", "graphed"):
        step, opt = rig.step()
        before = tracing.counts("train.graph.")
        losses = rig.run(step if name == "graphed" else step.eager, its)
        torch.cuda.synchronize()
        after = tracing.counts("train.graph.")
        runs[name] = (losses, _state(rig, opt))
        if name == "graphed":
            assert {k: after.get(k, 0) - before.get(k, 0) for k in ("train.graph.captures", "train.graph.replays")} \
                == {"train.graph.captures": 1, "train.graph.replays": GRAPH_STEPS - 1}
    assert all(tuple(step_losses) == ("MSE01", "VisibilityLoss01", "VisibilityPriorLoss01", "TotalLoss")
               and step_losses["TotalLoss"].shape == (8,) for step_losses in runs["graphed"][0])
    spread = max(_max_gap(runs["eager"][0], runs["eager again"][0]), _max_gap(runs["eager"][1], runs["eager again"][1]))
    gap = max(_max_gap(runs["eager"][0], runs["graphed"][0]), _max_gap(runs["eager"][1], runs["graphed"][1]))
    print(f"S = 8 without sparse depth: graphed against eager, largest gap {gap:.3e}; two eager runs {spread:.3e}")
    assert gap <= spread


@pytest.mark.cuda
def test_eight_scenes_without_sparse_depth_count_one_ray_stream_in_the_trainers_loop(device, tmp_path):
    """llff_2view_vp's run through `MultiSceneTrainer.train` (S = 8, 1024
    NeRF rays a scene, no sparse-depth stream), two chunks of GRAPH_STEPS
    steps from iteration 30000: each step counts 8 x 1024 NeRF rays and no
    sparse-depth ray, every step after the first is a replay of one capture,
    and each chunk's `train.log` logs steps x 8 x (three terms, TotalLoss and
    the learning rate), as its counter and its span's `scalars` say."""
    from vipnerf_tpu_torch.data.synthetic import write_synthetic_database
    from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer

    scenes, start, steps = 8, 30000, 2 * GRAPH_STEPS
    for i in range(scenes):
        write_synthetic_database(tmp_path / "data/databases", scene_name=f"synth{i + 1:02}", num_frames=5,
                                 train_frames=(0, 2, 4), val_frames=(1,), height=189, width=252, seed=i)
    cfg = dict(_graph_configs(tmp_path, scenes, sparse_depth=False), scan_steps=GRAPH_STEPS)
    t = MultiSceneTrainer(cfg, cfg["data_loader"]["scene_names"], tmp_path / "data" / cfg["database_dirpath"],
                          device=device, output_dirpath=tmp_path / "runs", verbose_log=False)
    t.save_checkpoints(start)
    tracing.reset()
    t.train(start + steps, validation_interval=0, model_save_interval=0)
    t.close()
    per_chunk = GRAPH_STEPS * scenes * 5
    logs = [s["attrs"] for s in tracing.snapshot()["spans"] if s["name"] == "train.log"]
    assert logs == [{"it": start, "scalars": per_chunk}, {"it": start + GRAPH_STEPS, "scalars": per_chunk}]
    assert tracing.counts("train.") == {"train.rays.nerf": steps * scenes * 1024, "train.rays.sparse_depth": 0,
                                        "train.graph.captures": 1, "train.graph.replays": steps - 1,
                                        "train.log.scalars": 2 * per_chunk}


@pytest.mark.cuda
def test_graph_recaptures_at_a_loss_stage_and_a_replaced_state(device, tmp_path):
    """The visibility prior staged in at iteration 30003: the step there is
    captured again and its TotalLoss carries the new weight; Adam's moments
    replaced by a copy: captured again; replays otherwise."""
    rig = _GraphRig(tmp_path, device, prior_at=30003)
    step, opt = rig.step()
    before = tracing.counts("train.graph.")
    seen = []
    for it in range(30000, 30007):
        if it == 30005:
            opt.exp_avg = opt.exp_avg.clone()
        (losses,) = rig.run(step, [it])
        counts = tracing.counts("train.graph.")
        seen.append(tuple(counts.get(k, 0) - before.get(k, 0) for k in ("train.graph.captures", "train.graph.replays")))
        weights = {name: rig.loss_computer.get_loss_weight(name, it) for name in rig.loss_computer.losses}
        total = torch.zeros((), dtype=torch.float64)
        for name, w in weights.items():
            total = total + w * losses[name].double().cpu()
        assert float(losses["TotalLoss"]) == pytest.approx(float(total), rel=1e-6), it
    assert weights["VisibilityPriorLoss01"] > 0
    assert seen == [(0, 0), (1, 1), (1, 2), (2, 3), (2, 4), (3, 5), (3, 6)]


@pytest.mark.cuda
def test_a_replay_counts_what_an_eager_step_counts(device, tmp_path):
    """K1's launches and the points through its view branch, per step: the
    replays add what the eager step adds."""
    rig = _GraphRig(tmp_path, device)
    step, _ = rig.step()
    deltas = []
    for it in range(30000, 30004):
        before = tracing.counts()
        rig.run(step, [it])
        after = tracing.counts()
        deltas.append({k: v - before.get(k, 0) for k, v in after.items()
                       if k.startswith(("k1.launches.", "vis.")) and v != before.get(k, 0)})
    assert deltas[0]["k1.launches.fused_mlp_bf16_f32h"] == 2 and deltas[0]["vis.sec_view_points"] > 0
    assert deltas[1] == deltas[2] == deltas[3] == deltas[0]


@pytest.mark.cuda
def test_an_eager_k1_forward_after_replays_packs_the_current_parameters(device, tmp_path):
    """Replays write the parameters unseen by autograd; the step bumps their
    versions, so an eager use of K1 after them (a validation render) packs
    the current parameters, not the last capture's: its pack is a fresh
    pack's bit for bit, and its output K1's plain version's on them."""
    rig = _GraphRig(tmp_path, device)
    step, _ = rig.step()
    mlp = rig.model.fine_model
    rig.run(step, list(range(30000, 30003)))
    first = k1.prepare_weights(mlp, torch.bfloat16, True).w_flat.clone()
    rig.run(step, list(range(30003, 30006)))
    weights = k1.prepare_weights(mlp, torch.bfloat16, True)
    fresh = k1.kernel_buffers(k1.pack_layers(mlp, torch.bfloat16, torch.float32), torch.bfloat16, torch.float32)
    assert torch.equal(weights.w_flat, fresh[0]) and torch.equal(weights.b_flat, fresh[1])
    assert not torch.equal(first, weights.w_flat)  # the parameters moved in between
    name = k1.INSTANCE[weights.mode]
    xe, ve, ve2, ns = cs.k1_inputs(k1, 2048 + 37, 2, name, torch.Generator(device=device).manual_seed(3), device)
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns).float()
    ref = k1.fused_mlp_reference(k1.pack_layers(mlp, torch.bfloat16, torch.float32), xe, ve, ve2, ns).float()
    assert (out - ref).abs().max().item() <= TOL_REL_MAX[name] * ref.abs().max().item()
    assert (out - ref).norm().item() <= TOL_REL_RMS[name] * ref.norm().item()


@pytest.mark.cuda
def test_profiled_replays_show_the_kernels_and_time_their_spans(device, tmp_path):
    """torch.profiler over replayed steps (the benchmark's traced chunk) sees
    K1's forward, its heads backward and the trunk's kernels by name, and
    the tracer gives each replayed step its device-timed spans (forward,
    backward, the other views' directions, the trunk's backward), which the
    benchmark's readers read; `graphed_steps.train` reads 100 %."""
    bench = Path(__file__).resolve().parent.parent / "benchmark"
    sys.path.insert(0, str(bench))
    from harness import cells, trace

    rig = _GraphRig(tmp_path, device)
    step, _ = rig.step()
    tracing.reset()
    its = list(range(30000, 30006))

    def stepped(model, batch, gen):
        with tracing.span("train.step", device, it=stepped.it):
            stepped.it += 1
            return step(model, batch, gen)

    stepped.it = its[0]
    rig.run(stepped, its[:2])
    prof = trace.start_profiler()
    rig.run(stepped, its[2:])
    torch.cuda.synchronize()
    prof.stop()
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    for part in ("fused_mlp_", "heads_bwd_", "trunk_bwd_", "trunk_recompute", "k1_encode"):
        assert any(part in n for n in names), part
    seconds = trace.reduce_profile(prof)["seconds"]
    assert seconds["k1_fwd"] > 0 and seconds["k1_bwd"] > 0
    tracing.collect()
    # the window: the profiled steps after the first (step_ms_p95 times each from the step before it)
    run = {"counts": {"kind": "train", "steps": len(its) - 3, "trace_steps": 0}}
    for metric in ("forward_ms_per_step.train", "backward_ms_per_step.train", "sec_views_ms_per_step.train",
                   "trunk_bwd_ms_per_step.train", "step_ms_p95.train"):
        value = cells.reader(metric, bench)(run)
        print(f"{metric}: {value}")
        assert value is not None and 0 < value < 1e3, metric
    assert cells.reader("graphed_steps.train", bench)(run) == 100.0
