"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where CUDA is absent. The file imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances of the forward are chip_smoke.py's, relative to the plain
outputs' scale (`TOL_REL_MAX` on max|err| / max|plain|, `TOL_REL_RMS` on
the RMS ratio): bf16 1/32 and 2e-3 (kernel and plain version sum in
different orders, so a bf16 rounding can land one step apart and carry on);
f32 1e-5 and 1e-6 (summation order only). The scene-batched launch is held
against the plain version looped over the scenes with the same tolerances,
and against each scene's single-scene launch bit for bit. K1's backward on
the card is held against autograd through its recompute there; one training
step on the card against the same step on the CPU (tolerances at each test).
nvJPEG's decode of the committed 4:2:0 fixture against the JAX package's
(libjpeg's) decode of it: at least chip_smoke.py's `JPEG_MIN_PSNR` dB, since
the two differ in the IDCT and the chroma upsampling.
"""

import itertools
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import JPEG_MIN_PSNR, TOL_REL_MAX, TOL_REL_RMS  # noqa: E402
from vipnerf_tpu_torch.kernels import fused_mlp as k1  # noqa: E402
from vipnerf_tpu_torch.models.mlp import NeRFMLP

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_sec", [0, 1, 2, 3])
# a ragged last tile; with 132 SMs, 3 tiles of 128 per persistent CTA and 37
# rows more, so the loop runs several tiles and ends mid-tile; one point
@pytest.mark.parametrize("n", [2048 + 37, 132 * 128 * 3 + 37, 1])
def test_fused_mlp_matches_plain(device, dtype, n_sec, n):
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(0)).to(device)
    weights = k1.prepare_weights(mlp, dtype)
    g = torch.Generator(device=device).manual_seed(n_sec)
    pts = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=device)) if n_sec else None
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype)
    before = k1.fused_mlp_raw.launches
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    torch.cuda.synchronize()
    assert k1.fused_mlp_raw.launches == before + 1
    ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
    err = out.float() - ref
    assert err.abs().max().item() <= TOL_REL_MAX[dtype] * ref.abs().max().item()
    assert err.norm().item() <= TOL_REL_RMS[dtype] * ref.norm().item()
    assert torch.isfinite(out).all() and not out[:, 5 + n_sec:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [2048 + 37, 132 * 128 * 3 + 37])
def test_fused_raw_backward_matches_the_recompute(device, dtype, n):
    """K1's autograd.Function on the card: one launch forward, and the
    gradients of autograd through `raw_recompute` on the card, for every
    parameter and for xe/ve/ve2 (the same function, so equal exactly)."""
    mlp = NeRFMLP(CFG, torch.Generator().manual_seed(1)).to(device)
    g = torch.Generator(device=device).manual_seed(2)
    pts = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, 2, 3), generator=g, device=device))
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype)
    inputs = [t.clone().requires_grad_() for t in (xe, ve, ve2)]
    params = k1.module_params(mlp)
    upstream = torch.randn((n, k1.NOUT), generator=g, device=device).to(dtype)
    before = k1.fused_mlp_raw.launches
    out = k1.FusedRaw.apply(k1.prepare_weights(mlp, dtype), ns, *inputs, *params)
    assert k1.fused_mlp_raw.launches == before + 1
    got = torch.autograd.grad(out, inputs + params, upstream)
    ref_in = [t.clone().requires_grad_() for t in (xe, ve, ve2)]
    want = torch.autograd.grad(k1.raw_recompute(params, *ref_in, ns), ref_in + params, upstream)
    assert k1.fused_mlp_raw.launches == before + 1  # the backward launches nothing
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _stacked_mlp(device, scenes):
    """S flagship MLPs with different weights, and the same as one stacked MLP."""
    singles = [NeRFMLP(CFG, torch.Generator().manual_seed(10 + s)).to(device) for s in range(scenes)]
    stacked = NeRFMLP(CFG, scenes=scenes).to(device)
    with torch.no_grad():
        for name, p in stacked.named_parameters():
            p.copy_(torch.stack([dict(m.named_parameters())[name] for m in singles]))
    return singles, stacked


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scenes,n_per_scene,n_sec", [(1, 2048 + 37, 2), (2, 4096 * 64 + 37, 2),
                                                      (3, 132 * 128 + 5, 0), (4, 129, 3)])
def test_scene_batched_launch(device, dtype, scenes, n_per_scene, n_sec):
    """One launch for S scenes, each on its own weights and its own ragged
    last tile: within the forward tolerances of the plain version looped over
    the scenes, and bit for bit each scene's own single-scene launch."""
    singles, stacked = _stacked_mlp(device, scenes)
    g = torch.Generator(device=device).manual_seed(scenes)
    n = scenes * n_per_scene
    pts = torch.rand((n, 3), generator=g, device=device) * 2 - 1
    unit = lambda t: torch.nn.functional.normalize(t, dim=-1)  # noqa: E731
    vd = unit(torch.randn((n, 3), generator=g, device=device))
    vd2 = unit(torch.randn((n, n_sec, 3), generator=g, device=device)) if n_sec else None
    xe, ve, ve2, ns = k1.encode_inputs(pts, vd, vd2, dtype)
    weights = k1.prepare_weights(stacked, dtype)
    before = k1.fused_mlp_raw.launches
    out = k1.fused_mlp_raw(weights, xe, ve, ve2, ns)
    torch.cuda.synchronize()
    assert k1.fused_mlp_raw.launches == before + 1
    ref = k1.fused_mlp_reference(weights.layers, xe, ve, ve2, ns).float()
    err = out.float() - ref
    assert err.abs().max().item() <= TOL_REL_MAX[dtype] * ref.abs().max().item()
    assert err.norm().item() <= TOL_REL_RMS[dtype] * ref.norm().item()
    rows = [slice(s * n_per_scene, (s + 1) * n_per_scene) for s in range(scenes)]
    for s, r in enumerate(rows):
        one = k1.fused_mlp_raw(k1.prepare_weights(singles[s], dtype), xe[r].contiguous(), ve[r].contiguous(),
                               ve2[r].contiguous(), ns)
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
        before = k1.fused_mlp_raw.launches
        scalars = step(model, batch, torch.Generator(device=dev))
        assert k1.fused_mlp_raw.launches - before == (2 if dev.type == "cuda" else 0)
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
    from vipnerf_tpu_torch.utils.jpeg import decode_jpeg

    data = Path(__file__).resolve().parent / "data"
    before = decode_jpeg.launches
    got = read_image(data / "synth_1008x756.jpg", device).astype(np.float64)
    want = read_png(data / "synth_1008x756_decoded.png").astype(np.float64)
    assert decode_jpeg.launches == before + 1
    assert got.shape == want.shape == (756, 1008, 3)
    psnr = 10 * np.log10(255.0 ** 2 / np.mean((got - want) ** 2))
    print(f"nvJPEG vs libjpeg: max |diff| {np.abs(got - want).max():.0f}, PSNR {psnr:.2f} dB")
    assert psnr >= JPEG_MIN_PSNR
