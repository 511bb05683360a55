"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`; each test skips where CUDA is absent. The file imports
nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances are chip_smoke.py's, relative to the plain outputs' scale
(`TOL_REL_MAX` on max|err| / max|plain|, `TOL_REL_RMS` on the RMS ratio):
bf16 1/32 and 2e-3 (kernel and plain version sum in different orders, so a
bf16 rounding can land one step apart and carry on); f32 1e-5 and 1e-6
(summation order only).
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import TOL_REL_MAX, TOL_REL_RMS  # noqa: E402
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
