"""Depth sampling along rays: stratified coarse samples and inverse-CDF fine
resampling (counterpart of vipnerf_tpu/core/sampling.py).

Randomness comes from an explicit `torch.Generator`; the deterministic path
(generator None, perturb off) is what inference runs.
"""

from typing import Optional

import torch


def coarse_z_vals(
    near: torch.Tensor,
    far: torch.Tensor,
    num_samples: int,
    *,
    lindisp: bool = False,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Coarse depths (num_rays, num_samples) from near/far (num_rays, 1)."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=torch.float32, device=near.device)
    if not lindisp:
        z = near * (1.0 - t) + far * t
    else:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)

    if perturb:
        if generator is None:
            raise ValueError("perturb requires a torch.Generator")
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        t_rand = torch.rand(z.shape, generator=generator, dtype=z.dtype, device=z.device)
        z = lower + (upper - lower) * t_rand
    return z


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    *,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling. bins (nr, n_bins), weights (nr, n_bins - 1).

    Edges as in the reference: u below cdf[0] takes (cdf[0], bins[0]); u at or
    above cdf[-1] takes (cdf[-1], bins[-1]); a bin narrower than 1e-5 in the
    CDF divides by 1.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (nr, n_bins)

    shape = cdf.shape[:-1] + (num_samples,)
    if det:
        u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(shape).contiguous()
    else:
        if generator is None:
            raise ValueError("stochastic sample_pdf requires a torch.Generator")
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)

    # index of the first cdf entry > u; clamp both neighbours into range
    n_bins = cdf.shape[-1]
    above = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(above - 1, min=0)
    above = torch.clamp(above, max=n_bins - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def fine_z_vals(
    z_vals_coarse: torch.Tensor,
    weights_coarse: torch.Tensor,
    num_samples_fine: int,
    *,
    perturb: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample the PDF of the (detached) coarse weights over the coarse
    midpoints, merge with the coarse z and sort: (nr, n_coarse + n_fine)."""
    z_mid = 0.5 * (z_vals_coarse[..., 1:] + z_vals_coarse[..., :-1])
    w = weights_coarse[..., 1:-1].detach()
    z_samples = sample_pdf(
        z_mid, w, num_samples_fine, det=not perturb, generator=generator
    ).detach()
    z_all = torch.cat([z_vals_coarse, z_samples], dim=-1)
    return torch.sort(z_all, dim=-1).values
