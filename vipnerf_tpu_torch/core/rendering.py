"""Volume rendering (alpha compositing), counterpart of
vipnerf_tpu/core/rendering.py, with the same epsilons: delta tail 1e10
(metric) / 1.0 (NDC), transmittance cumprod of 1-alpha+1e-10, depth
normalised by acc+1e-6, NDC depth also converted to metric (near=1).
"""

from typing import Dict, Optional

import torch

from vipnerf_tpu_torch.core.rays import depth_from_ndc


class _Cumprod(torch.autograd.Function):
    """torch.cumprod along the last axis, with torch's own backward for
    factors that are not 0 (the reversed cumulative sum of output x grad,
    over the factors) but without its test for zeros, which reads the device
    from the host (a `.item()`): a wait in every backward, and an operation
    a CUDA graph cannot capture. The transmittance's factors 1 - alpha +
    1e-10 are never 0 (alpha <= 1)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] <= 1:
            return grad
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """cumprod([1, x_0, ..., x_{n-2}]) along the last axis, for factors
    that are not 0."""
    inclusive = _Cumprod.apply(x)
    return torch.cat([torch.ones_like(x[..., :1]), inclusive[..., :-1]], dim=-1)


def volume_rendering(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    *,
    z_vals: Optional[torch.Tensor] = None,
    rays_d: Optional[torch.Tensor] = None,
    z_vals_ndc: Optional[torch.Tensor] = None,
    rays_d_ndc: Optional[torch.Tensor] = None,
    rays_o: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    ndc: bool = False,
    visibility2: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Composite per-sample rgb (nr, ns, 3) and sigma (nr, ns) into per-ray maps.

    In NDC mode pass z_vals_ndc + rays_d_ndc + the metric rays_o/rays_d;
    otherwise z_vals + rays_d. Returns rgb, acc, alpha, visibility
    (transmittance), weights, depth, depth_var [, depth_ndc, depth_var_ndc]
    [, visibility2 (nr, nf-1)].
    """
    if not ndc:
        if z_vals is None or rays_d is None:
            raise ValueError("metric compositing needs z_vals and rays_d")
        z_for_delta, d_for_delta, tail = z_vals, rays_d, 1e10
    else:
        if z_vals_ndc is None or rays_d_ndc is None or rays_o is None or rays_d is None:
            raise ValueError("NDC compositing needs z_vals_ndc, rays_d_ndc, rays_o, rays_d")
        z_for_delta, d_for_delta, tail = z_vals_ndc, rays_d_ndc, 1.0

    z1 = torch.cat([z_for_delta, torch.full_like(z_for_delta[..., :1], tail)], dim=-1)
    z_dists = z1[..., 1:] - z1[..., :-1]
    delta = z_dists * torch.linalg.norm(d_for_delta, dim=-1, keepdim=True)

    alpha = 1.0 - torch.exp(-sigma * delta)
    transmittance = exclusive_cumprod(1.0 - alpha + 1e-10)
    weights = alpha * transmittance
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    acc_map = torch.sum(weights, dim=-1)

    out: Dict[str, torch.Tensor] = {}
    if not ndc:
        depth_map = torch.sum(weights * z_vals, dim=-1) / (acc_map + 1e-6)
        depth_var_map = torch.sum(weights * (z_vals - depth_map[..., None]) ** 2, dim=-1)
    else:
        depth_map_ndc = torch.sum(weights * z_vals_ndc, dim=-1) / (acc_map + 1e-6)
        depth_var_map_ndc = torch.sum(
            weights * (z_vals_ndc - depth_map_ndc[..., None]) ** 2, dim=-1
        )
        z_metric = depth_from_ndc(z_vals_ndc, rays_o, rays_d)
        depth_map = torch.sum(weights * z_metric, dim=-1) / (acc_map + 1e-6)
        depth_var_map = torch.sum(weights * (z_metric - depth_map[..., None]) ** 2, dim=-1)
        out["depth_ndc"] = depth_map_ndc
        out["depth_var_ndc"] = depth_var_map_ndc

    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    out.update(
        rgb=rgb_map,
        acc=acc_map,
        alpha=alpha,
        visibility=transmittance,
        weights=weights,
        depth=depth_map,
        depth_var=depth_var_map,
    )
    if visibility2 is not None:
        # (nr, ns, nf-1, 1) per point -> (nr, nf-1) per pixel
        out["visibility2"] = torch.sum(
            weights[..., None] * visibility2[..., 0], dim=-2
        ) / (acc_map[..., None] + 1e-6)
    return out
