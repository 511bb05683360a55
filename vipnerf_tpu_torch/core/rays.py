"""Ray generation, NDC projection and NDC<->metric depth conversion
(counterpart of vipnerf_tpu/core/rays.py).

The two NDC conversions keep their distinct stabilizers: `depth_from_ndc`
adds 1e-3 only where z' == 1 exactly, `ndc_z_to_ray_t` adds 1e-6 everywhere.
Near is 1 in both, as in the reference.
"""

from typing import Tuple

import torch


def get_rays(
    height: int, width: int, intrinsic: torch.Tensor, c2w: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins/directions, each (h, w, 3), in exact float32.

    dirs = K^-1 [x, y, 1]; dirs[..., 1:] *= -1; rays_d = R @ dirs. The
    products are written as explicit multiply-adds so that no TF32 tensor-core
    path can touch them, whatever `allow_tf32` says.
    """
    device = c2w.device
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")  # (h, w)
    pix = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)  # (h, w, 3)
    # a 3x3 inverse: taken on the host, no solver launch on the card
    k_inv = torch.linalg.inv(intrinsic.detach().cpu().float()).to(device)
    dirs = (pix[..., None, :] * k_inv).sum(-1)  # pix @ k_inv.T
    dirs = dirs * torch.tensor([1.0, -1.0, -1.0], device=device)
    rot = c2w[:3, :3].to(torch.float32)
    rays_d = (dirs[..., None, :] * rot).sum(-1)  # dirs @ rot.T
    rays_o = c2w[:3, 3].to(torch.float32).expand(rays_d.shape)
    return rays_o, rays_d


def get_view_dirs(rays_d: torch.Tensor) -> torch.Tensor:
    """Unit-norm view directions."""
    return rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)


def get_ndc_rays(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    height: int,
    width: int,
    focal_x: float,
    focal_y: float,
    near: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift origins to the near plane, then the LLFF NDC projection."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]

    sx = -1.0 / (width / (2.0 * focal_x))
    sy = -1.0 / (height / (2.0 * focal_y))

    o0 = sx * ox / oz
    o1 = sy * oy / oz
    o2 = 1.0 + 2.0 * near / oz

    d0 = sx * (dx / dz - ox / oz)
    d1 = sy * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz
    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def depth_to_ndc(
    depths: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
    near: float = 1.0,
) -> torch.Tensor:
    """Metric depth (t along the un-shifted ray) -> NDC z' in [0, 1].

    `depths`: (..., 1) or (...,); `rays_o`/`rays_d`: (..., 3).
    """
    oz = rays_o[..., 2:3]
    dz = rays_d[..., 2:3]
    tn = -(near + oz) / dz
    oz_prime = oz + tn * dz
    d = depths if depths.ndim == oz.ndim else depths[..., None]
    ndc = 1.0 - oz_prime / (oz_prime + (d - tn) * dz)
    return ndc if depths.ndim == oz.ndim else ndc[..., 0]


def depth_from_ndc(
    z_vals_ndc: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
    near: float = 1.0,
) -> torch.Tensor:
    """NDC z' -> metric depth, with a 1e-3 stabilizer where z' == 1 exactly."""
    oz = rays_o[..., 2:3]
    dz = rays_d[..., 2:3]
    tn = -(near + oz) / dz
    constant = torch.where(z_vals_ndc == 1.0, 1e-3, 0.0)
    return (oz + tn * dz) / dz * (1.0 / (1.0 - z_vals_ndc + constant) - 1.0) + tn


def ndc_z_to_ray_t(
    z_vals_ndc: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
    near: float = 1.0,
) -> torch.Tensor:
    """NDC z' -> parametric t for the secondary-view points (1e-6 stabilizer)."""
    oz = rays_o[..., 2:3]
    dz = rays_d[..., 2:3]
    tn = -(near + oz) / dz
    return ((oz + tn * dz) / (1.0 - z_vals_ndc + 1e-6) - oz) / dz
