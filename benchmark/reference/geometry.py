"""Camera geometry of the plain reference: pose normalisation, pixel rays,
LLFF's NDC projection and depth conversions, written from the published
NeRF / ViP-NeRF conventions in float64 numpy and plain torch. It imports
nothing of the program.

Conventions (NeRF-LLFF's `load_llff_data` with ViP-NeRF's extrinsics):
- extrinsics are world-to-camera, Colmap axes (x right, y down, z forward);
- training scales translations by sc = 1 / (near * bd_factor) (none without
  bd_factor), recentres on the average camera (only where asked), and flips
  y and z into NeRF's camera axes; test poses reuse the training's sc and
  average pose;
- a pixel (x, y) casts the direction K^-1 [x, y, 1] with y and z negated,
  rotated into the world;
- NDC (forward-facing scenes): rays shifted to the plane z = -near, then
  projected, near = 1 after the scaling.
"""

from typing import Dict, Optional

import numpy as np
import torch


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def average_pose_w2c(w2c: np.ndarray) -> np.ndarray:
    """The mean camera of a set of w2c extrinsics, as a w2c matrix: the mean
    centre, the summed viewing axis, the summed up axis made orthogonal."""
    c2w = np.linalg.inv(w2c)
    centre = c2w[:, :3, 3].mean(0)
    z = _unit(c2w[:, :3, 2].sum(0))
    up = c2w[:, :3, 1].sum(0)
    x = _unit(np.cross(up, z))
    y = _unit(np.cross(z, x))
    avg = np.eye(4)
    avg[:3, :4] = np.stack([x, y, z, centre], axis=1)
    return np.linalg.inv(avg)


def normalise_poses(w2c: np.ndarray, sc: float, average_w2c: np.ndarray) -> np.ndarray:
    """c2w NeRF poses (n, 4, 4), float64: translations scaled by sc, the
    average camera taken to the identity, y and z flipped."""
    w2c = np.array(w2c, dtype=np.float64)
    w2c[:, :3, 3] *= sc
    c2w = average_w2c[None] @ np.linalg.inv(w2c)
    flip = np.diag([1.0, -1.0, -1.0])
    out = c2w.copy()
    out[:, :3, :3] = flip @ c2w[:, :3, :3] @ flip
    out[:, :3, 3] = c2w[:, :3, 3] @ flip
    return out


def training_frame(w2c: np.ndarray, bounds: np.ndarray, bd_factor: Optional[float],
                   recenter: bool) -> Dict[str, object]:
    """The training run's normalisation from its train views' extrinsics
    and depth bounds [near, far]: sc, the average pose, the c2w poses and
    the scaled bounds."""
    bounds = np.asarray(bounds, dtype=np.float64)
    sc = 1.0 / (float(bounds[0]) * bd_factor) if bd_factor is not None else 1.0
    scaled = np.array(w2c, dtype=np.float64)
    scaled[:, :3, 3] *= sc
    avg = average_pose_w2c(scaled) if recenter else np.eye(4)
    return {"sc": sc, "average_pose": avg, "poses": normalise_poses(w2c, sc, avg), "bounds": bounds * sc}


def pixel_rays(c2w: np.ndarray, intrinsic: np.ndarray, xs: np.ndarray, ys: np.ndarray):
    """Origins and directions (n, 3), float64, of the pixels (xs, ys) of one camera."""
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1).astype(np.float64)
    dirs = pix @ np.linalg.inv(np.asarray(intrinsic, np.float64)).T
    dirs = dirs * np.array([1.0, -1.0, -1.0])
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    return rays_o, rays_d


def ndc_rays(rays_o: np.ndarray, rays_d: np.ndarray, height: int, width: int, fx: float, fy: float, near: float):
    """LLFF's NDC: shift each origin to z = -near, then project."""
    t = -(near + rays_o[:, 2]) / rays_d[:, 2]
    o = rays_o + t[:, None] * rays_d
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = rays_d[:, 0], rays_d[:, 1], rays_d[:, 2]
    ax, ay = -2.0 * fx / width, -2.0 * fy / height
    o_ndc = np.stack([ax * ox / oz, ay * oy / oz, 1.0 + 2.0 * near / oz], -1)
    d_ndc = np.stack([ax * (dx / dz - ox / oz), ay * (dy / dz - oy / oz), -2.0 * near / oz], -1)
    return o_ndc, d_ndc


def ndc_to_metric_depth(z_ndc: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """NDC z' -> the metric t along the un-shifted ray (near = 1); z' = 1
    is taken a thousandth short of infinity."""
    oz, dz = rays_o[:, 2:3], rays_d[:, 2:3]
    tn = -(1.0 + oz) / dz
    eps = torch.where(z_ndc == 1.0, 1e-3, 0.0)
    return (oz + tn * dz) / dz * (1.0 / (1.0 - z_ndc + eps) - 1.0) + tn


def ndc_to_ray_t(z_ndc: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor) -> torch.Tensor:
    """NDC z' -> t along the un-shifted ray, for points seen from another
    view (a 1e-6 guard against z' = 1)."""
    oz, dz = rays_o[:, 2:3], rays_d[:, 2:3]
    tn = -(1.0 + oz) / dz
    return ((oz + tn * dz) / (1.0 - z_ndc + 1e-6) - oz) / dz
