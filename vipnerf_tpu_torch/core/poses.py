"""Camera pose preprocessing on the host, in numpy (counterpart of
vipnerf_tpu/core/poses.py).
"""

from typing import Dict, Optional, Tuple

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def compute_average_pose(poses_w2c: np.ndarray) -> np.ndarray:
    """Average pose (as world2camera) of a set of w2c extrinsics."""
    rot = poses_w2c[:, :3, :3]
    rot_inv = np.transpose(rot, (0, 2, 1))
    trans = poses_w2c[:, :3, 3:]
    centers = -rot_inv @ trans
    avg_center = centers.mean(axis=0)[:, 0]

    vec2 = _normalize(rot_inv[:, :3, 2].sum(0))
    up = rot_inv[:, :3, 1].sum(0)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    m = np.stack([vec0, vec1, vec2, avg_center], axis=1)
    avg_c2w = np.concatenate([m, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    return np.linalg.inv(avg_c2w)


def recenter_poses(poses_w2c: np.ndarray, avg_pose_w2c: np.ndarray) -> np.ndarray:
    """avg_pose @ inv(w2c) -> recentered c2w poses."""
    return avg_pose_w2c[None] @ np.linalg.inv(poses_w2c)


def change_coordinate_system(poses: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Similarity transform of each pose: R' = P^T R P, t' = P t."""
    r = poses[:, :3, :3]
    t = poses[:, :3, 3:]
    rc = np.einsum("ab,nbc,cd->nad", p.T, r, p)
    tc = np.einsum("ab,nbc->nac", p, t)
    top = np.concatenate([rc, tc], axis=2)
    return np.concatenate([top, poses[:, 3:]], axis=1)


def convert_pose_to_standard_coordinates(poses: np.ndarray) -> np.ndarray:
    """Colmap/RE10K -> NeRF convention: flip y and z."""
    return change_coordinate_system(poses, np.diag([1.0, -1.0, -1.0]))


def spherify_poses(poses: np.ndarray, bds: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spherify c2w poses around the point closest to every optical axis,
    scaled to unit mean radius. Returns (poses (n, 3, 5): the spherified 3x4
    with pose 0's last column appended, as the LLFF code does; the 120 poses
    of a circular render path; the scaled bounds)."""
    def to_44(p):
        return np.concatenate([p, np.tile(np.eye(4)[-1].reshape(1, 1, 4), (p.shape[0], 1, 1))], axis=1)

    rays_d, rays_o = poses[:, :3, 2:3], poses[:, :3, 3:4]
    a_i = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b_i = -a_i @ rays_o
    center = np.squeeze(-np.linalg.inv((np.transpose(a_i, (0, 2, 1)) @ a_i).mean(0)) @ b_i.mean(0))
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    poses_reset = np.linalg.inv(to_44(c2w[None])) @ to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    zh = np.mean(poses_reset[:, :3, 3], 0)[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, np.array([0.0, 0.0, -1.0])))
        vec1 = _normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)
    last = poses[0, :3, -1:]
    new_poses = np.concatenate([new_poses, np.broadcast_to(last, new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate([poses_reset[:, :3, :4], np.broadcast_to(last, poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds


def preprocess_poses(
    poses_w2c: np.ndarray,
    *,
    train_mode: bool,
    bounds: Optional[np.ndarray] = None,
    bd_factor: Optional[float] = None,
    recenter: bool = True,
    spherify: bool = False,
    translation_scale: Optional[float] = None,
    average_pose: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Scale, recenter and flip w2c extrinsics into c2w NeRF poses.

    Train mode computes sc = 1/(bounds.min()*bd_factor) and the average
    pose; test mode applies the stored translation_scale / average_pose of
    the train run's ModelConfigs.json; `spherify` then spherifies the poses
    and bounds. Returns poses (float32) and, in train mode, sc, bounds and
    average_pose.
    """
    poses = poses_w2c.astype(np.float64).copy()
    out: Dict[str, np.ndarray] = {}
    if train_mode:
        if bounds is not None:
            bds = np.asarray(bounds, dtype=np.float64).copy()
            sc = 1.0 / (float(bds[0]) * bd_factor) if bd_factor is not None else 1.0
            poses[:, :3, 3] *= sc
            out["sc"] = sc
            out["bounds"] = bds * sc
        avg_pose = compute_average_pose(poses) if recenter else np.eye(4)
        out["average_pose"] = avg_pose
    else:
        if average_pose is None:
            raise ValueError(
                "test mode requires the average_pose stored in the train "
                "run's model configs"
            )
        sc = translation_scale if translation_scale is not None else 1.0
        poses[:, :3, 3] *= sc
        if bounds is not None:
            out["bounds"] = np.asarray(bounds, dtype=np.float64) * sc
        avg_pose = average_pose

    poses = recenter_poses(poses, avg_pose)
    poses = convert_pose_to_standard_coordinates(poses)
    if spherify:
        if "bounds" not in out:
            raise ValueError("spherify requires depth bounds")
        poses, _, out["bounds"] = spherify_poses(poses, out["bounds"])
    out["poses"] = poses.astype(np.float32)
    return out
