"""Camera pose preprocessing on the host, in numpy (counterpart of
vipnerf_tpu/core/poses.py; spherify is not carried over, no shipped config
sets it).
"""

from typing import Dict, Optional

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


def preprocess_poses(
    poses_w2c: np.ndarray,
    *,
    train_mode: bool,
    bounds: Optional[np.ndarray] = None,
    bd_factor: Optional[float] = None,
    recenter: bool = True,
    translation_scale: Optional[float] = None,
    average_pose: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Scale, recenter and flip w2c extrinsics into c2w NeRF poses.

    Train mode computes sc = 1/(bounds.min()*bd_factor) and the average
    pose; test mode applies the stored translation_scale / average_pose of
    the train run's ModelConfigs.json. Returns poses (float32) and, in train
    mode, sc, bounds and average_pose.
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
    out["poses"] = poses.astype(np.float32)
    return out
