"""Test-mode data preprocessing: full-image ray batches for a pose, and the
reshaping of rendered rays into image-shaped outputs (counterpart of the
test-mode half of vipnerf_tpu/data/preprocessor.py).

Train and validation modes (ray cache, sparse-depth and prior caches, index
streams, batch gather) arrive with the training slice of the port.
"""

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.core import poses as pose_ops
from vipnerf_tpu_torch.core import rays as ray_ops


def get_data_preprocessor(
    configs, mode, raw_data_dict=None, model_configs=None, device=None
):
    """Factory; the one implementation answers to 'DataPreprocessor01'."""
    name = configs["data_loader"]["data_preprocessor_name"]
    if name != "DataPreprocessor01":
        raise RuntimeError(f"Unknown data preprocessor: {name}")
    return DataPreprocessor(configs, mode, raw_data_dict, model_configs, device)


class DataPreprocessor:
    def __init__(
        self,
        configs: Dict[str, Any],
        mode: str,
        raw_data_dict: Optional[dict] = None,
        model_configs: Optional[dict] = None,
        device: Optional[torch.device] = None,
    ):
        self.mode = mode.lower()
        if self.mode != "test":
            raise NotImplementedError(
                f"mode {mode!r}: the train and validation preprocessor arrives "
                "with the training slice of the port; only 'test' is ported"
            )
        self.configs = configs
        self.ndc = configs["data_loader"]["ndc"]
        self.mip_nerf_used = "mip_nerf" in configs["data_loader"]
        self.model_configs = model_configs
        self.device = torch.device("cpu") if device is None else torch.device(device)

    def _ray_intrinsic(self, intr: np.ndarray) -> np.ndarray:
        """mip-NeRF casts rays through pixel centres: a -0.5 principal-point shift."""
        if not self.mip_nerf_used:
            return np.asarray(intr)
        intr = np.asarray(intr).copy()
        intr[..., 0, 2] -= 0.5
        intr[..., 1, 2] -= 0.5
        return intr

    def _prep_pose(self, pose: np.ndarray, preprocess_pose: bool) -> np.ndarray:
        if not preprocess_pose:
            return pose.astype(np.float32)
        mc = self.model_configs
        return pose_ops.preprocess_poses(
            pose[None],
            train_mode=False,
            translation_scale=mc["translation_scale"],
            average_pose=np.asarray(mc["average_pose"]),
        )["poses"][0]

    def _rays(self, h, w, intrinsic, pose):
        return ray_ops.get_rays(
            h, w,
            torch.as_tensor(self._ray_intrinsic(intrinsic).astype(np.float32)),
            torch.as_tensor(pose, device=self.device),
        )

    def create_test_data(
        self,
        pose: np.ndarray,
        view_pose: Optional[np.ndarray] = None,
        secondary_poses: Optional[List[np.ndarray]] = None,
        preprocess_pose: bool = True,
        intrinsic: Optional[np.ndarray] = None,
        view_intrinsic: Optional[np.ndarray] = None,
        secondary_intrinsics: Optional[List[np.ndarray]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Full-image ray batch (h*w rays, scanline order) for a w2c pose, on
        the preprocessor's device. Secondary poses give `rays_o2`, the other
        cameras' centres per ray (their intrinsics do not move a centre)."""
        mc = self.model_configs
        h, w = mc["resolution"]
        if intrinsic is None:
            intrinsic = np.array(mc["intrinsic"])
        intrinsic = np.asarray(intrinsic, dtype=np.float32)

        rays_o, rays_d = self._rays(h, w, intrinsic, self._prep_pose(pose.copy(), preprocess_pose))
        if view_pose is not None:
            vi = np.array(mc["intrinsic"]) if view_intrinsic is None else view_intrinsic
            _, view_rays_d = self._rays(
                h, w, np.asarray(vi, np.float32), self._prep_pose(view_pose.copy(), preprocess_pose)
            )
            view_dirs = ray_ops.get_view_dirs(view_rays_d)
        else:
            view_dirs = ray_ops.get_view_dirs(rays_d)

        nr = h * w
        full = lambda v: torch.full((nr, 1), float(v), device=self.device)  # noqa: E731
        batch = {
            "rays_o": rays_o.reshape(-1, 3),
            "rays_d": rays_d.reshape(-1, 3),
            "view_dirs": view_dirs.reshape(-1, 3),
            "near": full(mc["near"]),
            "far": full(mc["far"]),
        }
        if self.ndc:
            o_ndc, d_ndc = ray_ops.get_ndc_rays(
                rays_o, rays_d, h, w, float(intrinsic[0, 0]), float(intrinsic[1, 1]),
                mc["near"],
            )
            batch["rays_o_ndc"] = o_ndc.reshape(-1, 3)
            batch["rays_d_ndc"] = d_ndc.reshape(-1, 3)
            batch["near_ndc"] = full(mc["near_ndc"])
            batch["far_ndc"] = full(mc["far_ndc"])

        if secondary_poses is not None:
            centres = [
                torch.as_tensor(self._prep_pose(p.copy(), preprocess_pose)[:3, 3],
                                device=self.device)
                for p in secondary_poses
            ]
            batch["rays_o2"] = torch.stack(centres)[None].expand(nr, -1, -1).contiguous()
        return batch

    def retrieve_inference_outputs(self, outputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Fine (else coarse) outputs reshaped to the image and post-processed."""
        h, w = self.model_configs["resolution"]
        if "fine_mlp" in self.configs["model"]:
            suffix = "_fine"
        elif "coarse_mlp" in self.configs["model"]:
            suffix = "_coarse"
        else:
            raise RuntimeError("no mlp configured")
        np_out = {
            k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in outputs.items()
        }
        result = {
            "image": self.post_process_image(np_out[f"rgb{suffix}"].reshape(h, w, 3)),
            "depth": self.post_process_depth(np_out[f"depth{suffix}"].reshape(h, w)),
            "depth_var": self.post_process_depth(np_out[f"depth_var{suffix}"].reshape(h, w)),
        }
        if self.ndc:
            result["depth_ndc"] = self.post_process_depth(
                np_out[f"depth_ndc{suffix}"].reshape(h, w)
            )
            result["depth_var_ndc"] = self.post_process_depth(
                np_out[f"depth_var_ndc{suffix}"].reshape(h, w)
            )
        if f"visibility2{suffix}" in np_out:
            vis2 = np_out[f"visibility2{suffix}"].reshape(h, w, -1)
            result["visibility2"] = vis2.transpose(2, 0, 1).astype(np.float32)
        return result

    @staticmethod
    def post_process_image(rgb: np.ndarray) -> np.ndarray:
        return np.round(np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)

    @staticmethod
    def post_process_depth(depth: np.ndarray) -> np.ndarray:
        return np.clip(depth, 0.0, np.inf).astype(np.float32)
