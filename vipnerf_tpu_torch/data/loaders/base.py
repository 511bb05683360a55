"""Dataset loaders for the ViP-NeRF on-disk database layout (a copy of
vipnerf_tpu/data/loaders/base.py that reads CSVs with the standard library
and PNGs with the port's own decoder).

On-disk contract per scene:
- train_test_sets/set{NN}/{Train,Validation,Test}VideosData.csv
  (columns: scene_name|scene_num, pred_frame_num)
- {split_dir}/database_data/{scene}/rgb{suffix}/{frame:04}.png
- .../CameraExtrinsics.csv          (rows of flattened 4x4 w2c)
- .../CameraIntrinsics{suffix}.csv  (rows of flattened 3x3)
- .../DepthBounds.csv               (per-frame [near, far]; LLFF only)
- {split_dir}/estimated_depths/{dirname}/{scene}/estimated_depths{suffix}/{frame:04}.csv
  (columns x, y, depth, reprojection_error[, weight])
- {split_dir}/visibility_prior/{masks_dirname}/{scene}/visibility_masks/{f1:04}_{f2:04}.png
  and .../visibility_weights/{f1:04}_{f2:04}.npy
"""

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, read_mask
from vipnerf_tpu_torch.utils.naming import scene_dirname


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Per-dataset path and format policy."""

    name: str
    split_dir: str  # 'all' (LLFF/DTU) or 'test' (RealEstate)
    scene_key: str  # CSV column: 'scene_name' or 'scene_num'
    scene_id_is_num: bool  # scene dir is {num:05}
    use_resolution_suffix: bool  # LLFF rgb_down4 / intrinsics suffix
    fixed_bounds: Optional[np.ndarray]  # None -> read DepthBounds.csv
    tolerate_missing_sparse_depth: bool  # DTU skips absent CSVs


NERF_LLFF_SPEC = DatasetSpec("NeRF_LLFF", "all", "scene_name", False, True, None, False)
REAL_ESTATE_SPEC = DatasetSpec(
    "RealEstate10K", "test", "scene_num", True, False, np.array([1.0, 100.0], np.float32), False,
)
DTU_SPEC = DatasetSpec("DTU", "all", "scene_num", True, False, np.array([0.1, 5.0], np.float32), True)


class DataLoader:
    """Loads one scene's raw data dict."""

    def __init__(self, spec: DatasetSpec, configs: dict, data_dirpath, mode: Optional[str]):
        self.spec = spec
        self.configs = configs
        self.data_dirpath = Path(data_dirpath)
        self.mode = mode
        dl = configs["data_loader"]
        scene_id = dl["scene_id"]
        if spec.scene_id_is_num:
            self.scene_num = int(scene_id)
            self.scene_dirname = scene_dirname(self.scene_num, "scene_num")
        else:
            self.scene_dirname = str(scene_id)
        self.resolution_suffix = dl.get("resolution_suffix", "") if spec.use_resolution_suffix else ""
        self.sparse_depth_needed = "sparse_depth" in dl
        self.dense_depth_needed = "dense_depth" in dl
        self.visibility_prior_needed = "visibility_prior" in dl

    def _scene_dir(self) -> Path:
        return self.data_dirpath / f"{self.spec.split_dir}/database_data/{self.scene_dirname}"

    def _prior_dir(self, kind: str, dirname: str) -> Path:
        return self.data_dirpath / f"{self.spec.split_dir}/{kind}/{dirname}/{self.scene_dirname}"

    def load_data(self) -> dict:
        frame_nums = self.get_frame_nums()
        data_dict = {"frame_nums": frame_nums, "nerf_data": self.load_nerf_data(frame_nums)}
        if self.mode == "train":
            if self.sparse_depth_needed:
                data_dict["sparse_depth_data"] = self.load_sparse_depth_data(frame_nums)
            if self.dense_depth_needed:
                data_dict["dense_depth_data"] = self.load_dense_depth_data(frame_nums)
            if self.visibility_prior_needed:
                data_dict["visibility_prior_data"] = self.load_visibility_prior_data(frame_nums)
        return data_dict

    def get_frame_nums(self) -> np.ndarray:
        set_num = self.configs["data_loader"]["train_set_num"]
        path = self.data_dirpath / (
            f"train_test_sets/set{set_num:02}/{self.mode.capitalize()}VideosData.csv"
        )
        video_data = read_csv_columns(path)
        if self.spec.scene_key == "scene_name":
            sel = video_data["scene_name"].astype(str) == self.scene_dirname
        else:
            sel = video_data["scene_num"].astype(int) == self.scene_num
        return video_data["pred_frame_num"][sel].astype(int)

    def load_nerf_data(self, frame_nums: np.ndarray) -> dict:
        scene_dir = self._scene_dir()
        images_dir = scene_dir / f"rgb{self.resolution_suffix}"
        images = np.stack([read_image(images_dir / f"{f:04}.png") for f in frame_nums])
        if self.spec.fixed_bounds is not None:
            bounds = self.spec.fixed_bounds.copy()
        else:
            bds = np.loadtxt((scene_dir / "DepthBounds.csv").as_posix(), delimiter=",")[frame_nums]
            bounds = np.array([bds.min(), bds.max()])
        extrinsics = np.loadtxt(
            (scene_dir / "CameraExtrinsics.csv").as_posix(), delimiter=","
        ).reshape((-1, 4, 4))[frame_nums]
        intrinsics = np.loadtxt(
            (scene_dir / f"CameraIntrinsics{self.resolution_suffix}.csv").as_posix(), delimiter=","
        ).reshape((-1, 3, 3))[frame_nums]
        h, w = images.shape[1:3]
        return {
            "images": images,
            "extrinsics": extrinsics,
            "intrinsics": intrinsics,
            "resolution": (h, w),
            "bounds": bounds,
        }

    def load_sparse_depth_data(self, frame_nums: np.ndarray) -> Dict[int, Dict[str, np.ndarray]]:
        """{frame: {column: array}} of each frame's sparse-depth CSV."""
        base = self._prior_dir("estimated_depths", self.configs["data_loader"]["sparse_depth"]["dirname"])
        out = {}
        for f in frame_nums:
            path = base / f"estimated_depths{self.resolution_suffix}/{f:04}.csv"
            if self.spec.tolerate_missing_sparse_depth and not path.exists():
                continue
            out[int(f)] = read_csv_columns(path)
        return out

    def load_dense_depth_data(self, frame_nums: np.ndarray) -> dict:
        dl = self.configs["data_loader"]["dense_depth"]
        base = self._prior_dir("estimated_depths", dl["dirname"])
        weights_suffix = dl.get("weights_suffix", "")
        depths, weights = [], []
        for f in frame_nums:
            depth = np.load((base / f"estimated_depths{self.resolution_suffix}/{f:04}.npy").as_posix())
            depths.append(depth)
            wpath = base / f"Weights{self.resolution_suffix}{weights_suffix}/{f:04}.npy"
            weights.append(np.load(wpath.as_posix()) if wpath.exists() else np.ones_like(depth))
        return {"depth_values": np.stack(depths), "depth_weights": np.stack(weights)}

    def load_visibility_prior_data(self, frame_nums: np.ndarray) -> dict:
        vp = self.configs["data_loader"]["visibility_prior"]
        out = {}
        if vp.get("load_masks"):
            base = self._prior_dir("visibility_prior", vp["masks_dirname"])
            out["masks"] = np.array([
                [read_mask(base / f"visibility_masks/{f1:04}_{f2:04}.png") for f2 in frame_nums if f2 != f1]
                for f1 in frame_nums
            ])  # (n, n-1, h, w)
        if vp.get("load_weights"):
            base = self._prior_dir("visibility_prior", vp["weights_dirname"])
            out["weights"] = np.array([
                [np.load((base / f"visibility_weights/{f1:04}_{f2:04}.npy").as_posix())
                 for f2 in frame_nums if f2 != f1]
                for f1 in frame_nums
            ])  # (n, n-1, h, w)
        return out
