"""Sparse-depth prior by external COLMAP triangulation with known poses
(counterpart of vipnerf_tpu/priors/sparse_depth.py).

Per scene: the train frames and a cameras.txt / images.txt of their known
intrinsics and extrinsics go to COLMAP (feature_extractor,
exhaustive_matcher, point_triangulator with the poses fixed,
model_converter); the binary model is read back. Per frame, the depth bounds
are the 0.5 / 99.5 percentiles of its points' camera z, and each feature in
bounds gives a row x, y, depth = r3^T (X - C), reprojection_error and
weight = 2 exp(-(error / mean error)^2). Outputs under
{split}/estimated_depths/DE{gen_num:02}/{scene}/: estimated_depths{suffix}/
{frame:04}.csv and EstimatedBounds.csv (near, far), written with the csv
module.

COLMAP stays an external CPU binary. Where it is absent (the GPU machine has
none) generation raises ColmapNotFoundError.

    python -m vipnerf_tpu_torch.priors.sparse_depth --database NeRF_LLFF --gen_nums 2
"""

import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from vipnerf_tpu_torch.priors import colmap_io
from vipnerf_tpu_torch.priors.visibility import save_gen_configs
from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, save_image, write_csv_columns
from vipnerf_tpu_torch.utils.naming import scene_dirname

DEPTH_COLUMNS = ("x", "y", "depth", "reprojection_error", "weight")


class ColmapNotFoundError(RuntimeError):
    pass


class ColmapTester:
    def __init__(self, tmp_dirpath: Path):
        self.tmp_dirpath = Path(tmp_dirpath)
        self.images_dirpath = self.tmp_dirpath / "images"
        self.db_path = self.tmp_dirpath / "database.db"
        self.sparse_dirpath = self.tmp_dirpath / "sparse/0"

    def _colmap(self, *args: str):
        if shutil.which("colmap") is None:
            raise ColmapNotFoundError(
                "COLMAP binary not found on PATH. Sparse-depth prior generation "
                "requires the external colmap tool."
            )
        subprocess.run(["colmap", *args], check=True)

    def clean_tmp_dir(self):
        if self.tmp_dirpath.exists():
            shutil.rmtree(self.tmp_dirpath)
        self.tmp_dirpath.mkdir(parents=True)

    def save_tmp_data(self, images: np.ndarray, intrinsics: np.ndarray):
        """Write the images, cameras.txt and an empty points3D.txt. All frames
        must share one intrinsic matrix."""
        for intrinsic in intrinsics:
            if not np.allclose(intrinsic, intrinsics[0]):
                raise ValueError("the sparse-depth prior needs one intrinsic matrix for all frames")
        intrinsic = intrinsics[0]
        camera_id = 1

        self.sparse_dirpath.mkdir(parents=True, exist_ok=True)
        for frame_num, image in enumerate(images):
            save_image(self.images_dirpath / f"{frame_num:04}.png", image)

        h, w = images[0].shape[:2]
        camera_line = (
            f"{camera_id} FULL_OPENCV {w} {h} "
            f"{intrinsic[0, 0]} {intrinsic[1, 1]} {intrinsic[0, 2]} "
            f"{intrinsic[1, 2]} 0 0 0 0 0 0 0 0 \n"
        )
        (self.sparse_dirpath / "cameras.txt").write_text(camera_line)
        (self.sparse_dirpath / "points3D.txt").touch()
        return {camera_id: intrinsic}

    def run_colmap(self, camera_data: Dict, extrinsics: np.ndarray):
        """feature_extractor -> the known camera parameters -> images.txt
        with the known poses -> exhaustive_matcher -> point_triangulator ->
        model_converter."""
        self._colmap(
            "feature_extractor",
            "--database_path", self.db_path.as_posix(),
            "--image_path", self.images_dirpath.as_posix(),
            "--ImageReader.single_camera", "1",
        )

        camera_id, intrinsic = next(iter(camera_data.items()))
        params = np.array([intrinsic[0, 0], intrinsic[1, 1], intrinsic[0, 2], intrinsic[1, 2]])
        colmap_io.update_camera_params(self.db_path, camera_id, params, model=6)

        lines: List[str] = []
        for frame_num, w2c in enumerate(extrinsics):
            q = colmap_io.rotmat2qvec(w2c[:3, :3])
            t = w2c[:3, 3]
            image_id = colmap_io.get_image_id_by_name(self.db_path, f"{frame_num:04}.png")
            q_str = " ".join(str(v) for v in q)
            t_str = " ".join(str(v) for v in t)
            lines.append(f"{image_id} {q_str} {t_str} {camera_id} {frame_num:04}.png\n")
            lines.append("\n")
        (self.sparse_dirpath / "images.txt").write_text("".join(lines))

        self._colmap("exhaustive_matcher", "--database_path", self.db_path.as_posix())
        self._colmap(
            "point_triangulator",
            "--database_path", self.db_path.as_posix(),
            "--image_path", self.images_dirpath.as_posix(),
            "--input_path", self.sparse_dirpath.as_posix(),
            "--output_path", self.sparse_dirpath.as_posix(),
            "--Mapper.tri_ignore_two_view_tracks", "0",
            "--Mapper.num_threads", "16",
            "--Mapper.init_min_tri_angle", "4",
            "--Mapper.multiple_models", "0",
            "--Mapper.extract_colors", "0",
        )
        self._colmap(
            "model_converter",
            "--input_path", self.sparse_dirpath.as_posix(),
            "--output_path", self.sparse_dirpath.as_posix(),
            "--output_type", "TXT",
        )

    def compute_colmap_depth(
        self,
    ) -> Tuple[Optional[List[Dict[str, np.ndarray]]], Optional[Dict[str, np.ndarray]]]:
        """Per-frame {x, y, depth, reprojection_error, weight} columns (frames
        in image-id order) and the {near, far} f32 bounds, or (None, None)
        without a model or points."""
        if not (self.sparse_dirpath / "images.bin").exists():
            return None, None
        images = colmap_io.read_images_binary(self.sparse_dirpath / "images.bin")
        points = colmap_io.read_points3d_binary(self.sparse_dirpath / "points3D.bin")
        if not points:
            return None, None

        errs = np.array([p.error for p in points.values()])
        err_mean = errs.mean()

        # depth along the camera z axis: z = r3^T (X - C) in the w2c frame
        poses = {}
        for i, im in images.items():
            w2c = np.eye(4)
            w2c[:3, :3] = im.qvec2rotmat()
            w2c[:3, 3] = im.tvec
            poses[i] = np.linalg.inv(w2c)

        per_image_z: Dict[int, List[float]] = {i: [] for i in images}
        for pt in points.values():
            for i in pt.image_ids:
                c2w = poses[int(i)]
                per_image_z[int(i)].append(c2w[:3, 2].T @ (pt.xyz - c2w[:3, 3]))
        bounds = []
        for i in sorted(images.keys()):
            zs = np.array(per_image_z[i])
            if zs.size == 0:
                return None, None
            bounds.append([np.percentile(zs, 0.5), np.percentile(zs, 99.5)])
        bds_raw = np.array(bounds, np.float32)

        depth_data_list = []
        for idx, image_id in enumerate(sorted(images.keys())):
            im = images[image_id]
            c2w = poses[image_id]
            rows = []
            for xy, pid in zip(im.xys, im.point3d_ids):
                if pid == -1:
                    continue
                pt = points[int(pid)]
                depth = c2w[:3, 2].T @ (pt.xyz - c2w[:3, 3])
                if depth < bds_raw[idx, 0] or depth > bds_raw[idx, 1]:
                    continue
                weight = 2 * np.exp(-((pt.error / err_mean) ** 2))
                rows.append([xy[0], xy[1], depth, pt.error, weight])
            table = np.array(rows, np.float64).reshape(-1, len(DEPTH_COLUMNS))
            depth_data_list.append({name: table[:, j] for j, name in enumerate(DEPTH_COLUMNS)})
        bounds_data = {"near": bds_raw[:, 0], "far": bds_raw[:, 1]}
        return depth_data_list, bounds_data

    def estimate_sparse_depth(self, images: np.ndarray, extrinsics: np.ndarray, intrinsics: np.ndarray):
        """The whole pipeline: temporary data, COLMAP, the model read back."""
        self.clean_tmp_dir()
        camera_data = self.save_tmp_data(images, intrinsics)
        self.run_colmap(camera_data, extrinsics)
        return self.compute_colmap_depth()


def start_generation(gen_configs: Dict, root_dirpath: Optional[Path] = None):
    """Generate the sparse-depth priors of every scene of a train set; a
    scene whose EstimatedBounds.csv exists is skipped."""
    root_dirpath = Path(root_dirpath) if root_dirpath else Path(".")
    database_dirpath = root_dirpath / "data/databases" / gen_configs["database_dirpath"]
    tmp_dirpath = root_dirpath / "tmp"

    scene_key = gen_configs.get("scene_key", "scene_name")
    split_dir = gen_configs.get("split_dir", "all")
    output_dirpath = database_dirpath / f"{split_dir}/estimated_depths/DE{gen_configs['gen_num']:02}"
    output_dirpath.mkdir(parents=True, exist_ok=True)
    save_gen_configs(output_dirpath, dict(gen_configs))

    set_num = gen_configs["gen_set_num"]
    video_data = read_csv_columns(database_dirpath / f"train_test_sets/set{set_num:02}/TrainVideosData.csv")
    suffix = gen_configs.get("resolution_suffix", "")

    tester = ColmapTester(tmp_dirpath)
    for scene_id in np.unique(video_data[scene_key]):
        scene_dir = scene_dirname(scene_id, scene_key)
        bounds_path = output_dirpath / f"{scene_dir}/EstimatedBounds.csv"
        if bounds_path.exists():
            continue
        frame_nums = video_data["pred_frame_num"][video_data[scene_key] == scene_id].astype(int)
        base = database_dirpath / f"{split_dir}/database_data/{scene_dir}"
        frames = np.stack([read_image(base / f"rgb{suffix}/{f:04}.png") for f in frame_nums])
        intrinsics = np.loadtxt((base / f"CameraIntrinsics{suffix}.csv").as_posix(), delimiter=",").reshape((-1, 3, 3))[frame_nums]
        extrinsics = np.loadtxt((base / "CameraExtrinsics.csv").as_posix(), delimiter=",").reshape((-1, 4, 4))[frame_nums]

        depth_data_list, bounds_data = tester.estimate_sparse_depth(frames, extrinsics, intrinsics)
        if depth_data_list is None:
            continue
        for i, frame_num in enumerate(frame_nums):
            depth_path = output_dirpath / f"{scene_dir}/estimated_depths{suffix}/{frame_num:04}.csv"
            depth_path.parent.mkdir(parents=True, exist_ok=True)
            write_csv_columns(depth_path, depth_data_list[i])
        bounds_path.parent.mkdir(parents=True, exist_ok=True)
        write_csv_columns(bounds_path, bounds_data)


if __name__ == "__main__":
    from vipnerf_tpu_torch.priors.cli import main_sparse_depth

    main_sparse_depth()
