"""NeRF-LLFF database builder (counterpart of vipnerf_tpu/db_builders/nerf_llff.py).

- `unzip_data` + `extract_scene_data`: nerf_llff_data.zip -> per scene
  rgb/, rgb_down4/, rgb_down8/ (PNG), CameraExtrinsics.csv (flattened w2c
  4x4), CameraIntrinsics{,_down4,_down8}.csv, DepthBounds.csv (cols 15:17 of
  poses_bounds.npy), FrameNamesMapping.csv; the COLMAP model is read by the
  port's `priors/colmap_io.py`. The full-size source frames (images/*.JPG)
  are decoded by nvJPEG on the card: extraction takes a `device` and
  raises without CUDA unless asked for the CPU, where a JPEG raises.
- `create_train_test_set`: every 8th frame is a test frame, n uniformly
  spaced train frames among the rest, the middle test frame validates.
- `create_video_poses` / `create_spiral_video_poses`: the LLFF spiral render
  path, written as w2c extrinsics with the average pose first.

    python -m vipnerf_tpu_torch.db_builders.nerf_llff --database_dirpath data/databases/NeRF_LLFF/data \\
        --zip_filepath nerf_llff_data.zip [--set_nums 1 2 3 4] [--video_poses] [--device cpu]
"""

import argparse
import json
import shutil
from pathlib import Path
from typing import Optional
from zipfile import ZipFile

import numpy as np

from vipnerf_tpu_torch.core.poses import change_coordinate_system, compute_average_pose
from vipnerf_tpu_torch.priors import colmap_io
from vipnerf_tpu_torch.utils.device import device_from_arg, resolve_device
from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, save_image, write_csv_columns


def unzip_data(zip_filepath: Path, database_data_dirpath: Path):
    database_data_dirpath.parent.mkdir(parents=True, exist_ok=True)
    with ZipFile(zip_filepath, "r") as zf:
        zf.extractall(database_data_dirpath.parent)
    shutil.move(database_data_dirpath.parent / "nerf_llff_data", database_data_dirpath)


def extract_scene_data(scene_dirpath: Path, device="all"):
    """One scene: COLMAP model + image pyramids -> database layout. `device`
    ("all", a GPU index list or "cpu") decodes the JPEG source frames."""
    dev = resolve_device(device)
    scene_dirpath = Path(scene_dirpath)
    cams = colmap_io.read_cameras_binary(scene_dirpath / "sparse/0/cameras.bin")
    images = colmap_io.read_images_binary(scene_dirpath / "sparse/0/images.bin")
    bounds = np.load((scene_dirpath / "poses_bounds.npy").as_posix())[:, 15:17]

    down = {f: sorted(p for p in (scene_dirpath / f"images_{f}").iterdir() if p.is_file()) for f in (4, 8)}
    old_names, new_nums, intrinsics, extrinsics, bds = [], [], [], [], []
    for frame_num, key in enumerate(images):
        im = images[key]
        cam = cams[im.camera_id]
        intrinsic = np.eye(3)
        intrinsic[0, 0] = intrinsic[1, 1] = cam.params[0]
        intrinsic[0, 2] = cam.width / 2
        intrinsic[1, 2] = cam.height / 2
        extrinsic = np.eye(4)
        extrinsic[:3, :3] = im.qvec2rotmat()
        extrinsic[:3, 3] = im.tvec

        old_names.append(Path(im.name).stem)
        new_nums.append(frame_num)
        intrinsics.append(intrinsic.ravel())
        extrinsics.append(extrinsic.ravel())
        bds.append(bounds[frame_num])

        src = next(scene_dirpath.glob(f"images/{Path(im.name).stem}.*"))
        save_image(scene_dirpath / f"rgb/{frame_num:04}.png", read_image(src, dev))
        for f in (4, 8):
            save_image(scene_dirpath / f"rgb_down{f}/{frame_num:04}.png", read_image(down[f][frame_num], dev))

    write_csv_columns(scene_dirpath / "FrameNamesMapping.csv", {"OldFrameName": old_names, "NewFrameNum": new_nums})
    intr = np.stack(intrinsics)
    np.savetxt(scene_dirpath / "CameraIntrinsics.csv", intr, delimiter=",")
    for factor in (4, 8):
        scaled = intr.copy()
        scaled[:, [0, 4, 2, 5]] /= factor  # fx, fy, cx, cy of the flattened 3x3
        np.savetxt(scene_dirpath / f"CameraIntrinsics_down{factor}.csv", scaled, delimiter=",")
    np.savetxt(scene_dirpath / "CameraExtrinsics.csv", np.stack(extrinsics), delimiter=",")
    np.savetxt(scene_dirpath / "DepthBounds.csv", np.stack(bds), delimiter=",")


def extract_data(database_data_dirpath: Path, device="all"):
    for scene_dirpath in sorted(Path(database_data_dirpath).iterdir()):
        if scene_dirpath.is_dir():
            extract_scene_data(scene_dirpath, device)


# ------------------------------------------------------- train/test creator

def sample_sparse_train_frames(frame_nums, num_frames: int):
    """n uniformly spaced frames; -1 keeps them all."""
    if num_frames == -1:
        return np.asarray(frame_nums)
    idx = np.round(np.linspace(-1, len(frame_nums), num_frames + 2)).astype(int)
    return np.asarray(frame_nums)[idx[1:-1]]


def create_train_test_set(database_dirpath: Path, set_num: int, num_train_frames: int):
    """Every-8th test split + sparse train sampling."""
    database_dirpath = Path(database_dirpath)
    set_dirpath = database_dirpath / f"train_test_sets/set{set_num:02}"
    set_dirpath.mkdir(parents=True, exist_ok=True)

    scenes_dirpath = database_dirpath / "all/database_data"
    scene_names = sorted(p.stem for p in scenes_dirpath.iterdir() if p.is_dir())
    splits = {"Train": [], "Validation": [], "Test": []}
    for scene_name in scene_names:
        frame_nums = sorted(int(p.stem) for p in (scenes_dirpath / f"{scene_name}/rgb").iterdir())
        test_frames = list(range(0, len(frame_nums), 8))
        train_candidates = sorted(set(frame_nums) - set(test_frames))
        train_frames = sample_sparse_train_frames(train_candidates, num_train_frames)
        splits["Train"] += [(scene_name, int(f)) for f in train_frames]
        splits["Test"] += [(scene_name, int(f)) for f in test_frames]
        splits["Validation"].append((scene_name, int(test_frames[len(test_frames) // 2])))
    for name, rows in splits.items():
        write_csv_columns(set_dirpath / f"{name}VideosData.csv",
                          {"scene_name": [r[0] for r in rows], "pred_frame_num": [r[1] for r in rows]})
    with open(set_dirpath / "Configs.json", "w") as f:
        json.dump({"creator": "TrainTestCreator01_UniformSparseSampling", "set_num": set_num,
                   "num_train_frames": num_train_frames}, f, indent=4)


# ----------------------------------------------------------- spiral video

def _normalize(x):
    return x / np.linalg.norm(x)


def _view_matrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def _poses_avg(poses):
    center = poses[:, :3, 3].mean(0)
    m = _view_matrix(_normalize(poses[:, :3, 2].sum(0)), poses[:, :3, 1].sum(0), center)
    return np.concatenate([m, np.array([[0, 0, 0, 1.0]])], axis=0)


def render_path_spiral(c2w, up, rads, focal, zrate, rots, n):
    """The LLFF helix of n poses around `c2w`."""
    rads = np.array(list(rads) + [1.0])
    poses = []
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        poses.append(np.concatenate([_view_matrix(z, up, c), np.array([[0, 0, 0, 1.0]])], axis=0))
    return poses


def create_video_poses(w2c_mats: np.ndarray, num_frames: int, num_rotations: int, bds: np.ndarray,
                       bd_factor: Optional[float]):
    """The spiral in the original (COLMAP) convention: to recentered NeRF
    c2w poses, scaled, the helix, then every step undone, so the result is
    w2c extrinsics the tester takes as they are; the average pose first."""
    avg_pose = compute_average_pose(w2c_mats.copy())
    flip = np.diag([1.0, -1.0, -1.0])
    c2w_nerf = change_coordinate_system(avg_pose[None] @ np.linalg.inv(w2c_mats), flip)

    bds = np.asarray(bds, np.float64).copy()
    sc = 1.0 if bd_factor is None else 1.0 / (float(bds.min()) * bd_factor)
    c2w_nerf[:, :3, 3] *= sc
    bds *= sc

    c2w_avg = _poses_avg(c2w_nerf)
    up = _normalize(c2w_nerf[:, :3, 1].sum(0))
    close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    rads = np.percentile(np.abs(c2w_nerf[:, :3, 3]), 90, axis=0)
    render_c2w = np.stack(render_path_spiral(c2w_avg, up, rads, focal, zrate=0.5, rots=num_rotations,
                                             n=num_frames))

    cv_poses = change_coordinate_system(render_c2w, flip)
    video_w2c = np.linalg.inv(np.linalg.inv(avg_pose)[None] @ cv_poses)
    video_w2c[:, :3, 3] /= sc
    return np.concatenate([_poses_avg(video_w2c)[None], video_w2c], axis=0)


def create_spiral_video_poses(database_dirpath: Path, set_num: int, num_frames: int = 120,
                              num_rotations: int = 2, bd_factor: Optional[float] = 0.75, video_num: int = 1):
    """video_poses{NN}/{scene}.csv + VideoFrameNums.csv for each scene of
    the set's train split."""
    database_dirpath = Path(database_dirpath)
    set_dirpath = database_dirpath / f"train_test_sets/set{set_num:02}"
    out = set_dirpath / f"video_poses{video_num:02}"
    out.mkdir(parents=True, exist_ok=True)
    train_data = read_csv_columns(set_dirpath / "TrainVideosData.csv")
    for scene_name in np.unique(train_data["scene_name"]):
        base = database_dirpath / f"all/database_data/{scene_name}"
        w2c = np.loadtxt((base / "CameraExtrinsics.csv").as_posix(), delimiter=",").reshape(-1, 4, 4)
        bds = np.loadtxt((base / "DepthBounds.csv").as_posix(), delimiter=",")
        poses = create_video_poses(w2c, num_frames, num_rotations, bds, bd_factor)
        np.savetxt(out / f"{scene_name}.csv", poses.reshape(poses.shape[0], -1), delimiter=",")
    np.savetxt(out / "VideoFrameNums.csv", np.arange(num_frames), fmt="%i", delimiter=",")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.db_builders.nerf_llff",
                                     description="NeRF-LLFF database builder")
    parser.add_argument("--database_dirpath", required=True)
    parser.add_argument("--zip_filepath", default=None)
    parser.add_argument("--set_nums", type=int, nargs="*", default=[1, 2, 3, 4])
    parser.add_argument("--num_train_frames", type=int, nargs="*", default=[-1, 2, 3, 4])
    parser.add_argument("--video_poses", action="store_true")
    parser.add_argument("--device", default="all",
                        help='where the JPEG source frames decode: "all" (the first GPU), a GPU index, or "cpu"')
    args = parser.parse_args(argv)

    db = Path(args.database_dirpath)
    if args.zip_filepath:
        unzip_data(Path(args.zip_filepath), db / "all/database_data")
        extract_data(db / "all/database_data", device_from_arg(args.device))
    for set_num, n in zip(args.set_nums, args.num_train_frames):
        create_train_test_set(db, set_num, n)
        if args.video_poses:
            create_spiral_video_poses(db, set_num)


if __name__ == "__main__":
    main()
