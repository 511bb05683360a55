"""DTU database builder (counterpart of vipnerf_tpu/db_builders/dtu.py).

- `extract_pixelnerf_data`: pixelNeRF's rs_dtu_4 scans -> per scan
  rgb/{frame:04}.png and the cameras of `cameras.npz`: each world_mat
  decomposed (`decompose_world_mat`), the principal point put at the image
  centre, one focal length (the mean over the frames), the scale_mat
  normalisation applied to the translation.
- `extract_regnerf_masks`: RegNeRF's idrmasks -> ObjectMasks/{frame:04}.png,
  downsampled, for the masked QA metrics.
- `create_train_test_set`: the pixelNeRF protocols; sparse: train
  [25, 22, 28, 40, 44, 48, 0, 8, 13][:n], test the rest of 0..48,
  validation [24, 26]; dense: those nine are the test frames.

Host work only: the sources are PNGs and a numpy archive.

    python -m vipnerf_tpu_torch.db_builders.dtu --database_dirpath data/databases/DTU/data \\
        --rs_dtu_4_dirpath rs_dtu_4/DTU --idrmasks_dirpath idrmasks [--set_nums 1 2 3 4]
"""

import argparse
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from vipnerf_tpu_torch.utils.io import read_image, rescale_image, save_image, write_csv_columns

PIXELNERF_TEST_SCENES = [8, 21, 30, 31, 34, 38, 40, 41, 45, 55, 63, 82, 103, 110, 114]
PIXELNERF_FRAME_ORDER = [25, 22, 28, 40, 44, 48, 0, 8, 13]


def rq3(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """m = k @ r with k upper triangular, k[0, 0] > 0 and k[1, 1] > 0, and r
    a rotation (det +1): the decomposition OpenCV's RQDecomp3x3 returns
    (its Givens rotations have det +1, and it makes the first two diagonal
    entries positive; the last keeps its sign). Unique for a non-singular m."""
    flip = np.flipud(np.eye(3))
    q, r = np.linalg.qr((flip @ m).T)
    k = flip @ r.T @ flip
    rot = flip @ q.T
    d0, d1 = np.sign(k[0, 0]), np.sign(k[1, 1])
    d = np.diag([d0, d1, d0 * d1 * np.sign(np.linalg.det(rot))])
    return k @ d, d @ rot


def decompose_projection_matrix(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(camera matrix, rotation, camera centre as a homogeneous (4, 1)
    vector) of a 3x4 projection, as cv2.decomposeProjectionMatrix gives its
    first three: the RQ decomposition of p[:, :3], and p's null vector (a
    unit vector of either sign: only its ratios are defined)."""
    k, rot = rq3(p[:, :3])
    centre = np.linalg.svd(p)[2][3]
    return k, rot, centre[:, None]


def decompose_world_mat(world_mat: np.ndarray, resolution, scale_mat: Optional[np.ndarray] = None):
    """(intrinsic, w2c 4x4) from a 3x4 projection matrix."""
    intrinsic_raw, rot, trans = decompose_projection_matrix(world_mat[:3])
    intrinsic_raw = intrinsic_raw / intrinsic_raw[2, 2]
    intrinsic = np.eye(3)
    intrinsic[0, 0] = intrinsic_raw[0, 0]
    intrinsic[1, 1] = intrinsic_raw[1, 1]
    intrinsic[0, 2] = resolution[1] / 2
    intrinsic[1, 2] = resolution[0] / 2

    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, :3] = rot.T
    c2w[:3, 3] = (trans[:3] / trans[3])[:, 0]
    if scale_mat is not None:
        c2w[:3, 3:] -= scale_mat[:3, 3:]
        c2w[:3, 3:] /= np.diagonal(scale_mat[:3, :3])[..., None]
    return intrinsic, np.linalg.inv(c2w)


def extract_pixelnerf_data(unzipped_dirpath: Path, extracted_dirpath: Path):
    """rs_dtu_4 scans (scanNNN/image/*.png, cameras.npz) -> database layout."""
    for scene_dirpath in sorted(Path(unzipped_dirpath).iterdir()):
        if not scene_dirpath.is_dir():
            continue
        scene_num = int(scene_dirpath.stem[4:])  # 'scanNNN'
        num_frames = len(list((scene_dirpath / "image").iterdir()))
        scene_out = Path(extracted_dirpath) / f"{scene_num:05}"
        resolution = None
        for frame_num in range(num_frames):
            img = read_image(scene_dirpath / f"image/{frame_num:06}.png")
            if resolution is None:
                resolution = img.shape[:2]
            save_image(scene_out / f"rgb/{frame_num:04}.png", img)

        intrinsics, extrinsics = [], []
        with np.load((scene_dirpath / "cameras.npz").as_posix()) as cams:
            for frame_num in range(num_frames):
                intrinsic, w2c = decompose_world_mat(cams[f"world_mat_{frame_num}"], resolution,
                                                     cams.get(f"scale_mat_{frame_num}"))
                intrinsics.append(intrinsic)
                extrinsics.append(w2c)
        intrinsics = np.stack(intrinsics)
        focal = np.sum(intrinsics[:, 0, 0] + intrinsics[:, 1, 1]) / (2 * num_frames)  # one focal for the scan
        intrinsics[:, 0, 0] = focal
        intrinsics[:, 1, 1] = focal
        np.savetxt(scene_out / "CameraIntrinsics.csv", intrinsics.reshape(-1, 9), delimiter=",")
        np.savetxt(scene_out / "CameraExtrinsics.csv", np.stack(extrinsics).reshape(-1, 16), delimiter=",")


def extract_regnerf_masks(idrmasks_dirpath: Path, extracted_dirpath: Path, downsampling_factor: int = 4):
    """RegNeRF idrmasks (scanNNN/{frame:03}.png or scanNNN/mask/...) ->
    ObjectMasks/{frame:04}.png."""
    for scene_dirpath in sorted(Path(idrmasks_dirpath).iterdir()):
        if not scene_dirpath.is_dir():
            continue
        scene_num = int(scene_dirpath.stem[4:])
        frame_num = 0
        while True:
            src = scene_dirpath / f"{frame_num:03}.png"
            if not src.exists():
                src = scene_dirpath / f"mask/{frame_num:03}.png"
            if not src.exists():
                break
            mask = read_image(src)
            if mask.ndim == 3:
                mask = mask[..., 0]
            down = rescale_image((mask > 127).astype(np.float32), downsampling_factor, anti_aliasing=False)
            out = Path(extracted_dirpath) / f"{scene_num:05}/ObjectMasks/{frame_num:04}.png"
            save_image(out, ((down > 0.5) * 255).astype(np.uint8))
            frame_num += 1


def create_train_test_set(database_dirpath: Path, set_num: int, num_train_frames: int, *,
                          protocol: str = "sparse", scene_nums: Optional[List[int]] = None):
    """pixelNeRF-protocol splits."""
    scene_nums = scene_nums or PIXELNERF_TEST_SCENES
    if protocol == "sparse":
        train_frames = PIXELNERF_FRAME_ORDER[:num_train_frames]
        test_frames = [f for f in range(49) if f not in PIXELNERF_FRAME_ORDER]
        val_frames = [PIXELNERF_FRAME_ORDER[0] - 1, PIXELNERF_FRAME_ORDER[0] + 1]
    elif protocol == "dense":
        test_frames = PIXELNERF_FRAME_ORDER
        train_frames = [f for f in range(49) if f not in test_frames]
        val_frames = test_frames[:2]
    else:
        raise RuntimeError(f"Unknown protocol: {protocol}")

    set_dirpath = Path(database_dirpath) / f"train_test_sets/set{set_num:02}"
    set_dirpath.mkdir(parents=True, exist_ok=True)
    for name, frames in (("Train", train_frames), ("Test", test_frames), ("Validation", val_frames)):
        rows = [(s, f) for s in scene_nums for f in sorted(frames)]
        write_csv_columns(set_dirpath / f"{name}VideosData.csv",
                          {"scene_num": [r[0] for r in rows], "pred_frame_num": [r[1] for r in rows]})
    with open(set_dirpath / "Configs.json", "w") as f:
        json.dump({"creator": f"TrainTestCreator_PixelNeRF_{protocol}", "set_num": set_num,
                   "num_train_frames": num_train_frames}, f, indent=4)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.db_builders.dtu",
                                     description="DTU database builder")
    parser.add_argument("--database_dirpath", required=True)
    parser.add_argument("--rs_dtu_4_dirpath", default=None)
    parser.add_argument("--idrmasks_dirpath", default=None)
    parser.add_argument("--set_nums", type=int, nargs="*", default=[1, 2, 3, 4])
    parser.add_argument("--num_train_frames", type=int, nargs="*", default=[-1, 2, 3, 4])
    args = parser.parse_args(argv)

    db = Path(args.database_dirpath)
    if args.rs_dtu_4_dirpath:
        extract_pixelnerf_data(args.rs_dtu_4_dirpath, db / "all/database_data")
    if args.idrmasks_dirpath:
        extract_regnerf_masks(args.idrmasks_dirpath, db / "all/database_data")
    for set_num, n in zip(args.set_nums, args.num_train_frames):
        create_train_test_set(db, set_num, n, protocol="dense" if n == -1 else "sparse")


if __name__ == "__main__":
    main()
