"""RealEstate-10K database builder (counterpart of vipnerf_tpu/db_builders/real_estate.py).

- `parse_camera_file`, `compute_intrinsic_matrices` (normalised fx fy px py
  scaled by the resolution), `compute_extrinsic_matrices` (3x4 w2c padded
  to 4x4), `map_video_names` (video hash -> scene number).
- `extract_scene`: the window of a scene (from the camera-file line whose
  timestamp is the curated `start_timestamp`, `num_frames` lines strided by
  `step_size`), its cameras, and its frames resized to `resolution` with
  INTER_AREA (`utils/io.py` `resize_image`). The frames come from the
  caller or from the video through the ffmpeg tool, one call per frame at
  its timestamp, as the reference extracted them; without ffmpeg this
  raises `FfmpegNotFoundError`.
- `create_train_test_set`: sparse train frames [10, 20, 30, 0, 40][:n],
  test the rest of 0..49 without all five, validation 3 test frames; dense:
  every 5th frame is a test frame.
- `create_original_video_poses`: the original trajectory as the video path.
- `select_scenes`: the motion-based curation of the reference's
  SceneSelector01.

    python -m vipnerf_tpu_torch.db_builders.real_estate --database_dirpath data/databases/RealEstate10K/data \\
        --camera_files_dirpath RealEstate10K/test --videos_dirpath videos [--scene_nums 0 1 2]
"""

import argparse
import json
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vipnerf_tpu_torch.priors.visibility import save_gen_configs
from vipnerf_tpu_torch.utils.io import read_csv_columns, resize_image, save_image, write_csv_columns


class FfmpegNotFoundError(RuntimeError):
    pass


def parse_camera_file(path: Path) -> Dict[str, np.ndarray]:
    """A camera file: the video URL, then per frame
    `timestamp fx fy px py k1 k2 r11..r34` (19 numbers after the timestamp)."""
    lines = Path(path).read_text().strip().splitlines()
    rows = np.array([[float(x) for x in line.split()] for line in lines[1:]])
    return {
        "url": lines[0].strip(),
        "timestamps": rows[:, 0].astype(np.int64),
        "intrinsics_norm": rows[:, 1:5],
        "poses_3x4": rows[:, 7:19].reshape(-1, 3, 4),
    }


def compute_intrinsic_matrices(intrinsics_norm: np.ndarray, resolution) -> np.ndarray:
    """Normalised (fx, fy, px, py) -> pixel-space 3x3."""
    h, w = resolution
    out = np.zeros((intrinsics_norm.shape[0], 3, 3), np.float32)
    out[:, 0, 0] = w * intrinsics_norm[:, 0]
    out[:, 1, 1] = h * intrinsics_norm[:, 1]
    out[:, 0, 2] = w * intrinsics_norm[:, 2]
    out[:, 1, 2] = h * intrinsics_norm[:, 3]
    out[:, 2, 2] = 1
    return out


def compute_extrinsic_matrices(poses_3x4: np.ndarray) -> np.ndarray:
    """3x4 w2c -> 4x4."""
    bottom = np.zeros((poses_3x4.shape[0], 1, 4), poses_3x4.dtype)
    bottom[:, 0, 3] = 1
    return np.concatenate([poses_3x4, bottom], axis=1)


def map_video_names(camera_files_dirpath: Path, output_path: Path):
    """Video hash -> scene number, in sorted order of the camera files."""
    names = sorted(p.stem for p in Path(camera_files_dirpath).glob("*.txt"))
    write_csv_columns(output_path, {"VideoName": names, "SceneNum": list(range(len(names)))})


def _ffmpeg_tools():
    tools = {name: shutil.which(name) for name in ("ffmpeg", "ffprobe")}
    missing = [name for name, path in tools.items() if path is None]
    if missing:
        raise FfmpegNotFoundError(
            f"{' and '.join(missing)} not found on PATH. Extracting RealEstate-10K frames from a video "
            "requires the external ffmpeg tool; or pass the decoded frames to extract_scene")
    return tools["ffmpeg"], tools["ffprobe"]


def extract_frames_from_video(video_path: Path, timestamps_us: np.ndarray) -> Optional[np.ndarray]:
    """The frame at each (microsecond) timestamp, (t, h, w, 3) uint8 RGB, one
    ffmpeg call per frame seeking to the timestamp; None where the video
    cannot be read or a frame is missing, as the JAX package returns."""
    ffmpeg, ffprobe = _ffmpeg_tools()
    probe = subprocess.run([ffprobe, "-v", "error", "-select_streams", "v:0", "-show_entries",
                            "stream=width,height", "-of", "csv=p=0", str(video_path)],
                           capture_output=True, text=True)
    if probe.returncode != 0 or not probe.stdout.strip():
        return None
    w, h = (int(x) for x in probe.stdout.strip().splitlines()[0].split(",")[:2])
    frames = []
    for ts in timestamps_us:
        res = subprocess.run([ffmpeg, "-nostdin", "-loglevel", "error", "-ss", f"{ts / 1e6:.6f}",
                              "-i", str(video_path), "-frames:v", "1", "-f", "rawvideo", "-pix_fmt", "rgb24",
                              "pipe:1"], capture_output=True)
        if res.returncode != 0 or len(res.stdout) != h * w * 3:
            return None
        frames.append(np.frombuffer(res.stdout, np.uint8).reshape(h, w, 3))
    return np.stack(frames)


def scene_window(timestamps: np.ndarray, num_frames: int, step_size: int,
                 start_timestamp: Optional[int], camera_file: Path) -> slice:
    """The camera-file lines of a scene: `num_frames` strided by `step_size`
    from the line whose timestamp is `start_timestamp` (the first line
    without one)."""
    start = 0
    if start_timestamp is not None:
        matches = np.flatnonzero(timestamps == int(start_timestamp))
        if matches.size == 0:
            raise RuntimeError(f"start_timestamp {start_timestamp} not found in {camera_file}")
        start = int(matches[0])
    return slice(start, start + num_frames * step_size, step_size)


def save_scene_frames(scene_dir: Path, frames: np.ndarray, resolution):
    """rgb/{i:04}.png of each frame, resized to `resolution` (h, w) with
    INTER_AREA and rounded to uint8 as cv2.resize rounds, where its size
    differs."""
    h, w = resolution
    for i, frame in enumerate(frames):
        if frame.shape[:2] != (h, w):
            frame = np.clip(np.round(resize_image(frame, (h, w))), 0, 255).astype(np.uint8)
        save_image(scene_dir / f"rgb/{i:04}.png", frame)


def extract_scene(camera_file: Path, scene_num: int, output_dirpath: Path, *, num_frames: int = 50,
                  step_size: int = 1, start_timestamp: Optional[int] = None, resolution=(576, 1024),
                  video_path: Optional[Path] = None, frames: Optional[np.ndarray] = None):
    """One scene -> {output_dirpath}/{scene:05}/: the window's cameras, at
    `resolution`, and its frames (`frames`, the window's frames in order,
    or decoded from `video_path`), resized to `resolution` so that the
    pixels match the intrinsics."""
    data = parse_camera_file(camera_file)
    sel = scene_window(data["timestamps"], num_frames, step_size, start_timestamp, camera_file)
    scene_dir = Path(output_dirpath) / f"{scene_num:05}"
    scene_dir.mkdir(parents=True, exist_ok=True)
    intrinsics = compute_intrinsic_matrices(data["intrinsics_norm"][sel], resolution)
    extrinsics = compute_extrinsic_matrices(data["poses_3x4"][sel])
    np.savetxt(scene_dir / "CameraIntrinsics.csv", intrinsics.reshape(-1, 9), delimiter=",")
    np.savetxt(scene_dir / "CameraExtrinsics.csv", extrinsics.reshape(-1, 16), delimiter=",")
    if frames is None and video_path is not None:
        frames = extract_frames_from_video(video_path, data["timestamps"][sel])
    if frames is not None:
        save_scene_frames(scene_dir, frames, resolution)


def create_train_test_set(database_dirpath: Path, set_num: int, scene_nums: List[int], num_train_frames: int,
                          train_views_density: str = "sparse"):
    """Fixed RealEstate splits; the sparse test split leaves out all five
    candidate train frames [10, 20, 30, 0, 40] whatever the number trained
    on, as the published sets do."""
    candidates = [10, 20, 30, 0, 40]
    if train_views_density == "sparse":
        train_frames = sorted(candidates[:num_train_frames])
        test_frames = sorted(set(range(50)) - set(candidates))
    elif train_views_density == "dense":
        test_frames = list(range(0, 50, 5))
        train_frames = sorted(set(range(50)) - set(test_frames))
    else:
        raise RuntimeError(f"Unknown train views density: {train_views_density}")
    val_frames = test_frames[:: len(test_frames) // 5][1:4]

    set_dirpath = Path(database_dirpath) / f"train_test_sets/set{set_num:02}"
    set_dirpath.mkdir(parents=True, exist_ok=True)
    for name, frames in (("Train", train_frames), ("Test", test_frames), ("Validation", val_frames)):
        rows = [(s, f) for s in scene_nums for f in frames]
        write_csv_columns(set_dirpath / f"{name}VideosData.csv",
                          {"scene_num": [r[0] for r in rows], "pred_frame_num": [r[1] for r in rows]})
    with open(set_dirpath / "Configs.json", "w") as f:
        json.dump({"creator": "TrainTestCreator01", "set_num": set_num, "scene_nums": list(scene_nums),
                   "num_train_frames": num_train_frames, "train_views_density": train_views_density},
                  f, indent=4)


def create_original_video_poses(database_dirpath: Path, set_num: int, video_num: int = 1):
    """The original camera trajectory as the render path, its first pose
    repeated in front (the tester skips pose 0)."""
    database_dirpath = Path(database_dirpath)
    set_dirpath = database_dirpath / f"train_test_sets/set{set_num:02}"
    out = set_dirpath / f"video_poses{video_num:02}"
    out.mkdir(parents=True, exist_ok=True)
    test_data = read_csv_columns(set_dirpath / "TestVideosData.csv")
    for scene_num in np.unique(test_data["scene_num"]):
        scene_dir = database_dirpath / f"test/database_data/{int(scene_num):05}"
        extr = np.loadtxt((scene_dir / "CameraExtrinsics.csv").as_posix(), delimiter=",")
        poses = np.concatenate([extr[:1], extr], axis=0)
        np.savetxt(out / f"{int(scene_num):05}.csv", poses, delimiter=",")


def _segment_motion_stats(poses_3x4: np.ndarray, step_size: int, num_frames_per_scene: int) -> Optional[np.ndarray]:
    """(num_segments, num_frames_per_scene - 1, 4): abs [tx, ty, tz, norm] of
    each step's relative translation inside each sliding window; None when
    the video is too short for one window."""
    num_segments = poses_3x4.shape[0] - (num_frames_per_scene - 1) * step_size
    if num_segments <= 0:
        return None
    t = compute_extrinsic_matrices(poses_3x4)
    trans = (t[step_size:] @ np.linalg.inv(t[:-step_size]))[:, :3, 3]
    steps = np.abs(np.concatenate([trans, np.linalg.norm(trans, axis=1, keepdims=True)], 1))
    window = (num_frames_per_scene - 1) * step_size
    return np.stack([steps[i:i + window:step_size] for i in range(num_segments)])


def select_scenes(extracted_dirpath: Path, output_dirpath: Path, *, num_scenes: int = 10,
                  percentage_xy_motion_scenes: int = 50, step_size: int = 1, start_offset: int = 15,
                  end_offset: int = 0, num_frames_per_scene: int = 50, translation_threshold: float = 0.01,
                  seed: int = 0) -> Dict[str, list]:
    """Motion-based scene curation: a window of `num_frames_per_scene`
    frames passes when every step moves at least `translation_threshold`
    and some step moves more in x or y than in z; the best-scored passing
    window of the best `percentage_xy_motion_scenes` % of the scenes, and a
    random window of random scenes for the rest. When fewer scenes pass
    than asked for, the random bucket skips that many candidates and the
    selection comes out short, as the reference's slicing gives.

    Writes Cache/{All,Filtered,Random}ScenesData.csv (scene_name,
    start_timestamp) and a strict Configs.json; returns the AllScenesData
    columns."""
    extracted_dirpath, output_dirpath = Path(extracted_dirpath), Path(output_dirpath)
    rng = np.random.default_rng(seed)
    filtered_rows, random_rows = [], []  # (scene, timestamp[, score])
    for scene_dir in sorted(p for p in extracted_dirpath.iterdir() if p.is_dir()):
        cam_path = scene_dir / "CameraData.txt"
        if not cam_path.exists():
            continue
        data = parse_camera_file(cam_path)
        stop = len(data["timestamps"]) - end_offset
        poses = data["poses_3x4"][start_offset:stop]
        timestamps = data["timestamps"][start_offset:stop]
        stats = _segment_motion_stats(poses, step_size, num_frames_per_scene)
        if stats is None:
            continue
        random_rows.append((scene_dir.name, int(timestamps[rng.integers(0, stats.shape[0])])))
        keep = (stats[:, :, 3].min(axis=1) >= translation_threshold) & np.any(
            (stats[:, :, 2] < stats[:, :, 0]) | (stats[:, :, 2] < stats[:, :, 1]), axis=1)
        if not keep.any():
            continue
        scores = stats[:, :, 3].mean(axis=1)
        best = int(np.flatnonzero(keep)[np.argmax(scores[keep])])
        filtered_rows.append((scene_dir.name, int(timestamps[best]), float(scores[best])))

    num_filtered = num_scenes * percentage_xy_motion_scenes // 100
    num_random = num_scenes - num_filtered
    filtered_rows.sort(key=lambda r: -r[2])
    selected_filtered = [(s, t) for s, t, _ in filtered_rows[:num_filtered]]
    chosen = {s for s, _ in selected_filtered}
    random_pool = [(s, t) for s, t in random_rows if s not in chosen]
    skip = num_filtered - len(selected_filtered)
    selected_random = random_pool[skip:skip + num_random]

    cache_dir = output_dirpath / "Cache"
    cache_dir.mkdir(parents=True, exist_ok=True)
    tables = {}
    for name, rows in (("All", selected_filtered + selected_random), ("Filtered", selected_filtered),
                       ("Random", selected_random)):
        rows = sorted(rows)
        tables[name] = {"scene_name": [r[0] for r in rows], "start_timestamp": [r[1] for r in rows]}
        write_csv_columns(cache_dir / f"{name}ScenesData.csv", tables[name])
    # keys the code added since an output dir was written do not block a
    # resume over it; the selector is named as the JAX package names it, so
    # either package resumes the other's selection
    save_gen_configs(output_dirpath, {
        "SceneSelector": "vipnerf_tpu.db_builders.real_estate",
        "num_scenes": num_scenes,
        "percentage_xy_motion_scenes": percentage_xy_motion_scenes,
        "step_size": step_size,
        "start_offset": start_offset,
        "end_offset": end_offset,
        "num_frames_per_scene": num_frames_per_scene,
        "segment_filter": {"name": "segment_filter01", "translation_threshold": translation_threshold},
        "seed": seed,
    }, backfill_new_keys=True)
    return tables["All"]


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m vipnerf_tpu_torch.db_builders.real_estate",
                                     description="RealEstate10K database builder")
    parser.add_argument("--database_dirpath", required=True)
    parser.add_argument("--camera_files_dirpath", default=None)
    parser.add_argument("--videos_dirpath", default=None)
    parser.add_argument("--scene_nums", type=int, nargs="*", default=[0, 1, 2, 3, 4, 5, 6])
    parser.add_argument("--set_nums", type=int, nargs="*", default=[1, 2, 3, 4])
    parser.add_argument("--num_train_frames", type=int, nargs="*", default=[-1, 2, 3, 4],
                        help="-1 = dense protocol (published set01)")
    parser.add_argument("--select_scenes_from", default=None,
                        help="extracted_data dir: run motion-based scene selection (SceneSelector01) "
                             "instead of building")
    parser.add_argument("--select_output", default=None)
    parser.add_argument("--num_scenes", type=int, default=10)
    parser.add_argument("--scenes_data_csv", default=None,
                        help="Cache/AllScenesData.csv from --select_scenes_from: restricts extraction to the "
                             "curated scenes and starts each window at its start_timestamp")
    parser.add_argument("--step_size", type=int, default=1)
    parser.add_argument("--num_frames_per_scene", type=int, default=50)
    args = parser.parse_args(argv)

    db = Path(args.database_dirpath)
    if args.select_scenes_from:
        select_scenes(Path(args.select_scenes_from), Path(args.select_output or db / "processed_data/test01"),
                      num_scenes=args.num_scenes)
        return
    if args.camera_files_dirpath:
        cam_dir = Path(args.camera_files_dirpath)
        map_video_names(cam_dir, db / "test/VideoNameMapping.csv")
        # curated windows by scene name: the extracted dir's name, which is
        # the video hash (camera-file stem) here or the zero-padded scene
        # number in the reference's layout
        windows = None
        if args.scenes_data_csv:
            table = read_csv_columns(args.scenes_data_csv)
            windows = {str(s): int(t) for s, t in zip(table["scene_name"], table["start_timestamp"])}
        for i, cam_file in enumerate(sorted(cam_dir.glob("*.txt"))):
            if i not in args.scene_nums:
                continue
            start_timestamp = None
            if windows is not None:
                keys = [k for k in (cam_file.stem, f"{i:05}", str(i)) if k in windows]
                if not keys:
                    continue  # not a curated scene
                start_timestamp = windows[keys[0]]
            video_path = None
            if args.videos_dirpath:
                candidates = list(Path(args.videos_dirpath).glob(f"{cam_file.stem}.*"))
                video_path = candidates[0] if candidates else None
            extract_scene(cam_file, i, db / "test/database_data", video_path=video_path,
                          start_timestamp=start_timestamp, step_size=args.step_size,
                          num_frames=args.num_frames_per_scene)
    for set_num, n in zip(args.set_nums, args.num_train_frames):
        create_train_test_set(db, set_num, args.scene_nums, n, train_views_density="dense" if n == -1 else "sparse")
        create_original_video_poses(db, set_num)


if __name__ == "__main__":
    main()
