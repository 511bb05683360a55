"""What the three dataset apps share (counterpart of
vipnerf_tpu/apps/common.py, without pandas):

- `start_training`: the run-level configs and every scene of them through
  `train.trainer.start_training`, or all scenes at once through
  `train.multi_scene.start_training_batched` with `batch_scenes: true`; both
  run one rank per device that `device` selects (and so does the tester),
  while QA and the videos run in the app's process;
- `start_testing`: scenes_data from the split CSVs and camera CSVs, the
  tester with depth, depth variance and visibility outputs, then QA as a
  subprocess of `python -m vipnerf_tpu_torch.qa.runner`;
- `start_testing_videos` / `start_testing_static_videos`: the frames of a
  pose track (video_poses01/{scene}.csv; its first pose is the static
  camera) rendered and written as a video, subsampled by VideoFrameNums.csv
  where it exists. The GPU machine has no video encoder, so a video is a
  directory of frames (`utils.io.save_video`).

Each stage is a span of the tracer (`utils/tracing.py`): `app.training`,
`app.testing` (the renders), `app.qa`, `app.videos` and
`app.static_videos`, with the trainer's and tester's spans inside them.
"""

import argparse
import datetime
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from vipnerf_tpu_torch.infer import tester as tester_mod
from vipnerf_tpu_torch.train import multi_scene
from vipnerf_tpu_torch.train import trainer as trainer_mod
from vipnerf_tpu_torch.utils import tracing
from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, save_video
from vipnerf_tpu_torch.utils.naming import scene_dirname

REPO_ROOT = Path(__file__).resolve().parents[2]


def _device_arg(device: Any) -> str:
    """A configs' device selection as the QA runner's --device value."""
    if isinstance(device, (list, tuple)):
        return ",".join(str(d) for d in device)
    return str(device or "all")


class DatasetApp:
    def __init__(
        self,
        dataset: str,  # 'NeRF_LLFF' | 'RealEstate10K' | 'DTU'
        scene_key: str,  # 'scene_name' | 'scene_num'
        split_dir: str,  # 'all' | 'test'
        root_dirpath: Optional[Path] = None,
    ):
        self.dataset = dataset
        self.scene_key = scene_key
        self.split_dir = split_dir
        self.root_dirpath = Path(root_dirpath) if root_dirpath else Path(".")

    def _scene_dirname(self, scene_id) -> str:
        return scene_dirname(scene_id, self.scene_key)

    def _database_dirpath(self, configs: Dict[str, Any]) -> Path:
        key = configs.get("database_dirpath")
        if not key.startswith("databases/"):
            key = f"databases/{key}"
        return self.root_dirpath / "data" / key

    def _scene_ids(self, configs: Dict[str, Any], frames_data: Dict[str, np.ndarray]) -> np.ndarray:
        return np.unique(configs.get(self.scene_key + "s", frames_data[self.scene_key]))

    # --------------------------------------------------------------- training

    def start_training(self, train_configs: Dict[str, Any]):
        """Train the scenes of `train_configs` one after another, or with
        `batch_scenes` all at once, over the selected devices."""
        train_configs = dict(train_configs)
        train_configs["root_dirpath"] = str(self.root_dirpath)
        with tracing.span("app.training"):
            if train_configs.get("batch_scenes"):
                multi_scene.start_training_batched(train_configs)
            else:
                trainer_mod.start_training(train_configs)

    # ---------------------------------------------------------------- testing

    def build_scenes_data(self, test_configs: Dict[str, Any], with_intrinsics: bool = True) -> Dict[str, Any]:
        """{scene dir: {output_dirname, frames_data}} of the test set's scenes:
        each test and train frame's extrinsic (and intrinsic), train frames
        marked. Keyed by the formatted scene dir (DTU and RealEstate10K pad
        their scene numbers to 5 digits), as the tester finds the train dir."""
        database_dirpath = self._database_dirpath(test_configs)
        sets_dir = database_dirpath / f"train_test_sets/set{test_configs['test_set_num']:02}"
        train_data = read_csv_columns(sets_dir / "TrainVideosData.csv")
        test_data = read_csv_columns(sets_dir / "TestVideosData.csv")
        resolution_suffix = test_configs.get("resolution_suffix", "")

        scenes_data = {}
        for scene_id in self._scene_ids(test_configs, test_data):
            scene_dir = self._scene_dirname(scene_id)
            base = database_dirpath / f"{self.split_dir}/database_data/{scene_dir}"
            extrinsics = np.loadtxt((base / "CameraExtrinsics.csv").as_posix(), delimiter=",").reshape((-1, 4, 4))
            intrinsics = None
            intr_path = base / f"CameraIntrinsics{resolution_suffix}.csv"
            if with_intrinsics and intr_path.exists():
                intrinsics = np.loadtxt(intr_path.as_posix(), delimiter=",").reshape((-1, 3, 3))

            test_frames = test_data["pred_frame_num"][test_data[self.scene_key] == scene_id].tolist()
            train_frames = train_data["pred_frame_num"][train_data[self.scene_key] == scene_id].tolist()
            frames_data = {}
            for frame_num in np.unique(sorted(test_frames + train_frames)):
                frame_num = int(frame_num)
                fd = {"extrinsic": extrinsics[frame_num], "is_train_frame": frame_num in train_frames}
                if intrinsics is not None:
                    fd["intrinsic"] = intrinsics[frame_num]
                frames_data[frame_num] = fd
            scenes_data[scene_dir] = {"output_dirname": scene_dir, "frames_data": frames_data}
        return scenes_data

    def start_testing(self, test_configs: Dict[str, Any], run_qa: bool = True) -> Path:
        """Render every test and train frame of the test set's scenes, then
        score them (not a preview's frames)."""
        test_configs = dict(test_configs)
        test_configs["root_dirpath"] = str(self.root_dirpath)
        output_dirpath = self.root_dirpath / f"runs/testing/test{test_configs['test_num']:04}"
        output_dirpath.mkdir(parents=True, exist_ok=True)
        tester_mod.save_test_configs(output_dirpath, test_configs)

        with tracing.span("app.testing"):
            tester_mod.start_testing(test_configs, self.build_scenes_data(test_configs),
                                     save_depth=True, save_depth_var=True, save_visibility=True)
        if run_qa:
            if test_configs.get("preview"):
                # preview frames go to {scene}_preview dirs, which QA does not read
                print("Skipping QA for preview renders.")
            else:
                self.run_qa(test_configs, output_dirpath)
        return output_dirpath

    def run_qa(self, test_configs: Dict[str, Any], output_dirpath: Path):
        """QA in a process of its own, on the tester's device: a failure
        there leaves the rendered frames in place."""
        database_dirpath = self._database_dirpath(test_configs)
        frames_datapath = database_dirpath / f"train_test_sets/set{test_configs['test_set_num']:02}/TestVideosData.csv"
        cmd = [
            sys.executable, "-m", "vipnerf_tpu_torch.qa.runner",
            "--database", self.dataset,
            "--pred_videos_dirpath", str(output_dirpath.absolute()),
            "--database_dirpath", str(database_dirpath.absolute()),
            "--frames_datapath", str(frames_datapath.absolute()),
            "--pred_folder_name", "predicted_frames",
            "--resolution_suffix", test_configs.get("resolution_suffix", ""),
            "--device", _device_arg(test_configs.get("device", "all")),
        ]
        with tracing.span("app.qa"):
            subprocess.run(cmd, cwd=REPO_ROOT, check=False)

    # ----------------------------------------------------------------- videos

    def _video_track_testing(self, test_configs: Dict[str, Any], static_camera: bool,
                             video_filename: str, suffix_template: str):
        test_configs = dict(test_configs)
        test_configs["root_dirpath"] = str(self.root_dirpath)
        database_dirpath = self._database_dirpath(test_configs)
        output_dirpath = self.root_dirpath / f"runs/testing/test{test_configs['test_num']:04}"
        output_dirpath.mkdir(parents=True, exist_ok=True)
        tester_mod.save_test_configs(output_dirpath, test_configs)

        sets_dir = database_dirpath / f"train_test_sets/set{test_configs['test_set_num']:02}"
        scene_ids = self._scene_ids(test_configs, read_csv_columns(sets_dir / "TestVideosData.csv"))

        for video_num in (1,):
            frame_nums_path = sets_dir / f"video_poses{video_num:02}/VideoFrameNums.csv"
            # at least 1-D: a file of one number would index one frame's rows
            video_frame_nums = (np.atleast_1d(np.loadtxt(frame_nums_path.as_posix(), delimiter=",")).astype(int)
                                if frame_nums_path.exists() else None)
            for scene_id in scene_ids:
                scene_dir = self._scene_dirname(scene_id)
                track_path = sets_dir / f"video_poses{video_num:02}/{scene_dir}.csv"
                if not track_path.exists():
                    continue
                extrinsics = np.loadtxt(track_path.as_posix(), delimiter=",").reshape((-1, 4, 4))
                frame_nums = np.arange(extrinsics.shape[0] - 1)
                frames_data = {}
                for f in frame_nums:
                    if static_camera:  # the first pose's camera, the track's view directions
                        frames_data[int(f)] = {"extrinsic": extrinsics[0], "extrinsic_viewcam": extrinsics[f + 1],
                                               "is_train_frame": False}
                    else:
                        frames_data[int(f)] = {"extrinsic": extrinsics[f + 1], "is_train_frame": False}
                scenes_data = {scene_dir: {"output_dirname": scene_dir, "frames_data": frames_data}}
                suffix = suffix_template.format(video_num=video_num)
                out = tester_mod.start_testing(test_configs, scenes_data, suffix)
                if out is None:  # no train run: the tester said so
                    continue
                scene_out = out / f"{scene_dir}{tester_mod.effective_output_suffix(test_configs, suffix)}"
                if not scene_out.exists():
                    continue
                frames = np.stack([read_image(scene_out / f"predicted_frames/{f:04}.png") for f in frame_nums])
                if video_frame_nums is not None:
                    frames = frames[video_frame_nums]
                save_video(scene_out / video_filename, frames)

    def start_testing_videos(self, test_configs: Dict[str, Any]):
        with tracing.span("app.videos"):
            self._video_track_testing(test_configs, False, "PredictedVideo.mp4", "_video{video_num:02}")

    def start_testing_static_videos(self, test_configs: Dict[str, Any]):
        """A fixed camera with the track's view directions."""
        with tracing.span("app.static_videos"):
            self._video_track_testing(test_configs, True, "StaticCameraVideo.mp4",
                                      "_video{video_num:02}_static_camera")


def run_main(demos: Dict[str, Callable], default: Optional[List[str]] = None,
             argv: Optional[List[str]] = None) -> int:
    """`python -m vipnerf_tpu_torch.apps.nerf_llff demo1a [demo1b ...]`: run
    the named demos, report the first error with its traceback, and return
    the exit status (1 after an error)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("demo_names", nargs="*", default=default or [],
                        help=f"demos to run; available: {sorted(demos)}")
    args = parser.parse_args(argv)

    print("Program started at " + datetime.datetime.now().strftime("%d/%m/%Y %I:%M:%S %p"))
    start_time = time.perf_counter()
    status = 0
    try:
        for name in args.demo_names:
            demos[name]()
        run_result = "Program completed successfully!"
    except Exception as e:  # the CLI's boundary: report, then exit non-zero
        print(e)
        traceback.print_exc()
        run_result = "Error: " + str(e)
        status = 1
    print(run_result)
    print("Program ended at " + datetime.datetime.now().strftime("%d/%m/%Y %I:%M:%S %p"))
    print("Execution time: " + str(datetime.timedelta(seconds=time.perf_counter() - start_time)))
    return status
