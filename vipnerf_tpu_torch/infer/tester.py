"""Novel-view inference: checkpoint loading, per-frame rendering,
skip-if-exists, output saving (counterpart of vipnerf_tpu/infer/tester.py).

Output tree: runs/testing/test{NNNN:04}/{scene}{suffix}/ with
predicted_frames/{f:04}.png, predicted_depths/{f:04}[_ndc].npy (+png),
predicted_depths_variance/ and predicted_visibilities/{f1:04}_{f2:04}.npy.

Over several devices (`test_configs['device']`), `start_testing` runs one
rank per device (`parallel.mesh.run_on_devices`): every rank renders each
frame's tiles sharded over the ranks (`TiledRenderer` with the group, the
JAX tester's mesh), and rank 0 alone writes.

`predict_frame` is traced (`utils/tracing.py`): `render.frame` (`frame`,
a running count, its interval on the card's stream too) with
`render.prepare` (the rays), the tiled renderer's spans and
`render.outputs` (the outputs rearranged on the host).
"""

import copy
import functools
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.infer.renderer import (
    TiledRenderer,
    preview_budget_configs,
    preview_configs,
)
from vipnerf_tpu_torch.models.factory import get_model
from vipnerf_tpu_torch.parallel.mesh import current_group, run_on_devices
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.utils import tracing
from vipnerf_tpu_torch.utils.config import dict_diff
from vipnerf_tpu_torch.utils.device import resolve_device
from vipnerf_tpu_torch.utils.io import save_image as _save_image_raw
from vipnerf_tpu_torch.utils.io import save_numpy_array


class NerfTester:
    def __init__(
        self,
        train_configs: Dict[str, Any],
        model_configs: Dict[str, Any],
        test_configs: Dict[str, Any],
        root_dirpath: Path,
    ):
        self.train_configs = train_configs
        self.test_configs = test_configs
        self.root_dirpath = Path(root_dirpath)
        self.model_configs = model_configs
        self.group = current_group(test_configs.get("device", "all"))
        self.writes = self.group is None or self.group.is_writer
        self.device = resolve_device(test_configs.get("device", "all"))

        # `preview: true` renders the 32+8 budget through both levels; an
        # integer N renders the coarse field alone at N samples. Either way
        # the trained checkpoint loads unchanged.
        render_configs = train_configs
        preview = test_configs.get("preview")
        if preview:
            if isinstance(preview, int) and not isinstance(preview, bool):
                render_configs = preview_configs(train_configs, preview)
            else:
                render_configs = preview_budget_configs(train_configs)
        sample_overrides = {
            "coarse_mlp": test_configs.get("num_samples_coarse"),
            "fine_mlp": test_configs.get("num_samples_fine"),
        }
        if any(v is not None for v in sample_overrides.values()):
            render_configs = copy.deepcopy(render_configs)
            for mlp_key, value in sample_overrides.items():
                if value is not None and mlp_key in render_configs["model"]:
                    render_configs["model"][mlp_key]["num_samples"] = int(value)

        self.data_preprocessor = get_data_preprocessor(
            render_configs, mode="test", model_configs=model_configs, device=self.device
        )
        model_cls, self.render_fn = get_model(train_configs)
        seed = train_configs.get("seed", 0) or 0
        self.model = model_cls(train_configs, torch.Generator().manual_seed(seed))
        self.model = self.model.to(self.device).eval()
        self.renderer = TiledRenderer(self.render_fn, render_configs, group=self.group)
        self.chunk_size = test_configs.get("chunk_size", 8192)
        self.frames = 0  # frames predicted: the `frame` of each one's span

    def load_model(self, model_path: Path):
        model_path = Path(model_path)
        iter_num = checkpoints.load_checkpoint(model_path, self.model)
        train_dirname = model_path.parent.parent.parent.stem
        scene_dirname = model_path.parent.parent.stem
        print(
            f"Loaded Model in {train_dirname}/{scene_dirname}/{model_path.stem} "
            f"trained for {iter_num} iterations"
        )

    def predict_frame(
        self,
        camera_pose: np.ndarray,
        view_camera_pose: Optional[np.ndarray] = None,
        secondary_poses: Optional[List[np.ndarray]] = None,
        intrinsic: Optional[np.ndarray] = None,
        view_intrinsic: Optional[np.ndarray] = None,
        secondary_intrinsics: Optional[List[np.ndarray]] = None,
    ) -> Dict[str, np.ndarray]:
        self.frames += 1
        with tracing.span("render.frame", self.device, frame=self.frames):
            with tracing.span("render.prepare"):
                batch = self.data_preprocessor.create_test_data(
                    camera_pose, view_camera_pose, secondary_poses, True,
                    intrinsic, view_intrinsic, secondary_intrinsics,
                )
            outputs, _ = self.renderer.render(
                self.model, batch, chunk_size=self.chunk_size,
                sec_views_vis=secondary_poses is not None,
            )
            with tracing.span("render.outputs"):
                return self.data_preprocessor.retrieve_inference_outputs(outputs)

    @staticmethod
    def save_image(path: Path, image: np.ndarray):
        _save_image_raw(path, image)

    @staticmethod
    def save_depth(path: Path, depth: np.ndarray, as_png: bool = False):
        save_numpy_array(path, depth, as_png=as_png)

    @staticmethod
    def save_visibility(path: Path, visibility: np.ndarray, as_png: bool = False):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        vis_image = np.round(visibility * 255).astype("uint8")
        if path.suffix == ".png":
            _save_image_raw(path, vis_image)
        elif path.suffix == ".npy":
            np.save(path.as_posix(), visibility)
            if as_png:
                _save_image_raw(path.parent / f"{path.stem}.png", vis_image)
        else:
            raise RuntimeError(f"Unknown visibility format: {path.as_posix()}")


def save_test_configs(
    output_dirpath: Path, configs: Dict[str, Any], filename: str = "Configs.json"
):
    """Test-config persistence with scene-list merge."""
    configs = {k: v for k, v in configs.items() if k not in ("root_dirpath",)}
    configs_path = Path(output_dirpath) / filename
    if configs_path.exists():
        with open(configs_path) as f:
            old_configs = json.load(f)
        for key in old_configs:
            if key not in configs:
                configs[key] = old_configs[key]
        for candidate in ("scene_nums", "scene_names", "scene_ids"):
            if candidate in old_configs:
                merged = sorted(
                    set(old_configs.get(candidate, [])) | set(configs.get(candidate, []))
                )
                if merged:
                    configs[candidate] = merged
                    old_configs[candidate] = merged
                break
        if "device" in configs:
            old_configs["device"] = configs["device"]
        if configs != old_configs:
            print(
                "Configs mismatch while resuming testing: "
                + "; ".join(dict_diff(old_configs, configs))
            )
    Path(output_dirpath).mkdir(parents=True, exist_ok=True)
    with open(configs_path, "w") as f:
        json.dump(configs, f, indent=4, default=str)


def effective_output_suffix(
    test_configs: Dict[str, Any], output_dir_suffix: str = ""
) -> str:
    """Scene-dir suffix used by start_testing: previews go to
    `{scene}{suffix}_preview`, so skip-if-exists never mixes them with full
    renders."""
    if test_configs.get("preview"):
        return f"{output_dir_suffix}_preview"
    return output_dir_suffix


def start_testing(
    test_configs: Dict[str, Any],
    scenes_data: Dict[str, Any],
    output_dir_suffix: str = "",
    save_depth: bool = False,
    save_depth_var: bool = False,
    save_visibility: bool = False,
) -> Optional[Path]:
    """Render all frames of all scenes from a trained run.

    scenes_data: {scene_id: {'output_dirname': str, 'frames_data':
    {frame_num: {'extrinsic', 'is_train_frame'[, 'intrinsic',
    'extrinsic_viewcam', 'intrinsic_viewcam']}}}}. A frame whose outputs all
    exist is skipped. Train frames also render their visibility towards the
    other train frames when `save_visibility` is on. Runs on every device
    `test_configs['device']` selects (see the module docstring).
    """
    return run_on_devices(functools.partial(
        _start_testing, scenes_data=scenes_data, output_dir_suffix=output_dir_suffix, save_depth=save_depth,
        save_depth_var=save_depth_var, save_visibility=save_visibility), test_configs)


def _start_testing(
    test_configs: Dict[str, Any],
    scenes_data: Dict[str, Any],
    output_dir_suffix: str,
    save_depth: bool,
    save_depth_var: bool,
    save_visibility: bool,
) -> Optional[Path]:
    root_dirpath = Path(test_configs.get("root_dirpath", "."))
    output_dirpath = root_dirpath / f"runs/testing/test{test_configs['test_num']:04}"
    output_dir_suffix = effective_output_suffix(test_configs, output_dir_suffix)
    train_dirpath = root_dirpath / f"runs/training/train{test_configs['train_num']:04}"
    model_name = test_configs["model_name"]

    train_configs_path = train_dirpath / "Configs.json"
    if not train_configs_path.exists():
        print(f"Train Configs does not exist at {train_configs_path}. Skipping.")
        return None
    with open(train_configs_path) as f:
        base_train_configs = json.load(f)

    for scene_id, scene_data in scenes_data.items():
        scene_train_dirpath = train_dirpath / f"{scene_id}"
        train_configs = json.loads(json.dumps(base_train_configs))
        train_configs["data_loader"]["scene_id"] = scene_id

        model_configs_path = scene_train_dirpath / "ModelConfigs.json"
        if not model_configs_path.exists():
            print(
                f"Scene {scene_id}: Trained Model Configs does not exist at "
                f"{model_configs_path}. Skipping."
            )
            continue
        with open(model_configs_path) as f:
            trained_model_configs = json.load(f)
        model_path = scene_train_dirpath / f"saved_models/{model_name}"
        if not model_path.exists():
            print(f"Scene {scene_id}: Model does not exist at {model_path}. Skipping.")
            continue

        tester = NerfTester(train_configs, trained_model_configs, test_configs, root_dirpath)
        tester.load_model(model_path)
        scene_dir = output_dirpath / f"{scene_data['output_dirname']}{output_dir_suffix}"

        frames = scene_data["frames_data"]
        train_frame_nums = [f for f in frames if frames[f]["is_train_frame"]]
        for frame_num, frame_data in frames.items():
            frame_path = scene_dir / f"predicted_frames/{frame_num:04}.png"
            depth_path = scene_dir / f"predicted_depths/{frame_num:04}.npy"
            depth_var_path = scene_dir / f"predicted_depths_variance/{frame_num:04}.npy"
            with_vis = save_visibility and frame_data["is_train_frame"]
            secondary_frame_nums = (
                [f for f in train_frame_nums if f != frame_num] if with_vis else []
            )

            inference_required = not frame_path.exists()
            if save_depth:
                inference_required |= not depth_path.exists()
            if save_depth_var:
                inference_required |= not depth_var_path.exists()
            # visibility maps are written last: existing frames or depths must
            # not hide a missing one
            inference_required |= any(
                not (scene_dir / f"predicted_visibilities/{frame_num:04}_{f:04}.npy").exists()
                for f in secondary_frame_nums
            )
            if not inference_required:
                continue

            secondary_poses = secondary_intrinsics = None
            if with_vis:
                secondary_poses = [frames[f]["extrinsic"] for f in secondary_frame_nums]
                secondary_intrinsics = [frames[f].get("intrinsic") for f in secondary_frame_nums]
                if any(x is None for x in secondary_intrinsics):
                    secondary_intrinsics = None

            predictions = tester.predict_frame(
                frame_data["extrinsic"],
                frame_data.get("extrinsic_viewcam"),
                secondary_poses,
                frame_data.get("intrinsic"),
                frame_data.get("intrinsic_viewcam"),
                secondary_intrinsics,
            )
            if not tester.writes:
                continue

            tester.save_image(frame_path, predictions["image"])
            if save_depth:
                tester.save_depth(depth_path, predictions["depth"], as_png=True)
                if "depth_ndc" in predictions:
                    tester.save_depth(
                        scene_dir / f"predicted_depths/{frame_num:04}_ndc.npy",
                        predictions["depth_ndc"], as_png=True,
                    )
            if save_depth_var:
                tester.save_depth(depth_var_path, predictions["depth_var"], as_png=True)
                if "depth_var_ndc" in predictions:
                    tester.save_depth(
                        scene_dir / f"predicted_depths_variance/{frame_num:04}_ndc.npy",
                        predictions["depth_var_ndc"], as_png=True,
                    )
            if with_vis and "visibility2" in predictions:
                for i, sec in enumerate(secondary_frame_nums):
                    tester.save_visibility(
                        scene_dir / f"predicted_visibilities/{frame_num:04}_{sec:04}.npy",
                        predictions["visibility2"][i], as_png=True,
                    )
    group = current_group(test_configs.get("device", "all"))
    if group is not None:  # every rank returns once rank 0's files are written
        group.barrier()
    return output_dirpath
