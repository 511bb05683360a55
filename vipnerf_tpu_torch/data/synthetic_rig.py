"""A trained-run tree with seeded random weights, for smoke runs and profiles.

`forward_facing_rig` places cameras like an LLFF capture (a few views on a
small patch, all looking at one point); `write_run_tree` writes what
`infer.tester.start_testing` reads: runs/training/train{N:04}/Configs.json,
{scene}/ModelConfigs.json and {scene}/saved_models/Model_Iter000000.tar.
`flagship_training_configs` is the flagship training config for the
synthetic database of `data.synthetic`.
"""

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vipnerf_tpu_torch.core.poses import preprocess_poses
from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF
from vipnerf_tpu_torch.train.checkpoints import save_checkpoint

# an LLFF scene at a quarter of 4032x3024
LLFF_DOWN4 = {"height": 756, "width": 1008, "focal": 815.0}


def flagship_mlp_config(num_samples: int) -> Dict[str, Any]:
    """The 8x256 MLP block of the demo configs (PE 10/4, view-dependent rgb,
    visibility head)."""
    return {
        "num_samples": num_samples, "netdepth": 8, "netwidth": 256,
        "points_positional_encoding_degree": 10, "views_positional_encoding_degree": 4,
        "use_view_dirs": True, "view_dependent_rgb": True, "predict_visibility": True,
    }


def flagship_train_configs(seed: int = 0) -> Dict[str, Any]:
    """The flagship model block (64 coarse + 128 fine samples, NDC, bf16
    matmuls) with bf16 heads, the precision mode K1 implements."""
    return {
        "train_num": 1,
        "database": "NeRF_LLFF",
        "data_loader": {
            "data_loader_name": "NerfLlffDataLoader01",
            "data_preprocessor_name": "DataPreprocessor01",
            "ndc": True, "bd_factor": 0.75, "recenter_camera_poses": True,
            "spherify": False, "batching": True, "downsampling_factor": 1,
            "num_rays": 2048,
        },
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": flagship_mlp_config(64),
            "fine_mlp": flagship_mlp_config(128),
            "chunk": 4096, "lindisp": False, "netchunk": 16384,
            "perturb": True, "raw_noise_std": 1.0, "white_bkgd": False,
            "bf16_matmuls": True, "f32_heads": False,
        },
        "seed": seed,
    }


def flagship_training_configs(
    root_dirpath: Path, num_iterations: int, *, visibility_prior_start_iter: int = 30000,
) -> Dict[str, Any]:
    """The flagship training config of the JAX package's apps/configs.py
    `build_train_configs` (2048 NeRF + 2048 sparse-depth rays, the four
    losses with the visibility prior staged in at `visibility_prior_start_iter`,
    Adam at 5e-4 * 0.1^(it/250k)) with bf16 heads, for the synthetic LLFF
    scene `synth01` of `data.synthetic.write_synthetic_database` under
    {root_dirpath}/data/databases."""
    configs = flagship_train_configs()
    configs["data_loader"].update({
        "train_set_num": 2, "scene_names": ["synth01"], "resolution_suffix": "",
        "precrop_fraction": 1, "precrop_iterations": -1,
        "visibility_prior": {"load_masks": True, "load_weights": False, "masks_dirname": "VW02"},
        "sparse_depth": {"dirname": "DE02", "num_rays": 2048},
    })
    configs.update({
        "database_dirpath": "databases/NeRF_LLFF/data",
        "root_dirpath": str(root_dirpath),
        "losses": [
            {"name": "MSE01", "weight": 1},
            {"name": "VisibilityLoss01", "weight": 0.1},
            {"name": "VisibilityPriorLoss01",
             "iter_weights": {"0": 0, str(visibility_prior_start_iter): 0.001}},
            {"name": "SparseDepthMSE01", "weight": 0.1},
        ],
        "optimizer": {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 5e-4,
                      "lr_decay": 250, "beta1": 0.9, "beta2": 0.999},
        "resume_training": True,
        "num_iterations": num_iterations,
        "validation_interval": 10000,
        "validation_chunk_size": 16384,
        "validation_save_loss_maps": False,
        "model_save_interval": 10000,
        "device": "all",
    })
    return configs


def look_at_w2c(centre: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World-to-camera extrinsic (x right, y down, z forward) at `centre`."""
    z = (target - centre) / np.linalg.norm(target - centre)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    rot = np.stack([x, np.cross(z, x), z])
    w2c = np.eye(4)
    w2c[:3, :3] = rot
    w2c[:3, 3] = -rot @ centre
    return w2c


def forward_facing_rig(num_views: int = 5, seed: int = 0) -> np.ndarray:
    """(num_views, 4, 4) w2c extrinsics on a 0.8 x 0.5 patch facing a point 6 away."""
    rng = np.random.default_rng(seed)
    target = np.array([0.0, 0.0, 6.0])
    xs = rng.uniform(-0.4, 0.4, num_views)
    ys = rng.uniform(-0.25, 0.25, num_views)
    return np.stack([look_at_w2c(np.array([x, y, 0.0]), target) for x, y in zip(xs, ys)])


def write_run_tree(
    root: Path,
    configs: Dict[str, Any],
    poses_w2c: np.ndarray,
    *,
    scene: str = "rig",
    height: int = LLFF_DOWN4["height"],
    width: int = LLFF_DOWN4["width"],
    focal: float = LLFF_DOWN4["focal"],
    bounds: Tuple[float, float] = (1.2, 24.0),
    sigma_offset: float = 0.0,
    seed: int = 0,
) -> Dict[str, Any]:
    """Write the run tree of train{configs['train_num']:04}/{scene}; returns
    the model configs. `sigma_offset` is added to both sigma-head biases, so
    that a random model renders a scene that is not empty."""
    bd_factor = configs["data_loader"]["bd_factor"]
    pp = preprocess_poses(poses_w2c, train_mode=True, bounds=np.asarray(bounds),
                          bd_factor=bd_factor)
    model_configs = {
        "resolution": [height, width],
        "intrinsic": [[focal, 0.0, width / 2], [0.0, focal, height / 2], [0.0, 0.0, 1.0]],
        "near": float(pp["bounds"][0] * bd_factor),
        "far": float(pp["bounds"][1]),
        "near_ndc": 0.0,
        "far_ndc": 1.0,
        "translation_scale": float(pp["sc"]),
        "average_pose": pp["average_pose"].tolist(),
    }
    train_dir = Path(root) / f"runs/training/train{configs['train_num']:04}"
    (train_dir / scene).mkdir(parents=True, exist_ok=True)
    (train_dir / "Configs.json").write_text(json.dumps(configs, indent=4))
    (train_dir / scene / "ModelConfigs.json").write_text(json.dumps(model_configs, indent=4))
    model = ViPNeRF(configs, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for mlp in model.children():
            mlp.pts_output_linear.bias[0] += sigma_offset
    save_checkpoint(train_dir / scene / "saved_models", 0, model)
    return model_configs
