"""Demo config builders (counterpart of vipnerf_tpu/apps/configs.py): the
shipped demo configs of the three dataset apps -- 2048 + 2048 rays, 64 + 128
samples, 8x256 MLPs with PE 10/4, Adam(5e-4, decay 250), the ViP-NeRF loss
stack with the visibility prior from iteration 30k.

Against the JAX package's dicts: the checkpoints are `.tar` (the port's
checkpoint contract), and the TPU memory knobs `remat`, `netchunk_map` and
`netchunk_map_infer`, which the port does not read, are left out.
`scan_steps` stays: the trainer cuts its chunks of steps by it.
"""

import copy
from typing import Any, Dict, List, Optional


def mlp_config(num_samples: int) -> Dict[str, Any]:
    return {
        "num_samples": num_samples,
        "netdepth": 8,
        "netwidth": 256,
        "points_positional_encoding_degree": 10,
        "views_positional_encoding_degree": 4,
        "use_view_dirs": True,
        "view_dependent_rgb": True,
        "predict_visibility": True,
    }


def build_train_configs(
    *,
    entry_name: str,
    train_num: int,
    database: str,
    database_dirpath: str,
    data_loader_name: str,
    scene_key: str,
    scene_ids: List,
    set_num: int,
    ndc: bool,
    recenter_camera_poses: bool,
    bd_factor: Optional[float],
    num_iterations: int,
    resolution_suffix: Optional[str] = None,
    num_rays: int = 2048,
    sparse_depth: bool = True,
    sparse_depth_rays: int = 2048,
    visibility_prior_start_iter: int = 30000,
    validation_interval: int = 10000,
    model_save_interval: int = 10000,
    seed: int = 0,
    device: Optional[Any] = None,
    scan_steps: int = 100,
    # the shipped precision mode: bf16 trunk with f32 heads (the f32 heads
    # keep bf16 activation noise from killing the density head); pass
    # bf16_matmuls=False for f32
    bf16_matmuls: bool = True,
) -> Dict[str, Any]:
    data_loader: Dict[str, Any] = {
        "data_loader_name": data_loader_name,
        "data_preprocessor_name": "DataPreprocessor01",
        "train_set_num": set_num,
        scene_key: list(scene_ids),
        "recenter_camera_poses": recenter_camera_poses,
        "bd_factor": bd_factor,
        "spherify": False,
        "ndc": ndc,
        "batching": True,
        "downsampling_factor": 1,
        "num_rays": num_rays,
        "precrop_fraction": 1,
        "precrop_iterations": -1,
        "visibility_prior": {
            "load_masks": True,
            "load_weights": False,
            "masks_dirname": f"VW{set_num:02}",
        },
    }
    if resolution_suffix is not None:
        data_loader["resolution_suffix"] = resolution_suffix
    if sparse_depth:
        data_loader["sparse_depth"] = {"dirname": f"DE{set_num:02}", "num_rays": sparse_depth_rays}

    losses = [
        {"name": "MSE01", "weight": 1},
        {"name": "VisibilityLoss01", "weight": 0.1},
        {"name": "VisibilityPriorLoss01", "iter_weights": {"0": 0, str(visibility_prior_start_iter): 0.001}},
    ]
    if sparse_depth:
        losses.append({"name": "SparseDepthMSE01", "weight": 0.1})

    return {
        "trainer": f"{entry_name}/VipNerfTpuTrainer",
        "train_num": train_num,
        "database": database,
        "database_dirpath": database_dirpath,
        "data_loader": data_loader,
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": mlp_config(64),
            "fine_mlp": mlp_config(128),
            "chunk": 4 * 1024,
            "lindisp": False,
            "netchunk": 16 * 1024,
            "perturb": True,
            "raw_noise_std": 1.0,
            "white_bkgd": False,
            "bf16_matmuls": bf16_matmuls,
            "f32_heads": bf16_matmuls,
        },
        "losses": losses,
        "optimizer": {
            "lr_decayer_name": "NeRFLearningRateDecayer01",
            "lr_initial": 5e-4,
            "lr_decay": 250,
            "beta1": 0.9,
            "beta2": 0.999,
        },
        "resume_training": True,
        "num_iterations": num_iterations,
        "scan_steps": scan_steps,
        "validation_interval": validation_interval,
        "validation_chunk_size": 16384,
        "validation_save_loss_maps": False,
        "model_save_interval": model_save_interval,
        "mixed_precision_training": bf16_matmuls,
        "seed": seed,
        # "all": the first GPU; "cpu"; or a one-element list of a GPU index
        "device": device or "all",
    }


def build_test_configs(
    *,
    entry_name: str,
    test_num: int,
    train_num: int,
    set_num: int,
    database: str,
    database_dirpath: str,
    num_iterations: int,
    scene_key: str,
    scene_ids: List,
    resolution_suffix: Optional[str] = None,
    device: Optional[Any] = None,
) -> Dict[str, Any]:
    cfg = {
        "tester": f"{entry_name}/VipNerfTpuTester",
        "test_num": test_num,
        "test_set_num": set_num,
        "train_num": train_num,
        "model_name": f"Model_Iter{num_iterations:06}.tar",
        "database_name": database,
        "database_dirpath": database_dirpath,
        scene_key: list(scene_ids),
        "device": device or "all",
    }
    if resolution_suffix is not None:
        cfg["resolution_suffix"] = resolution_suffix
    return cfg


def clone(cfg: Dict[str, Any], **overrides) -> Dict[str, Any]:
    out = copy.deepcopy(cfg)
    out.update(overrides)
    return out
