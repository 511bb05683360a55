"""Config persistence with the resume-merge semantics of
vipnerf_tpu/utils/config.py: on resume the saved Configs.json's seed and
missing keys are inherited into the live dict, scene lists are merged,
num_iterations may grow, and any other mismatch is printed as a diff.
"""

import json
import os
import random
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

_PATH_KEYS = ("root_dirpath", "output_dirpath")


def dict_diff(old: Any, new: Any, prefix: str = "") -> list:
    """Minimal recursive diff: list of 'path: old -> new' strings."""
    diffs = []
    if isinstance(old, dict) and isinstance(new, dict):
        for key in sorted(set(old) | set(new)):
            p = f"{prefix}.{key}" if prefix else str(key)
            if key not in old:
                diffs.append(f"{p}: <absent> -> {new[key]!r}")
            elif key not in new:
                diffs.append(f"{p}: {old[key]!r} -> <absent>")
            else:
                diffs.extend(dict_diff(old[key], new[key], p))
    elif old != new:
        diffs.append(f"{prefix}: {old!r} -> {new!r}")
    return diffs


def save_configs(
    output_dirpath: Path, configs: Dict[str, Any], filename: str = "Configs.json"
) -> Dict[str, Any]:
    """Write the run's configs, merged into the live dict from an existing
    file first (resume): a minimal {train_num, resume_training} config
    inherits the rest. The merged dict is returned (and is `configs`)."""
    configs_path = Path(output_dirpath) / filename
    if configs_path.exists():
        old_configs = read_configs(configs_path)
        configs["seed"] = old_configs.get("seed", configs.get("seed"))
        for key in old_configs:
            if key not in configs:
                configs[key] = old_configs[key]
        for candidate in ("scene_nums", "scene_names", "scene_ids"):
            if candidate in old_configs.get("data_loader", {}):
                merged = sorted(set(old_configs["data_loader"].get(candidate, []))
                                | set(configs["data_loader"].get(candidate, [])))
                if merged:
                    configs["data_loader"][candidate] = merged
                    old_configs["data_loader"][candidate] = merged
                break
        if configs.get("num_iterations", 0) > old_configs.get("num_iterations", 0):
            old_configs["num_iterations"] = configs["num_iterations"]
        if "device" in configs:
            old_configs["device"] = configs["device"]
        live = {k: v for k, v in configs.items() if k not in _PATH_KEYS}
        if live != old_configs:
            print("Configs mismatch while resuming training: "
                  + "; ".join(dict_diff(old_configs, live)))
    with open(configs_path, "w") as f:
        json.dump({k: v for k, v in configs.items() if k not in _PATH_KEYS}, f,
                  indent=4, default=str)
    return configs


def save_model_configs(
    output_dirpath: Path, configs: Dict[str, Any], filename: str = "ModelConfigs.json"
):
    """Write the model configs, printing how they differ from saved ones."""
    configs_path = Path(output_dirpath) / filename
    if configs_path.exists():
        old_configs = read_configs(configs_path)
        if configs != old_configs:
            print("Model configs mismatch while resuming training: "
                  + "; ".join(dict_diff(old_configs, configs)))
    with open(configs_path, "w") as f:
        json.dump(configs, f, indent=4, default=str)


def read_configs(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def init_seeds(seed: Optional[int] = 0):
    """Pin the host-side generators (Python, numpy, torch's default one).
    The training randomness itself comes from explicit torch.Generators."""
    if seed is None:
        return
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
