"""Offline prior-generation CLIs (counterpart of vipnerf_tpu/priors/cli.py).

The per-dataset generation policy (plane spacing, bounds, split dir,
resolution suffix) lives in one table, and the generators run as modules:

    python -m vipnerf_tpu_torch.priors.visibility   --database NeRF_LLFF --gen_nums 2 3 4
    python -m vipnerf_tpu_torch.priors.sparse_depth --database NeRF_LLFF --gen_nums 2 3 4

`gen_num` doubles as the train-set number. The visibility prior runs on the
GPU unless `--device cpu` is given.
"""

import argparse
from typing import Dict, List, Optional

from vipnerf_tpu_torch.utils.device import device_from_arg

# Per-dataset generation policy:
# - NeRF_LLFF: scene_name keys, 'all' split, _down4 resolution, inverse-depth
#   planes, per-scene bounds from DepthBounds.csv.
# - RealEstate10K: scene_num keys, 'test' split, full resolution, inverse
#   planes, fixed bounds [1, 100].
# - DTU: scene_num keys, 'all' split, full resolution, LINEAR planes (128),
#   fixed bounds [0.1, 5].
DATASET_POLICIES: Dict[str, Dict] = {
    "NeRF_LLFF": {
        "database_dirpath": "NeRF_LLFF/data",
        "scene_key": "scene_name",
        "split_dir": "all",
        "resolution_suffix": "_down4",
    },
    "RealEstate10K": {
        "database_dirpath": "RealEstate10K/data",
        "scene_key": "scene_num",
        "split_dir": "test",
        "resolution_suffix": "",
        "fixed_bounds": (1.0, 100.0),
    },
    "DTU": {
        "database_dirpath": "DTU/data",
        "num_depth_planes": 128,
        "scene_key": "scene_num",
        "split_dir": "all",
        "resolution_suffix": "",
        "fixed_bounds": (0.1, 5.0),
        "depth_planes_linear": True,
    },
}


def build_visibility_configs(database: str, gen_num: int, set_num: Optional[int] = None) -> Dict:
    policy = DATASET_POLICIES[database]
    configs = {
        "generator": "vipnerf_tpu_torch.priors.visibility",
        "gen_num": gen_num,
        "gen_set_num": set_num if set_num is not None else gen_num,
        "database_name": database,
        "database_dirpath": policy["database_dirpath"],
        "scene_key": policy["scene_key"],
        "split_dir": policy["split_dir"],
        # the published VW02 priors: 64 planes (LLFF, RealEstate), 128 (DTU)
        "num_depth_planes": policy.get("num_depth_planes", 64),
        "temperature": 10,
        "resolution_suffix": policy["resolution_suffix"],
    }
    if "fixed_bounds" in policy:
        configs["fixed_bounds"] = list(policy["fixed_bounds"])
    if policy.get("depth_planes_linear"):
        configs["depth_planes_linear"] = True
    return configs


def build_sparse_depth_configs(database: str, gen_num: int, set_num: Optional[int] = None) -> Dict:
    policy = DATASET_POLICIES[database]
    return {
        "generator": "vipnerf_tpu_torch.priors.sparse_depth",
        "gen_num": gen_num,
        "gen_set_num": set_num if set_num is not None else gen_num,
        "database_name": database,
        "database_dirpath": policy["database_dirpath"],
        "scene_key": policy["scene_key"],
        "split_dir": policy["split_dir"],
        "resolution_suffix": policy["resolution_suffix"],
    }


def _parser(prior_name: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=f"python -m vipnerf_tpu_torch.priors.{prior_name}",
        description=f"Generate the {prior_name} prior of a database",
    )
    parser.add_argument("--database", required=True, choices=sorted(DATASET_POLICIES))
    parser.add_argument("--gen_nums", type=int, nargs="+", default=[2],
                        help="gen numbers == train-set numbers (the demos use 2 3 4)")
    parser.add_argument("--root_dirpath", default=".", help="project root containing data/databases/")
    return parser


def main_visibility(argv: Optional[List[str]] = None):
    from vipnerf_tpu_torch.priors.visibility import start_generation

    parser = _parser("visibility")
    parser.add_argument("--device", default="all",
                        help='"all" (the first GPU), a GPU index or a list of them (the first), or "cpu"')
    args = parser.parse_args(argv)
    directions = []
    for gen_num in args.gen_nums:
        print(f"visibility prior: {args.database} VW{gen_num:02} (set{gen_num:02})", flush=True)
        directions += start_generation(build_visibility_configs(args.database, gen_num),
                                       root_dirpath=args.root_dirpath, device=device_from_arg(args.device))
    return directions


def main_sparse_depth(argv: Optional[List[str]] = None):
    from vipnerf_tpu_torch.priors.sparse_depth import start_generation

    args = _parser("sparse_depth").parse_args(argv)
    for gen_num in args.gen_nums:
        print(f"sparse-depth prior: {args.database} DE{gen_num:02} (set{gen_num:02})", flush=True)
        start_generation(build_sparse_depth_configs(args.database, gen_num), root_dirpath=args.root_dirpath)
