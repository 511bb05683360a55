"""Data-loader factory: the reference's loader names -> dataset specs."""

from typing import Optional

from vipnerf_tpu_torch.data.loaders.base import (
    DTU_SPEC,
    NERF_LLFF_SPEC,
    REAL_ESTATE_SPEC,
    DataLoader,
)

_REGISTRY = {
    "NerfLlffDataLoader01": NERF_LLFF_SPEC,
    "RealEstateDataLoader01": REAL_ESTATE_SPEC,
    "DtuDataLoader01": DTU_SPEC,
}


def get_data_loader(configs: dict, data_dirpath, mode: Optional[str]) -> DataLoader:
    name = configs["data_loader"]["data_loader_name"]
    if name not in _REGISTRY:
        raise RuntimeError(f"Unknown data loader: {name}; known: {sorted(_REGISTRY)}")
    return DataLoader(_REGISTRY[name], configs, data_dirpath, mode)
