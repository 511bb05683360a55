"""Model factory: `configs['model']['name']` -> (build, render) pair
(counterpart of vipnerf_tpu/models/factory.py; the reference name
'VipNeRF01' is kept)."""

from typing import Any, Callable, Dict, Tuple

from vipnerf_tpu_torch.models import vip_nerf

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {
    "VipNeRF01": (vip_nerf.ViPNeRF, vip_nerf.render_rays),
}


def get_model(configs: Dict[str, Any]) -> Tuple[Callable, Callable]:
    """Return (model class, render_rays) for `configs['model']['name']`."""
    name = configs["model"]["name"]
    if name not in _REGISTRY:
        raise RuntimeError(f"Unknown model: {name}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
