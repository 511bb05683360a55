"""Tiled full-image rendering (counterpart of vipnerf_tpu/infer/renderer.py).

Rays are cut into tiles of `chunk_size`; the last tile is padded by
repeating its last ray, so every tile has the same shape. Each tile renders
eagerly on the model's device, the kept outputs stay there, and one copy at
the end brings the frame to the host. Outputs do not depend on the tile size.
"""

import copy
from typing import Any, Callable, Dict, List, Optional

import torch

# Keys returned to the host from a tile render (missing ones are skipped).
_KEEP_KEYS = (
    "rgb_coarse", "rgb_fine",
    "acc_coarse", "acc_fine",
    "depth_coarse", "depth_fine",
    "depth_var_coarse", "depth_var_fine",
    "depth_ndc_coarse", "depth_ndc_fine",
    "depth_var_ndc_coarse", "depth_var_ndc_fine",
    "visibility2_coarse", "visibility2_fine",
)

# The default-preview sample budget (coarse, fine).
PREVIEW_BUDGET = (32, 8)


def preview_budget_configs(configs: Dict[str, Any]) -> Dict[str, Any]:
    """`preview: true` render configs: the reduced 32+8 sample budget through
    the full coarse+fine pipeline, never above the trained counts."""
    out = copy.deepcopy(configs)
    coarse, fine = PREVIEW_BUDGET
    coarse_mlp = out["model"]["coarse_mlp"]
    coarse_mlp["num_samples"] = min(coarse, coarse_mlp["num_samples"])
    fine_mlp = out["model"].get("fine_mlp")
    if fine_mlp is not None:
        fine_mlp["num_samples"] = min(fine, fine_mlp["num_samples"])
    return out


def preview_configs(
    configs: Dict[str, Any], num_samples: Optional[int] = None
) -> Dict[str, Any]:
    """`preview: N` render configs: the coarse field alone (a density/debug
    view), optionally at `num_samples`. The model keeps both MLPs; the fine
    one is simply not evaluated."""
    out = copy.deepcopy({k: v for k, v in configs.items() if k != "model"})
    model = {k: v for k, v in configs["model"].items() if k != "fine_mlp"}
    model["coarse_mlp"] = dict(model["coarse_mlp"])
    if num_samples is not None:
        model["coarse_mlp"]["num_samples"] = int(num_samples)
    out["model"] = model
    return out


def _split_batch(batch: Dict[str, Any], num_rays: int, tile: int):
    """Pad ray-axis fields to a multiple of `tile` by edge repetition and
    yield the tiles; other fields go to every tile unchanged."""
    num_tiles = (num_rays + tile - 1) // tile
    pad = num_tiles * tile - num_rays
    ray_keys = {
        k for k, v in batch.items()
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == num_rays
    }
    padded = {}
    for k, v in batch.items():
        if k in ray_keys and pad:
            v = torch.cat([v, v[-1:].expand((pad,) + v.shape[1:])], dim=0)
        padded[k] = v
    for t in range(num_tiles):
        yield {
            k: v[t * tile:(t + 1) * tile] if k in ray_keys else v
            for k, v in padded.items()
        }


class TiledRenderer:
    """Renders arbitrary-size ray batches in fixed-size tiles."""

    def __init__(self, render_fn: Callable, configs: Dict[str, Any]):
        self.render_fn = render_fn
        self.configs = configs

    @torch.no_grad()
    def render(
        self,
        model,
        batch: Dict[str, Any],
        *,
        chunk_size: int = 65536,
        sec_views_vis: bool = False,
        with_losses: bool = False,
    ):
        """Render `batch` (nr rays) -> (outputs, None): outputs a dict of
        numpy arrays (nr, ...). In-render losses arrive with the losses slice."""
        if with_losses:
            raise NotImplementedError(
                "rendering with losses arrives with the losses slice of the port"
            )
        nr = int(batch["rays_o"].shape[0])
        tile = min(chunk_size, nr)
        parts: Dict[str, List[torch.Tensor]] = {}
        for tile_batch in _split_batch(batch, nr, tile):
            out = self.render_fn(
                model, self.configs, tile_batch, train=False, sec_views_vis=sec_views_vis,
            )
            for k in _KEEP_KEYS:
                if k in out:
                    parts.setdefault(k, []).append(out[k])
        outputs = {
            k: torch.cat(v, dim=0)[:nr].cpu().numpy() for k, v in parts.items()
        }
        return outputs, None
