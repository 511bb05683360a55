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


# Masks the losses select rays with: their pad rows are False, so the
# edge-repeated pad rays of the last tile count in no loss. `ray_valid` is
# added for loss renders, so that losses without a stream mask skip them too.
_LOSS_MASK_KEYS = ("indices_mask_nerf", "indices_mask_sparse_depth", "ray_valid")


def _split_batch(batch: Dict[str, Any], num_rays: int, tile: int):
    """Pad ray-axis fields to a multiple of `tile` (loss masks with False,
    the rest by edge repetition) and yield the tiles; other fields go to
    every tile unchanged."""
    num_tiles = (num_rays + tile - 1) // tile
    pad = num_tiles * tile - num_rays
    ray_keys = {
        k for k, v in batch.items()
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == num_rays
    }
    padded = {}
    for k, v in batch.items():
        if k in ray_keys and pad:
            fill = torch.zeros_like(v[:1]) if k in _LOSS_MASK_KEYS else v[-1:]
            v = torch.cat([v, fill.expand((pad,) + v.shape[1:])], dim=0)
        padded[k] = v
    for t in range(num_tiles):
        yield {
            k: v[t * tile:(t + 1) * tile] if k in ray_keys else v
            for k, v in padded.items()
        }


class TiledRenderer:
    """Renders arbitrary-size ray batches in fixed-size tiles; with a
    `loss_computer`, also the losses of the batch."""

    def __init__(self, render_fn: Callable, configs: Dict[str, Any], loss_computer=None):
        self.render_fn = render_fn
        self.configs = configs
        self.loss_computer = loss_computer

    @torch.no_grad()
    def render(
        self,
        model,
        batch: Dict[str, Any],
        *,
        chunk_size: int = 65536,
        sec_views_vis: bool = False,
        with_losses: bool = False,
        return_loss_maps: bool = False,
    ):
        """Render `batch` (nr rays) -> (outputs, losses): outputs a dict of
        numpy arrays (nr, ...); losses None, or with `with_losses` each loss's
        {'loss_value': float[, 'loss_maps': {name: (nr,) array}]} and
        'TotalLoss', merged over the tiles with weights from their real ray
        counts, so the frame's loss does not depend on the tile size."""
        if with_losses and self.loss_computer is None:
            raise ValueError("rendering with losses needs a loss_computer")
        nr = int(batch["rays_o"].shape[0])
        if with_losses and "ray_valid" not in batch:
            batch = {**batch, "ray_valid": torch.ones(nr, dtype=torch.bool,
                                                      device=batch["rays_o"].device)}
        tile = min(chunk_size, nr)
        parts: Dict[str, List[torch.Tensor]] = {}
        tile_losses: List[Dict[str, Any]] = []
        for tile_batch in _split_batch(batch, nr, tile):
            out = self.render_fn(
                model, self.configs, tile_batch, train=False, sec_views_vis=sec_views_vis,
                retraw=with_losses,
            )
            for k in _KEEP_KEYS:
                if k in out:
                    parts.setdefault(k, []).append(out[k])
            if with_losses:
                tile_losses.append(self.loss_computer.compute_losses(
                    tile_batch, out, return_loss_maps=return_loss_maps))
        outputs = {
            k: torch.cat(v, dim=0)[:nr].cpu().numpy() for k, v in parts.items()
        }
        return outputs, (_merge_losses(tile_losses, nr, tile) if with_losses else None)


def _merge_losses(tile_losses: List[Dict[str, Any]], nr: int, tile: int) -> Dict[str, Any]:
    """Tile losses -> frame losses: values averaged with the tiles' real ray
    counts as weights (one copy to the host), loss maps concatenated."""
    counts = torch.tensor([min(tile, nr - t * tile) for t in range(len(tile_losses))],
                          dtype=torch.float64)

    def wmean(values):
        v = torch.stack([x.reshape(()) for x in values]).cpu().double()
        return float((v * counts).sum() / counts.sum())

    merged: Dict[str, Any] = {}
    for name, val in tile_losses[0].items():
        if not isinstance(val, dict):
            merged[name] = wmean([p[name] for p in tile_losses])
            continue
        merged[name] = {"loss_value": wmean([p[name]["loss_value"] for p in tile_losses])}
        if "loss_maps" in val:
            merged[name]["loss_maps"] = {
                mk: torch.cat([p[name]["loss_maps"][mk] for p in tile_losses])[:nr].cpu().numpy()
                for mk in val["loss_maps"]
            }
    return merged
