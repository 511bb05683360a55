"""The ViP-NeRF renderer: hierarchical coarse+fine NeRF with a visibility
head (counterpart of vipnerf_tpu/models/vip_nerf.py).

`ViPNeRF` holds the `coarse_model` / `fine_model` MLPs, so its state_dict
keys are the reference checkpoint's. `render_rays` runs a ray batch through
both levels. The MLP of a level runs through K1 (kernels/fused_mlp.py) when
its config is the flagship architecture, in every precision mode: bf16
matmuls with f32 heads (the shipped one), with bf16 heads, or f32, each
through its own instance; every other config runs the `nn.Module` MLP. The
choice is made from the config alone.

A stacked model (`ViPNeRF(..., scenes=S)`, or `stack_models`) holds S
scenes' MLPs with a leading scene axis, for batched multi-scene training
(the counterpart of vmapping the JAX renderer over stacked params). Its
`render_rays` takes S scenes' rays flattened scene-major, S*R of them with R
per scene, and samples, encodes, resamples and composites them as one
batch; the near/far planes are per ray, each scene's secondary-view origins
come from its own `poses` (S, nf, 4, 4), and each MLP call runs every scene
on its own weights at once (K1 with a scene axis, or batched products).
`unstack_model` gives one scene's `ViPNeRF` back, for checkpoints and
validation.

Under a profiler session `render_rays` also records its phases as spans
(`utils/tracing.py` `detail`): `rays.sample`, then per level
`rays.<level>.points` (samples and other-view directions), `.mlp` (K1's
launch or the module) and `.composite`, with `rays.resample` between.
"""

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from vipnerf_tpu_torch.core.rays import ndc_z_to_ray_t
from vipnerf_tpu_torch.core.rendering import volume_rendering
from vipnerf_tpu_torch.core.sampling import coarse_z_vals, fine_z_vals
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.models.mlp import NeRFMLP
from vipnerf_tpu_torch.utils import tracing


class ViPNeRF(nn.Module):
    """Coarse (+ fine) MLPs per `configs['model']`; with `scenes`, S of each,
    stacked, all starting from the weights one model draws."""

    def __init__(self, configs: Dict[str, Any], generator: Optional[torch.Generator] = None,
                 scenes: Optional[int] = None):
        super().__init__()
        mcfg = configs["model"]
        if "fine_mlp" in mcfg and "coarse_mlp" not in mcfg:
            raise RuntimeError("fine_mlp requires coarse_mlp")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.configs = configs
        self.scenes = scenes
        if "coarse_mlp" in mcfg:
            self.coarse_model = NeRFMLP(mcfg["coarse_mlp"], generator, scenes)
        if "fine_mlp" in mcfg:
            self.fine_model = NeRFMLP(mcfg["fine_mlp"], generator, scenes)


@torch.no_grad()
def stack_models(models: List[ViPNeRF], into: Optional[ViPNeRF] = None) -> ViPNeRF:
    """S single-scene models -> one stacked model (`into`, in place, when
    given: its parameters, and an optimizer's references to them, stay)."""
    if into is None:
        into = ViPNeRF(models[0].configs, scenes=len(models)).to(next(models[0].parameters()).device)
    states = [m.state_dict() for m in models]
    for name, p in into.named_parameters():
        p.copy_(torch.stack([sd[name] for sd in states]))
    return into


@torch.no_grad()
def unstack_model(stacked: ViPNeRF, scene: int) -> ViPNeRF:
    """Scene `scene` of a stacked model as a single-scene model (a copy)."""
    model = ViPNeRF(stacked.configs).to(next(stacked.parameters()).device)
    model.load_state_dict({k: v[scene] for k, v in stacked.state_dict().items()})
    return model


def uses_fused_mlp(mlp_cfg: Dict[str, Any], bf16_matmuls: bool, f32_heads: bool) -> Optional[str]:
    """The K1 instance a level's MLP runs through in this precision mode, or
    None (the nn.Module MLP) for a config other than the flagship."""
    return k1.INSTANCE[k1.precision(bf16_matmuls, f32_heads)] if k1.supports_config(mlp_cfg) else None


def _gather_secondary_origins(poses: torch.Tensor, pixel_id: torch.Tensor) -> torch.Tensor:
    """Per-ray other-view camera centres (nr, nf-1, 3); other_id = j + (j >= image_id).
    With stacked poses (S, nf, 4, 4) the rays are S scenes' in order, and each
    ray takes its own scene's poses."""
    nf = poses.shape[-3]
    image_id = pixel_id[:, 0].long()
    j = torch.arange(nf - 1, device=poses.device)
    other_ids = j[None, :] + (j[None, :] >= image_id[:, None]).long()
    centres = poses[..., :3, 3]
    if poses.dim() == 3:
        return centres[other_ids]
    nr, scenes = pixel_id.shape[0], poses.shape[0]
    scene = torch.arange(nr, device=poses.device) // (nr // scenes)
    return centres[scene[:, None], other_ids]


def _compute_other_view_dirs(
    z_vals: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor,
    rays_o2: torch.Tensor, ndc: bool,
) -> torch.Tensor:
    """Unit dirs (nr, ns, nf-1, 3) from the secondary camera centres to the
    ray points; NDC z' is converted to metric t (near=1) first."""
    t = ndc_z_to_ray_t(z_vals, rays_o, rays_d) if ndc else z_vals
    pts = rays_o[..., None, :] + t[..., None] * rays_d[..., None, :]
    d = pts[:, :, None, :] - rays_o2[:, None, :, :]
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def _run_mlp_on_samples(
    mlp: NeRFMLP,
    pts: torch.Tensor,
    view_dirs: Optional[torch.Tensor],
    view_dirs2: Optional[torch.Tensor],
    *,
    raw_noise_std: float,
    generator: Optional[torch.Generator],
    bf16_matmuls: bool,
    f32_heads: bool,
) -> Dict[str, torch.Tensor]:
    """Flatten (nr, ns, ...) samples, run the MLP (K1 or the module), reshape
    back; a stacked MLP gets them as (S, nr * ns / S, ...), scene by scene.
    K1 takes the view dirs per ray (its encode reads them with the sample
    stride); the module gets them copied out to every sample."""
    nr, ns = pts.shape[0], pts.shape[1]
    lead = (nr * ns,) if mlp.scenes is None else (mlp.scenes, nr * ns // mlp.scenes)
    pts_flat = pts.reshape(*lead, 3)
    vd2_flat = None
    if view_dirs2 is not None:
        vd2_flat = view_dirs2.reshape(*lead, view_dirs2.shape[2], 3)

    if uses_fused_mlp(mlp.cfg, bf16_matmuls, f32_heads):
        raw = k1.apply_fused_mlp(
            mlp, pts_flat, view_dirs, vd2_flat,
            raw_noise_std=raw_noise_std, generator=generator,
            dtype=torch.bfloat16 if bf16_matmuls else torch.float32, f32_heads=f32_heads,
        )
    else:
        vd_flat = None if view_dirs is None else view_dirs[:, None, :].expand(nr, ns, 3).reshape(*lead, 3)
        raw = mlp(
            pts_flat, vd_flat, vd2_flat,
            raw_noise_std=raw_noise_std, generator=generator,
            bf16_matmuls=bf16_matmuls, f32_heads=f32_heads,
        )
    return {k: v.reshape((nr, ns) + v.shape[len(lead):]) for k, v in raw.items()}


def render_rays(
    model: ViPNeRF,
    configs: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    *,
    train: bool,
    sec_views_vis: bool = False,
    retraw: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Render a batch of rays through the coarse (+ fine) MLPs.

    `batch` fields (all (nr, ...)): rays_o, rays_d, view_dirs, near, far;
    NDC adds rays_o_ndc, rays_d_ndc, near_ndc, far_ndc. Secondary visibility
    takes `rays_o2` (nr, nf-1, 3), or `pixel_id` + `poses` (nf, 4, 4). A
    stacked model takes S scenes' rays in order (nr = S * R) and poses
    (S, nf, 4, 4).
    `generator` drives the perturbation and the sigma noise when training.

    Output: {rgb, acc, alpha, visibility, weights, depth, depth_var
    [, depth_ndc, depth_var_ndc][, visibility2]}_{coarse,fine}, z_vals_* and
    raw_* with retraw; z_vals, visibility and weights dropped without it.
    """
    mcfg = configs["model"]
    ndc = configs["data_loader"]["ndc"]
    retraw = retraw or train
    sec_views_vis = sec_views_vis or train
    coarse_needed = "coarse_mlp" in mcfg
    fine_needed = "fine_mlp" in mcfg
    predict_visibility = (
        coarse_needed and mcfg["coarse_mlp"]["predict_visibility"]
    ) or (fine_needed and mcfg["fine_mlp"]["predict_visibility"])
    perturb = bool(mcfg["perturb"]) and train
    if (perturb or (train and mcfg["raw_noise_std"] > 0)) and generator is None:
        raise ValueError("training with perturb or sigma noise needs a torch.Generator")
    level_args = dict(
        ndc=ndc,
        white_bkgd=mcfg["white_bkgd"],
        sec_views_vis=sec_views_vis,
        raw_noise_std=mcfg["raw_noise_std"] if train else 0.0,
        generator=generator,
        bf16=mcfg.get("bf16_matmuls", False),
        f32_heads=mcfg.get("f32_heads", False),
    )

    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    view_dirs = batch.get("view_dirs")
    if ndc:
        rays_o_s, rays_d_s = batch["rays_o_ndc"], batch["rays_d_ndc"]
        near, far = batch["near_ndc"], batch["far_ndc"]
    else:
        rays_o_s, rays_d_s = rays_o, rays_d
        near, far = batch["near"], batch["far"]

    rays_o2 = None
    if predict_visibility and sec_views_vis:
        if "rays_o2" in batch:
            rays_o2 = batch["rays_o2"]
        else:
            rays_o2 = _gather_secondary_origins(batch["poses"], batch["pixel_id"])

    out: Dict[str, torch.Tensor] = {}
    z_coarse = weights_coarse = None
    if coarse_needed:
        with tracing.detail("rays.sample"):
            z_coarse = coarse_z_vals(
                near, far, mcfg["coarse_mlp"]["num_samples"], lindisp=mcfg["lindisp"],
                perturb=perturb, generator=generator,
            )
        out_c, raw_c = _render_one_level(
            "coarse", model.coarse_model, mcfg["coarse_mlp"], z_coarse, rays_o, rays_d,
            rays_o_s, rays_d_s, view_dirs, rays_o2, **level_args,
        )
        weights_coarse = out_c["weights"]
        _collect(out, "coarse", z_coarse, out_c, raw_c, retraw)

    if fine_needed:
        with tracing.detail("rays.resample"):
            z_fine = fine_z_vals(
                z_coarse, weights_coarse, mcfg["fine_mlp"]["num_samples"],
                perturb=perturb, generator=generator,
            )
        out_f, raw_f = _render_one_level(
            "fine", model.fine_model, mcfg["fine_mlp"], z_fine, rays_o, rays_d,
            rays_o_s, rays_d_s, view_dirs, rays_o2, **level_args,
        )
        _collect(out, "fine", z_fine, out_f, raw_f, retraw)

    if not retraw:
        for suffix in ("coarse", "fine"):
            for k in ("z_vals", "visibility", "weights"):
                out.pop(f"{k}_{suffix}", None)
    return out


def _collect(out, suffix, z_vals, level_out, level_raw, retraw):
    out[f"z_vals_{suffix}"] = z_vals
    for k, v in level_out.items():
        out[f"{k}_{suffix}"] = v
    if retraw:
        for k, v in level_raw.items():
            out[f"raw_{k}_{suffix}"] = v


def _render_one_level(
    level: str,
    mlp: NeRFMLP,
    mlp_cfg: Dict[str, Any],
    z_vals: torch.Tensor,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    rays_o_s: torch.Tensor,
    rays_d_s: torch.Tensor,
    view_dirs: Optional[torch.Tensor],
    rays_o2: Optional[torch.Tensor],
    *,
    ndc: bool,
    white_bkgd: bool,
    sec_views_vis: bool,
    raw_noise_std: float,
    generator: Optional[torch.Generator],
    bf16: bool,
    f32_heads: bool,
):
    """One MLP evaluation + compositing pass (`level`: coarse or fine)."""
    with tracing.detail(f"rays.{level}.points"):
        pts = rays_o_s[..., None, :] + rays_d_s[..., None, :] * z_vals[..., :, None]
        view_dirs2 = None
        if mlp_cfg["predict_visibility"] and sec_views_vis and rays_o2 is not None:
            view_dirs2 = _compute_other_view_dirs(z_vals, rays_o, rays_d, rays_o2, ndc)

    with tracing.detail(f"rays.{level}.mlp"):
        raw = _run_mlp_on_samples(
            mlp, pts, view_dirs if mlp_cfg["use_view_dirs"] else None, view_dirs2,
            raw_noise_std=raw_noise_std, generator=generator,
            bf16_matmuls=bf16, f32_heads=f32_heads,
        )
    with tracing.detail(f"rays.{level}.composite"):
        if not ndc:
            outputs = volume_rendering(
                raw["rgb"], raw["sigma"][..., 0], z_vals=z_vals, rays_d=rays_d,
                white_bkgd=white_bkgd, ndc=False, visibility2=raw.get("visibility2"),
            )
        else:
            outputs = volume_rendering(
                raw["rgb"], raw["sigma"][..., 0], z_vals_ndc=z_vals, rays_d_ndc=rays_d_s,
                rays_o=rays_o, rays_d=rays_d, white_bkgd=white_bkgd, ndc=True,
                visibility2=raw.get("visibility2"),
            )
    return outputs, raw
