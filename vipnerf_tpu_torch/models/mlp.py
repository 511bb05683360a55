"""The ViP-NeRF MLP as an `nn.Module` (counterpart of vipnerf_tpu/models/mlp.py).

Parameter names and registration order are the reference torch model's
(`pts_linears.N`, `views_linears.0`, `pts_output_linear`, `feature_linear`,
`views_output_linear`; weights (out, in)), so a state_dict of this module is
a reference state_dict.

- trunk: `netdepth` x `netwidth` linear+ReLU, with the skip concat
  [encoded_pts, h] after layer 4;
- pts head: sigma (+ 3 view-independent rgb), sigma noise before ReLU;
- view branch: feature linear, concat encoded view dirs, one ReLU layer of
  width/2, output [3 rgb][1 visibility] through sigmoids;
- secondary views re-run the view branch per other view, folded point-major
  into the batch, giving visibility2 (npts, nf-1, 1).

`bf16_matmuls` runs every matmul on bf16 operands with f32 accumulation
rounded to bf16, then adds the bf16 bias; `f32_heads` keeps the heads in f32
on the upcast trunk output. Both as in the JAX package.

With `scenes=S` the module holds S MLPs of one config (batched multi-scene
training): every parameter gets a leading scene axis (`StackedLinear`, same
names), inputs and outputs gain it too, and each layer is one batched
product over the scenes (`core.scene_linear.scene_matmul`, a `torch.bmm`,
with the bf16 product rounded before the bias add as in `_dense`). Every
scene starts from the weights the unstacked module draws from the same
generator.
"""

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vipnerf_tpu_torch.core.encoding import encoding_dim, positional_encoding
from vipnerf_tpu_torch.core.sampling import ray_draw
from vipnerf_tpu_torch.core.scene_linear import scene_matmul

SKIPS = (4,)


def mlp_feature_dims(mlp_cfg: Dict[str, Any]) -> Dict[str, int]:
    """Static dims derived from an mlp config block (coarse_mlp / fine_mlp)."""
    pts_in = encoding_dim(3, mlp_cfg["points_positional_encoding_degree"])
    views_in = (
        encoding_dim(3, mlp_cfg["views_positional_encoding_degree"])
        if mlp_cfg["use_view_dirs"]
        else 0
    )
    view_dep_rgb = mlp_cfg["view_dependent_rgb"]
    return {
        "pts_in": pts_in,
        "views_in": views_in,
        "pts_out": 1 + (0 if view_dep_rgb else 3),
        "views_out": (3 if view_dep_rgb else 0)
        + (1 if mlp_cfg["predict_visibility"] else 0),
    }


class StackedLinear(nn.Module):
    """`scenes` linear layers of one shape: weight (S, out, in), bias (S, out)."""

    def __init__(self, in_features: int, out_features: int, scenes: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(scenes, out_features, in_features))
        self.bias = nn.Parameter(torch.empty(scenes, out_features))


def _linear(fan_in: int, fan_out: int, scenes: Optional[int] = None) -> nn.Module:
    """A layer whose parameters are filled later (no global-RNG init)."""
    if scenes is not None:
        return StackedLinear(fan_in, fan_out, scenes)
    return torch.nn.utils.skip_init(nn.Linear, fan_in, fan_out)


def _dense(x: torch.Tensor, layer: nn.Module, bf16: bool) -> torch.Tensor:
    """x @ w.T + b; in bf16 the product is rounded before the bf16 bias add.
    A stacked layer takes x (S, n, in) and multiplies scene by scene."""
    if layer.weight.dim() == 3:
        if bf16:
            y = scene_matmul(x.to(torch.bfloat16), layer.weight.to(torch.bfloat16))
            return y + layer.bias.to(torch.bfloat16)[:, None]
        return scene_matmul(x, layer.weight) + layer.bias[:, None]
    if bf16:
        y = F.linear(x.to(torch.bfloat16), layer.weight.to(torch.bfloat16))
        return y + layer.bias.to(torch.bfloat16)
    return F.linear(x, layer.weight, layer.bias)


class NeRFMLP(nn.Module):
    """One MLP (coarse or fine) of the ViP-NeRF model."""

    def __init__(
        self, mlp_cfg: Dict[str, Any], generator: Optional[torch.Generator] = None,
        scenes: Optional[int] = None,
    ):
        super().__init__()
        if not mlp_cfg["use_view_dirs"] and (
            mlp_cfg["view_dependent_rgb"] or mlp_cfg["predict_visibility"]
        ):
            raise RuntimeError(
                "view_dependent_rgb / predict_visibility require use_view_dirs"
            )
        self.cfg = dict(mlp_cfg)
        self.scenes = scenes
        depth, width = mlp_cfg["netdepth"], mlp_cfg["netwidth"]
        dims = mlp_feature_dims(mlp_cfg)
        self.view_dep_outputs = (
            mlp_cfg["view_dependent_rgb"] or mlp_cfg["predict_visibility"]
        )

        layers = []
        in_dim = dims["pts_in"]
        for i in range(depth):
            layers.append(_linear(in_dim, width, scenes))
            in_dim = width + dims["pts_in"] if i in SKIPS else width
        self.pts_linears = nn.ModuleList(layers)
        if self.view_dep_outputs:
            self.views_linears = nn.ModuleList(
                [_linear(dims["views_in"] + width, width // 2, scenes)]
            )
        self.pts_output_linear = _linear(width, dims["pts_out"], scenes)
        if self.view_dep_outputs:
            self.feature_linear = _linear(width, width, scenes)
            self.views_output_linear = _linear(width // 2, dims["views_out"], scenes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch.nn.Linear's bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn
        from `generator` (a fresh generator seeded 0 when None); a stacked
        layer draws one scene's values and gives them to every scene."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for module in self.modules():
            if isinstance(module, (nn.Linear, StackedLinear)):
                bound = 1.0 / math.sqrt(module.in_features)
                for p in (module.weight, module.bias):
                    shape = p.shape[1:] if isinstance(module, StackedLinear) else p.shape
                    vals = torch.rand(shape, generator=generator, dtype=torch.float32)
                    p.copy_(vals * (2 * bound) - bound)

    def forward(
        self,
        pts: torch.Tensor,
        view_dirs: Optional[torch.Tensor] = None,
        view_dirs2: Optional[torch.Tensor] = None,
        *,
        raw_noise_std: float = 0.0,
        generator: Optional[torch.Generator] = None,
        bf16_matmuls: bool = False,
        f32_heads: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """pts (npts, 3); view_dirs (npts, 3); view_dirs2 (npts, nf-1, 3);
        a stacked module takes each with a leading scene axis (S, npts, ...).

        Returns sigma (npts, 1), rgb (npts, 3) and, as configured,
        rgb_view_independent / rgb_view_dependent / visibility /
        visibility2 (npts, nf-1, 1), all f32. Sigma noise is drawn from
        `generator` when raw_noise_std > 0.
        """
        cfg = self.cfg
        view_dep_rgb = cfg["view_dependent_rgb"]
        predict_visibility = cfg["predict_visibility"]

        fast = cfg.get("fast_encoding", False)
        enc_pts = positional_encoding(pts, cfg["points_positional_encoding_degree"], fast)
        h = enc_pts
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(_dense(h, layer, bf16_matmuls))
            if i in SKIPS:
                h = torch.cat([enc_pts.to(h.dtype), h], dim=-1)

        head_bf16 = bf16_matmuls and not f32_heads
        if bf16_matmuls and f32_heads:
            h = h.float()

        out: Dict[str, torch.Tensor] = {}
        pts_output = _dense(h, self.pts_output_linear, head_bf16)
        sigma = pts_output[..., 0:1]
        if raw_noise_std > 0.0 and generator is not None:
            noise = ray_draw(sigma.shape, generator, sigma.device, normal=True)
            sigma = sigma + (raw_noise_std * noise).to(sigma.dtype)
        out["sigma"] = torch.relu(sigma)
        if not view_dep_rgb:
            rgb = torch.sigmoid(pts_output[..., 1:4])
            out["rgb_view_independent"] = rgb

        if self.view_dep_outputs:
            if view_dirs is None:
                raise ValueError("view-dependent outputs need view_dirs")
            feature = _dense(h, self.feature_linear, head_bf16)
            degree = cfg["views_positional_encoding_degree"]

            def view_branch(enc_views: torch.Tensor, feat: torch.Tensor):
                hv = torch.cat([feat, enc_views.to(feat.dtype)], dim=-1)
                for layer in self.views_linears:
                    hv = torch.relu(_dense(hv, layer, head_bf16))
                view_out = _dense(hv, self.views_output_linear, head_bf16)
                branch: Dict[str, torch.Tensor] = {}
                ch = 0
                if view_dep_rgb:
                    branch["rgb_view_dependent"] = torch.sigmoid(view_out[..., 0:3])
                    ch = 3
                if predict_visibility:
                    branch["visibility"] = torch.sigmoid(view_out[..., ch:ch + 1])
                return branch

            primary = view_branch(positional_encoding(view_dirs, degree, fast), feature)
            out.update(primary)
            if view_dep_rgb:
                rgb = primary["rgb_view_dependent"]

            if predict_visibility and view_dirs2 is not None:
                lead, (npts, nf_m1) = view_dirs2.shape[:-3], view_dirs2.shape[-3:-1]
                enc2 = positional_encoding(view_dirs2.reshape(*lead, npts * nf_m1, 3), degree, fast)
                feat2 = feature.repeat_interleave(nf_m1, dim=-2) if nf_m1 > 1 else feature
                vis2 = view_branch(enc2, feat2)["visibility"]
                out["visibility2"] = vis2.reshape(*lead, npts, nf_m1, 1)

        out["rgb"] = rgb
        return {k: v.float() for k, v in out.items()}
