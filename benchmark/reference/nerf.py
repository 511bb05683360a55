"""The plain reference of ViP-NeRF's model, renderer, losses and optimizer,
in plain torch, written from the ViP-NeRF paper and its published code
(NagabhushanSN95/ViP-NeRF: `VipNeRF01`, the four losses, Adam with the
NeRF learning-rate decay). It imports nothing of the program and takes
nothing the program made: weights, rays and targets come from the
benchmark's own inputs.

Precision: the configuration's. With `bf16_matmuls` every layer of the
trunk (layers 0-7) takes bf16 operands, rounds its product to bf16, adds
the bf16 bias and rounds again, as a bf16 GEMM with a bf16 epilogue does;
with `f32_heads` the feature, sigma and view layers run in float32 on the
trunk's bf16 output. Products are float32 matmuls with TF32 off
(`no_tf32`). The rounding is straight-through: the backward pass is the
float32 gradient of the rounded forward.

MLP (per level, `VipNeRF01`): PE of the point (degree 10, with the input)
-> 8 x 256 ReLU layers with the encoded point concatenated to layer 4's
output -> sigma (one linear) and a 256 feature (one linear) -> [feature,
PE(dir, 4)] -> 128 ReLU -> rgb (3, sigmoid) and visibility (1, sigmoid); for
each other training view, its direction through the same view branch gives
that view's visibility. Sigma gets N(0, raw_noise_std) noise while training,
then ReLU.
"""

import contextlib
from typing import Dict, List, Optional

import torch

from reference import geometry

# module parameter names of one level, in the order the program's optimizer
# flattens them (the reference checkpoint's)
LEAVES = [f"pts_linears.{i}.{k}" for i in range(8) for k in ("weight", "bias")] + [
    "views_linears.0.weight", "views_linears.0.bias", "pts_output_linear.weight", "pts_output_linear.bias",
    "feature_linear.weight", "feature_linear.bias", "views_output_linear.weight", "views_output_linear.bias"]


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, kept in float32, with the gradient passed straight through."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def encode(x: torch.Tensor, degree: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(d-1) x), cos(2^(d-1) x)]."""
    blocks = [x]
    for k in range(degree):
        blocks += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(blocks, dim=-1)


def dense(x: torch.Tensor, params: Dict[str, torch.Tensor], name: str, bf16: bool) -> torch.Tensor:
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    if not bf16:
        return x @ w.t() + b
    return round_bf16(round_bf16(round_bf16(x) @ round_bf16(w).t()) + round_bf16(b))


def mlp(params: Dict[str, torch.Tensor], pts: torch.Tensor, dirs: torch.Tensor,
        dirs2: Optional[torch.Tensor], precision: Dict[str, bool]) -> Dict[str, torch.Tensor]:
    """One level's raw outputs for points (n, 3), their view dirs (n, 3) and
    the other views' dirs (n, v, 3): sigma (before noise), rgb logits (n, 3),
    visibility logit (n,), other views' visibility logits (n, v)."""
    trunk_bf16 = precision["bf16_matmuls"]
    heads_bf16 = trunk_bf16 and not precision["f32_heads"]
    xe = encode(pts, 10)
    if trunk_bf16:
        xe = round_bf16(xe)
    h = xe
    for i in range(8):
        h = torch.relu(dense(h, params, f"pts_linears.{i}", trunk_bf16))
        if i == 4:
            h = torch.cat([xe, h], dim=-1)
    sigma = dense(h, params, "pts_output_linear", heads_bf16)[:, 0]
    feature = dense(h, params, "feature_linear", heads_bf16)

    def view_branch(d):
        enc = encode(d, 4)
        hv = torch.relu(dense(torch.cat([feature, enc], dim=-1), params, "views_linears.0", heads_bf16))
        return dense(hv, params, "views_output_linear", heads_bf16)

    out = view_branch(dirs)
    vis2 = None
    if dirs2 is not None and dirs2.shape[1]:
        vis2 = torch.stack([view_branch(dirs2[:, j])[:, 3] for j in range(dirs2.shape[1])], dim=1)
    return {"sigma": sigma, "rgb": out[:, :3], "vis": out[:, 3], "vis2": vis2}


def coarse_depths(near: torch.Tensor, far: torch.Tensor, n: int, u: Optional[torch.Tensor]) -> torch.Tensor:
    """n depths from near to far (rays, 1); with u (rays, n), one uniform
    draw in each sample's stratum."""
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = near * (1.0 - t) + far * t
    if u is None:
        return z
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * u


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """NeRF's `sample_pdf`: depths at the quantiles u (rays, k) of the
    piecewise-constant density over `bins` (rays, m + 1) with weights
    (rays, m) + 1e-5; a bin under 1e-5 of the CDF wide divides by 1."""
    weights = weights + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1)
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = (above - 1).clamp(min=0)
    above = above.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = cdf.gather(-1, below), cdf.gather(-1, above)
    b0, b1 = bins.gather(-1, below), bins.gather(-1, above)
    denom = torch.where(c1 - c0 < 1e-5, torch.ones_like(c1), c1 - c0)
    return b0 + (u - c0) / denom * (b1 - b0)


def composite(sigma: torch.Tensor, rgb: torch.Tensor, z: torch.Tensor, dir_norm: torch.Tensor,
              tail: float) -> Dict[str, torch.Tensor]:
    """Alpha compositing along each ray: sigma, z (rays, s), rgb (rays, s, 3).
    The last sample reaches the depth `tail` (ViP-NeRF's renderer appends
    1e10 to metric depths, 1 to NDC ones, before taking differences)."""
    z1 = torch.cat([z, torch.full_like(z[:, :1], tail)], -1)
    dists = (z1[:, 1:] - z1[:, :-1]) * dir_norm
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    return {"weights": w, "trans": trans, "rgb": (w[..., None] * rgb).sum(1), "acc": w.sum(-1)}


def render_level(params, z: torch.Tensor, rays: Dict[str, torch.Tensor], precision, noise: Optional[torch.Tensor],
                 ndc: bool) -> Dict[str, torch.Tensor]:
    """One level at depths z (rays, s): MLP, noise, compositing, depth (and
    NDC depth), visibility towards the other views."""
    nr, ns = z.shape
    o_s, d_s = (rays["o_ndc"], rays["d_ndc"]) if ndc else (rays["o"], rays["d"])
    pts = o_s[:, None, :] + d_s[:, None, :] * z[..., None]
    dirs = rays["view_dirs"][:, None, :].expand(nr, ns, 3)
    dirs2 = None
    if rays.get("o2") is not None:
        t = geometry.ndc_to_ray_t(z, rays["o"], rays["d"]) if ndc else z
        world = rays["o"][:, None, :] + t[..., None] * rays["d"][:, None, :]
        diff = world[:, :, None, :] - rays["o2"][:, None, :, :]
        dirs2 = (diff / torch.linalg.norm(diff, dim=-1, keepdim=True)).reshape(nr * ns, -1, 3)
    raw = mlp(params, pts.reshape(-1, 3), dirs.reshape(-1, 3), dirs2, precision)
    sigma = raw["sigma"]
    if noise is not None:
        sigma = sigma + noise.reshape(-1)
    sigma = torch.relu(sigma).reshape(nr, ns)
    out = composite(sigma, torch.sigmoid(raw["rgb"]).reshape(nr, ns, 3), z,
                    torch.linalg.norm(d_s, dim=-1, keepdim=True), 1.0 if ndc else 1e10)
    w, acc = out["weights"], out["acc"]
    z_metric = geometry.ndc_to_metric_depth(z, rays["o"], rays["d"]) if ndc else z
    out["depth"] = (w * z_metric).sum(-1) / (acc + 1e-6)
    out["vis"] = torch.sigmoid(raw["vis"]).reshape(nr, ns)
    if raw["vis2"] is not None:
        vis2 = torch.sigmoid(raw["vis2"]).reshape(nr, ns, -1)
        out["vis2"] = (w[..., None] * vis2).sum(1) / (acc[:, None] + 1e-6)
    return out


def render_rays(params: Dict[str, Dict[str, torch.Tensor]], rays: Dict[str, torch.Tensor], model_cfg,
                ndc: bool, draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Coarse then fine level of a ray batch. `draws` (training) holds the
    stratification u, each level's sigma noise (already scaled by
    raw_noise_std) and the fine quantiles; without it the render is
    deterministic (quantiles evenly spaced, no noise)."""
    precision = {"bf16_matmuls": model_cfg["bf16_matmuls"], "f32_heads": model_cfg["f32_heads"]}
    near, far = (rays["near_ndc"], rays["far_ndc"]) if ndc else (rays["near"], rays["far"])
    nc, nf = model_cfg["coarse_mlp"]["num_samples"], model_cfg["fine_mlp"]["num_samples"]
    draws = draws or {}
    z_c = coarse_depths(near, far, nc, draws.get("u_coarse"))
    coarse = render_level(params["coarse"], z_c, rays, precision, draws.get("noise_coarse"), ndc)
    mids = 0.5 * (z_c[:, 1:] + z_c[:, :-1])
    u = draws.get("u_fine")
    if u is None:
        u = torch.linspace(0.0, 1.0, nf, device=z_c.device).expand(z_c.shape[0], nf).contiguous()
    z_f = inverse_cdf(mids, coarse["weights"][:, 1:-1].detach(), u).detach()
    z_f = torch.sort(torch.cat([z_c, z_f], -1), -1).values
    fine = render_level(params["fine"], z_f, rays, precision, draws.get("noise_fine"), ndc)
    return {"coarse": coarse, "fine": fine}


def losses(out, target_rgb: torch.Tensor, nerf: torch.Tensor, sd_depth: torch.Tensor, prior: torch.Tensor,
           weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """ViP-NeRF's four losses over a batch of NeRF rays (mask `nerf`) and
    sparse-depth rays (the rest): rgb MSE and the visibility prior on NeRF
    rays, both levels; the visibility consistency on every ray, both levels,
    each side against the other held fixed; the sparse-depth MSE of the fine
    depth on the sparse-depth rays."""
    m = nerf.float()
    sd = 1.0 - m
    mse = vis = prior_loss = 0.0
    for level in ("coarse", "fine"):
        o = out[level]
        mse = mse + ((o["rgb"] - target_rgb) ** 2).mean(-1).mul(m).sum() / m.sum().clamp(min=1)
        vis = vis + (o["vis"] - o["trans"].detach()).abs().mean(-1).mean() \
            + (o["vis"].detach() - o["trans"]).abs().mean(-1).mean()
        prior_loss = prior_loss + (prior * (1.0 - o["vis2"])).sum(-1).mul(m).sum() / m.sum().clamp(min=1)
    depth = ((out["fine"]["depth"] - sd_depth) ** 2).mul(sd).sum() / sd.sum().clamp(min=1)
    terms = {"MSE01": mse, "VisibilityLoss01": vis, "VisibilityPriorLoss01": prior_loss, "SparseDepthMSE01": depth}
    terms["TotalLoss"] = sum(weights[k] * v for k, v in terms.items())
    return terms


class Adam:
    """Adam (eps 1e-8 outside the square root, bias-corrected) at
    lr_initial * 0.1^(t / (lr_decay * 1000)) for the t-th update from 0."""

    def __init__(self, params: List[torch.Tensor], opt_cfg):
        self.params = params
        self.b1, self.b2 = opt_cfg["beta1"], opt_cfg["beta2"]
        self.lr0, self.decay = opt_cfg["lr_initial"], opt_cfg["lr_decay"]
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        lr = self.lr0 * 0.1 ** (self.t / (self.decay * 1000.0))
        self.t += 1
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + 1e-8))


def leaf_norm_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], floor_share: float = 1e-3,
                   median: bool = False):
    """Per leaf: |‖got‖ - ‖want‖| over the larger of ‖want‖ and the median
    leaf's ‖want‖; leaves whose ‖want‖ is under `floor_share` of the median
    leaf's are left out (nought to rounding in the reference). Returns
    (worst gap, or with `median` the median leaf's gap; its leaf; the
    leaves left out)."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in want.items()}
    median_norm = sorted(norms.values())[len(norms) // 2]
    gaps, skipped = {}, []
    for k in want:
        if norms[k] < floor_share * median_norm:
            skipped.append(k)
            continue
        gaps[k] = abs(float(torch.linalg.vector_norm(got[k].double())) - norms[k]) / max(norms[k], median_norm)
    ranked = sorted(gaps, key=gaps.get)
    leaf = ranked[len(ranked) // 2] if median else ranked[-1]
    return gaps[leaf], leaf, skipped

