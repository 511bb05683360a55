"""The plain reference's two drivers: the first training steps of a cell
from the benchmark's inputs, and held-out pixels of a served frame.

Training follows the program's documented random stream: each step's
generator is seeded with (seed << 32) + iteration, and draws, in this
order, the coarse stratification (rays, coarse samples), the coarse sigma
noise (points, 1), the fine quantiles (rays, fine samples) and the fine
sigma noise (points, 1). The batch's rays are the pixels of the step's
sampled indices: frame = index // (h w), then row and column. Targets, the
sparse depths and the visibility masks come from the benchmark's scene.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from reference import geometry, nerf


def scene_frame(cfg, gt) -> Dict[str, Any]:
    """The training run's normalisation of the configuration's scene."""
    dl = cfg["train_configs"]["data_loader"]
    train = list(cfg["scene"]["train_frames"])
    if cfg["dataset"] == "DTU":
        bounds = np.array([0.1, 5.0], np.float32).astype(np.float64)
    else:
        bds = gt["bounds"][train]
        bounds = np.array([bds.min(), bds.max()])
    frame = geometry.training_frame(gt["extrinsics"][train], bounds, dl["bd_factor"], dl["recenter_camera_poses"])
    scaled = frame["bounds"]
    frame["near"] = float(scaled[0] * dl["bd_factor"]) if dl["ndc"] else float(scaled[0] * 0.9)
    frame["far"] = float(scaled[1])
    return frame


def _as_torch(rays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in rays.items()}


def _rays(cfg, frame, c2w: np.ndarray, intrinsic: np.ndarray, xs, ys, near: float, far: float):
    """Float64 rays of pixels, each with its own c2w (n, 4, 4)."""
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    dirs = (pix @ np.linalg.inv(intrinsic).T) * np.array([1.0, -1.0, -1.0])
    rays_d = np.einsum("nij,nj->ni", c2w[:, :3, :3], dirs)
    rays_o = c2w[:, :3, 3].copy()
    n = len(xs)
    out = {"o": rays_o, "d": rays_d, "view_dirs": rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True),
           "near": np.full((n, 1), near), "far": np.full((n, 1), far)}
    if cfg["train_configs"]["data_loader"]["ndc"]:
        h, w = cfg["scene"]["height"], cfg["scene"]["width"]
        out["o_ndc"], out["d_ndc"] = geometry.ndc_rays(rays_o, rays_d, h, w, intrinsic[0, 0], intrinsic[1, 1], near)
        out["near_ndc"], out["far_ndc"] = np.zeros((n, 1)), np.ones((n, 1))
    return out


def _params(weights, device, requires_grad: bool):
    return {level: {k: v.detach().to(device).clone().requires_grad_(requires_grad) for k, v in leaves.items()}
            for level, leaves in weights.items()}


def loss_weights(cfg, iteration: int) -> Dict[str, float]:
    out = {}
    for loss in cfg["train_configs"]["losses"]:
        if "weight" in loss:
            out[loss["name"]] = float(loss["weight"])
        else:
            stages = sorted((int(k), v) for k, v in loss["iter_weights"].items())
            out[loss["name"]] = float(([0.0] + [v for t, v in stages if iteration >= t])[-1])
    return out


def train_steps(cfg, mix, gt, weights, steps: List[Dict[str, Any]], seed: int, device, scenes: int = 1,
                scene: int = 0) -> Dict[str, Any]:
    """The first len(steps) steps from the benchmark's weights: each step's
    losses and per-ray colour and depth of both levels, the first step's
    gradient, the parameters after the last. Of `scenes` trained in
    lockstep, scene `scene`: the step's draws are the whole batch's, the
    scenes' rays one after the other, and this scene takes its rows."""
    model_cfg = cfg["train_configs"]["model"]
    dl = cfg["train_configs"]["data_loader"]
    ndc = dl["ndc"]
    h, w = cfg["scene"]["height"], cfg["scene"]["width"]
    train = list(cfg["scene"]["train_frames"])
    frame = scene_frame(cfg, gt)
    poses, sc = frame["poses"], frame["sc"]
    intrinsic = gt["intrinsic"]
    n_rays = dl["num_rays"]
    sd_grid = -np.ones((len(train), h, w))
    for i, f in enumerate(train):
        pts = gt["sparse"][f]
        sd_grid[i, pts[:, 1].astype(int), pts[:, 0].astype(int)] = pts[:, 2] * sc
    nf = len(train)
    params = _params(weights, device, True)
    leaves = [params[level][k] for level in ("coarse", "fine") for k in nerf.LEAVES]
    adam = nerf.Adam(leaves, cfg["train_configs"]["optimizer"])
    adam.t = mix["start_iter"]
    std = model_cfg["raw_noise_std"]
    nc, nfine = model_cfg["coarse_mlp"]["num_samples"], model_cfg["fine_mlp"]["num_samples"]
    losses, grad1, outputs = [], None, []
    for step in steps:
        idx = step["indices"].cpu().numpy().astype(np.int64)
        fi, pix = idx // (h * w), idx % (h * w)
        ys, xs = pix // w, pix % w
        nr = len(idx)
        rays = _rays(cfg, frame, poses[fi], intrinsic, xs, ys, frame["near"], frame["far"])
        others = np.array([[j + (j >= i) for j in range(nf - 1)] for i in fi])
        rays["o2"] = poses[others][..., :3, 3]
        nerf_mask = np.arange(nr) < n_rays
        target = gt["images"][np.array(train)[fi], ys, xs].astype(np.float64) / 255.0
        sd = np.where(nerf_mask, 0.0, sd_grid[fi, ys, xs])
        prior = np.stack([[gt["masks"][train[i], train[j]][y, x] for j in others_row]
                          for i, others_row, y, x in zip(fi, others, ys, xs)]).astype(np.float64)
        t = _as_torch(rays, device)
        g = torch.Generator(device=device).manual_seed((int(seed) << 32) + step["iter"])
        total, rows = scenes * nr, slice(scene * nr, (scene + 1) * nr)
        draws = {"u_coarse": torch.rand((total, nc), generator=g, device=device)[rows],
                 "noise_coarse": std * torch.randn((total, nc), generator=g, device=device)[rows].reshape(-1, 1),
                 "u_fine": torch.rand((total, nfine), generator=g, device=device)[rows],
                 "noise_fine": std * torch.randn((total, nc + nfine), generator=g,
                                                 device=device)[rows].reshape(-1, 1)}
        with nerf.no_tf32():
            out = nerf.render_rays(params, t, model_cfg, ndc, draws)
            terms = nerf.losses(out, torch.as_tensor(target, dtype=torch.float32, device=device),
                                torch.as_tensor(nerf_mask, device=device),
                                torch.as_tensor(sd, dtype=torch.float32, device=device),
                                torch.as_tensor(prior, dtype=torch.float32, device=device),
                                loss_weights(cfg, step["iter"]))
            grads = torch.autograd.grad(terms["TotalLoss"], leaves)
        losses.append({k: float(v.detach()) for k, v in terms.items()})
        outputs.append({f"{k}_{level}": out[level][k].detach() for level in ("coarse", "fine") for k in ("rgb", "depth")})
        if grad1 is None:
            grad1 = {f"{level}_model.{k}": gr.detach()
                     for (level, k), gr in zip([(lv, k) for lv in ("coarse", "fine") for k in nerf.LEAVES], grads)}
        del out, terms
        adam.step(list(grads))
    after = {f"{level}_model.{k}": params[level][k].detach() for level in ("coarse", "fine") for k in nerf.LEAVES}
    return {"losses": losses, "grad1": grad1, "params_after": after, "outputs": outputs}


def render_pixels(cfg, gt_train, weights, w2c: np.ndarray, xs: np.ndarray, ys: np.ndarray, device,
                  block: int = 4096) -> Dict[str, np.ndarray]:
    """rgb (n, 3) and metric depth (n,) of the fine level at pixels (xs, ys)
    of the held-out camera w2c, as a deterministic render (no noise, evenly
    spaced quantiles, no other view)."""
    model_cfg = dict(cfg["train_configs"]["model"])
    frame = scene_frame(cfg, gt_train)
    c2w = geometry.normalise_poses(w2c[None], frame["sc"], frame["average_pose"])[0]
    intrinsic = gt_train["intrinsic"]
    params = _params(weights, device, False)
    rgb, depth = [], []
    with torch.no_grad(), nerf.no_tf32():
        for a in range(0, len(xs), block):
            sl = slice(a, a + block)
            n = len(xs[sl])
            rays = _rays(cfg, frame, np.broadcast_to(c2w, (n, 4, 4)), intrinsic, xs[sl], ys[sl],
                         frame["near"], frame["far"])
            out = nerf.render_rays(params, _as_torch(rays, device), model_cfg, cfg["train_configs"]["data_loader"]["ndc"])
            rgb.append(out["fine"]["rgb"].cpu().numpy())
            depth.append(out["fine"]["depth"].cpu().numpy())
    return {"rgb": np.concatenate(rgb), "depth": np.concatenate(depth)}
