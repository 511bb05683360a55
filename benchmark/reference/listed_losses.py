"""The plain reference's training steps for a configuration that lists
fewer than ViP-NeRF's four losses: each step's total is the weighted sum of
the listed losses alone, and a configuration without a `sparse_depth`
block draws no sparse-depth rays, so every ray of the batch is a NeRF ray.
This is ViP-NeRF's ablation without the sparse-depth prior (demo1d-1f of
NagabhushanSN95/ViP-NeRF `src/NerfLlffTrainerTester01.py`: MSE01,
VisibilityLoss01 and VisibilityPriorLoss01).

It reuses the model, renderer and Adam of `nerf` and the rays, scene
normalisation, weights and staged loss weights of `driver`, and follows
`driver.train_steps`' random stream and batch layout; with all four losses
listed it computes what `driver.train_steps` computes. Float32 with TF32
off (`nerf.no_tf32`). Departures from the published description are
`nerf`'s and `driver`'s (the configuration's precision emulated by
rounding, the synthetic scene); this file adds none.
"""

from typing import Any, Dict, List

import numpy as np
import torch

from reference import driver, nerf


def _mse(out, target, nerf_mask, sd_depth, prior):
    """rgb MSE of both levels over the NeRF rays."""
    m = nerf_mask.float()
    return sum(((out[lv]["rgb"] - target) ** 2).mean(-1).mul(m).sum() / m.sum().clamp(min=1)
               for lv in ("coarse", "fine"))


def _visibility(out, target, nerf_mask, sd_depth, prior):
    """Visibility consistency of both levels over every ray, each side
    against the other held fixed."""
    vis = 0.0
    for lv in ("coarse", "fine"):
        o = out[lv]
        vis = vis + (o["vis"] - o["trans"].detach()).abs().mean(-1).mean() \
            + (o["vis"].detach() - o["trans"]).abs().mean(-1).mean()
    return vis


def _visibility_prior(out, target, nerf_mask, sd_depth, prior):
    """The visibility prior of both levels over the NeRF rays."""
    m = nerf_mask.float()
    return sum((prior * (1.0 - out[lv]["vis2"])).sum(-1).mul(m).sum() / m.sum().clamp(min=1)
               for lv in ("coarse", "fine"))


def _sparse_depth(out, target, nerf_mask, sd_depth, prior):
    """MSE of the fine depth over the sparse-depth rays."""
    sd = 1.0 - nerf_mask.float()
    return ((out["fine"]["depth"] - sd_depth) ** 2).mul(sd).sum() / sd.sum().clamp(min=1)


TERMS = {"MSE01": _mse, "VisibilityLoss01": _visibility, "VisibilityPriorLoss01": _visibility_prior,
         "SparseDepthMSE01": _sparse_depth}


def losses(out, target_rgb, nerf_mask, sd_depth, prior, weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Each loss that `weights` names, in its order, and their weighted sum."""
    terms = {name: TERMS[name](out, target_rgb, nerf_mask, sd_depth, prior) for name in weights}
    terms["TotalLoss"] = sum(weights[k] * v for k, v in terms.items())
    return terms


def train_steps(cfg, mix, gt, weights, steps: List[Dict[str, Any]], seed: int, device, scenes: int = 1,
                scene: int = 0) -> Dict[str, Any]:
    """`driver.train_steps` with the listed losses: the first len(steps)
    steps from the benchmark's weights, each step's losses and per-ray
    colour and depth of both levels, the first step's gradient, the
    parameters after the last; of `scenes` trained in lockstep, scene
    `scene`'s rows of each step's draws."""
    model_cfg = cfg["train_configs"]["model"]
    dl = cfg["train_configs"]["data_loader"]
    ndc = dl["ndc"]
    h, w = cfg["scene"]["height"], cfg["scene"]["width"]
    train = list(cfg["scene"]["train_frames"])
    frame = driver.scene_frame(cfg, gt)
    poses, sc = frame["poses"], frame["sc"]
    nf = len(train)
    sd_grid = -np.ones((nf, h, w))
    if "sparse_depth" in dl:
        for i, f in enumerate(train):
            pts = gt["sparse"][f]
            sd_grid[i, pts[:, 1].astype(int), pts[:, 0].astype(int)] = pts[:, 2] * sc
    params = driver._params(weights, device, True)
    names = [(level, k) for level in ("coarse", "fine") for k in nerf.LEAVES]
    leaves = [params[level][k] for level, k in names]
    adam = nerf.Adam(leaves, cfg["train_configs"]["optimizer"])
    adam.t = mix["start_iter"]
    std = model_cfg["raw_noise_std"]
    nc, nfine = model_cfg["coarse_mlp"]["num_samples"], model_cfg["fine_mlp"]["num_samples"]
    losses_out, grad1, outputs = [], None, []
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    for step in steps:
        idx = step["indices"].cpu().numpy().astype(np.int64)
        fi, pix = idx // (h * w), idx % (h * w)
        ys, xs = pix // w, pix % w
        nr = len(idx)
        rays = driver._rays(cfg, frame, poses[fi], gt["intrinsic"], xs, ys, frame["near"], frame["far"])
        others = np.array([[j + (j >= i) for j in range(nf - 1)] for i in fi])
        rays["o2"] = poses[others][..., :3, 3]
        nerf_mask = np.arange(nr) < dl["num_rays"]
        target = gt["images"][np.array(train)[fi], ys, xs].astype(np.float64) / 255.0
        sd = np.where(nerf_mask, 0.0, sd_grid[fi, ys, xs])
        prior = np.stack([[gt["masks"][train[i], train[j]][y, x] for j in others_row]
                          for i, others_row, y, x in zip(fi, others, ys, xs)]).astype(np.float64)
        g = torch.Generator(device=device).manual_seed((int(seed) << 32) + step["iter"])
        total, rows = scenes * nr, slice(scene * nr, (scene + 1) * nr)
        draws = {"u_coarse": torch.rand((total, nc), generator=g, device=device)[rows],
                 "noise_coarse": std * torch.randn((total, nc), generator=g, device=device)[rows].reshape(-1, 1),
                 "u_fine": torch.rand((total, nfine), generator=g, device=device)[rows],
                 "noise_fine": std * torch.randn((total, nc + nfine), generator=g,
                                                 device=device)[rows].reshape(-1, 1)}
        with nerf.no_tf32():
            out = nerf.render_rays(params, driver._as_torch(rays, device), model_cfg, ndc, draws)
            terms = losses(out, f32(target), torch.as_tensor(nerf_mask, device=device), f32(sd), f32(prior),
                           driver.loss_weights(cfg, step["iter"]))
            grads = torch.autograd.grad(terms["TotalLoss"], leaves)
        losses_out.append({k: float(v.detach()) for k, v in terms.items()})
        outputs.append({f"{k}_{level}": out[level][k].detach() for level in ("coarse", "fine") for k in ("rgb", "depth")})
        if grad1 is None:
            grad1 = {f"{level}_model.{k}": gr.detach() for (level, k), gr in zip(names, grads)}
        del out, terms
        adam.step(list(grads))
    after = {f"{level}_model.{k}": params[level][k].detach() for level, k in names}
    return {"losses": losses_out, "grad1": grad1, "params_after": after, "outputs": outputs}
