"""What the ranks of tests/test_torch_parallel.py run, and its one-process
references (this module imports torch and the port only, so that spawned
ranks start without JAX).

`session(cfg)` runs on every rank of one group of CPU ranks and writes
each rank's results to cfg["workdir"]/{name}_rank{r}.npz:

- "steps_*": K train steps of a narrow model on a ray cache, each rank on
  its columns of every step's index block (`ray_shard`, `run_steps`);
- "masks": one step's loss scalars and gradients on a batch whose masks
  fall on rank 0 (`run_loss_grads`);
- "render_*": a tile render with and without losses (`run_render`);
- the training entry points, which write their run trees (rank 0).

`joined(cfg)` runs `run_steps` alone, on each rank's device: run as a
script, this module is one process of a torchrun-style group (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT in its environment) that calls it
through `run_on_devices`, which joins that group; tests/
test_torch_kernels_cuda.py spawns it as two gloo ranks sharing a card.
"""

import pickle
import sys
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.infer.renderer import TiledRenderer
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models import vip_nerf as t_vn
from vipnerf_tpu_torch.parallel.mesh import ShardGenerator, current_group, ray_shard, run_on_devices
from vipnerf_tpu_torch.train.multi_scene import start_training_batched
from vipnerf_tpu_torch.train.step import all_reduce_grads, make_optimizer, make_train_step
from vipnerf_tpu_torch.train.trainer import start_training, step_seed


def step_configs(perturb: bool = True) -> Dict[str, Any]:
    """tests/test_train_step.py's `small_configs` (a narrow coarse MLP,
    MSE and visibility losses), for the processes without JAX."""
    return {
        "data_loader": {"ndc": False},
        "model": {
            "name": "VipNeRF01",
            "coarse_mlp": {"num_samples": 8, "netdepth": 6, "netwidth": 32, "points_positional_encoding_degree": 4,
                           "views_positional_encoding_degree": 2, "use_view_dirs": True,
                           "view_dependent_rgb": True, "predict_visibility": True},
            "chunk": 4096, "lindisp": False, "netchunk": 16384, "perturb": perturb, "raw_noise_std": 0.0,
            "white_bkgd": False,
        },
        "losses": [{"name": "MSE01", "weight": 1}, {"name": "VisibilityLoss01", "weight": 0.1}],
        "optimizer": {"lr_decayer_name": "NeRFLearningRateDecayer01", "lr_initial": 5e-4, "lr_decay": 250,
                      "beta1": 0.9, "beta2": 0.999},
        "seed": 0,
    }


def step_cache(n: int = 512, nf: int = 3, seed: int = 0) -> Dict[str, np.ndarray]:
    """tests/test_train_step.py's `make_cache`, in numpy."""
    rng = np.random.default_rng(seed)
    rays_d = (rng.normal(size=(n, 3)) - [0, 0, 3.0]).astype(np.float32)
    return {
        "rays_o": rng.normal(size=(n, 3)).astype(np.float32), "rays_d": rays_d,
        "view_dirs": rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True),
        "pixel_id": np.stack([rng.integers(0, nf, n), rng.integers(0, 8, n), rng.integers(0, 8, n)], 1).astype(np.int32),
        "target_rgb": rng.uniform(size=(n, 3)).astype(np.float32),
        "poses": np.tile(np.eye(4, dtype=np.float32), (nf, 1, 1)),
    }


def model_from(configs: Dict[str, Any], state: Dict[str, np.ndarray]) -> t_vn.ViPNeRF:
    model = t_vn.ViPNeRF(configs)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def gather(cache: Dict[str, torch.Tensor], idx: torch.Tensor, iter_num: int, nf: int = 3,
           n_nerf: Optional[int] = None) -> Dict[str, Any]:
    """The batch of tests/test_train_step.py `make_gather`, in torch; with
    `n_nerf`, only the first n_nerf rays are NeRF rays (the rest a second
    stream, which MSE01 leaves out)."""
    nr = idx.shape[0]
    batch = {k: cache[k][idx] for k in ("rays_o", "rays_d", "view_dirs", "pixel_id", "target_rgb")}
    dev = idx.device
    mask_nerf = torch.arange(nr, device=dev) < (nr if n_nerf is None else n_nerf)
    batch.update(iter_num=iter_num, num_frames=nf, indices_mask_nerf=mask_nerf,
                 near=torch.full((nr, 1), 1.0, device=dev), far=torch.full((nr, 1), 4.0, device=dev),
                 poses=cache["poses"])
    return batch


def run_steps(configs, state, cache, idx, streams=None, group=None, device="cpu"):
    """K steps (one per row of the (K, B) index block) from `state`, on the
    group's device or `device`: (TotalLoss per step, the final parameters on
    the host). `streams` (default [B]) splits each row into NeRF rays and a
    second stream, laid end to end. With a group, each rank trains on its
    columns of every row, drawing the randoms of every global sub-batch
    (`ray_shard`)."""
    device = torch.device(device) if group is None else group.device
    model = model_from(configs, state).to(device)
    optimizer = make_optimizer(configs, model.parameters())
    streams = streams or [idx.shape[1]]
    shard = None if group is None else ray_shard(group, streams, configs.get("sub_batch_size"))
    step = make_train_step(configs, t_vn.render_rays, LossComputer(configs), optimizer, shard)
    generator = ShardGenerator(device)
    cache = {k: torch.tensor(v, device=device) for k, v in cache.items()}
    cols, n_nerf = np.arange(idx.shape[1]), streams[0]
    if shard is not None:
        cols = np.concatenate([c + sum(streams[:k]) for k, c in enumerate(shard.columns)])
        n_nerf = len(shard.columns[0])
    losses = []
    for j, row in enumerate(idx):
        generator.manual_seed(step_seed(configs.get("seed", 0), j))
        batch = gather(cache, torch.from_numpy(row[cols]).long().to(device), j, n_nerf=n_nerf)
        losses.append(float(step(model, batch, generator)["TotalLoss"]))
    return np.asarray(losses), {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def run_loss_grads(configs, state, batch, group=None):
    """One render's loss scalars and parameter gradients; with a group,
    on this rank's contiguous share of `batch`, summed over the ranks."""
    model = model_from(configs, state)
    if group is not None:
        nr = batch["rays_o"].shape[0]
        rows = group.shard(nr)
        batch = {k: v[rows] if isinstance(v, np.ndarray) and v.shape[:1] == (nr,) else v for k, v in batch.items()}
    batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    outputs = t_vn.render_rays(model, configs, batch, train=True)
    losses = LossComputer(configs).compute_losses(batch, outputs, group=group)
    losses["TotalLoss"].backward()
    scalars = {k: (v["loss_value"] if isinstance(v, dict) else v).detach().reshape(()) for k, v in losses.items()}
    params = list(model.parameters())
    if group is not None:
        scalars = all_reduce_grads(params, scalars, group)
    grads = {name: p.grad.numpy().copy() for (name, _), p in zip(model.named_parameters(), params)}
    return {k: float(v) for k, v in scalars.items()}, grads


def run_render(configs, state, batch, chunk_size, with_losses, group=None):
    """A tile render of `batch`: (outputs, losses' values or None)."""
    model = model_from(configs, state)
    renderer = TiledRenderer(t_vn.render_rays, configs, loss_computer=LossComputer(configs), group=group)
    batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
    out, losses = renderer.render(model, batch, chunk_size=chunk_size, sec_views_vis=True, with_losses=with_losses,
                                  return_loss_maps=with_losses)
    return out, losses


def _save(workdir: Path, name: str, rank: int, result):
    with open(workdir / f"{name}_rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def load(workdir: Path, name: str, rank: int):
    with open(Path(workdir) / f"{name}_rank{rank}.pkl", "rb") as f:
        return pickle.load(f)


def session(cfg: Dict[str, Any]) -> None:
    group = current_group(cfg["device"])
    workdir, rank = Path(cfg["workdir"]), group.rank
    for name, args in cfg["steps"].items():
        _save(workdir, name, rank, run_steps(*args, group=group))
    configs, state, batch = cfg["masks"]
    _save(workdir, "masks", rank, run_loss_grads(configs, state, batch, group))
    configs, state, batch = cfg["render"]
    for chunk in cfg["render_chunks"]:
        for with_losses in (False, True):
            _save(workdir, f"render_{chunk}_{with_losses}", rank,
                  run_render(configs, state, batch, chunk, with_losses, group))
    for train_cfg in cfg["train_runs"]:
        start_training(dict(train_cfg, device=cfg["device"]))
    for train_cfg in cfg["batched_runs"]:
        start_training_batched(dict(train_cfg, device=cfg["device"]))


def joined(cfg: Dict[str, Any]) -> None:
    """A torchrun-style rank: `run_steps` in the group it joined."""
    group = current_group(cfg["device"])
    _save(Path(cfg["workdir"]), "joined", group.rank, run_steps(*cfg["steps"], group=group))


if __name__ == "__main__":
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        job: Optional[Dict[str, Any]] = pickle.load(f)
    run_on_devices(joined, job)
