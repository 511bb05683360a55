"""Batched multi-scene training on one GPU (counterpart of
vipnerf_tpu/train/multi_scene.py `MultiSceneTrainer` and
`start_training_batched`).

ViP-NeRF keeps no state across scenes, so S scenes of one dataset (LLFF's 8,
say) train together: every per-scene array gets a leading scene axis and one
step runs all S. The JAX package vmaps its train step over the scene axis
and shards that axis over a device mesh; with one device it trains every
scene there, as the port does on one card:

- the model is a stacked `ViPNeRF` (`scenes=S`), every scene starting from
  the weights the seed draws, as `init_fn(PRNGKey(seed))` once per scene;
- one step gathers S scenes' rays (the caches stacked along the ray axis on
  the device, `DataPreprocessor.gather_batch` over each scene's rows), runs
  one render of S*R rays (each MLP level one K1 launch for all S scenes, or
  batched products), per-scene losses, one backward of their sum, and
  per-scene Adam (`train.step.Adam` with a scene axis: per-scene clipping,
  counts and loss guards);
- the chunks are cut at validation, checkpoints and the end of precrop, as
  the single-scene trainer cuts them; each scene's index streams are its
  own preprocessor's, one host read of the loss scalars per chunk.

Artifacts per scene, as the single-scene trainer writes them:
{scene}/ModelConfigs.json, logs/scalars.jsonl, samples/ (validation through
`TiledRenderer` with that scene's unstacked model) and saved_models/
Model_Iter{N:06}.tar with Model_Latest.tar (its model and its row of the
optimizer). A resume starts from the latest checkpoint every scene has (the
minimum), then renders a boundary validation that was cut short. The
chunks are traced as the single-scene trainer's (`trainer.train_chunk`),
and the `profiler` hook traces chunks into the run's logs/profile.

All scenes need one resolution and frame count (true within a dataset's
train set).

Over several devices (the JAX package's scene-axis mesh),
`start_training_batched` runs one rank per device, the first S devices
when more are selected, and S must divide by their number
(`scene_devices`). Each rank trains its contiguous S/n scenes as a stacked
model on its device (K1 keeps its scene axis: 2 launches per step per
rank), and draws its rows of each sub-batch's per-ray randoms over the S
scenes (`parallel.mesh.scene_shard`), so that the ranks together compute
what one process of S scenes does. Adam, clipping
and the guards are per scene, so the step needs no collective: only the
loss scalars (each chunk), the weights and optimizer rows (at each
checkpoint and validation) are gathered. Rank 0 writes every scene's
files; validation renders each scene's frames sharded over the ranks, so
every rank holds every scene's preprocessors.
"""

import copy
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.infer.renderer import TiledRenderer
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays, stack_models, unstack_model
from vipnerf_tpu_torch.parallel.mesh import ShardGenerator, current_group, run_on_devices, scene_shard, select_devices
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.logging import NullLogger, ScalarLogger
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule
from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
from vipnerf_tpu_torch.train.trainer import (
    boundary_validation,
    chunk_boundary,
    profile_chunk,
    resolve_scene_ids,
    run_device,
    run_dirs,
    save_run_configs,
    train_chunk,
    validation_complete,
)
from vipnerf_tpu_torch.utils import tracing
from vipnerf_tpu_torch.utils.config import init_seeds, merge_configs, save_model_configs
from vipnerf_tpu_torch.utils.device import resolve_device


class MultiSceneTrainer:
    """Trains S same-shaped scenes in lockstep on one device, or this
    rank's share of them with a `group`."""

    def __init__(
        self,
        configs: Dict[str, Any],
        scene_ids: List,
        database_dirpath: Path,
        device: Optional[torch.device] = None,
        output_dirpath: Optional[Path] = None,
        verbose_log: bool = True,
        group=None,
    ):
        self.configs = configs
        self.scene_ids = list(scene_ids)
        self.output_dirpath = Path(output_dirpath) if output_dirpath else None
        self.group = group
        self.writes = group is None or group.is_writer
        self.verbose_log = verbose_log and self.writes
        if group is not None:
            self.device = group.device
        else:
            self.device = resolve_device(configs.get("device", "all")) if device is None else torch.device(device)
        s = len(self.scene_ids)
        self.local = slice(0, s) if group is None else group.shard(s)  # this rank's scenes
        local = range(s)[self.local]

        self.preprocessors, self.val_preprocessors = [], []
        for scene_id in self.scene_ids:
            cfg = dict(configs)
            cfg["data_loader"] = dict(configs["data_loader"], scene_id=scene_id)
            prep = get_data_preprocessor(
                cfg, "train", device=self.device,
                raw_data_dict=get_data_loader(cfg, database_dirpath, mode="train").load_data())
            self.preprocessors.append(prep)
            self.val_preprocessors.append(get_data_preprocessor(
                cfg, "validation", model_configs=prep.get_model_configs(), device=self.device,
                raw_data_dict=get_data_loader(cfg, database_dirpath, mode="validation").load_data()))
        res = {tuple(p.resolution) for p in self.preprocessors}
        frames = {p.num_frames for p in self.preprocessors}
        if len(res) != 1 or len(frames) != 1:
            raise ValueError("batched multi-scene training needs one resolution and frame count across "
                             f"scenes (got resolutions {res}, frames {frames})")

        # this rank's caches stacked along the ray axis (poses along a scene
        # axis); each of its preprocessors keeps views of its rows for validation
        trained = self.preprocessors[self.local]
        prep0 = trained[0]
        self.rays_per_scene = prep0.cache["rays_o"].shape[0]
        self.cache = {}
        for key in prep0.cache:
            parts = [p.cache[key] for p in trained]
            self.cache[key] = torch.stack(parts) if key == "poses" else torch.cat(parts)
            for i, p in enumerate(trained):
                p.cache[key] = self.cache[key][i] if key == "poses" else \
                    self.cache[key][i * self.rays_per_scene:(i + 1) * self.rays_per_scene]
        self.near = torch.tensor([p.near for p in trained], dtype=torch.float32, device=self.device)
        self.far = torch.tensor([p.far for p in trained], dtype=torch.float32, device=self.device)

        self.seed = configs.get("seed", 0) or 0
        self.model = ViPNeRF(configs, torch.Generator().manual_seed(self.seed), scenes=len(local)).to(self.device)
        self.optimizer = make_optimizer(configs, self.model.parameters(), scenes=len(local))
        self.loss_computer = LossComputer(configs)
        per_step = prep0.num_rays + (prep0.num_rays_sparse_depth if prep0.sparse_depth_needed else 0)
        shard = None if group is None else scene_shard(group, s, per_step, configs.get("sub_batch_size"))
        self.train_step = make_train_step(configs, render_rays, self.loss_computer, self.optimizer, shard)
        self.lr_schedule = get_lr_schedule(configs)
        self.renderer = TiledRenderer(render_rays, configs, loss_computer=self.loss_computer, group=group)
        self.generator = ShardGenerator(self.device)
        self.scan_steps = int(configs.get("scan_steps", 100))
        self.profiler_cfg = configs.get("profiler")
        self._loggers: Optional[List[ScalarLogger]] = None

    @property
    def with_sd(self) -> bool:
        return self.preprocessors[0].sparse_depth_needed

    def _scene_dir(self, i: int) -> Path:
        return self.output_dirpath / f"{self.scene_ids[i]}"

    def loggers(self) -> List[ScalarLogger]:
        """Every scene's logger (rank 0 writes them all)."""
        if self._loggers is None:
            self._loggers = [ScalarLogger(self._scene_dir(i) / "logs") if self.writes else NullLogger()
                             for i in range(len(self.scene_ids))]
        return self._loggers

    def close(self):
        for logger in self._loggers or []:
            logger.close()

    @torch.no_grad()
    def gathered(self):
        """The stacked model and optimizer of all S scenes, every rank's rows
        gathered onto every rank (this trainer's own without a group)."""
        if self.group is None:
            return self.model, self.optimizer
        s, gather = len(self.scene_ids), self.group.gather
        model = ViPNeRF(self.configs, scenes=s).to(self.device)
        for p, q in zip(model.parameters(), self.model.parameters()):
            p.copy_(gather(q))
        optimizer = make_optimizer(self.configs, model.parameters(), scenes=s)
        for name in ("exp_avg", "exp_avg_sq", "count"):
            setattr(optimizer, name, gather(getattr(self.optimizer, name)))
        if optimizer.guard is not None:
            for name in ("ema", "count", "skips"):
                setattr(optimizer.guard, name, gather(getattr(self.optimizer.guard, name)))
        return model, optimizer

    # ------------------------------------------------------------ checkpoints

    def save_checkpoints(self, iteration_num: int):
        """Each scene's unstacked model and optimizer row, with the standard
        naming contract, written by rank 0."""
        model, optimizer = self.gathered()
        if self.writes:
            for i in range(len(self.scene_ids)):
                checkpoints.save_checkpoint(self._scene_dir(i) / "saved_models", iteration_num,
                                            unstack_model(model, i), optimizer, scene=i)
        if self.group is not None:
            self.group.barrier()

    def load_checkpoints(self) -> int:
        """Resume from the latest checkpoint that every scene has (the
        scenes train in lockstep); returns the start iteration. Each rank
        loads its own scenes."""
        if self.output_dirpath is None:
            return 0
        iters = []
        for i in range(len(self.scene_ids)):
            latest = checkpoints.latest_checkpoint(self._scene_dir(i) / "saved_models")
            if latest is None:
                return 0
            iters.append(checkpoints.checkpoint_iteration(latest))
        start = min(iters)
        models = []
        for row, i in enumerate(range(len(self.scene_ids))[self.local]):
            model = ViPNeRF(self.configs).to(self.device)
            path = self._scene_dir(i) / f"saved_models/Model_Iter{start:06}.tar"
            if checkpoints.load_checkpoint(path, model, self.optimizer, scene=row) != start:
                raise RuntimeError(f"{path} does not hold iteration {start}")
            models.append(model)
        stack_models(models, into=self.model)
        if self.writes:
            print(f"Resuming multi-scene training from iteration {start + 1}")
        return start

    # --------------------------------------------------------------- training

    def _index_rows(self, it: int, k: int):
        """(S, K, R) flat indices into the stacked cache of every scene's
        next k steps, on the host; the sparse-depth rows or None."""
        chunks = [p.get_index_chunk(it, k) for p in self.preprocessors[self.local]]
        offsets = self.rays_per_scene * np.arange(len(chunks), dtype=np.int64)[:, None, None]

        def rows(blocks):
            return np.stack(blocks).astype(np.int64) + offsets

        nerf = rows([c[0] for c in chunks])
        sd = rows([c[1] for c in chunks]) if chunks[0][1] is not None else None
        return nerf, sd

    def _read_scalars(self, chunk: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
        scalars = {name: torch.stack([c[name] for c in chunk]) for name in chunk[0]}
        if self.group is not None:  # (k, S/n) per rank -> (k, S)
            scalars = {name: self.group.gather(v.T.contiguous()).T for name, v in scalars.items()}
        return {name: v.cpu().numpy() for name, v in scalars.items()}

    def train(self, num_iterations: int, *, validation_interval: Optional[int] = None,
              model_save_interval: Optional[int] = None, log_scalars: bool = True):
        """The lockstep loop: per-iteration scalars, validation renders and
        interval checkpoints per scene. Returns the last step's per-scene
        loss scalars ((S,) numpy arrays), or None when nothing ran."""
        can_persist = self.output_dirpath is not None
        if validation_interval is None:
            validation_interval = self.configs.get("validation_interval")
        if model_save_interval is None:
            model_save_interval = self.configs.get("model_save_interval")
        loggers = self.loggers() if (log_scalars and can_persist) else None

        start_iter = self.load_checkpoints()
        if (can_persist and start_iter > 0 and validation_interval and start_iter % validation_interval == 0
                and not all(validation_complete(self.configs, (self.preprocessors[i], self.val_preprocessors[i]),
                                                start_iter, self._scene_dir(i) / "samples")
                            for i in range(len(self.scene_ids)))):
            self.run_validation(start_iter)

        prep0 = self.preprocessors[self.local][0]
        logs = self.output_dirpath / "logs" if can_persist and self.writes else None
        scalars = None
        it = start_iter
        while it < num_iterations:
            k = chunk_boundary(it, self.configs, num_iterations, self.scan_steps,
                               validation_interval, model_save_interval)
            scalars = train_chunk(
                self, it, k, lambda: self._index_rows(it, k),
                lambda rows, j: prep0.gather_batch(rows[0][:, j], None if rows[1] is None else rows[1][:, j], it + j,
                                                   cache=self.cache, near=self.near, far=self.far),
                self._read_scalars, profile_chunk(self.profiler_cfg if logs else None, it, k, logs, self.device))
            if loggers is not None:
                logged = k * len(loggers) * (len(scalars) + 1)  # each scene's loss scalars and lr, per step
                tracing.count("train.log.scalars", logged)
                with tracing.span("train.log", it=it, scalars=logged):
                    for j in range(k):
                        lr = float(self.lr_schedule(it + j))
                        for i, logger in enumerate(loggers):
                            for name, vals in scalars.items():
                                logger.add_scalar(f"train/{name}", float(vals[j, i]), it + j + 1)
                            logger.add_scalar("train/lr", lr, it + j + 1)
            it += k
            if self.verbose_log:
                print(f"iter {it}/{num_iterations} TotalLoss per scene "
                      f"{np.round(scalars['TotalLoss'][-1], 5).tolist()}", flush=True)
            # checkpoint before validation, and at the last iteration off a boundary
            if can_persist and model_save_interval and (it % model_save_interval == 0 or it == num_iterations):
                self.save_checkpoints(it)
            if can_persist and validation_interval and it % validation_interval == 0:
                self.run_validation(it)
        if loggers is not None:
            for logger in loggers:
                logger.flush()
        return None if scalars is None else {name: vals[-1] for name, vals in scalars.items()}

    def run_validation(self, it: int):
        """Each scene's boundary validation through `TiledRenderer` with its
        unstacked model, into its samples/ and its log."""
        model, _ = self.gathered()
        for i in range(len(self.scene_ids)):
            boundary_validation(self.renderer, unstack_model(model, i), self.configs,
                                self.preprocessors[i], self.val_preprocessors[i], self.loggers()[i], it,
                                self._scene_dir(i) / "samples", self.verbose_log)


def scene_devices(device_sel: Any, scenes: int) -> Any:
    """The device selection of S scenes' batched training: the first S
    devices when more are selected (vipnerf_tpu/train/multi_scene.py:66-80);
    the number of devices must divide S."""
    devices = select_devices(device_sel)
    if len(devices) <= 1:
        return device_sel
    if len(devices) > scenes:
        if device_sel is None or device_sel == "all":
            device_sel = list(range(len(devices)))
        device_sel = list(device_sel)[:scenes]
        devices = devices[:scenes]
    if scenes % len(devices):
        raise ValueError(f"the number of devices ({len(devices)}) must divide the number of scenes ({scenes})")
    return device_sel


def start_training_batched(configs: Dict[str, Any]) -> Optional[MultiSceneTrainer]:
    """Every scene of `configs` trained at once into
    {root_dirpath}/runs/training/train{train_num:04}/{scene}/, as
    `start_training` trains them one after another, on the devices
    `scene_devices` selects. Returns the trainer when it trained in this
    process (one device), else None."""
    output_dirpath, data_dirpath = run_dirs(configs)
    merged = merge_configs(output_dirpath, copy.deepcopy(configs), quiet=True)
    device_sel = merged.get("device", "all")
    if not dist.is_initialized():  # the scene count picks the devices before any rank starts
        scenes = len(resolve_scene_ids(merged, data_dirpath / merged["database_dirpath"]))
        device_sel = scene_devices(device_sel, scenes)
        configs = dict(configs, device=device_sel)
    return run_on_devices(_train_batched, configs, device_sel)


def _train_batched(configs: Dict[str, Any]) -> Optional[MultiSceneTrainer]:
    output_dirpath, data_dirpath = run_dirs(configs)
    group = current_group(run_device(output_dirpath, configs))
    configs = save_run_configs(output_dirpath, configs, group)
    database_dirpath = data_dirpath / configs["database_dirpath"]
    init_seeds(configs.get("seed", 0))

    scene_ids = resolve_scene_ids(configs, database_dirpath)
    writes = group is None or group.is_writer
    if writes:
        for scene_id in scene_ids:
            # reusing a scene's directory needs resume_training, as in start_training
            (output_dirpath / f"{scene_id}").mkdir(parents=True, exist_ok=configs.get("resume_training", False))
    trainer = MultiSceneTrainer(configs, scene_ids, database_dirpath, output_dirpath=output_dirpath, group=group)
    if writes:
        for i, scene_id in enumerate(scene_ids):
            save_model_configs(output_dirpath / f"{scene_id}", trainer.preprocessors[i].get_model_configs())
    if group is not None:
        group.barrier()
    try:
        trainer.train(configs["num_iterations"])
        if not configs.get("model_save_interval"):
            trainer.save_checkpoints(configs["num_iterations"])
    finally:
        trainer.close()
    if group is not None:  # rank 0's last files are written
        group.barrier()
        return None
    return trainer
