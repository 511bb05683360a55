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
`profiler` hook traces chunks into the run's logs/profile.

All scenes need one resolution and frame count (true within a dataset's
train set).
"""

from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.infer.renderer import TiledRenderer
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays, stack_models, unstack_model
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.logging import ScalarLogger
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule
from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
from vipnerf_tpu_torch.train.trainer import (
    boundary_validation,
    chunk_boundary,
    profile_chunk,
    resolve_scene_ids,
    step_seed,
    validation_complete,
)
from vipnerf_tpu_torch.utils.config import init_seeds, save_configs, save_model_configs
from vipnerf_tpu_torch.utils.device import resolve_device


class MultiSceneTrainer:
    """Trains S same-shaped scenes in lockstep on one device."""

    def __init__(
        self,
        configs: Dict[str, Any],
        scene_ids: List,
        database_dirpath: Path,
        device: Optional[torch.device] = None,
        output_dirpath: Optional[Path] = None,
        verbose_log: bool = True,
    ):
        self.configs = configs
        self.scene_ids = list(scene_ids)
        self.output_dirpath = Path(output_dirpath) if output_dirpath else None
        self.verbose_log = verbose_log
        self.device = resolve_device(configs.get("device", "all")) if device is None else torch.device(device)
        s = len(self.scene_ids)

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

        # the caches stacked along the ray axis (poses along a scene axis);
        # each preprocessor keeps views of its rows for validation
        prep0 = self.preprocessors[0]
        self.rays_per_scene = prep0.cache["rays_o"].shape[0]
        self.cache = {}
        for key in prep0.cache:
            parts = [p.cache[key] for p in self.preprocessors]
            self.cache[key] = torch.stack(parts) if key == "poses" else torch.cat(parts)
            for i, p in enumerate(self.preprocessors):
                p.cache[key] = self.cache[key][i] if key == "poses" else \
                    self.cache[key][i * self.rays_per_scene:(i + 1) * self.rays_per_scene]
        self.near = torch.tensor([p.near for p in self.preprocessors], dtype=torch.float32, device=self.device)
        self.far = torch.tensor([p.far for p in self.preprocessors], dtype=torch.float32, device=self.device)

        self.seed = configs.get("seed", 0) or 0
        self.model = ViPNeRF(configs, torch.Generator().manual_seed(self.seed), scenes=s).to(self.device)
        self.optimizer = make_optimizer(configs, self.model.parameters(), scenes=s)
        self.loss_computer = LossComputer(configs)
        self.train_step = make_train_step(configs, render_rays, self.loss_computer, self.optimizer)
        self.lr_schedule = get_lr_schedule(configs)
        self.renderer = TiledRenderer(render_rays, configs, loss_computer=self.loss_computer)
        self.generator = torch.Generator(device=self.device)
        self.scan_steps = int(configs.get("scan_steps", 100))
        self.profiler_cfg = configs.get("profiler")
        self._loggers: Optional[List[ScalarLogger]] = None

    @property
    def with_sd(self) -> bool:
        return self.preprocessors[0].sparse_depth_needed

    def _scene_dir(self, i: int) -> Path:
        return self.output_dirpath / f"{self.scene_ids[i]}"

    def loggers(self) -> List[ScalarLogger]:
        if self._loggers is None:
            self._loggers = [ScalarLogger(self._scene_dir(i) / "logs") for i in range(len(self.scene_ids))]
        return self._loggers

    def close(self):
        for logger in self._loggers or []:
            logger.close()

    # ------------------------------------------------------------ checkpoints

    def save_checkpoints(self, iteration_num: int):
        """Each scene's unstacked model and optimizer row, with the standard
        naming contract."""
        for i in range(len(self.scene_ids)):
            checkpoints.save_checkpoint(self._scene_dir(i) / "saved_models", iteration_num,
                                        unstack_model(self.model, i), self.optimizer, scene=i)

    def load_checkpoints(self) -> int:
        """Resume from the latest checkpoint that every scene has (the
        scenes train in lockstep); returns the start iteration."""
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
        for i in range(len(self.scene_ids)):
            model = ViPNeRF(self.configs).to(self.device)
            path = self._scene_dir(i) / f"saved_models/Model_Iter{start:06}.tar"
            if checkpoints.load_checkpoint(path, model, self.optimizer, scene=i) != start:
                raise RuntimeError(f"{path} does not hold iteration {start}")
            models.append(model)
        stack_models(models, into=self.model)
        print(f"Resuming multi-scene training from iteration {start + 1}")
        return start

    # --------------------------------------------------------------- training

    def _index_rows(self, it: int, k: int):
        """(S, K, R) flat indices into the stacked cache of every scene's
        next k steps, on the device; the sparse-depth rows or None."""
        chunks = [p.get_index_chunk(it, k) for p in self.preprocessors]
        offsets = self.rays_per_scene * np.arange(len(chunks), dtype=np.int64)[:, None, None]

        def rows(blocks):
            return torch.from_numpy(np.stack(blocks).astype(np.int64) + offsets).to(self.device)

        nerf = rows([c[0] for c in chunks])
        sd = rows([c[1] for c in chunks]) if chunks[0][1] is not None else None
        return nerf, sd

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

        prep0 = self.preprocessors[0]
        logs = self.output_dirpath / "logs" if can_persist else None
        scalars = None
        it = start_iter
        while it < num_iterations:
            k = chunk_boundary(it, self.configs, num_iterations, self.scan_steps,
                               validation_interval, model_save_interval)
            nerf, sd = self._index_rows(it, k)
            with profile_chunk(self.profiler_cfg if logs else None, it, k, logs, self.device):
                chunk = []
                for j in range(k):
                    batch = prep0.gather_batch(nerf[:, j], None if sd is None else sd[:, j], it + j,
                                               cache=self.cache, near=self.near, far=self.far)
                    self.generator.manual_seed(step_seed(self.seed, it + j))
                    chunk.append(self.train_step(self.model, batch, self.generator))
                scalars = {name: torch.stack([c[name] for c in chunk]).cpu().numpy() for name in chunk[0]}
            if loggers is not None:
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
        for i in range(len(self.scene_ids)):
            boundary_validation(self.renderer, unstack_model(self.model, i), self.configs,
                                self.preprocessors[i], self.val_preprocessors[i], self.loggers()[i], it,
                                self._scene_dir(i) / "samples", self.verbose_log)


def start_training_batched(configs: Dict[str, Any]) -> MultiSceneTrainer:
    """Every scene of `configs` trained at once into
    {root_dirpath}/runs/training/train{train_num:04}/{scene}/, as
    `start_training` trains them one after another."""
    root_dirpath = Path(configs.get("root_dirpath", "."))
    output_dirpath = root_dirpath / f"runs/training/train{configs['train_num']:04}"
    output_dirpath.mkdir(parents=True, exist_ok=True)
    configs = save_configs(output_dirpath, configs)
    database_dirpath = root_dirpath / "data" / configs["database_dirpath"]
    init_seeds(configs.get("seed", 0))

    scene_ids = resolve_scene_ids(configs, database_dirpath)
    for scene_id in scene_ids:
        # reusing a scene's directory needs resume_training, as in start_training
        (output_dirpath / f"{scene_id}").mkdir(parents=True, exist_ok=configs.get("resume_training", False))
    trainer = MultiSceneTrainer(configs, scene_ids, database_dirpath, output_dirpath=output_dirpath)
    for i, scene_id in enumerate(scene_ids):
        save_model_configs(output_dirpath / f"{scene_id}", trainer.preprocessors[i].get_model_configs())
    try:
        trainer.train(configs["num_iterations"])
        if not configs.get("model_save_interval"):
            trainer.save_checkpoints(configs["num_iterations"])
    finally:
        trainer.close()
    return trainer
