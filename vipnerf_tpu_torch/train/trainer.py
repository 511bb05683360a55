"""Training runtime (counterpart of vipnerf_tpu/train/trainer.py): the
per-scene loop, checkpoints, validation renders with losses, logging, and
`start_training`.

Output tree: runs/training/train{NNNN}/Configs.json and per scene
{scene}/ModelConfigs.json, logs/scalars.jsonl, samples/ (validation renders:
predicted_frames/{frame:04}_{coarse|fine}_Iter{it:05}.png, depths, depth
variances, visibilities, loss maps) and saved_models/Model_Iter{it:06}.tar
with the Model_Latest.tar symlink.

The loop runs in chunks of at most `scan_steps` iterations, cut at every
boundary the host observes (validation, checkpoint, end of precrop, end of
run), as the JAX trainer cuts its scanned chunks. A chunk's index blocks go
to the device in one copy; each step gathers its batch there, re-seeds the
training generator from (seed, iteration) as JAX folds the iteration into
its key, and leaves its loss scalars on the device; they are stacked and
read once per chunk. A checkpoint is written before a boundary's
validation, and a resume whose boundary validation is incomplete renders it
again. `scan_steps`, `remat`, `netchunk_map*` and `step_dispatch` (TPU
dispatch knobs) change no result and are accepted as they are.

`profiler: {start_iter, num_iters}` traces every chunk that overlaps those
iterations with torch.profiler (host, and the card's kernels on CUDA) into
{scene}/logs/profile/ as a Chrome trace, one file per chunk (the JAX
trainer's jax.profiler hook). The validation helpers below serve the
batched multi-scene trainer too (train/multi_scene.py).
"""

import contextlib
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.infer.renderer import TiledRenderer
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models.factory import get_model
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.logging import ScalarLogger
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule
from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
from vipnerf_tpu_torch.utils.config import init_seeds, save_configs, save_model_configs
from vipnerf_tpu_torch.utils.device import resolve_device
from vipnerf_tpu_torch.utils.io import read_csv_columns, save_image, save_numpy_array
from vipnerf_tpu_torch.utils.naming import scene_dirname


def step_seed(seed: int, iteration: int) -> int:
    """The training generator's seed at `iteration`."""
    return (int(seed) << 32) + int(iteration)


def chunk_boundary(it: int, configs: Dict[str, Any], total: int, scan_steps: int,
                   validation_interval: int, model_save_interval: int) -> int:
    """Iterations of the chunk starting at `it`: at most `scan_steps`, cut
    at the next validation, checkpoint, end of precrop and end of the run."""
    boundaries = [total]
    for interval in (validation_interval, model_save_interval):
        if interval:
            boundaries.append((it // interval + 1) * interval)
    precrop_end = configs["data_loader"].get("precrop_iterations", -1)
    if it < precrop_end:
        boundaries.append(precrop_end)
    return min(min(boundaries) - it, scan_steps)


@contextlib.contextmanager
def profile_chunk(profiler_cfg: Optional[Dict[str, Any]], it: int, k: int, logs_dirpath: Path,
                  device: torch.device):
    """torch.profiler over the chunk [it, it + k) when it overlaps the
    configured window, written to logs_dirpath/profile as a Chrome trace."""
    if profiler_cfg is None or not (
            it < profiler_cfg["start_iter"] + profiler_cfg.get("num_iters", 1)
            and it + k > profiler_cfg["start_iter"]):
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    out = Path(logs_dirpath) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"chunk_{it:06}-{it + k:06}.json"))


def validation_complete(configs: Dict[str, Any], preps: Sequence, it: int,
                        sample_images_dirpath: Path) -> bool:
    """Whether the iteration-`it` validation left every file it writes,
    for every preprocessor (the PNG is written first, so its presence alone
    proves nothing)."""
    modes = ["coarse"] + (["fine"] if configs["model"].get("fine_mlp") else [])
    ndc = configs["data_loader"].get("ndc", False)
    predicts_vis = any(
        configs["model"].get(m, {}).get("predict_visibility", False)
        for m in ("coarse_mlp", "fine_mlp")
    )
    for prep in preps:
        frame_nums = [int(f) for f in prep.frame_nums]
        for f in frame_nums:
            for mode in modes:
                tag = f"{mode}_Iter{it:05}"
                expected = [
                    f"predicted_frames/{f:04}_{tag}.png",
                    f"predicted_depths/{f:04}_{tag}.npy",
                    f"predicted_depths_variance/{f:04}_{tag}.npy",
                ]
                if ndc:
                    expected += [
                        f"predicted_depths/{f:04}_{mode}_ndc_Iter{it:05}.npy",
                        f"predicted_depths_variance/{f:04}_{mode}_ndc_Iter{it:05}.npy",
                    ]
                if predicts_vis and prep.mode == "train":
                    expected += [f"predicted_visibilities/{f:04}_{sec:04}_{tag}.npy"
                                 for sec in frame_nums if sec != f]
                if not all((sample_images_dirpath / rel).exists() for rel in expected):
                    return False
    return True


def run_validation(renderer: TiledRenderer, model: torch.nn.Module, configs: Dict[str, Any],
                   iter_num: int, data_preprocessor, save_dirpath: Path,
                   verbose_log: bool = True) -> Dict[str, float]:
    """Full-image renders of every frame of `data_preprocessor`, with
    losses (train frames with visibility towards the other train frames),
    saved under `save_dirpath`; returns the losses averaged over frames.

    Tiles: `validation_tile_size`, else the smaller of
    `validation_chunk_size` and 8192 rays. The losses do not depend on
    the tile size (pad rays excluded, tiles weighted by real rays)."""
    chunk_size = configs.get("validation_tile_size") or min(configs["validation_chunk_size"], 8192)
    save_loss_maps = configs.get("validation_save_loss_maps", False)
    h, w = data_preprocessor.resolution
    is_train_data = data_preprocessor.mode == "train"
    frame_nums = [int(f) for f in data_preprocessor.frame_nums]
    total: Dict[str, float] = {}
    for frame_num in frame_nums:
        if verbose_log:
            print(f"  rendering frame {frame_num:04}...", flush=True)
        batch = data_preprocessor.get_next_batch(iter_num, image_num=frame_num)
        outputs, losses = renderer.render(
            model, batch, chunk_size=chunk_size, sec_views_vis=is_train_data,
            with_losses=True, return_loss_maps=save_loss_maps,
        )
        for name, val in losses.items():
            total[name] = total.get(name, 0.0) + (val["loss_value"] if isinstance(val, dict) else val)

        it_tag = f"Iter{iter_num + 1:05}"
        for mode in ("coarse", "fine"):
            if f"rgb_{mode}" not in outputs:
                continue
            tag = f"{mode}_{it_tag}"
            save_image(save_dirpath / f"predicted_frames/{frame_num:04}_{tag}.png",
                       np.clip(outputs[f"rgb_{mode}"].reshape(h, w, 3), 0, 1))
            save_numpy_array(save_dirpath / f"predicted_depths/{frame_num:04}_{tag}.npy",
                             outputs[f"depth_{mode}"].reshape(h, w), as_png=True)
            save_numpy_array(save_dirpath / f"predicted_depths_variance/{frame_num:04}_{tag}.npy",
                             outputs[f"depth_var_{mode}"].reshape(h, w), as_png=True)
            if f"depth_ndc_{mode}" in outputs:
                save_numpy_array(
                    save_dirpath / f"predicted_depths/{frame_num:04}_{mode}_ndc_{it_tag}.npy",
                    outputs[f"depth_ndc_{mode}"].reshape(h, w), as_png=True)
                save_numpy_array(
                    save_dirpath / f"predicted_depths_variance/{frame_num:04}_{mode}_ndc_{it_tag}.npy",
                    outputs[f"depth_var_ndc_{mode}"].reshape(h, w), as_png=True)
            if f"visibility2_{mode}" in outputs:
                others = [x for x in frame_nums if x != frame_num]
                for j, sec in enumerate(others):
                    save_numpy_array(
                        save_dirpath / f"predicted_visibilities/{frame_num:04}_{sec:04}_{tag}.npy",
                        outputs[f"visibility2_{mode}"][:, j].reshape(h, w), as_png=True)
        if save_loss_maps:
            for val in losses.values():
                for full_name, loss_map in (val.get("loss_maps", {}) if isinstance(val, dict) else {}).items():
                    save_numpy_array(
                        save_dirpath / f"Losses/{full_name}_{frame_num:04}_{it_tag}.npy",
                        np.asarray(loss_map).reshape(h, w), as_png=True)
    return {k: v / max(len(frame_nums), 1) for k, v in total.items()}


def boundary_validation(renderer: TiledRenderer, model: torch.nn.Module, configs: Dict[str, Any],
                        train_prep, val_prep, logger: ScalarLogger, it: int,
                        sample_images_dirpath: Path, verbose_log: bool = True):
    """The validation of boundary `it`: train and validation frames, their
    mean losses logged at `it`."""
    for tag, prep in (("train_images", train_prep), ("val_images", val_prep)):
        if verbose_log:
            print(f"validation/{tag} @ iter {it}...", flush=True)
        t_val = time.time()
        val_losses = run_validation(renderer, model, configs, it - 1, prep, sample_images_dirpath, verbose_log)
        logger.add_scalars(f"validation/{tag}", val_losses, it)
        if verbose_log:
            print(f"validation/{tag} done in {time.time() - t_val:.0f}s", flush=True)


class Trainer:
    def __init__(
        self,
        configs: Dict[str, Any],
        model_configs: Dict[str, Any],
        train_data_preprocessor,
        val_data_preprocessor,
        model: torch.nn.Module,
        loss_computer: LossComputer,
        output_dirpath: Path,
        verbose_log: bool = True,
    ):
        self.configs = configs
        self.model_configs = model_configs
        self.train_data_preprocessor = train_data_preprocessor
        self.val_data_preprocessor = val_data_preprocessor
        self.model = model
        self.device = next(model.parameters()).device
        self.output_dirpath = Path(output_dirpath)
        self.verbose_log = verbose_log
        _, self.render_fn = get_model(configs)
        self.optimizer = make_optimizer(configs, model.parameters())
        self.train_step = make_train_step(configs, self.render_fn, loss_computer, self.optimizer)
        self.lr_schedule = get_lr_schedule(configs)
        self.renderer = TiledRenderer(self.render_fn, configs, loss_computer=loss_computer)
        self.logger = ScalarLogger(self.output_dirpath / "logs")
        self.seed = configs.get("seed", 0) or 0
        self.generator = torch.Generator(device=self.device)
        self.scan_steps = int(configs.get("scan_steps", 100))
        self.profiler_cfg = configs.get("profiler")

    # --------------------------------------------------------------- training

    def train(self):
        scene_id = self.configs["data_loader"]["scene_id"]
        print(f"Training {self.configs['train_num']}/{scene_id} begins...")
        sample_images_dirpath = self.output_dirpath / "samples"
        saved_models_dirpath = self.output_dirpath / "saved_models"
        sample_images_dirpath.mkdir(parents=True, exist_ok=True)
        saved_models_dirpath.mkdir(parents=True, exist_ok=True)

        validation_interval = self.configs["validation_interval"]
        model_save_interval = self.configs["model_save_interval"]
        total_num_iters = self.configs["num_iterations"]

        start_iter = self.load_model(saved_models_dirpath)
        # a checkpoint is written before its boundary's validation: a run cut
        # during that validation resumes by rendering it again
        if (start_iter > 0 and start_iter % validation_interval == 0
                and not self._validation_complete(start_iter, sample_images_dirpath)):
            self._boundary_validation(start_iter, sample_images_dirpath)

        prep = self.train_data_preprocessor
        it = start_iter
        t_start = time.time()
        rays_done = 0
        while it < total_num_iters:
            k = chunk_boundary(it, self.configs, total_num_iters, self.scan_steps,
                               validation_interval, model_save_interval)
            nerf_idx, sd_idx = prep.get_index_chunk(it, k)
            nerf_dev = torch.from_numpy(nerf_idx).to(self.device)
            sd_dev = torch.from_numpy(sd_idx).to(self.device) if sd_idx is not None else None
            with profile_chunk(self.profiler_cfg, it, k, self.output_dirpath / "logs", self.device):
                chunk = []
                for j in range(k):
                    batch = prep.gather_batch(nerf_dev[j], sd_dev[j] if sd_dev is not None else None, it + j)
                    self.generator.manual_seed(step_seed(self.seed, it + j))
                    chunk.append(self.train_step(self.model, batch, self.generator))
                scalars = {name: torch.stack([s[name] for s in chunk]).cpu().numpy() for name in chunk[0]}
            rays_done += k * (nerf_idx.shape[1] + (sd_idx.shape[1] if sd_idx is not None else 0))
            for j in range(k):
                for name, vals in scalars.items():
                    self.logger.add_scalar(f"train/{name}", float(vals[j]), it + j + 1)
                self.logger.add_scalar("train/lr", float(self.lr_schedule(it + j)), it + j + 1)
            it += k
            if self.verbose_log:
                elapsed = time.time() - t_start
                print(f"iter {it}/{total_num_iters} TotalLoss {float(scalars['TotalLoss'][-1]):.5f} "
                      f"({rays_done / max(elapsed, 1e-9):,.0f} rays/s)", flush=True)
            # saved also at the last iteration when it is off every boundary
            if it % model_save_interval == 0 or it == total_num_iters:
                self.save_model(it, saved_models_dirpath)
            if it % validation_interval == 0:
                self._boundary_validation(it, sample_images_dirpath)
        self.logger.flush()

    def _validation_complete(self, it: int, sample_images_dirpath: Path) -> bool:
        return validation_complete(self.configs, (self.train_data_preprocessor, self.val_data_preprocessor),
                                   it, sample_images_dirpath)

    def _boundary_validation(self, it: int, sample_images_dirpath: Path):
        boundary_validation(self.renderer, self.model, self.configs, self.train_data_preprocessor,
                            self.val_data_preprocessor, self.logger, it, sample_images_dirpath, self.verbose_log)

    # ------------------------------------------------------------ checkpoints

    def save_model(self, iter_num: int, save_dirpath: Path):
        checkpoints.save_checkpoint(save_dirpath, iter_num, self.model, self.optimizer)

    def load_model(self, saved_models_dirpath: Path) -> int:
        latest = checkpoints.latest_checkpoint(saved_models_dirpath)
        if latest is None:
            return 0
        iter_num = checkpoints.load_checkpoint(latest, self.model, self.optimizer)
        print(f"Resuming Training from iteration {iter_num + 1}")
        return iter_num


def resolve_scene_ids(configs: Dict[str, Any], database_dirpath: Path):
    """scene_ids from scene_ids/scene_names/scene_nums (numbers become
    zero-padded ids), else every scene of the train split CSV."""
    dl = configs["data_loader"]
    for key in ("scene_ids", "scene_names", "scene_nums"):
        if dl.get(key):
            ids = list(np.unique(dl[key]))
            if key == "scene_nums":
                ids = [scene_dirname(n, "scene_num") for n in ids]
            return [i.item() if isinstance(i, np.generic) else i for i in ids]
    csv_path = database_dirpath / f"train_test_sets/set{dl['train_set_num']:02}/TrainVideosData.csv"
    data = read_csv_columns(csv_path)
    if "scene_name" in data:
        return [str(s) for s in np.unique(data["scene_name"].astype(str))]
    return [scene_dirname(n, "scene_num") for n in np.unique(data["scene_num"])]


def start_training(configs: Dict[str, Any]):
    """Train every scene of `configs` into
    {root_dirpath}/runs/training/train{train_num:04}/{scene}/. On resume the
    saved Configs.json is merged into `configs` first."""
    root_dirpath = Path(configs.get("root_dirpath", "."))
    output_dirpath = root_dirpath / f"runs/training/train{configs['train_num']:04}"
    output_dirpath.mkdir(parents=True, exist_ok=True)
    configs = save_configs(output_dirpath, configs)
    database_dirpath = root_dirpath / "data" / configs["database_dirpath"]
    device = resolve_device(configs.get("device", "all"))

    for scene_id in resolve_scene_ids(configs, database_dirpath):
        init_seeds(configs.get("seed", 0))
        scene_output_dirpath = output_dirpath / f"{scene_id}"
        scene_output_dirpath.mkdir(parents=True, exist_ok=configs.get("resume_training", False))
        configs["data_loader"]["scene_id"] = scene_id

        train_data_preprocessor = get_data_preprocessor(
            configs, mode="train", device=device,
            raw_data_dict=get_data_loader(configs, database_dirpath, mode="train").load_data(),
        )
        model_configs = train_data_preprocessor.get_model_configs()
        val_data_preprocessor = get_data_preprocessor(
            configs, mode="validation", model_configs=model_configs, device=device,
            raw_data_dict=get_data_loader(configs, database_dirpath, mode="validation").load_data(),
        )
        model_cls, _ = get_model(configs)
        model = model_cls(configs, torch.Generator().manual_seed(configs.get("seed", 0) or 0)).to(device)
        save_model_configs(scene_output_dirpath, model_configs)
        trainer = Trainer(configs, model_configs, train_data_preprocessor, val_data_preprocessor,
                          model, LossComputer(configs), scene_output_dirpath)
        try:
            trainer.train()
        finally:
            trainer.logger.close()
