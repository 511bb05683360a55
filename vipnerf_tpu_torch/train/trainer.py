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

Every chunk is traced (`utils/tracing.py`, `train_chunk`, shared with the
batched trainer): `train.chunk` with its index draw, the indices' copy to
the device, one `train.step` per iteration (`it`) and the scalars' read;
the steps' forward, losses, backward and Adam are spans of
`train/step.py`; after the chunk, `train.log` is the logging of its
scalars. The forward and the backward also time their interval on the
card's stream, and the step its end (nothing is queued between Adam's last
kernel and the step's end; the chunk's first step its start too), read
back at the chunk's read of its scalars.

`profiler: {start_iter, num_iters}` traces every chunk that overlaps those
iterations with torch.profiler (host, and the card's kernels on CUDA) into
{scene}/logs/profile/ as a Chrome trace, one file per chunk (the JAX
trainer's jax.profiler hook), with the program's spans on its timeline.
The validation helpers below serve the batched multi-scene trainer too
(train/multi_scene.py).

More than one device (`configs['device']` a list, or "all" on a host with
several GPUs): `start_training` runs one rank per device
(`parallel.mesh.run_on_devices`), and the `Trainer` of each takes the
`group` (the JAX trainer's ray-sharded mesh):

- every rank draws the same index blocks from its own copy of the ray
  cache and streams, and trains on its columns of them
  (`parallel.mesh.ray_shard`): its contiguous share of each stream's piece
  of each global sub-batch (of `sub_batch_size` rays, or the whole batch),
  so the ranks' sub-batches together are one process's; where a piece does
  not divide by the world size, every rank computes the whole batch
  without a collective, as the JAX trainer's `_place_indices` replicates it;
- the step (train/step.py) sums the gradient over the ranks, so the
  parameters stay identical on every rank;
- validation renders shard each tile's rays over the ranks;
- rank 0 alone writes the run tree (configs, scalars, samples,
  checkpoints, profiles); the other ranks wait for its checkpoints at a
  barrier, and on resume every rank loads the checkpoint rank 0 wrote.
"""

import contextlib
import copy
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vipnerf_tpu_torch.data.loaders import get_data_loader
from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
from vipnerf_tpu_torch.infer.renderer import TiledRenderer
from vipnerf_tpu_torch.losses import LossComputer
from vipnerf_tpu_torch.models.factory import get_model
from vipnerf_tpu_torch.parallel.mesh import ShardGenerator, current_group, ray_shard, run_on_devices
from vipnerf_tpu_torch.train import checkpoints
from vipnerf_tpu_torch.train.logging import NullLogger, ScalarLogger
from vipnerf_tpu_torch.train.lr_schedules import get_lr_schedule
from vipnerf_tpu_torch.train.step import make_optimizer, make_train_step
from vipnerf_tpu_torch.utils.config import (
    init_seeds,
    merge_configs,
    read_configs,
    save_configs,
    save_model_configs,
)
from vipnerf_tpu_torch.utils.device import resolve_device
from vipnerf_tpu_torch.utils import tracing
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
    configured window, written to logs_dirpath/profile as a Chrome trace;
    the program's spans appear in it beside the operations and kernels."""
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


def train_chunk(trainer, it: int, k: int, draw: Callable[[], Tuple[np.ndarray, Optional[np.ndarray]]],
                gather: Callable[[Tuple[torch.Tensor, ...], int], Dict[str, Any]],
                read: Callable[[List[Dict[str, Any]]], Dict[str, np.ndarray]], profiled) -> Dict[str, np.ndarray]:
    """The chunk [it, it + k) of either trainer (its `model`, `device`,
    `generator`, `seed` and `train_step`), in spans: `draw()` the index
    blocks, copy them to the device, then per step `gather(blocks, j)` its
    batch and train on it, the generator seeded from (seed, iteration), and
    `read` the steps' loss scalars to the host, which waits for the last
    step; the steps and the read run inside `profiled` (`profile_chunk`)."""
    with tracing.span("train.chunk", it=it, steps=k):
        with tracing.span("train.chunk.indices"):
            host = draw()
        with tracing.span("train.chunk.copy"):
            blocks = tuple(None if b is None else torch.from_numpy(b).to(trainer.device) for b in host)
        with profiled:
            chunk = []
            for j in range(k):
                with tracing.span("train.step", trainer.device, start_event=j == 0, it=it + j):
                    with tracing.span("train.gather"):
                        batch = gather(blocks, j)
                    trainer.generator.manual_seed(step_seed(trainer.seed, it + j))
                    chunk.append(trainer.train_step(trainer.model, batch, trainer.generator))
            with tracing.span("train.chunk.read"):
                scalars = read(chunk)
                tracing.collect()
    return scalars


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
    the tile size (pad rays excluded, tiles weighted by real rays). With a
    sharded renderer every rank renders and rank 0 alone saves."""
    writes = renderer.group is None or renderer.group.is_writer
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
        if not writes:
            continue

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
        t_val = time.perf_counter()
        val_losses = run_validation(renderer, model, configs, it - 1, prep, sample_images_dirpath, verbose_log)
        logger.add_scalars(f"validation/{tag}", val_losses, it)
        if verbose_log:
            print(f"validation/{tag} done in {time.perf_counter() - t_val:.0f}s", flush=True)


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
        group=None,
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
        self.group = group
        self.writes = group is None or group.is_writer
        self.verbose_log = verbose_log and self.writes
        self.generator = ShardGenerator(self.device)
        # the streams' rays per step, sharded when every piece of every sub-batch divides
        prep = train_data_preprocessor
        streams = [prep.num_rays] + ([prep.num_rays_sparse_depth] if prep.sparse_depth_needed else [])
        self.shard = None if group is None else ray_shard(group, streams, configs.get("sub_batch_size"))
        self.optimizer = make_optimizer(configs, model.parameters())
        self.train_step = make_train_step(configs, self.render_fn, loss_computer, self.optimizer, self.shard)
        self.lr_schedule = get_lr_schedule(configs)
        self.renderer = TiledRenderer(self.render_fn, configs, loss_computer=loss_computer, group=group)
        self.logger = ScalarLogger(self.output_dirpath / "logs") if self.writes else NullLogger()
        self.seed = configs.get("seed", 0) or 0
        self.scan_steps = int(configs.get("scan_steps", 100))
        self.profiler_cfg = configs.get("profiler")

    # --------------------------------------------------------------- training

    def train(self):
        scene_id = self.configs["data_loader"]["scene_id"]
        print(f"Training {self.configs['train_num']}/{scene_id} begins...")
        sample_images_dirpath = self.output_dirpath / "samples"
        saved_models_dirpath = self.output_dirpath / "saved_models"
        if self.writes:
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
        rays_per_step = prep.num_rays + (prep.num_rays_sparse_depth if prep.sparse_depth_needed else 0)
        it = start_iter
        t_start = time.perf_counter()
        rays_done = 0
        while it < total_num_iters:
            k = chunk_boundary(it, self.configs, total_num_iters, self.scan_steps,
                               validation_interval, model_save_interval)
            profiler_cfg = self.profiler_cfg if self.writes else None
            scalars = train_chunk(
                self, it, k, lambda: self._index_blocks(it, k),
                lambda blocks, j: prep.gather_batch(blocks[0][j], None if blocks[1] is None else blocks[1][j],
                                                    it + j),
                _read_scalars, profile_chunk(profiler_cfg, it, k, self.output_dirpath / "logs", self.device))
            rays_done += k * rays_per_step
            with tracing.span("train.log", it=it):
                for j in range(k):
                    for name, vals in scalars.items():
                        self.logger.add_scalar(f"train/{name}", float(vals[j]), it + j + 1)
                    self.logger.add_scalar("train/lr", float(self.lr_schedule(it + j)), it + j + 1)
            it += k
            if self.verbose_log:
                elapsed = time.perf_counter() - t_start
                print(f"iter {it}/{total_num_iters} TotalLoss {float(scalars['TotalLoss'][-1]):.5f} "
                      f"({rays_done / max(elapsed, 1e-9):,.0f} rays/s)", flush=True)
            # saved also at the last iteration when it is off every boundary
            if it % model_save_interval == 0 or it == total_num_iters:
                self.save_model(it, saved_models_dirpath)
            if it % validation_interval == 0:
                self._boundary_validation(it, sample_images_dirpath)
        self.logger.flush()

    def _index_blocks(self, it: int, k: int):
        """The next k steps' index blocks (this rank's columns of each stream's)."""
        nerf_idx, sd_idx = self.train_data_preprocessor.get_index_chunk(it, k)
        if self.shard is not None:
            nerf_idx = nerf_idx[:, self.shard.columns[0]]
            sd_idx = None if sd_idx is None else sd_idx[:, self.shard.columns[1]]
        return nerf_idx, sd_idx

    def _validation_complete(self, it: int, sample_images_dirpath: Path) -> bool:
        return validation_complete(self.configs, (self.train_data_preprocessor, self.val_data_preprocessor),
                                   it, sample_images_dirpath)

    def _boundary_validation(self, it: int, sample_images_dirpath: Path):
        boundary_validation(self.renderer, self.model, self.configs, self.train_data_preprocessor,
                            self.val_data_preprocessor, self.logger, it, sample_images_dirpath, self.verbose_log)

    # ------------------------------------------------------------ checkpoints

    def save_model(self, iter_num: int, save_dirpath: Path):
        """Rank 0 writes; the other ranks wait until the file is there."""
        if self.writes:
            checkpoints.save_checkpoint(save_dirpath, iter_num, self.model, self.optimizer)
        if self.group is not None:
            self.group.barrier()

    def load_model(self, saved_models_dirpath: Path) -> int:
        latest = checkpoints.latest_checkpoint(saved_models_dirpath)
        if latest is None:
            return 0
        iter_num = checkpoints.load_checkpoint(latest, self.model, self.optimizer)
        print(f"Resuming Training from iteration {iter_num + 1}")
        return iter_num


def _read_scalars(chunk: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    return {name: torch.stack([s[name] for s in chunk]).cpu().numpy() for name in chunk[0]}


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


def start_training(configs: Dict[str, Any]) -> None:
    """Train every scene of `configs` into
    {root_dirpath}/runs/training/train{train_num:04}/{scene}/, on every
    device `configs['device']` selects (one rank each). On resume the saved
    Configs.json is merged into `configs` first. The chunks' spans are in
    this process's tracer (rank 0's, with several devices)."""
    output_dirpath, _ = run_dirs(configs)
    run_on_devices(_start_training, configs, run_device(output_dirpath, configs))


def run_dirs(configs: Dict[str, Any]) -> Tuple[Path, Path]:
    """The run's output directory and the data directory."""
    root_dirpath = Path(configs.get("root_dirpath", "."))
    return root_dirpath / f"runs/training/train{configs['train_num']:04}", root_dirpath / "data"


def run_device(output_dirpath: Path, configs: Dict[str, Any]) -> Any:
    """The device selection of a run: the live configs', else (a resume from
    a minimal config) the saved Configs.json's."""
    return merge_configs(output_dirpath, copy.deepcopy(configs), quiet=True).get("device", "all")


def save_run_configs(output_dirpath: Path, configs: Dict[str, Any], group) -> Dict[str, Any]:
    """`save_configs`; in a group rank 0 writes, and every rank takes the
    merged configs from the file once it is there, so all ranks hold the
    same."""
    if group is None:
        output_dirpath.mkdir(parents=True, exist_ok=True)
        return save_configs(output_dirpath, configs)
    group.barrier()  # every rank has read the saved configs (`run_device`) before rank 0 rewrites them
    if group.is_writer:
        output_dirpath.mkdir(parents=True, exist_ok=True)
        save_configs(output_dirpath, configs)
    group.barrier()
    merged = read_configs(output_dirpath / "Configs.json")
    return {**merged, **{k: configs[k] for k in ("root_dirpath", "output_dirpath") if k in configs}}


def _start_training(configs: Dict[str, Any]) -> None:
    output_dirpath, data_dirpath = run_dirs(configs)
    group = current_group(run_device(output_dirpath, configs))
    writes = group is None or group.is_writer
    configs = save_run_configs(output_dirpath, configs, group)
    database_dirpath = data_dirpath / configs["database_dirpath"]
    device = resolve_device(configs.get("device", "all"))

    for scene_id in resolve_scene_ids(configs, database_dirpath):
        init_seeds(configs.get("seed", 0))
        scene_output_dirpath = output_dirpath / f"{scene_id}"
        if writes:
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
        if writes:
            save_model_configs(scene_output_dirpath, model_configs)
        if group is not None:  # rank 0's directories and files first
            group.barrier()
        trainer = Trainer(configs, model_configs, train_data_preprocessor, val_data_preprocessor,
                          model, LossComputer(configs), scene_output_dirpath, group=group)
        try:
            trainer.train()
        finally:
            trainer.logger.close()
        if group is not None:  # rank 0's last files are written
            group.barrier()
