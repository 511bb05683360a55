"""Training cells: the program's `Trainer` (one scene) or, for a mix of
several `scenes`, its `MultiSceneTrainer` (the scenes in lockstep, as
`batch_scenes` trains them), driven through the trainer's own chunked loop.

Set-up writes the synthetic scene(s) at the configuration's resolution,
loads them through the program's loaders and preprocessors, puts the
benchmark's seeded weights into the model, and saves them as the run's
checkpoints at the mix's `start_iter`, so that `train()` resumes there
through the program's own resume path. Then one call of `train()` runs
everything: the warm chunks (set-up), the measured window, and with
`--trace 1` the traced chunks. The harness hooks in at three points:

- the trainer's scalar logger: it forwards every scalar; at each chunk's
  end (the first scalar of the next iteration past a chunk, logged after
  the trainer read the chunk's scalars back, which waits for its last
  step) it notes the time, and ends the run once the window is over;
- for the first `check_steps` steps, the train step: it notes each step's
  batch indices and losses, the optimizer's first moments after the first
  step and the parameters after the last, then steps aside;
- the loss computer's `compute_losses`, for the same steps: it keeps what
  each step rendered, per ray, as it reaches the losses.
"""

import copy
import gc
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness import checks, common, scene, trace


class WindowLogger:
    """A scalar logger, forwarded. The first one of a run (`leader` None)
    also moves the run from warm-up to the window, the trace and the end at
    each chunk's end; the others (one per further scene) follow its phase."""

    def __init__(self, inner, mix, seconds: float, traced: bool, leader: Optional["WindowLogger"] = None):
        self.inner, self.mix, self.seconds, self.traced = inner, mix, seconds, traced
        self.leader = leader or self
        self.last_step = None
        self.phase = "warm"
        self.warm_left = mix["warm_chunks"]
        self.window_chunks = 0
        self.chunk_ends: List[float] = []
        self.t_start = self.t_end = None
        self.trace_chunks, self.trace_left = 0, mix["trace_chunks"]
        self.prof = self.profile = None
        self.losses: List[float] = []

    def _chunk_end(self):
        t = common.now()
        if self.phase == "warm":
            self.warm_left -= 1
            if self.warm_left == 0:
                self.phase, self.t_start = "window", t
                if self.seconds < 0:  # no window (calibrate.py reads the check alone)
                    self.t_end = t
                    raise common.WindowClosed()
            return
        if self.phase == "window":
            self.window_chunks += 1
            self.chunk_ends.append(t)
            if t - self.t_start < self.seconds:
                return
            self.t_end = t
            if not self.traced:
                raise common.WindowClosed()
            self.phase, self.prof = "trace", trace.start_profiler()
            return
        self.trace_chunks += 1
        self.trace_left -= 1
        if self.trace_left == 0:
            self.prof.stop()
            self.profile = trace.reduce_profile(self.prof)
            self.prof = None
            raise common.WindowClosed()

    def add_scalar(self, tag, value, step):
        if self.leader is self and step != self.last_step:
            done = step - 1 - self.mix["start_iter"]
            if done and done % self.mix["scan_steps"] == 0:
                self._chunk_end()
            self.last_step = step
        if self.leader.phase == "window" and tag == "train/TotalLoss":
            self.losses.append(float(value))
        self.inner.add_scalar(tag, value, step)

    def add_scalars(self, prefix, scalars, step):
        self.inner.add_scalars(prefix, scalars, step)

    def flush(self):
        self.inner.flush()

    def close(self):
        self.inner.close()


class StepRecorder:
    """Wraps the trainer's step for its first `count` calls: each call's
    batch indices, iteration and losses, the optimizer's first moments after
    the first call and the parameters after the last; then steps aside."""

    def __init__(self, trainer, count: int):
        self.trainer, self.inner, self.count = trainer, trainer.train_step, count
        self.steps: List[Dict[str, Any]] = []
        self.m1 = self.params_after = None

    def __call__(self, model, batch, generator):
        scalars = self.inner(model, batch, generator)
        self.steps.append({"indices": batch["indices"].detach().clone(), "iter": int(batch["iter_num"]),
                           "losses": {k: v.detach().clone() for k, v in scalars.items()}})
        if len(self.steps) == 1:
            self.m1 = self.trainer.optimizer.exp_avg.detach().clone()
        if len(self.steps) == self.count:
            self.params_after = {k: p.detach().clone() for k, p in model.named_parameters()}
            self.trainer.train_step = self.inner
        return scalars


def record_outputs(loss_computer, count: int) -> List[Dict[str, torch.Tensor]]:
    """Keep what the first `count` loss computations were given: each
    level's colour and depth per ray (per scene for a stacked model)."""
    inner, kept = loss_computer.compute_losses, []

    def compute_losses(batch, outputs, **kwargs):
        if len(kept) < count:
            kept.append({k: outputs[k].detach().clone()
                         for k in ("rgb_coarse", "rgb_fine", "depth_coarse", "depth_fine")})
        return inner(batch, outputs, **kwargs)

    loss_computer.compute_losses = compute_losses
    return kept


def plant_fault(trainer, fault: Optional[str]):
    """A broken step under the timed path, for the checks that must fail."""
    if fault is None:
        return
    inner = trainer.train_step
    if fault == "state_unchanged":
        def step(model, batch, generator):
            opt = trainer.optimizer
            saved = ([p.detach().clone() for p in model.parameters()], opt.exp_avg.clone(),
                     opt.exp_avg_sq.clone(), opt.count.clone())
            out = inner(model, batch, generator)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved[0]):
                    p.copy_(s)
            opt.exp_avg, opt.exp_avg_sq, opt.count = saved[1:]
            return out
    elif fault == "half_batch":
        def step(model, batch, generator):
            nr = batch["rays_o"].shape[0]
            per = nr // (model.scenes or 1)  # [nerf; sparse depth] of each scene
            keep = torch.arange(nr, device=batch["rays_o"].device)
            keep = keep[(keep % (per // 2)) < per // 4]  # the first half of each stream
            half = {k: (v.index_select(0, keep) if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == nr
                        else v) for k, v in batch.items()}
            return inner(model, half, generator)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    trainer.train_step = step


def scene_inputs(cfg, root: Path, seed: int, scene_index: int) -> Dict[str, Any]:
    """Write one synthetic scene of the configuration under root/data/databases."""
    s = cfg["scene"]
    name = f"{scene_index + 1:05}" if cfg["dataset"] == "DTU" else f"synth{scene_index + 1:02}"
    gt = scene.write_synthetic_database(
        root / "data/databases", dataset=cfg["dataset"], scene_name=name, num_frames=s["num_frames"],
        set_num=cfg["set_num"], train_frames=s["train_frames"], val_frames=s["val_frames"], height=s["height"],
        width=s["width"], seed=seed + scene_index, focal_factor=s["focal_factor"],
        resolution_suffix=cfg["train_configs"]["data_loader"].get("resolution_suffix", ""),
        shell_radius=s["shell_radius"], ring_radius=s["ring_radius"], ring_height=s["ring_height"],
        sparse_depth_dirname=f"DE{cfg['set_num']:02}", visibility_dirname=f"VW{cfg['set_num']:02}",
        render_frames=list(s["train_frames"]) + list(s["val_frames"]))
    gt["scene_name"] = name
    return gt


def program_configs(cfg, mix, root: Path, seed: int, device: torch.device, names: List[str]) -> Dict[str, Any]:
    configs = copy.deepcopy(cfg["train_configs"])
    configs.update({"root_dirpath": str(root), "seed": seed, "scan_steps": mix["scan_steps"],
                    "num_iterations": mix["start_iter"] + 10 ** 8, "validation_interval": 10 ** 9,
                    "model_save_interval": 10 ** 9,
                    "device": "cpu" if device.type == "cpu" else [device.index or 0]})
    configs["model"].update(cfg.get("program_overrides", {}))
    key = "scene_names" if cfg["dataset"] == "NeRF_LLFF" else "scene_nums"
    configs["data_loader"][key] = [n if key == "scene_names" else int(n) for n in names]
    configs["data_loader"]["scene_id"] = names[0]
    if mix["scenes"] > 1:
        configs["batch_scenes"] = True
    return configs


def single_scene(configs, mix, db: Path, root: Path, device, weights, scene_name: str):
    """A `Trainer` over the first scene, resuming at the mix's start."""
    from vipnerf_tpu_torch.data.loaders import get_data_loader
    from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
    from vipnerf_tpu_torch.losses import LossComputer
    from vipnerf_tpu_torch.models.factory import get_model
    from vipnerf_tpu_torch.train import checkpoints
    from vipnerf_tpu_torch.train.trainer import Trainer

    prep = get_data_preprocessor(configs, "train", device=device,
                                 raw_data_dict=get_data_loader(configs, db, "train").load_data())
    val_prep = get_data_preprocessor(configs, "validation", model_configs=prep.get_model_configs(), device=device,
                                     raw_data_dict=get_data_loader(configs, db, "validation").load_data())
    model = get_model(configs)[0](configs, torch.Generator().manual_seed(0)).to(device)
    common.load_weights(model, weights)
    loss_computer = LossComputer(configs)
    out_dir = root / "runs" / scene_name
    trainer = Trainer(configs, prep.get_model_configs(), prep, val_prep, model, loss_computer, out_dir,
                      verbose_log=False)
    checkpoints.save_checkpoint(out_dir / "saved_models", mix["start_iter"], model, trainer.optimizer)
    return trainer, prep, model, loss_computer


def run(cell, cfg, mix, seed: int, seconds: float, traced: bool, device: torch.device, t0: float,
        fault: Optional[str] = None) -> Dict[str, Any]:
    from vipnerf_tpu_torch.kernels import build
    from vipnerf_tpu_torch.train.multi_scene import MultiSceneTrainer

    common.start_device(device)
    if device.type == "cuda":
        build.build_all(["fused_mlp", "fused_mlp_bwd", "raystream"])
    scenes = mix["scenes"]
    tmp = tempfile.TemporaryDirectory(prefix="vipnerf_bench_")
    root = Path(tmp.name)
    gts = [scene_inputs(cfg, root, seed, i) for i in range(scenes)]
    names = [g["scene_name"] for g in gts]
    configs = program_configs(cfg, mix, root, seed, device, names)
    db = root / "data" / configs["database_dirpath"]
    weights = common.seeded_weights(cfg["train_configs"]["model"], seed, device, scenes=scenes)
    if scenes == 1:
        trainer, prep, model, loss_computer = single_scene(configs, mix, db, root, device, weights, names[0])
        trainer.logger = WindowLogger(trainer.logger, mix, seconds, traced)
        loggers = [trainer.logger]
    else:
        ids = names if cfg["dataset"] == "NeRF_LLFF" else [int(n) for n in names]
        trainer = MultiSceneTrainer(configs, ids, db, device, root / "runs", verbose_log=False)
        prep, model, loss_computer = trainer.preprocessors[0], trainer.model, trainer.loss_computer
        common.load_weights(model, weights)
        trainer.save_checkpoints(mix["start_iter"])
        inner = trainer.loggers()
        loggers = [WindowLogger(inner[0], mix, seconds, traced)]
        loggers += [WindowLogger(i, mix, seconds, traced, loggers[0]) for i in inner[1:]]
        trainer._loggers = loggers
    outputs = record_outputs(loss_computer, mix["check_steps"])
    plant_fault(trainer, fault)
    recorder = StepRecorder(trainer, mix["check_steps"])
    trainer.train_step = recorder
    clock = loggers[0]
    try:
        trainer.train() if scenes == 1 else trainer.train(configs["num_iterations"])
    except common.WindowClosed:
        pass
    finally:
        for logger in loggers:
            logger.close()
    rays_per_step = scenes * (prep.num_rays + (prep.num_rays_sparse_depth if prep.sparse_depth_needed else 0))
    steps = clock.window_chunks * mix["scan_steps"]
    window_s = clock.t_end - clock.t_start
    record = common.device_record(device, 1)
    losses = [v for logger in loggers for v in logger.losses]
    result = {
        "setup_s": clock.t_start - t0, "window_s": window_s, "steps": steps,
        "attempted": steps * scenes, "failed": int(sum(not np.isfinite(v) for v in losses)),
        "metrics": {"train_rays_per_s": steps * rays_per_step / max(window_s, 1e-9),
                    "peak_gib": record["memory_peak_bytes"] / 2 ** 30},
        "device": record, "profile": clock.profile,
        "window_parts_s": list(np.diff([clock.t_start] + clock.chunk_ends)),
        "counts": train_counts(cfg, rays_per_step, steps, clock.trace_chunks * mix["scan_steps"], window_s, scenes),
    }
    # the program's state is freed before the reference runs
    program = {"m1": recorder.m1, "outputs": outputs, "params_after": recorder.params_after,
               "steps": recorder.steps, "leaf_names": [k for k, _ in model.named_parameters()],
               "sizes": list(trainer.optimizer.sizes), "b1": trainer.optimizer.b1,
               "rays_per_scene": prep.cache["rays_o"].shape[0] if scenes == 1 else trainer.rays_per_scene}
    del trainer, model, prep, loss_computer, loggers, clock
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result["checks"] = checks.train_readings(cfg, mix, seed, device, gts, program, weights)
    tmp.cleanup()
    return result


def train_counts(cfg, rays_per_step: int, steps: int, trace_steps: int, window_s: float, scenes: int):
    m = cfg["train_configs"]["model"]
    pts = {"coarse": rays_per_step * m["coarse_mlp"]["num_samples"],
           "fine": rays_per_step * (m["coarse_mlp"]["num_samples"] + m["fine_mlp"]["num_samples"])}
    return {"kind": "train", "points_per_step": pts, "n_sec": len(cfg["scene"]["train_frames"]) - 1,
            "steps": steps, "trace_steps": trace_steps, "window_s": window_s, "scenes": scenes}
