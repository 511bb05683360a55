"""Render cells: held-out frames through the program's `NerfTester`, one
`predict_frame` after another (the tiled renderer, K1's forward), as a
researcher renders a trained scene's held-out views.

Set-up builds the tester from the configuration's training configs and the
model configs that training on the configuration's scene would save (the
normalisation of its train views, computed here), puts the benchmark's
seeded weights into its model (sigma biases offset by the mix's
`sigma_offset`, so that a random field is not empty), and renders
`warm_frames` frames. The window renders the held-out poses in turn, each
frame timed from the call to its outputs on the host. Per frame, a sample of
pixels drawn from the seed is kept for the check.
"""

import copy
import gc
import tempfile
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from harness import checks, common, scene, trace
from reference import driver


def serving_scene(cfg, seed: int) -> Dict[str, Any]:
    """The cameras of the configuration's scene and the depth bounds of its
    train views (traced at a quarter of the resolution), as a training run
    would have seen them; the held-out poses are the frames outside the
    train and validation sets."""
    s = cfg["scene"]
    sphere = scene.SphereScene(seed=seed, shell_radius=s["shell_radius"])
    extrinsics = scene.make_camera_ring(s["num_frames"], radius=s["ring_radius"], height=s["ring_height"])
    intrinsic = scene.intrinsic_matrix(s["height"], s["width"], s["focal_factor"])
    small = scene.intrinsic_matrix(s["height"] // 4, s["width"] // 4, s["focal_factor"])
    bounds = np.full((s["num_frames"], 2), np.nan)
    for f in s["train_frames"]:
        _, depth = sphere.render(extrinsics[f], small, s["height"] // 4, s["width"] // 4)
        bounds[f] = [depth.min() * 0.8, depth.max() * 1.2 + 1.0]
    held_out = [f for f in range(s["num_frames"]) if f not in s["train_frames"] and f not in s["val_frames"]]
    return {"extrinsics": extrinsics, "intrinsic": intrinsic, "bounds": bounds, "held_out": held_out}


def model_configs(cfg, gt) -> Dict[str, Any]:
    """What a training run on the scene saves beside its checkpoints."""
    frame = driver.scene_frame(cfg, gt)
    s = cfg["scene"]
    mc = {"resolution": [s["height"], s["width"]], "intrinsic": gt["intrinsic"].tolist(),
          "translation_scale": frame["sc"], "average_pose": frame["average_pose"].tolist(),
          "near": frame["near"], "far": frame["far"], "bounds": frame["bounds"].tolist()}
    if cfg["train_configs"]["data_loader"]["ndc"]:
        mc.update(near_ndc=0.0, far_ndc=1.0)
    return mc


def pixel_sample(seed: int, frame_index: int, h: int, w: int, count: int):
    rng = np.random.default_rng([seed, frame_index])
    flat = rng.choice(h * w, size=min(count, h * w), replace=False)
    return flat // w, flat % w


def plant_fault(tester, fault):
    """A broken frame under the timed path: one tile's depth altered."""
    if fault is None:
        return
    if fault != "answer_altered":
        raise ValueError(f"unknown fault {fault!r}")
    inner = tester.renderer.render

    def render(*args, **kwargs):
        outputs, losses = inner(*args, **kwargs)
        for key in ("depth_fine", "rgb_fine"):
            outputs[key][: tester.chunk_size] *= 1.01
        return outputs, losses

    tester.renderer.render = render


def run(cell, cfg, mix, seed: int, seconds: float, traced: bool, device: torch.device, t0: float,
        fault=None) -> Dict[str, Any]:
    from vipnerf_tpu_torch.infer.tester import NerfTester
    from vipnerf_tpu_torch.kernels import build

    common.start_device(device)
    if device.type == "cuda":
        build.build_all(["fused_mlp"])
    s = cfg["scene"]
    h, w = s["height"], s["width"]
    gt = serving_scene(cfg, seed)
    train_configs = copy.deepcopy(dict(cfg["train_configs"], seed=seed))
    train_configs["model"].update(cfg.get("program_overrides", {}))
    test_configs = {"device": "cpu" if device.type == "cpu" else [device.index or 0],
                    "chunk_size": mix["chunk_size"]}
    tmp = tempfile.TemporaryDirectory(prefix="vipnerf_bench_")
    tester = NerfTester(train_configs, model_configs(cfg, gt), test_configs, Path(tmp.name))
    weights = common.seeded_weights(cfg["train_configs"]["model"], seed, device, mix["sigma_offset"])
    common.load_weights(tester.model, weights)
    plant_fault(tester, fault)
    poses = [gt["extrinsics"][f] for f in gt["held_out"]]
    for i in range(mix["warm_frames"]):
        tester.predict_frame(poses[i % len(poses)])
    common.sync(device)
    t_start = common.now()
    latencies: List[float] = []
    kept: List[Dict[str, Any]] = []
    failed = 0
    while True:
        i = len(latencies)
        pose_index = i % len(poses)
        ta = common.now()
        out = tester.predict_frame(poses[pose_index])
        tb = common.now()
        latencies.append(tb - ta)
        ys, xs = pixel_sample(seed, i, h, w, mix["check_pixels"])
        kept.append({"pose": pose_index, "ys": ys, "xs": xs, "rgb": out["image"][ys, xs].copy(),
                     "depth": out["depth"][ys, xs].copy()})
        failed += int(not np.isfinite(out["depth"]).all())
        if tb - t_start >= seconds:
            break
    t_end = common.now()
    window_s = t_end - t_start
    record = common.device_record(device, 1)
    profile, trace_frames = None, 0
    if traced:
        prof = trace.start_profiler()
        ta = common.now()
        while trace_frames == 0 or common.now() - ta < mix["trace_seconds"]:
            tester.predict_frame(poses[trace_frames % len(poses)])
            trace_frames += 1
        common.sync(device)
        prof.stop()
        profile = trace.reduce_profile(prof)
    frames = len(latencies)
    result = {
        "setup_s": t_start - t0, "window_s": window_s, "attempted": frames, "failed": failed,
        "metrics": {"render_rays_per_s": frames * h * w / window_s,
                    "frame_ms_p95": 1e3 * float(np.quantile(latencies, 0.95, method="higher")),
                    "peak_gib": record["memory_peak_bytes"] / 2 ** 30},
        "device": record, "profile": profile, "window_parts_s": latencies,
        "counts": {"kind": "render", "pixels": h * w, "samples": (cfg["train_configs"]["model"]["coarse_mlp"][
            "num_samples"], cfg["train_configs"]["model"]["fine_mlp"]["num_samples"]), "frames": frames,
                   "trace_frames": trace_frames, "window_s": window_s, "chunk": mix["chunk_size"]},
    }
    del tester
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    chosen = sorted(set(rng.choice(frames, size=min(mix["check_frames"] - 1, frames), replace=False).tolist())
                    | {frames - 1})
    result["checks"] = checks.render_readings(cfg, device, gt, weights[0], [kept[i] for i in chosen], poses)
    tmp.cleanup()
    return result
