"""What the protocol drivers share: a database written once
(`write_database_once`), the synthetic DTU database of the two DTU drivers,
one leg of a dataset app's demo call (`run_demo_leg`) and the figures of a
leg (`leg_figures`).

A driver is restart-safe: the database is keyed on a completion marker
written after it, the prior generator skips the pairs it has written, the
trainer resumes from Model_Latest.tar and saves at its last iteration, and
the tester skips the frames it has rendered. A run may be cut into legs of
growing `--iters` (say 5000, then 10000): the schedules depend only on the
iteration, so the legs are the first iterations of one run. A leg's test
renders belong to its checkpoint, so those of an earlier, shorter leg are
moved aside (`retire_stale_testing`) before the next leg tests.
"""

import json
import os
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from vipnerf_tpu_torch.data.synthetic import (
    SphereScene,
    make_camera_ring,
    make_dtu_scene,
    write_synthetic_database,
)
from vipnerf_tpu_torch.kernels import fused_mlp as k1
from vipnerf_tpu_torch.utils import tracing
from vipnerf_tpu_torch.utils.io import save_image
from vipnerf_tpu_torch.utils.naming import scene_dirname

DB_MARKER = ".synthetic_db_complete"
DTU_SCENE = "00021"
DTU_FRAMES = 6
DEVICE_HELP = ('"all" (every GPU: training and testing run one rank on each, the rest on the first), a GPU '
               'index or a comma-separated list of them ("0,1"), "cpu", or "cpu,cpu" (two CPU ranks)')


def write_dtu_database(db_root: Path, *, set_num: int, train_frames, val_frames, height: int, width: int,
                       video_frames: int, with_visibility_prior: bool) -> None:
    """The seeded synthetic DTU scan 00021 (`make_dtu_scene`: six views of
    spheres inside a shell, within the loader's fixed [0.1, 5] bounds) with
    its split in set{set_num:02}, sparse depths DE{set_num:02}, the object
    masks the masked QA reads (the pixels whose depth lies inside the bare
    shell's), and a ring of `video_frames` + 1 poses with every second frame
    kept for the video, unless its completion marker is there already."""
    db_dir = Path(db_root) / "DTU/data"

    def write():
        scene, ring_kwargs = make_dtu_scene()
        gt = write_synthetic_database(
            db_root,
            dataset="DTU",
            scene_name=DTU_SCENE,
            num_frames=DTU_FRAMES,
            set_num=set_num,
            train_frames=train_frames,
            val_frames=val_frames,
            height=height,
            width=width,
            scene=scene,
            sparse_depth_dirname=f"DE{set_num:02}",
            with_visibility_prior=with_visibility_prior,
            **ring_kwargs,
        )
        background = SphereScene(seed=0, num_spheres=0, shell_radius=scene.shell_radius)
        masks_dir = db_dir / f"all/database_data/{DTU_SCENE}/ObjectMasks"
        masks_dir.mkdir(exist_ok=True)
        for f in range(DTU_FRAMES):
            _, shell_depth = background.render(gt["extrinsics"][f], gt["intrinsics"][f], height, width)
            mask = gt["depths"][f] < shell_depth - 1e-6
            save_image(masks_dir / f"{f:04}.png", mask.astype(np.uint8) * 255)
        poses_dir = db_dir / f"train_test_sets/set{set_num:02}/video_poses01"
        poses_dir.mkdir(parents=True, exist_ok=True)
        track = make_camera_ring(video_frames + 1, spread_deg=60.0, radius=ring_kwargs["ring_radius"],
                                 height=ring_kwargs["ring_height"])
        np.savetxt(poses_dir / f"{DTU_SCENE}.csv", track.reshape(video_frames + 1, 16), delimiter=",")
        np.savetxt(poses_dir / "VideoFrameNums.csv", np.arange(0, video_frames, 2), delimiter=",")

    write_database_once(db_dir, f"synthetic DTU database (set{set_num:02})", write)


def retire_stale_testing(workdir: Path, test_num: int, num_iterations: int) -> Optional[Path]:
    """Move runs/testing/test{test_num:04} to test{test_num:04}_Model_IterNNNNNN
    when an earlier leg tested another checkpoint there: the tester skips
    the frames it finds, and those would be the other checkpoint's."""
    test_dir = Path(workdir) / f"runs/testing/test{test_num:04}"
    configs_path = test_dir / "Configs.json"
    if not configs_path.exists():
        return None
    model_name = json.loads(configs_path.read_text()).get("model_name", "")
    if model_name == f"Model_Iter{num_iterations:06}.tar":
        return None
    moved = test_dir.with_name(f"{test_dir.name}_{Path(model_name).stem}")
    test_dir.rename(moved)
    print(f"test{test_num:04} held the renders of {model_name}: moved to {moved.name}", flush=True)
    return moved


def print_qa(workdir: Path, test_num: int) -> Optional[dict]:
    qa_path = Path(workdir) / f"runs/testing/test{test_num:04}/QA_Scores.json"
    if not qa_path.exists():
        return None
    text = qa_path.read_text()
    print("QA_Scores.json:", text, flush=True)
    return json.loads(text)


def read_scalars(scalars_path: Path) -> dict:
    """{tag: {step: value}} of a run's logs/scalars.jsonl."""
    series: dict = {}
    if Path(scalars_path).exists():
        for line in Path(scalars_path).read_text().splitlines():
            rec = json.loads(line)
            series.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return series


def leg_figures(spans: List[dict], steps: int, scan_steps: int = 100) -> dict:
    """What a leg's spans (the tracer's records since the leg began) say of
    its speed: the median of the trainer's full chunks' ms per step (a
    `train.chunk` ends when its losses are read, before a checkpoint or
    validation), the steps per second over the whole training stage (set-up,
    validation and checkpoints in it), each stage's seconds (the `app.*`
    spans) and the card's peak memory."""
    chunks = [(r["end_ns"] - r["start_ns"]) * 1e-6 / scan_steps for r in spans
              if r["name"] == "train.chunk" and r["attrs"]["steps"] == scan_steps]
    stage_s: dict = {}
    for r in spans:
        if r["name"].startswith("app."):
            stage = r["name"][len("app."):]
            stage_s[stage] = stage_s.get(stage, 0.0) + (r["end_ns"] - r["start_ns"]) * 1e-9
    training_s = stage_s.get("training", 0.0)
    out = {
        "steps": steps,
        "ms_per_step_median": float(np.median(chunks)) if chunks else None,
        "ms_per_step_range": [min(chunks), max(chunks)] if chunks else None,
        "full_chunks": len(chunks),
        "steps_per_s_over_training": steps / training_s if training_s and steps else None,
        "stage_s": stage_s,
    }
    if torch.cuda.is_initialized():
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["card"] = torch.cuda.get_device_name()
    return out


def write_database_once(db_dir: Path, label: str, write: Callable[[], None]) -> None:
    """`write()` the synthetic database under `db_dir` unless its
    completion marker is there, then mark it complete."""
    t0 = time.perf_counter()
    marker = Path(db_dir) / DB_MARKER
    if not marker.exists():
        print(f"generating {label}...", flush=True)
        write()
        marker.touch()
    print(f"db ready in {time.perf_counter() - t0:.0f}s", flush=True)


def run_demo_leg(workdir: Path, app_module, label: str, *, train_num: int, set_num: int, scene_ids: list,
                 iters: int, device, **run_full_kwargs) -> dict:
    """One leg of a dataset app's demo call (sparse depth, 2048 + 2048 rays,
    the demo's scene list swapped for `scene_ids`) to iteration `iters`,
    run from `workdir`: an earlier leg's test renders moved aside, training,
    testing with QA and both video tracks. Prints the wall clock and the QA
    scores; returns the leg's figures (`leg_figures`, over the steps this
    leg trained and the spans it left) with its wall clock, seconds per
    tested frame, QA and each K1 instance's launches over the leg (training,
    validation, testing)."""
    workdir = Path(workdir)
    app = app_module.app
    os.chdir(workdir)
    retire_stale_testing(workdir, train_num, iters)
    scene_dir = scene_dirname(scene_ids[0], app.scene_key)
    scalars_path = workdir / f"runs/training/train{train_num:04}/{scene_dir}/logs/scalars.jsonl"
    before = set(read_scalars(scalars_path).get("train/TotalLoss", {}))
    launches = k1.launches()
    t0 = time.perf_counter_ns()
    app_module._run_full(train_num, set_num, sparse_depth=True, num_rays=2048, num_iterations=iters,
                         device=device, **{app.scene_key + "s": scene_ids}, **run_full_kwargs)
    wall = (time.perf_counter_ns() - t0) * 1e-9
    print(f"{label} WALL CLOCK: {wall:.0f}s", flush=True)
    steps = len(set(read_scalars(scalars_path).get("train/TotalLoss", {})) - before)
    spans = [r for r in tracing.snapshot()["spans"] if r["start_ns"] >= t0]
    leg = {"iters": iters, "wall_s": round(wall, 1), **leg_figures(spans, steps),
           "k1_launches": {k: n - launches[k] for k, n in k1.launches().items()}}
    tested = len(list((workdir / f"runs/testing/test{train_num:04}/{scene_dir}/predicted_frames").glob("*.png")))
    if tested and "testing" in leg["stage_s"]:
        leg["s_per_tested_frame"] = leg["stage_s"]["testing"] / tested
    leg["qa"] = print_qa(workdir, train_num)
    return leg
