"""What decides `correct`: the program's outputs from the timed path
against the plain reference, each number beside its limit.

Training (the first `check_steps` steps, run through the window's own call
and feed): `loss_gap_first`, the relative gap of the first step's total
loss; `loss_gap`, the largest relative gap of a step's total loss;
`grad_gap`, the first gradient (as the optimizer holds it after one step:
its first moment over 1 - beta1) by its worst leaf; `update_gap`, each
parameter's change over those steps by its worst leaf. A leaf's gap is
|‖program‖ - ‖reference‖| over the larger of the reference's norm of that
leaf and of the median leaf (`grad_gap_median`, `update_gap_median`: the
median leaf's gap instead of the worst); leaves whose reference gradient is under a
thousandth of the median leaf's are left out (they move by round-off
alone). `rgb_gap_first` and `depth_gap_first`: what the first step
rendered, per ray, as it reached the losses: the largest colour gap and
the largest relative depth gap over both levels; `*_mean_first` and
`*_median_first`: the same gaps' mean and median over the rays, channels
and levels.

Rendering (a sample of the frames finished in the window, a sample of
pixels of each, both drawn from the seed): `rgb_off_share`, the share of
the frame's 8-bit colour values that differ from the reference's rounding
of its colour; `depth_gap`, the largest relative gap of the fine level's
metric depth.
"""

import json
from typing import Any, Dict, List

import numpy as np
import torch

from harness import common
from reference import driver, nerf


def train_readings(cfg, mix, seed: int, device, gts, program, weights) -> Dict[str, Any]:
    """Each scene's readings against the reference; the worst over the scenes."""
    scenes = len(gts)
    numbers: Dict[str, float] = {}
    details = []
    for s in range(scenes):
        got = _scene_view(program, s, scenes)
        nums, detail = _scene_readings(cfg, mix, seed, device, gts[s], got, weights[s], scenes, s)
        for k, v in nums.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        details.append(detail)
    return {"numbers": numbers, "detail": details[0] if scenes == 1 else details}


def _gaps(got, want, relative: bool):
    """Each ray's gaps, absolute or relative to the reference; infinite
    where the program rendered another number of rays."""
    if got.numel() != want.numel():
        return torch.full((1,), float("inf"))
    gap = (got.reshape(want.shape) - want).abs()
    return gap / want.abs().clamp(min=1e-6) if relative else gap


def _scene_view(program, s: int, scenes: int) -> Dict[str, Any]:
    """Scene s's share of what the program's first steps recorded."""
    if scenes == 1:
        return program
    per = program["steps"][0]["indices"].numel() // scenes
    steps = [{"indices": st["indices"].reshape(scenes, per)[s] - s * program["rays_per_scene"], "iter": st["iter"],
              "losses": {k: v[s] for k, v in st["losses"].items()}} for st in program["steps"]]
    outputs = [{k: v[s] for k, v in o.items()} for o in program["outputs"]]
    return dict(program, steps=steps, outputs=outputs, m1=program["m1"][s:s + 1],
                params_after={k: v[s] for k, v in program["params_after"].items()})


def _scene_readings(cfg, mix, seed, device, gt, program, weights, scenes: int, scene: int):
    ref = driver.train_steps(cfg, mix, gt, weights, program["steps"], seed, device, scenes, scene)
    gaps = [abs(float(s["losses"]["TotalLoss"]) - r["TotalLoss"]) / abs(r["TotalLoss"])
            for s, r in zip(program["steps"], ref["losses"])]
    leaves = program["leaf_names"]
    pieces = program["m1"][0].split(program["sizes"])
    g1 = {k: (p / (1.0 - program["b1"])).reshape(ref["grad1"][k].shape) for k, p in zip(leaves, pieces)}
    grad_gap, grad_leaf, skipped = nerf.leaf_norm_gaps(g1, ref["grad1"])
    grad_median = nerf.leaf_norm_gaps(g1, ref["grad1"], median=True)[0]
    init = {f"{level}_model.{k}": v for level, leaf in weights.items() for k, v in leaf.items()}
    moved = {k: program["params_after"][k] - init[k] for k in leaves}
    ref_moved = {k: ref["params_after"][k] - init[k].to(ref["params_after"][k].device) for k in leaves}
    for k in skipped:  # leaves the gradient rule leaves out
        moved.pop(k), ref_moved.pop(k)
    update_gap, update_leaf, _ = nerf.leaf_norm_gaps(moved, ref_moved, floor_share=0.0)
    update_median = nerf.leaf_norm_gaps(moved, ref_moved, floor_share=0.0, median=True)[0]
    got, want = program["outputs"][0], ref["outputs"][0]
    levels = ("coarse", "fine")
    rgb = [_gaps(got[f"rgb_{lv}"], want[f"rgb_{lv}"], relative=False) for lv in levels]
    depth = [_gaps(got[f"depth_{lv}"], want[f"depth_{lv}"], relative=True) for lv in levels]
    rgb_all = torch.cat([g.reshape(-1) for g in rgb]).double()
    depth_all = torch.cat([g.reshape(-1) for g in depth]).double()
    numbers = {"loss_gap_first": gaps[0], "loss_gap": max(gaps), "grad_gap": grad_gap,
               "grad_gap_median": grad_median, "update_gap": update_gap, "update_gap_median": update_median,
               "rgb_gap_first": float(rgb_all.max()), "rgb_gap_mean_first": float(rgb_all.mean()),
               "rgb_gap_median_first": float(rgb_all.median()), "depth_gap_first": float(depth_all.max()),
               "depth_gap_mean_first": float(depth_all.mean()), "depth_gap_median_first": float(depth_all.median())}
    detail = {"grad_leaf": grad_leaf, "update_leaf": update_leaf, "left_out": skipped,
              "program_losses": [float(s["losses"]["TotalLoss"]) for s in program["steps"]],
              "reference_losses": [r["TotalLoss"] for r in ref["losses"]]}
    return numbers, detail


def render_readings(cfg, device, gt, weights, frames: List[Dict[str, Any]], poses) -> Dict[str, Any]:
    off = total = 0
    depth_gap = 0.0
    for f in frames:
        ref = driver.render_pixels(cfg, gt, weights, poses[f["pose"]], f["xs"], f["ys"], device)
        ref_rgb = np.round(np.clip(ref["rgb"], 0.0, 1.0) * 255).astype(np.int64)
        off += int((ref_rgb != f["rgb"].astype(np.int64)).sum())
        total += ref_rgb.size
        ref_depth = np.clip(ref["depth"], 0.0, np.inf)
        gap = np.abs(f["depth"].astype(np.float64) - ref_depth) / np.maximum(ref_depth, 1e-6)
        depth_gap = max(depth_gap, float(np.nanmax(np.where(np.isfinite(gap), gap, np.inf))))
    return {"numbers": {"rgb_off_share": off / total, "depth_gap": depth_gap},
            "detail": {"frames": len(frames), "pixels": total // 3}}


def load_limits(cell: str) -> Dict[str, float]:
    return json.loads((common.BENCH_DIR / "limits" / f"{cell}.json").read_text())["limits"]


def judge(readings: Dict[str, Any], limits: Dict[str, float]) -> bool:
    """Every number that has a limit finite and at or under it; a limit
    whose number is missing fails. Numbers without a limit are readings
    only (PERF.md says why each is not compared)."""
    numbers = readings["numbers"]
    return all(name in numbers and np.isfinite(numbers[name]) and numbers[name] <= limit
               for name, limit in limits.items())

