"""QA runner: per-metric frame-wise evaluation with incremental CSVs,
QA_Scores.json and scene-wise grouping (counterpart of
vipnerf_tpu/qa/runner.py, without pandas).

- QA_Scores.json at the test dir's root holds {pred_folder: {metric: average}};
  QA_Scores/{pred_folder}/{Metric}_FrameWise.csv the per-frame scores.
- A frame the CSV already scores is skipped; a missing prediction is
  skipped; in masked mode a frame without its mask is skipped.
- New rows merge into an existing CSV as pandas' `combine_first` merges them:
  the union sorted by (scene, frame); without an old CSV the rows keep the
  order of the frames CSV. Scores are rounded to 4 decimals before the mean.
- A metric that cannot score (LPIPS without weights) leaves an explicit null
  in QA_Scores.json, never over an earlier average.
- Metric names carry the dataset's suffix (RMSE01 RealEstate10K, RMSE02
  NeRF_LLFF, RMSE05 DTU; Masked*05 for DTU's object masks).

    python -m vipnerf_tpu_torch.qa.runner --database NeRF_LLFF \\
        --pred_videos_dirpath runs/testing/test0011 \\
        --database_dirpath data/databases/NeRF_LLFF/data \\
        --frames_datapath data/databases/NeRF_LLFF/data/train_test_sets/set02/TestVideosData.csv

RMSE, PSNR and SSIM run on the host; LPIPS on the GPU unless `--device cpu`.
"""

import argparse
import json
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from vipnerf_tpu_torch.qa import metrics
from vipnerf_tpu_torch.qa.grouper import group_qa_dir
from vipnerf_tpu_torch.utils.device import device_from_arg, resolve_device
from vipnerf_tpu_torch.utils.io import read_csv_columns, read_image, read_mask, rescale_image, write_csv_columns
from vipnerf_tpu_torch.utils.naming import scene_dirname

_DATASET_SUFFIX = {"RealEstate10K": "01", "NeRF_LLFF": "02", "DTU": "05"}
_SCENE_KEY = {"RealEstate10K": "scene_num", "NeRF_LLFF": "scene_name", "DTU": "scene_num"}
_SPLIT_DIR = {"RealEstate10K": "test", "NeRF_LLFF": "all", "DTU": "all"}


def _downsample_uint8(image: np.ndarray, factor: int) -> np.ndarray:
    out = rescale_image(image.astype(np.float32), factor, anti_aliasing=True)
    return np.round(out).astype(np.uint8)


def _write_scores(path: Path, qa_scores: Dict):
    with open(path, "w") as f:
        json.dump(qa_scores, f, indent=4)


def start_qa(
    metric_base: str,
    metric_fn: Callable,
    dataset: str,
    pred_videos_dirpath: Path,
    database_dirpath: Path,
    frames_datapath: Path,
    pred_folder_name: str = "predicted_frames",
    resolution_suffix: str = "",
    downsampling_factor: int = 1,
    mask_folder_name: Optional[str] = None,
) -> Optional[float]:
    """Run one metric over all (scene, frame) rows; returns the average.

    metric_fn(gt_uint8, pred_uint8[, mask]) -> float, or None where the
    metric is unavailable (recorded as an explicit null).
    """
    pred_videos_dirpath = Path(pred_videos_dirpath)
    database_dirpath = Path(database_dirpath)
    for path, name in ((pred_videos_dirpath, "pred_videos_dirpath"), (database_dirpath, "database_dirpath")):
        if not path.exists():
            print(f"Skipping QA of folder: {pred_videos_dirpath.stem}. Reason: {name} does not exist")
            return None

    masked = mask_folder_name is not None
    metric_name = ("Masked" if masked else "") + metric_base + _DATASET_SUFFIX[dataset]
    scene_key = _SCENE_KEY[dataset]
    split_dir = _SPLIT_DIR[dataset]

    qa_scores_filepath = pred_videos_dirpath / "QA_Scores.json"
    csv_path = pred_videos_dirpath / f"QA_Scores/{pred_folder_name}/{metric_name}_FrameWise.csv"
    qa_scores = json.loads(qa_scores_filepath.read_text()) if qa_scores_filepath.exists() else {}
    qa_scores.setdefault(pred_folder_name, {})
    old = read_csv_columns(csv_path) if csv_path.exists() else None
    old_rows = (list(zip(old[scene_key].tolist(), old["pred_frame_num"].tolist(), old[metric_name].tolist()))
                if old is not None else [])
    scored = {(s, f) for s, f, _ in old_rows}

    frames_data = read_csv_columns(frames_datapath)
    new_rows = []
    for scene_id, frame_num in zip(frames_data[scene_key].tolist(), frames_data["pred_frame_num"].tolist()):
        frame_num = int(frame_num)
        if (scene_id, frame_num) in scored:
            continue
        scene_dir = scene_dirname(scene_id, scene_key)
        scene_base = database_dirpath / f"{split_dir}/database_data/{scene_dir}"
        gt_path = scene_base / f"rgb{resolution_suffix}/{frame_num:04}.png"
        pred_path = pred_videos_dirpath / f"{scene_dir}/{pred_folder_name}/{frame_num:04}.png"
        if not pred_path.exists():
            continue
        mask = None
        if masked:
            mask_path = scene_base / f"{mask_folder_name}/{frame_num:04}.png"
            if not mask_path.exists():
                continue
            mask = read_mask(mask_path)
            if mask.ndim == 3:
                mask = mask[..., 0]
        gt = read_image(gt_path)[..., :3]
        if downsampling_factor > 1:
            gt = _downsample_uint8(gt, downsampling_factor)
            if mask is not None:
                mask = _downsample_uint8(mask.astype(np.uint8) * 255, downsampling_factor) > 127
        pred = read_image(pred_path)[..., :3]
        score = metric_fn(gt, pred, mask) if masked else metric_fn(gt, pred)
        if score is None:
            # an unavailable metric (LPIPS without weights) leaves an explicit
            # null, and never replaces an earlier average
            print(f"{metric_name}: unavailable (missing weights?); skipping")
            qa_scores[pred_folder_name].setdefault(metric_name, None)
            _write_scores(qa_scores_filepath, qa_scores)
            return None
        new_rows.append((scene_id, frame_num, score))

    # pandas' combine_first: the union of both tables, sorted by (scene, frame)
    merged = sorted(old_rows + new_rows, key=lambda r: r[:2]) if old is not None and new_rows else old_rows or new_rows
    if not merged:
        print(f"{metric_name}: no frames evaluated")
        return None
    scores = np.round(np.array([r[2] for r in merged], np.float64), 4)
    kept = scores[~np.isnan(scores)]  # pandas' mean skips NaN
    avg = float(np.round(np.sum(kept) / kept.size, 4)) if kept.size else float("nan")
    qa_scores[pred_folder_name][metric_name] = avg
    print(f"Average {metric_name}: {pred_videos_dirpath.as_posix()} - {pred_folder_name}: {avg}")
    _write_scores(qa_scores_filepath, qa_scores)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    write_csv_columns(csv_path, {
        scene_key: [r[0] for r in merged],
        "pred_frame_num": [r[1] for r in merged],
        metric_name: scores,
    })
    return avg


def run_all_qa(
    dataset: str,
    pred_videos_dirpath: Path,
    database_dirpath: Path,
    frames_datapath: Path,
    pred_folder_name: str = "predicted_frames",
    resolution_suffix: str = "",
    downsampling_factor: int = 1,
    mask_folder_name: str = "ObjectMasks",
    device="all",
) -> Dict[str, Optional[float]]:
    """Every metric of a dataset (DTU adds the masked ones over its object
    masks), then the scene-wise grouping. LPIPS runs on `device`."""
    lpips_metric = metrics.LpipsMetric(resolve_device(device))

    def lpips_fn(gt, pred, mask=None):
        return lpips_metric(gt, pred, mask)

    metric_fns = [
        ("RMSE", metrics.compute_rmse),
        ("PSNR", metrics.compute_psnr),
        ("SSIM", metrics.compute_ssim),
        ("LPIPS", lpips_fn),
    ]
    args = (dataset, pred_videos_dirpath, database_dirpath, frames_datapath, pred_folder_name,
            resolution_suffix, downsampling_factor)
    results: Dict[str, Optional[float]] = {}
    for base, fn in metric_fns:
        results[base] = start_qa(base, fn, *args)
    if dataset == "DTU":
        for base, fn in metric_fns:
            results[f"Masked{base}"] = start_qa(base, fn, *args, mask_folder_name=mask_folder_name)

    qa_dirpath = Path(pred_videos_dirpath) / "QA_Scores"
    if qa_dirpath.exists():
        group_qa_dir(qa_dirpath)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="ViP-NeRF QA runner")
    parser.add_argument("--database", required=True, choices=sorted(_DATASET_SUFFIX))
    parser.add_argument("--pred_videos_dirpath", required=True)
    parser.add_argument("--database_dirpath", required=True)
    parser.add_argument("--frames_datapath", required=True)
    parser.add_argument("--pred_folder_name", default="predicted_frames")
    parser.add_argument("--resolution_suffix", default="")
    parser.add_argument("--downsampling_factor", type=int, default=1)
    parser.add_argument("--mask_folder_name", default="ObjectMasks")
    # the reference QA CLIs take --demo_function_name demo2; this runner
    # always scores a prediction dir against the database's frames
    parser.add_argument("--demo_function_name", default="demo2", choices=["demo2"])
    parser.add_argument("--device", default="all", help='LPIPS device: "all" (the first GPU), a GPU index or a '
                        'list of them (the first), or "cpu"')
    args = parser.parse_args(argv)
    run_all_qa(
        args.database,
        Path(args.pred_videos_dirpath),
        Path(args.database_dirpath),
        Path(args.frames_datapath),
        args.pred_folder_name,
        args.resolution_suffix,
        args.downsampling_factor,
        args.mask_folder_name,
        device=device_from_arg(args.device),
    )


if __name__ == "__main__":
    main()
