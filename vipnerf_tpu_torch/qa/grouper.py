"""Scene-wise grouping of frame-wise QA scores (counterpart of
vipnerf_tpu/qa/grouper.py, without pandas): each *_FrameWise.csv is grouped
by every column but its last two (the frame number and the metric), groups
in sorted key order; the metric's mean over a group's frames (NaN skipped,
as pandas' groupby mean does), rounded to 4 decimals, goes to the
*_SceneWise.csv beside it, with every column but the frame number.
"""

import math
from pathlib import Path
from typing import Dict

import numpy as np

from vipnerf_tpu_torch.utils.io import read_csv_columns, write_csv_columns


def _group_mean(values: np.ndarray) -> float:
    kept = [float(v) for v in values if not math.isnan(v)]
    return math.fsum(kept) / len(kept) if kept else math.nan


def get_grouped_qa_scores(qa_data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """{column: values} of one frame-wise table -> its scene-wise table."""
    columns = list(qa_data)
    group_columns = columns[:-2]
    final_columns = [c for c in columns if c != "pred_frame_num"]
    value_columns = [c for c in final_columns if c not in group_columns]
    keys = list(zip(*(qa_data[c].tolist() for c in group_columns)))
    groups: Dict[tuple, list] = {}
    for row, key in enumerate(keys):
        groups.setdefault(key, []).append(row)
    out = {c: [] for c in final_columns}
    for key in sorted(groups):
        rows = groups[key]
        for c, k in zip(group_columns, key):
            out[c].append(k)
        for c in value_columns:
            out[c].append(_group_mean(qa_data[c][rows]))
    result = {c: np.array(v) for c, v in out.items()}
    last = final_columns[-1]
    result[last] = np.round(result[last].astype(np.float64), 4)
    return result


def group_qa_dir(qa_dirpath: Path) -> None:
    """Group every *_FrameWise.csv under one QA_Scores dir into its
    *_SceneWise.csv sibling."""
    for pred_dirpath in sorted(Path(qa_dirpath).iterdir()):
        for qa_filepath in sorted(pred_dirpath.glob("*_FrameWise.csv")):
            grouped = get_grouped_qa_scores(read_csv_columns(qa_filepath))
            write_csv_columns(qa_filepath.parent / f"{qa_filepath.stem[:-9]}SceneWise.csv", grouped)


def group_qa_scores(testing_dirpath: Path, test_nums: list):
    for test_num in test_nums:
        qa_dirpath = Path(testing_dirpath) / f"test{test_num:04}/QA_Scores"
        if not qa_dirpath.exists():
            continue
        group_qa_dir(qa_dirpath)
