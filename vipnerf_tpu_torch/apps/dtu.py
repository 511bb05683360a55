"""DTU app (counterpart of vipnerf_tpu/apps/dtu.py): demo1a/1b/1c train the
full ViP-NeRF on 2/3/4 views (train 41/42/43, 50k iterations, 15 scans),
demo1d/1e/1f the ablation without sparse depth (train 44/45/46); demo2-4 as
in the LLFF app. No NDC, no recentring, no bd_factor; the loader fixes the
bounds to [0.1, 5], and QA adds the masked metrics over ObjectMasks.

    python -m vipnerf_tpu_torch.apps.dtu demo1a
"""

import sys
from pathlib import Path

from vipnerf_tpu_torch.apps.common import DatasetApp, run_main
from vipnerf_tpu_torch.apps.configs import build_test_configs, build_train_configs

ENTRY_NAME = "DtuTrainerTester01"
SCENES = [8, 21, 30, 31, 34, 38, 40, 41, 45, 55, 63, 82, 103, 110, 114]

app = DatasetApp("DTU", "scene_num", "all")

_COMMON = dict(
    entry_name=ENTRY_NAME,
    database="DTU",
    database_dirpath="databases/DTU/data",
    data_loader_name="DtuDataLoader01",
    scene_key="scene_nums",
    ndc=False,
    recenter_camera_poses=False,
    bd_factor=None,
)


def _run_full(train_num: int, set_num: int, *, sparse_depth: bool,
              num_rays: int, scene_nums=None):
    num_iterations = 50000
    for scene_num in scene_nums or SCENES:
        train_configs = build_train_configs(
            train_num=train_num,
            scene_ids=[scene_num],
            set_num=set_num,
            num_iterations=num_iterations,
            num_rays=num_rays,
            sparse_depth=sparse_depth,
            **_COMMON,
        )
        test_configs = build_test_configs(
            entry_name=ENTRY_NAME,
            test_num=train_num,
            train_num=train_num,
            set_num=set_num,
            database="DTU",
            database_dirpath="DTU/data",
            num_iterations=num_iterations,
            scene_key="scene_nums",
            scene_ids=[scene_num],
        )
        app.start_training(train_configs)
        app.start_testing(test_configs)
        app.start_testing_videos(test_configs)
        app.start_testing_static_videos(test_configs)


def demo1a():
    _run_full(41, 2, sparse_depth=True, num_rays=2048)


def demo1b():
    _run_full(42, 3, sparse_depth=True, num_rays=2048)


def demo1c():
    _run_full(43, 4, sparse_depth=True, num_rays=2048)


def demo1d():
    _run_full(44, 2, sparse_depth=False, num_rays=1024)


def demo1e():
    _run_full(45, 3, sparse_depth=False, num_rays=1024)


def demo1f():
    _run_full(46, 4, sparse_depth=False, num_rays=1024)


def demo2():
    app.start_training({
        "trainer": f"{ENTRY_NAME}/VipNerfTpuTrainer",
        "train_num": 42,
        "resume_training": True,
    })


def demo3():
    from vipnerf_tpu_torch.train.logging import export_plots

    export_plots(Path("runs/training/train0042/00021/logs"))
    sys.exit(0)


def demo4():
    for train_num in (41, 42, 43):
        test_configs = build_test_configs(
            entry_name=ENTRY_NAME,
            test_num=train_num,
            train_num=train_num,
            set_num=2,
            database="DTU",
            database_dirpath="DTU/data",
            num_iterations=50000,
            scene_key="scene_nums",
            scene_ids=SCENES,
        )
        app.start_testing(test_configs)
        app.start_testing_videos(test_configs)
        app.start_testing_static_videos(test_configs)


DEMOS = {
    "demo1a": demo1a, "demo1b": demo1b, "demo1c": demo1c,
    "demo1d": demo1d, "demo1e": demo1e, "demo1f": demo1f,
    "demo2": demo2, "demo3": demo3, "demo4": demo4,
}


def main():
    # with no demo named, the six training demos run
    sys.exit(run_main(DEMOS, default=["demo1a", "demo1b", "demo1c", "demo1d", "demo1e", "demo1f"]))


if __name__ == "__main__":
    main()
