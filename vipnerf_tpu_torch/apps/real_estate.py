"""RealEstate-10K app (counterpart of vipnerf_tpu/apps/real_estate.py):
demo1a/1b/1c train the full ViP-NeRF on 2/3/4 views (train 1/2/3, 50k
iterations, scenes 0, 1, 3, 4, 6), demo1d/1e/1f the ablation without sparse
depth (train 4/5/6); demo2-4 as in the LLFF app. NDC on; the loader fixes
the bounds to [1, 100].

    python -m vipnerf_tpu_torch.apps.real_estate demo1a
"""

import sys
from pathlib import Path

from vipnerf_tpu_torch.apps.common import DatasetApp, run_main
from vipnerf_tpu_torch.apps.configs import build_test_configs, build_train_configs

ENTRY_NAME = "RealEstateTrainerTester01"
SCENES = [0, 1, 3, 4, 6]

app = DatasetApp("RealEstate10K", "scene_num", "test")

_COMMON = dict(
    entry_name=ENTRY_NAME,
    database="RealEstate10K",
    database_dirpath="databases/RealEstate10K/data",
    data_loader_name="RealEstateDataLoader01",
    scene_key="scene_nums",
    ndc=True,
    recenter_camera_poses=True,
    bd_factor=0.75,
)


def demo_configs(train_num: int, set_num: int, scene_num: int, *, sparse_depth: bool,
                 num_rays: int, num_iterations: int = 50000, device=None):
    """The train and test configs of one scene of demo1a-1f."""
    train_configs = build_train_configs(
        train_num=train_num,
        scene_ids=[scene_num],
        set_num=set_num,
        num_iterations=num_iterations,
        num_rays=num_rays,
        sparse_depth=sparse_depth,
        device=device,
        **_COMMON,
    )
    test_configs = build_test_configs(
        entry_name=ENTRY_NAME,
        test_num=train_num,
        train_num=train_num,
        set_num=set_num,
        database="RealEstate10K",
        database_dirpath="RealEstate10K/data",
        num_iterations=num_iterations,
        scene_key="scene_nums",
        scene_ids=[scene_num],
        device=device,
    )
    return train_configs, test_configs


def _run_full(train_num: int, set_num: int, *, sparse_depth: bool,
              num_rays: int, scene_nums=None, num_iterations: int = 50000, device=None):
    for scene_num in scene_nums or SCENES:
        train_configs, test_configs = demo_configs(train_num, set_num, scene_num, sparse_depth=sparse_depth,
                                                   num_rays=num_rays, num_iterations=num_iterations,
                                                   device=device)
        app.start_training(train_configs)
        app.start_testing(test_configs)
        app.start_testing_videos(test_configs)
        app.start_testing_static_videos(test_configs)


def demo1a():
    _run_full(1, 2, sparse_depth=True, num_rays=2048)


def demo1b():
    _run_full(2, 3, sparse_depth=True, num_rays=2048)


def demo1c():
    _run_full(3, 4, sparse_depth=True, num_rays=2048)


def demo1d():
    _run_full(4, 2, sparse_depth=False, num_rays=1024)


def demo1e():
    _run_full(5, 3, sparse_depth=False, num_rays=1024)


def demo1f():
    _run_full(6, 4, sparse_depth=False, num_rays=1024)


def demo2():
    app.start_training({
        "trainer": f"{ENTRY_NAME}/VipNerfTpuTrainer",
        "train_num": 2,
        "resume_training": True,
    })


def demo3():
    from vipnerf_tpu_torch.train.logging import export_plots

    export_plots(Path("runs/training/train0002/00001/logs"))
    sys.exit(0)


def demo4():
    for train_num in (1, 2, 3):
        test_configs = build_test_configs(
            entry_name=ENTRY_NAME,
            test_num=train_num,
            train_num=train_num,
            set_num=2,
            database="RealEstate10K",
            database_dirpath="RealEstate10K/data",
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
