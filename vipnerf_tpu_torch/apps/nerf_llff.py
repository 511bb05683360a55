"""NeRF-LLFF app (counterpart of vipnerf_tpu/apps/nerf_llff.py): demo1a/1b/1c
train the full ViP-NeRF on 2/3/4 input views (train 11/12/13, 200k
iterations), demo1d/1e/1f the ablation without sparse depth at 1024 rays
(train 14/15/16, 50k iterations), each scene then tested, scored and
rendered along its video track; demo2 resumes train 12, demo3 plots its
logged scalars, demo4 tests trains 11-13.

    python -m vipnerf_tpu_torch.apps.nerf_llff demo1a
"""

import sys
from pathlib import Path

from vipnerf_tpu_torch.apps.common import DatasetApp, run_main
from vipnerf_tpu_torch.apps.configs import build_test_configs, build_train_configs

ENTRY_NAME = "NerfLlffTrainerTester01"
SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids", "room", "trex"]

app = DatasetApp("NeRF_LLFF", "scene_name", "all")

_COMMON = dict(
    entry_name=ENTRY_NAME,
    database="NeRF_LLFF",
    database_dirpath="databases/NeRF_LLFF/data",
    data_loader_name="NerfLlffDataLoader01",
    scene_key="scene_names",
    ndc=True,
    recenter_camera_poses=True,
    bd_factor=0.75,
    resolution_suffix="_down4",
)


def demo_configs(train_num: int, set_num: int, scene_name: str, *, sparse_depth: bool,
                 num_rays: int, num_iterations: int, device=None):
    """The train and test configs of one scene of demo1a-1f."""
    train_configs = build_train_configs(
        train_num=train_num,
        scene_ids=[scene_name],
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
        database="NeRF_LLFF",
        database_dirpath="NeRF_LLFF/data",
        num_iterations=num_iterations,
        scene_key="scene_names",
        scene_ids=[scene_name],
        resolution_suffix="_down4",
        device=device,
    )
    return train_configs, test_configs


def _run_full(train_num: int, set_num: int, *, sparse_depth: bool,
              num_rays: int, num_iterations: int, scene_names=None, device=None):
    for scene_name in scene_names or SCENES:
        train_configs, test_configs = demo_configs(train_num, set_num, scene_name, sparse_depth=sparse_depth,
                                                   num_rays=num_rays, num_iterations=num_iterations,
                                                   device=device)
        app.start_training(train_configs)
        app.start_testing(test_configs)
        app.start_testing_videos(test_configs)
        app.start_testing_static_videos(test_configs)


def demo1a():
    _run_full(11, 2, sparse_depth=True, num_rays=2048, num_iterations=200000)


def demo1b():
    _run_full(12, 3, sparse_depth=True, num_rays=2048, num_iterations=200000)


def demo1c():
    _run_full(13, 4, sparse_depth=True, num_rays=2048, num_iterations=200000)


def demo1d():
    _run_full(14, 2, sparse_depth=False, num_rays=1024, num_iterations=50000)


def demo1e():
    _run_full(15, 3, sparse_depth=False, num_rays=1024, num_iterations=50000)


def demo1f():
    _run_full(16, 4, sparse_depth=False, num_rays=1024, num_iterations=50000)


def demo2():
    """Resume train 12 from its saved configs."""
    app.start_training({
        "trainer": f"{ENTRY_NAME}/VipNerfTpuTrainer",
        "train_num": 12,
        "resume_training": True,
    })


def demo3():
    """Plot the logged scalars of train 12 / horns."""
    from vipnerf_tpu_torch.train.logging import export_plots

    export_plots(Path("runs/training/train0012/horns/logs"))
    sys.exit(0)


def demo4():
    """Test the checkpoints of trains 11-13."""
    for train_num in (11, 12, 13):
        test_configs = build_test_configs(
            entry_name=ENTRY_NAME,
            test_num=train_num,
            train_num=train_num,
            set_num=2,
            database="NeRF_LLFF",
            database_dirpath="NeRF_LLFF/data",
            num_iterations=50000,
            scene_key="scene_names",
            scene_ids=SCENES,
            resolution_suffix="_down4",
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
