"""The plain reference against the program's plain path on the CPU at a
tiny size (K1's plain version stands in for the kernel there): the same
rays from the same pixels, and the same render and losses from the same
weights and random draws. The test imports the program; the reference
does not."""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_support import SEED, tiny_config, tiny_mix
from harness import common, train
from reference import driver, nerf


@pytest.mark.parametrize("name", ["llff_2view", "dtu_3view"])
def test_reference_matches_the_program_on_a_training_batch(name):
    from vipnerf_tpu_torch.data.loaders import get_data_loader
    from vipnerf_tpu_torch.data.preprocessor import get_data_preprocessor
    from vipnerf_tpu_torch.losses import LossComputer
    from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF, render_rays

    cfg, mix = tiny_config(name), tiny_mix("train")
    dev = torch.device("cpu")
    root = Path(tempfile.mkdtemp())
    gt = train.scene_inputs(cfg, root, SEED, 0)
    configs = train.program_configs(cfg, mix, root, SEED, dev, [gt["scene_name"]])
    configs["data_loader"]["scene_id"] = gt["scene_name"]
    db = root / "data" / configs["database_dirpath"]
    prep = get_data_preprocessor(configs, "train", device=dev,
                                 raw_data_dict=get_data_loader(configs, db, "train").load_data())
    nerf_idx, sd_idx = prep.get_index_chunk(mix["start_iter"], 1)
    batch = prep.gather_batch(torch.from_numpy(nerf_idx[0]), torch.from_numpy(sd_idx[0]), mix["start_iter"])
    model = ViPNeRF(configs, torch.Generator().manual_seed(0))
    weights = common.seeded_weights(cfg["train_configs"]["model"], SEED, dev)
    common.load_weights(model, weights)
    g = torch.Generator().manual_seed((SEED << 32) + mix["start_iter"])  # the trainer's step seed
    out = render_rays(model, configs, batch, train=True, generator=g)
    program_loss = float(LossComputer(configs).compute_losses(batch, out)["TotalLoss"].detach())

    ref = driver.train_steps(cfg, mix, gt, weights[0], [{"indices": batch["indices"], "iter": mix["start_iter"]}],
                             SEED, dev)
    assert ref["losses"][0]["TotalLoss"] == pytest.approx(program_loss, rel=1e-4)
    # the level outputs, through the reference's own renderer on the same draws
    h, w = cfg["scene"]["height"], cfg["scene"]["width"]
    idx = batch["indices"].numpy()
    frame = driver.scene_frame(cfg, gt)
    rays = driver._rays(cfg, frame, frame["poses"][idx // (h * w)], gt["intrinsic"], idx % (h * w) % w,
                        idx % (h * w) // w, frame["near"], frame["far"])
    assert np.abs(rays["d"] - batch["rays_d"].numpy()).max() < 1e-6
    assert np.abs(rays["view_dirs"] - batch["view_dirs"].numpy()).max() < 1e-6
    if "rays_o_ndc" in batch:
        assert np.abs(rays["o_ndc"] - batch["rays_o_ndc"].numpy()).max() < 1e-5
        assert np.abs(rays["d_ndc"] - batch["rays_d_ndc"].numpy()).max() < 1e-5


def test_leaf_norm_gaps_leave_out_leaves_that_do_not_move():
    want = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.full((4,), 1e-9)}
    got = {"a": torch.ones(4) * 1.01, "b": torch.full((4,), 2.0), "c": torch.zeros(4)}
    worst, leaf, skipped = nerf.leaf_norm_gaps(got, want)
    assert skipped == ["c"] and leaf == "a"
    # a: |2.02 - 2| over the larger of its norm and the median leaf's (both 2)
    assert worst == pytest.approx(0.01, rel=1e-5)
