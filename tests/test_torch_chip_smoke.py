"""chip_smoke.py's contract off the card, and the run tree its checks rely on.

- Without CUDA, or without the repository around it, the script exits
  non-zero and prints no result line.
- `write_run_tree(sigma_offset=s, seed=k)` saves the model that
  `ViPNeRF(configs, Generator().manual_seed(k))` draws, with `s` added to
  each level's sigma bias and nothing else changed: chip_smoke's witness
  crop renders that model without the offset.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from vipnerf_tpu_torch.data.synthetic_rig import (
    flagship_train_configs,
    forward_facing_rig,
    write_run_tree,
)
from vipnerf_tpu_torch.models.vip_nerf import ViPNeRF
from vipnerf_tpu_torch.train import checkpoints

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_repo(alone, tmp_path):
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=script.parent, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_run_tree_offsets_only_the_sigma_biases():
    configs = flagship_train_configs(seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        write_run_tree(Path(tmp), configs, forward_facing_rig(3, seed=0), height=8, width=12,
                       sigma_offset=0.5, seed=3)
        saved = ViPNeRF(configs)
        checkpoints.load_checkpoint(
            Path(tmp) / "runs/training/train0001/rig/saved_models/Model_Latest.tar", saved)
    drawn = ViPNeRF(configs, torch.Generator().manual_seed(3)).state_dict()
    for key, value in saved.state_dict().items():
        expect = drawn[key].clone()
        if key.endswith("pts_output_linear.bias"):
            expect[0] += 0.5
        torch.testing.assert_close(value, expect, atol=0, rtol=0, msg=key)
