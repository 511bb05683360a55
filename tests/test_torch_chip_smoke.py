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
from vipnerf_tpu_torch.utils import tracing

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


def test_phase_protocol_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's phase 8 on the CPU: the DTU control's driver at 24x32
    with 128 + 128 rays and 8 + 8 samples at the flagship width, a leg of
    30 steps, the seam from 29,998 to 30,002 (the validation at 30,000 in
    it), K1's plain version and the encode's standing in for the kernels
    and counted where the wrappers would count the kernels' launches."""
    from vipnerf_tpu_torch.apps import dtu
    from vipnerf_tpu_torch.kernels import fused_mlp as k1

    ns = {"__name__": "chip_smoke_rehearsal", "__file__": str(ROOT / "chip_smoke.py")}
    exec(compile((ROOT / "chip_smoke.py").read_text(), str(ROOT / "chip_smoke.py"), "exec"), ns)
    ns.update(PROTO_H=24, PROTO_W=32, PROTO_STEPS=30, PROTO_VIDEO_FRAMES=2, SEAM_START=29998, SEAM_END=30002)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("VIPNERF_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.chdir(tmp_path)
    demo_configs = dtu.demo_configs

    def narrow(*args, **kwargs):
        train_configs, test_configs = demo_configs(*args, **kwargs)
        train_configs["data_loader"]["num_rays"] = 128
        train_configs["data_loader"]["sparse_depth"]["num_rays"] = 128
        for level in ("coarse_mlp", "fine_mlp"):
            train_configs["model"][level]["num_samples"] = 8
        return train_configs, test_configs

    monkeypatch.setattr(dtu, "demo_configs", narrow)
    reference = k1.fused_mlp_reference

    def counted(layers, xe, ve, *args):
        tracing.count(f"k1.launches.{k1.INSTANCE[xe.dtype, ve.dtype]}")
        return reference(layers, xe, ve, *args)

    monkeypatch.setattr(k1, "fused_mlp_reference", counted)
    encode = k1.encode_reference

    def counted_encode(pts, *args):
        if len(pts):
            tracing.count(f"k1.launches.{k1.ENCODE}")
        return encode(pts, *args)

    monkeypatch.setattr(k1, "encode_reference", counted_encode)
    torch.set_num_threads(2)
    out = ns["phase_protocol"](k1, torch.device("cpu"))
    seam = out["seam"]
    assert seam["adam_count"] == 30002 and seam["k1_launches_per_step"] == 2
    assert seam["lr_rel_to_jax"] <= 1e-6 and out["qa"]["MaskedPSNR05"] is not None
    assert set(out["k1_dtu"]) == {f"{level}_fused_mlp_{d}" for level in ("coarse", "fine")
                                  for d in ("bf16", "f32", "bf16_f32h")}
    assert out["k1_launches"] >= 2 * 4
    assert out["k1_launches_shipped"] >= 2 * 30  # the shipped leg's 30 steps, then its test and videos
    leg = out["shipped_leg"]
    assert leg["steps"] == 30 and leg["prior_devices"] == ["cpu"] and len(out["prior_s_per_direction"]) == 6
    assert leg["steps_per_s_over_training"] == pytest.approx(30 / leg["stage_s"]["training"])
