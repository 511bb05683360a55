"""Training cells of a configuration that lists fewer than ViP-NeRF's four
losses (the ablation without the sparse-depth prior): `harness.train`'s
run, its set-up, window, trace, faults and control override alike, with
the check against `reference.listed_losses`, which sums the listed losses
alone, in place of `reference.driver`'s four-loss steps.
"""

from typing import Any, Dict, Optional
from unittest import mock

import torch

from harness import checks, train
from reference import listed_losses


def run(cell, cfg, mix, seed: int, seconds: float, traced: bool, device: torch.device, t0: float,
        fault: Optional[str] = None) -> Dict[str, Any]:
    # `checks.train_readings` takes its reference steps from `checks.driver.train_steps`
    with mock.patch.object(checks, "driver", listed_losses):
        return train.run(cell, cfg, mix, seed, seconds, traced, device, t0, fault)
