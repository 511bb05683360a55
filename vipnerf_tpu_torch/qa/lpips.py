"""LPIPS (Learned Perceptual Image Patch Similarity) with an AlexNet
backbone, as an nn.Module (counterpart of vipnerf_tpu/qa/lpips_jax.py).

Inputs in [-1, 1] NCHW are shifted and scaled by the ImageNet statistics,
run through AlexNet's features (5 convolutions, max-pool 3 / stride 2 with
no padding after the first two), tapped after each of the 5 ReLU stages,
unit-normalised over channels (eps 1e-10), squared differences weighted by
the non-negative 1x1 "lin" weights, averaged over space and summed over
stages.

Pretrained weights are an .npz at $VIPNERF_LPIPS_WEIGHTS or
<repo>/data/weights/lpips_alex.npz (keys conv{i}_w, conv{i}_b, lin{i}_w, as
tools/convert_lpips_weights.py writes them). Without the file,
`load_default_lpips` returns None and QA records LPIPS as null.
"""

import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet features: (kernel, stride, padding) of each convolution; a max-pool
# follows the first two
_CONVS = [(11, 4, 2), (5, 1, 2), (3, 1, 1), (3, 1, 1), (3, 1, 1)]
_POOL_AFTER = (0, 1)
_NUM_STAGES = 5

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LpipsAlex(torch.nn.Module):
    def __init__(self, params: Dict[str, np.ndarray]):
        super().__init__()
        for name, value in params.items():
            self.register_buffer(name, torch.as_tensor(np.asarray(value, np.float32)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def _features(self, x: torch.Tensor):
        feats = []
        for i, (_, stride, pad) in enumerate(_CONVS):
            x = torch.relu(F.conv2d(x, getattr(self, f"conv{i}_w"), getattr(self, f"conv{i}_b"),
                                    stride=stride, padding=pad))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        return feats

    @staticmethod
    def _normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
        return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        """img0, img1: (n, 3, h, w) in [-1, 1] -> (n,) distances."""
        f0 = self._features((img0 - self.shift) / self.scale)
        f1 = self._features((img1 - self.shift) / self.scale)
        total = 0.0
        for i in range(_NUM_STAGES):
            d = (self._normalize(f0[i]) - self._normalize(f1[i])) ** 2
            lin_w = getattr(self, f"lin{i}_w")[0, :, 0, 0]  # (C,)
            total = total + torch.mean(torch.sum(d * lin_w[None, :, None, None], dim=1), dim=(1, 2))
        return total

    def distance(self, gt_uint8: np.ndarray, pred_uint8: np.ndarray) -> float:
        """uint8 (h, w, 3) images -> the LPIPS score, on the module's device."""
        dev = self.shift.device

        def to_tensor(im):
            x = im.astype(np.float32) * 2 / 255 - 1
            return torch.as_tensor(np.moveaxis(x, -1, 0)[None], device=dev)

        with torch.no_grad():
            return float(self(to_tensor(gt_uint8), to_tensor(pred_uint8))[0])


def default_weights_path() -> Path:
    env = os.environ.get("VIPNERF_LPIPS_WEIGHTS")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "data/weights/lpips_alex.npz"


def load_default_lpips(device: torch.device) -> Optional[LpipsAlex]:
    path = default_weights_path()
    if not path.exists():
        return None
    with np.load(path.as_posix()) as data:
        return LpipsAlex({k: data[k] for k in data.files}).to(device).eval()
