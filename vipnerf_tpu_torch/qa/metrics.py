"""Image quality metrics (counterpart of vipnerf_tpu/qa/metrics.py).

RMSE and PSNR on uint8 values as float64, SSIM as skimage's
structural_similarity(multichannel, gaussian_weights=True, sigma=1.5,
use_sample_covariance=False) with a border crop of the 11x11 window's
radius; each with an optional object mask (the DTU masked metrics). These
three are a copy of the JAX package's numpy and scipy code. LPIPS(AlexNet)
runs through `qa.lpips.LpipsAlex` on the device, and scores None without
its pretrained weights.
"""

from typing import Optional

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from vipnerf_tpu_torch.qa.lpips import load_default_lpips


def compute_rmse(
    gt: np.ndarray, pred: np.ndarray, mask: Optional[np.ndarray] = None
) -> float:
    error = gt.astype(np.float64) - pred.astype(np.float64)
    if mask is None:
        return float(np.sqrt(np.mean(np.square(error))))
    mask3 = np.stack([mask] * 3, axis=2).astype(np.float64)
    return float(np.sqrt(np.sum(np.square(mask3 * error)) / np.sum(mask3)))


def compute_psnr(
    gt: np.ndarray, pred: np.ndarray, mask: Optional[np.ndarray] = None
) -> float:
    error = gt.astype(np.float64) - pred.astype(np.float64)
    if mask is None:
        mse = np.mean(np.square(error))
    else:
        # Masked PSNR: 10*log10(255^2 / (sum(mask*err^2)/sum(mask)))
        # (MaskedPSNR05_DTU.py:33-40)
        mask3 = np.stack([mask] * 3, axis=2).astype(np.float64)
        mse = np.sum(mask3 * np.square(error)) / np.sum(mask3)
    return float(10 * np.log10(255 ** 2 / mse))


def _ssim_single_channel(
    im1: np.ndarray, im2: np.ndarray, data_range: float, sigma: float = 1.5
) -> np.ndarray:
    """SSIM map for one channel, skimage-equivalent (gaussian_weights=True,
    use_sample_covariance=False). Returns the full S map; caller crops."""
    truncate = 3.5
    filt = lambda im: gaussian_filter(im, sigma=sigma, truncate=truncate)

    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    ux = filt(im1)
    uy = filt(im2)
    uxx = filt(im1 * im1)
    uyy = filt(im2 * im2)
    uxy = filt(im1 * im2)
    vx = uxx - ux * ux  # population covariance (use_sample_covariance=False)
    vy = uyy - uy * uy
    vxy = uxy - ux * uy

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def compute_ssim(
    gt: np.ndarray,
    pred: np.ndarray,
    mask: Optional[np.ndarray] = None,
    data_range: float = 255.0,
    sigma: float = 1.5,
) -> float:
    """Multichannel SSIM; with `mask`, the masked-weighted mean over the SSIM
    map (MaskedSSIM05_DTU semantics)."""
    truncate = 3.5
    r = int(truncate * sigma + 0.5)  # skimage window radius: 5
    pad = r  # crop that many pixels from each border

    if gt.ndim == 2:
        gt = gt[..., None]
        pred = pred[..., None]
    maps = np.stack(
        [
            _ssim_single_channel(gt[..., c], pred[..., c], data_range, sigma)
            for c in range(gt.shape[-1])
        ],
        axis=-1,
    )
    cropped = maps[pad:-pad, pad:-pad]
    if mask is None:
        return float(cropped.mean())
    m = mask[pad:-pad, pad:-pad].astype(np.float64)
    m3 = np.stack([m] * cropped.shape[-1], axis=2)
    return float(np.sum(m3 * cropped) / np.sum(m3))


class LpipsMetric:
    """LPIPS(AlexNet) on `device`; None-scores when the pretrained weights
    are not on disk."""

    def __init__(self, device: torch.device):
        self.model = load_default_lpips(device)  # None if weights missing

    @property
    def available(self) -> bool:
        return self.model is not None

    def __call__(
        self, gt: np.ndarray, pred: np.ndarray, mask: Optional[np.ndarray] = None
    ) -> Optional[float]:
        if self.model is None:
            return None
        if mask is not None:
            # masked LPIPS multiplies both images by the mask
            m = mask.astype(gt.dtype)[..., None]
            gt = (gt * m).astype(gt.dtype)
            pred = (pred * m).astype(pred.dtype)
        return self.model.distance(gt, pred)
