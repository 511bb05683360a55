"""Sinusoidal positional encoding (counterpart of vipnerf_tpu/core/encoding.py).

Output layout, each block spanning the full input dimensionality:

    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]
"""

import torch


def encoding_dim(input_dim: int, degree: int) -> int:
    """Output dim: input + sin/cos per frequency."""
    return input_dim * (1 + 2 * degree)


def positional_encoding(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Encode `x` (..., d) -> (..., d * (1 + 2*degree)), frequencies 2^0..2^(degree-1)."""
    if degree <= 0:
        return x
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(degree, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., degree, d)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(x.shape[:-1] + (degree * 2 * d,))
    return torch.cat([x, enc], dim=-1)
