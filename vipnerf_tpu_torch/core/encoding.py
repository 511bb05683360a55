"""Sinusoidal positional encoding (counterpart of vipnerf_tpu/core/encoding.py).

Output layout, each block spanning the full input dimensionality:

    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]

`fast=True` (the model config's `fast_encoding`) computes one sin/cos pair
and doubles the angle by recurrence, as the JAX package does.
"""

import torch


def encoding_dim(input_dim: int, degree: int) -> int:
    """Output dim: input + sin/cos per frequency."""
    return input_dim * (1 + 2 * degree)


def positional_encoding(x: torch.Tensor, degree: int, fast: bool = False) -> torch.Tensor:
    """Encode `x` (..., d) -> (..., d * (1 + 2*degree)), frequencies 2^0..2^(degree-1).

    fast=True takes sin and cos of x once and then s, c = 2sc, (c-s)(c+s)
    per frequency (sin 2a = 2 sin a cos a, cos 2a = cos^2 a - sin^2 a): the
    recurrence amplifies rounding by about 2^degree (~6e-5 absolute at
    degree 10 in f32)."""
    if degree <= 0:
        return x
    if fast:
        s, c = torch.sin(x), torch.cos(x)
        blocks = [x]
        for _ in range(degree):
            blocks += [s, c]
            s, c = 2.0 * s * c, (c - s) * (c + s)
        return torch.cat(blocks, dim=-1)
    d = x.shape[-1]
    freqs = 2.0 ** torch.arange(degree, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., degree, d)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(x.shape[:-1] + (degree * 2 * d,))
    return torch.cat([x, enc], dim=-1)
