"""The product of a layer with a scene axis (batched multi-scene training).

`scene_matmul(x, w)`: x (S, n, in) @ w (S, out, in)^T -> (S, n, out), each
scene through its own weights, as one `torch.bmm` forward. Its backward
takes the input gradient as one `torch.bmm` too, but each scene's weight
gradient as its own `torch.mm`: that product reduces over all n points of
the scene (~10^6 in a training step) into a small (out, in) matrix, and a
strided-batched GEMM runs it on a handful of tiles per scene where a
single GEMM splits the long reduction over the whole card.
"""

import torch


class _SceneMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w.transpose(1, 2))

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx = torch.bmm(grad, w) if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            gw = torch.stack([grad[s].t().mm(x[s]) for s in range(w.shape[0])])
        return gx, gw


def scene_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (S, n, in), w (S, out, in) of one dtype -> (S, n, out)."""
    return _SceneMatmul.apply(x, w)
