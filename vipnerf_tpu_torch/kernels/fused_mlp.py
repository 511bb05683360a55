"""K1: the whole flagship ViP-NeRF MLP forward in one CUDA kernel.

Counterpart of experiments/fused_mlp.py (`_make_fwd_kernel`, launched by
`_fwd_pallas`): for the 8x256 flagship config (PE 10/4, view-dependent rgb,
visibility head) it computes the trunk, the skip layer, the feature and sigma
heads and the view branch once for the primary view and once per secondary
view (`n_sec` <= 3), keeping every activation on chip. The source is
`csrc/fused_mlp.cu`; it is built with nvcc at the first launch.

Layout contract, one row per point:

    xe  (N, 64)            padded PE(pts) (63 real + 1 zero)
    ve  (N, 32)            padded PE(view dir) (27 real + 5 zeros)
    ve2 (N, 32*max(n_sec,1)) padded PE of each secondary view dir
    out (N, 8)             [0] sigma, [1:4] rgb, [4] vis, [5:5+n_sec] vis2,
                           raw (before noise/ReLU/sigmoid), rest zero

all in the working dtype: bf16 (f32 accumulation, each product rounded to
bf16 before the bf16 bias add, then ReLU) or f32. The epilogues (sigma
noise and ReLU, sigmoids) run outside, in f32.

Weight layout (`kernel_buffers`): bf16 layers are K-slabs of 64 columns (the
view layer's last one 32), each the 128-byte (64-byte) swizzled K-major image
that the kernel's wgmma B descriptor reads, so the kernel copies a slab into
shared memory with one bulk copy. f32 layers are W^T row-major, staged by
the kernel in slabs of `f32_slab_rows` rows.

`fused_mlp_raw` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs `fused_mlp_reference`, the same function in
plain torch. It counts its launches in `fused_mlp_raw.launches`, and per
instance in `fused_mlp_raw.launches_by_instance`.

Gradients: `FusedRaw` is the `torch.autograd.Function` around the wrapper
(the counterpart of `_make_fused_raw`, a `jax.custom_vjp`). It takes the
module's own parameters as inputs; its backward recomputes the raw output
with `raw_recompute`, a differentiable torch function with K1's numerics
(as `_raw_xla` is in JAX), and returns autograd's gradients of it. The
backward is matrix products outside any kernel, as in the JAX package.

Scene axis (batched multi-scene training, the counterpart of vmap over K1):
a stacked MLP (`models.mlp.NeRFMLP(..., scenes=S)`) packs S scenes' weights
one after the other (`FusedWeights.scenes`), its inputs are S blocks of N/S
rows, and one launch runs every scene on its own weights: a tile never
straddles two scenes. The plain version loops `fused_mlp_reference` over the
scenes; the backward recomputes with batched products over the scene axis.
With one scene the launch is the unstacked kernel, bit for bit.
"""

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from vipnerf_tpu_torch.core.encoding import positional_encoding
from vipnerf_tpu_torch.core.scene_linear import scene_matmul
from vipnerf_tpu_torch.kernels import build

PTS_IN = 64  # padded PE(pts) width (63 real)
VIEW_IN = 32  # padded PE(view dir) width (27 real)
NOUT = 8  # output columns
MAX_SEC = 3

# (out, in) of each packed layer, in the kernel's order: trunk 0..7, feature,
# sigma (1 real row of 8), view hidden, view output (4 real rows of 8)
LAYER_SHAPES: Tuple[Tuple[int, int], ...] = (
    (256, 64), (256, 256), (256, 256), (256, 256), (256, 256),
    (256, 320), (256, 256), (256, 256),
    (256, 256), (8, 256), (128, 288), (8, 128),
)
W_NUMEL = sum(n * k for n, k in LAYER_SHAPES)
B_NUMEL = sum(n for n, _ in LAYER_SHAPES)
SIGMA, FEATURE, VIEW, VIEW_OUT = 9, 8, 10, 11

# multiply-adds per point, real (unpadded) widths: trunk + heads + view branch
MACS_PER_POINT = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256 * 257 + 283 * 128 + 128 * 4
MACS_PER_SEC_VIEW = 283 * 128 + 128 * 4


class FusedWeights(NamedTuple):
    """Packed weights of one MLP for K1 and for its plain version."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]  # (W ([S,] out, in) dtype, b ([S,] out) f32)
    w_flat: torch.Tensor  # kernel layout, dtype; S packs one after the other
    b_flat: torch.Tensor  # f32, bf16-rounded for the bf16 kernel
    dtype: torch.dtype
    scenes: int = 1


def supports_config(mlp_cfg: Dict[str, Any]) -> bool:
    """K1 implements the flagship architecture only."""
    return (
        mlp_cfg["netdepth"] == 8
        and mlp_cfg["netwidth"] == 256
        and mlp_cfg["points_positional_encoding_degree"] == 10
        and mlp_cfg["views_positional_encoding_degree"] == 4
        and mlp_cfg["use_view_dirs"]
        and mlp_cfg["view_dependent_rgb"]
        and mlp_cfg["predict_visibility"]
    )


def pack_layers(mlp, dtype: torch.dtype) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Pad the module's weights to the kernel's (out, in) shapes.

    Zero columns go where the inputs are zero-padded (PE(pts) 63->64, in front
    of h in the skip layer; PE(view) 27->32 at the end of the view concat);
    zero rows pad the 1-wide sigma and 4-wide view outputs to 8. A stacked
    MLP's layers keep their leading scene axis.
    """
    with torch.no_grad():
        pl = mlp.pts_linears
        w5 = pl[5].weight
        zero_col = torch.zeros_like(w5[..., :1])
        pairs = [(F.pad(pl[0].weight, (0, 1)), pl[0].bias)]
        pairs += [(pl[i].weight, pl[i].bias) for i in (1, 2, 3, 4)]
        pairs.append((torch.cat([w5[..., :63], zero_col, w5[..., 63:]], dim=-1), pl[5].bias))
        pairs += [(pl[i].weight, pl[i].bias) for i in (6, 7)]
        pairs.append((mlp.feature_linear.weight, mlp.feature_linear.bias))
        pairs.append((
            F.pad(mlp.pts_output_linear.weight, (0, 0, 0, 7)),
            F.pad(mlp.pts_output_linear.bias, (0, 7)),
        ))
        pairs.append((
            F.pad(mlp.views_linears[0].weight, (0, 5)), mlp.views_linears[0].bias,
        ))
        pairs.append((
            F.pad(mlp.views_output_linear.weight, (0, 0, 0, 4)),
            F.pad(mlp.views_output_linear.bias, (0, 4)),
        ))
        layers = []
        for (w, b), shape in zip(pairs, LAYER_SHAPES):
            if tuple(w.shape[-2:]) != shape:
                raise ValueError(f"layer shape {tuple(w.shape[-2:])} != {shape}")
            layers.append((w.detach().to(dtype).contiguous(), b.detach().to(dtype).float()))
    return layers


SLAB_K = 64  # K of one K-slab of a bf16 layer (the view layer's last one is 32)
F32_SLAB = 4096  # floats of one f32 weight slab (16 KB)

# bytes of each packed layer, in the kernel's order
LAYER_BYTES = {
    torch.bfloat16: tuple(2 * n * k for n, k in LAYER_SHAPES),
    torch.float32: tuple(4 * n * k for n, k in LAYER_SHAPES),
}


def swizzled_slab(w: torch.Tensor) -> torch.Tensor:
    """(N, kw) K-slab of a (out, in) weight -> its K-major swizzled image,
    flat: row n at n * 2kw bytes, its 16-byte chunk c at chunk position
    c ^ (n % 8) for kw 64 (128-byte swizzle) or c ^ (n // 2 % 4) for kw 32
    (64-byte swizzle) -- shared-memory address bits 4-6 (4-5) XORed with bits
    7-9 (7-8), as wgmma's descriptor reads them."""
    n, kw = w.shape
    r = torch.arange(n, device=w.device)[:, None]
    c = torch.arange(kw // 8, device=w.device)[None, :]
    src = w.reshape(n, kw // 8, 8)
    out = torch.empty_like(src)
    out[r, c ^ ((r & 7) if kw == SLAB_K else ((r >> 1) & 3))] = src
    return out.reshape(-1)


def pack_bf16(w: torch.Tensor) -> torch.Tensor:
    """(N, K) bf16 weight -> the swizzled images of its K-slabs, in K order."""
    return torch.cat([swizzled_slab(w[:, k0:k0 + SLAB_K].contiguous())
                      for k0 in range(0, w.shape[1], SLAB_K)])


def f32_slab_rows(n: int, k: int) -> int:
    """Rows of W^T in one f32 slab: 16 KB of them, or a whole 8-wide head."""
    return k if n == NOUT else F32_SLAB // n


def _layer_image(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One (out, in) layer in the kernel's layout, flat: swizzled K-slabs for
    bf16; W^T (in, out) row-major for f32, whose slabs of `f32_slab_rows`
    rows are then contiguous, as the kernel's cp.async reads them."""
    return pack_bf16(w) if dtype == torch.bfloat16 else w.t().contiguous().reshape(-1)


_PACK_INDEX: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}


def pack_index(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The kernel's weight layout as one gather: entry i of a packed buffer
    is entry pack_index[i] of the layers' flattened (out, in) weights, one
    after the other. Built once per device by laying out the entries' own
    positions, so that a training step packs with one gather, however many
    slabs and scenes there are."""
    key = (dtype, torch.device(device))
    if key not in _PACK_INDEX:
        images, start = [], 0
        for n, k in LAYER_SHAPES:
            images.append(_layer_image(torch.arange(start, start + n * k).reshape(n, k), dtype))
            start += n * k
        _PACK_INDEX[key] = torch.cat(images).to(device)
    return _PACK_INDEX[key]


def kernel_buffers(layers, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat weight and bias buffers in the kernel's layout (`_layer_image`
    of each layer in turn); stacked layers give each scene's pack in turn."""
    lead = layers[0][0].shape[:-2]  # () or (S,)
    flat = torch.cat([w.reshape(*lead, -1) for w, _ in layers], dim=-1)
    w_flat = flat[..., pack_index(dtype, flat.device)].reshape(-1)
    return w_flat, torch.cat([b for _, b in layers], dim=-1).reshape(-1)


def prepare_weights(mlp, dtype: torch.dtype) -> FusedWeights:
    """Packed weights of `mlp`, cached on it until a parameter changes."""
    params = list(mlp.parameters())
    # a tensor's _version counts its in-place updates (optimizer steps, loads)
    key = (dtype, params[0].device, tuple(p._version for p in params),
           tuple(p.data_ptr() for p in params))
    cache = getattr(mlp, "_fused_weights", None)
    if cache is not None and cache[0] == key:
        return cache[1]
    layers = pack_layers(mlp, dtype)
    w_flat, b_flat = kernel_buffers(layers, dtype)
    packed = FusedWeights(layers, w_flat, b_flat, dtype, mlp.scenes or 1)
    mlp._fused_weights = (key, packed)
    return packed


def encode_inputs(
    pts: torch.Tensor,
    view_dirs: torch.Tensor,
    view_dirs2: Optional[torch.Tensor],
    dtype: torch.dtype,
    fast: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """PE (the double-angle recurrence with `fast`, the config's
    `fast_encoding`) and zero-padding of the kernel's inputs: (xe, ve, ve2,
    n_sec). With no secondary view, K1 reads no ve2: `ve` stands in for it."""
    npts = pts.shape[0]
    n_sec = view_dirs2.shape[1] if view_dirs2 is not None else 0
    xe = F.pad(positional_encoding(pts, 10, fast), (0, PTS_IN - 63)).to(dtype)
    ve = F.pad(positional_encoding(view_dirs, 4, fast), (0, VIEW_IN - 27)).to(dtype)
    if n_sec:
        enc2 = positional_encoding(view_dirs2.reshape(npts * n_sec, 3), 4, fast)
        ve2 = F.pad(enc2, (0, VIEW_IN - 27)).reshape(npts, n_sec * VIEW_IN).to(dtype)
    else:
        ve2 = ve
    return xe.contiguous(), ve.contiguous(), ve2.contiguous(), n_sec


def fused_mlp_reference(
    layers, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, n_sec: int
) -> torch.Tensor:
    """K1's function in plain torch: f32 matmuls of dtype-valued tensors; in
    bf16 each product is rounded to bf16 before the bias add, as the kernel
    does. Returns (N, 8) in the inputs' dtype. Stacked layers (S scenes) take
    S blocks of N/S rows, each through its own scene's layers, in turn."""
    if layers[0][0].dim() == 3:
        scenes = layers[0][0].shape[0]
        blocks = zip(*(t.chunk(scenes) for t in (xe, ve, ve2)))
        return torch.cat([fused_mlp_reference([(w[s], b[s]) for w, b in layers], *block, n_sec)
                          for s, block in enumerate(blocks)])
    dtype = xe.dtype
    bf16 = dtype == torch.bfloat16

    def dense(x, i, relu):
        w, b = layers[i]
        y = x.float() @ w.float().t()
        y = (y.to(dtype).float() + b).to(dtype) if bf16 else y + b
        return torch.relu(y) if relu else y

    h = dense(xe, 0, True)
    for i in (1, 2, 3, 4):
        h = dense(h, i, True)
    h = dense(torch.cat([xe, h], dim=1), 5, True)
    for i in (6, 7):
        h = dense(h, i, True)
    feature = dense(h, FEATURE, False)
    sigma = dense(h, SIGMA, False)[:, :1]

    def view_branch(enc_v):
        hv = dense(torch.cat([feature, enc_v], dim=1), VIEW, True)
        return dense(hv, VIEW_OUT, False)

    cols = [sigma, view_branch(ve)[:, 0:4]]
    for j in range(n_sec):
        cols.append(view_branch(ve2[:, j * VIEW_IN:(j + 1) * VIEW_IN])[:, 3:4])
    out = torch.cat(cols, dim=1)
    return F.pad(out, (0, NOUT - out.shape[1])).to(dtype)


_ENTRY = {torch.bfloat16: "vipnerf_fused_mlp_bf16", torch.float32: "vipnerf_fused_mlp_f32"}
INSTANCE = {torch.bfloat16: "fused_mlp_bf16", torch.float32: "fused_mlp_f32"}


def _entry(dtype: torch.dtype):
    lib = build.load("fused_mlp")
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory per CTA of the instance (builds the kernel)."""
    return build.load("fused_mlp").vipnerf_fused_mlp_smem_bytes(int(dtype == torch.bfloat16))


def _check(weights: FusedWeights, xe, ve, ve2, n_sec: int):
    n = xe.shape[0]
    if weights.dtype not in _ENTRY:
        raise TypeError(f"K1 takes bf16 or f32, not {weights.dtype}")
    if not 0 <= n_sec <= MAX_SEC:
        raise ValueError(f"n_sec must be in 0..{MAX_SEC}, got {n_sec}")
    expect = {
        "xe": (xe, (n, PTS_IN)),
        "ve": (ve, (n, VIEW_IN)),
        "ve2": (ve2, (n, VIEW_IN * max(n_sec, 1))),
    }
    for name, (t, shape) in expect.items():
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != weights.dtype:
            raise TypeError(f"{name} is {t.dtype}, weights are {weights.dtype}")
        if t.device != xe.device:
            raise ValueError(f"{name} is on {t.device}, xe on {xe.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weights.w_flat.numel() != weights.scenes * W_NUMEL or weights.b_flat.numel() != weights.scenes * B_NUMEL:
        raise ValueError("packed weights do not match the kernel's layer table")
    if n % weights.scenes:
        raise ValueError(f"{n} rows do not split into {weights.scenes} scenes")
    if weights.w_flat.device != xe.device:
        raise ValueError(f"weights on {weights.w_flat.device}, inputs on {xe.device}")


def fused_mlp_raw(
    weights: FusedWeights, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor,
    n_sec: int,
) -> torch.Tensor:
    """K1 on (xe, ve, ve2) -> raw (N, 8) outputs; with stacked weights of S
    scenes, N/S rows per scene, one launch for all. CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream."""
    _check(weights, xe, ve, ve2, n_sec)
    if xe.device.type == "cpu":
        return fused_mlp_reference(weights.layers, xe, ve, ve2, n_sec)
    if xe.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {xe.device}")
    n = xe.shape[0]
    out = torch.empty((n, NOUT), dtype=weights.dtype, device=xe.device)
    if n == 0:
        return out
    fn = _entry(weights.dtype)
    stream = torch.cuda.current_stream(xe.device).cuda_stream
    with torch.cuda.device(xe.device):
        rc = fn(xe.data_ptr(), ve.data_ptr(), ve2.data_ptr(),
                weights.w_flat.data_ptr(), weights.b_flat.data_ptr(),
                out.data_ptr(), weights.scenes, n // weights.scenes, n_sec, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    fused_mlp_raw.launches += 1
    fused_mlp_raw.launches_by_instance[INSTANCE[weights.dtype]] += 1
    return out


def reset_launch_counts():
    fused_mlp_raw.launches = 0
    fused_mlp_raw.launches_by_instance = dict.fromkeys(INSTANCE.values(), 0)


reset_launch_counts()


def module_params(mlp) -> List[torch.Tensor]:
    """The flagship MLP's parameters in `raw_recompute`'s order: trunk 0..7
    (weight, bias each), feature, sigma head, view hidden, view output."""
    linears = list(mlp.pts_linears) + [
        mlp.feature_linear, mlp.pts_output_linear, mlp.views_linears[0],
        mlp.views_output_linear,
    ]
    return [p for lin in linears for p in (lin.weight, lin.bias)]


def raw_recompute(
    params, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, n_sec: int
) -> torch.Tensor:
    """K1's raw (N, 8) output as a differentiable torch function of the
    module's real parameters (`module_params` order), in the inputs' dtype;
    the counterpart of `_raw_xla`. Zero padding is built from the real
    weights with `F.pad`/`torch.cat`, so it takes no gradient; in bf16 each
    product is rounded to bf16 before the bf16 bias add. Unlike
    `fused_mlp_reference`, the products run in the working dtype (cuBLAS on
    the card), as XLA's do. Stacked parameters (S scenes) take S blocks of
    N/S rows and run each layer as one batched product over the scenes."""
    dt = xe.dtype
    w = [p.to(dt) for p in params[0::2]]
    b = [p.to(dt) for p in params[1::2]]
    n = xe.shape[0]
    if w[0].dim() == 3:  # (S, N/S, cols): a product per scene
        xe, ve, ve2 = (t.reshape(w[0].shape[0], -1, t.shape[-1]) for t in (xe, ve, ve2))

    def dense(x, i, relu):
        if x.dim() == 3:
            y = scene_matmul(x, w[i]) + b[i][:, None]
        else:
            y = F.linear(x, w[i]) + b[i]
        return torch.relu(y) if relu else y

    def pad_cols(wi, at, n):
        return torch.cat([wi[..., :at], wi.new_zeros(*wi.shape[:-1], n), wi[..., at:]], dim=-1)

    w[0] = F.pad(w[0], (0, 1))
    w[5] = pad_cols(w[5], 63, 1)
    w[10] = F.pad(w[10], (0, VIEW_IN - 27))
    h = dense(xe, 0, True)
    for i in range(1, 5):
        h = dense(h, i, True)
    h = dense(torch.cat([xe, h], dim=-1), 5, True)
    for i in (6, 7):
        h = dense(h, i, True)
    feature = dense(h, 8, False)
    sigma = dense(h, 9, False)

    def view_branch(enc_v):
        return dense(dense(torch.cat([feature, enc_v], dim=-1), 10, True), 11, False)

    cols = [sigma, view_branch(ve)]
    for j in range(n_sec):
        cols.append(view_branch(ve2[..., j * VIEW_IN:(j + 1) * VIEW_IN])[..., 3:4])
    out = torch.cat(cols, dim=-1)
    return F.pad(out, (0, NOUT - out.shape[-1])).reshape(n, NOUT)


class FusedRaw(torch.autograd.Function):
    """K1 with a gradient: forward launches the kernel (the plain version on
    the CPU); backward recomputes through `raw_recompute` and differentiates
    that, for the parameters and for xe/ve/ve2 where they need it."""

    @staticmethod
    def forward(ctx, weights: FusedWeights, n_sec: int, xe, ve, ve2, *params):
        ctx.n_sec = n_sec
        ctx.save_for_backward(xe, ve, ve2, *params)
        return fused_mlp_raw(weights, xe, ve, ve2, n_sec)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        with torch.enable_grad():
            out = raw_recompute(inputs[3:], *inputs[:3], ctx.n_sec)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype), allow_unused=True))
        return (None, None) + tuple(next(grads) if t.requires_grad else None for t in inputs)


def apply_fused_mlp(
    mlp,
    pts: torch.Tensor,
    view_dirs: torch.Tensor,
    view_dirs2: Optional[torch.Tensor] = None,
    *,
    raw_noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """NeRFMLP.forward for the flagship config, through K1. Same output dict
    (sigma, rgb, rgb_view_dependent, visibility[, visibility2]), f32, and
    differentiable in the module's parameters (and pts/view dirs). A stacked
    MLP takes and gives (S, n, ...), in one launch."""
    if not supports_config(mlp.cfg):
        raise ValueError("K1 implements the flagship 8x256 config only")
    lead = pts.shape[:-1]
    xe, ve, ve2, n_sec = encode_inputs(
        pts.reshape(-1, 3), view_dirs.reshape(-1, 3),
        None if view_dirs2 is None else view_dirs2.reshape(-1, *view_dirs2.shape[-2:]), dtype,
        mlp.cfg.get("fast_encoding", False))
    weights = prepare_weights(mlp, dtype)
    raw = FusedRaw.apply(weights, n_sec, xe, ve, ve2, *module_params(mlp)).float()
    sigma = raw[:, 0:1]
    if raw_noise_std > 0.0 and generator is not None:
        sigma = sigma + raw_noise_std * torch.randn(
            sigma.shape, generator=generator, device=sigma.device
        )
    out = {
        "sigma": torch.relu(sigma),
        "rgb_view_dependent": torch.sigmoid(raw[:, 1:4]),
        "visibility": torch.sigmoid(raw[:, 4:5]),
    }
    out["rgb"] = out["rgb_view_dependent"]
    if n_sec:
        out["visibility2"] = torch.sigmoid(raw[:, 5:5 + n_sec])[..., None]
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}
