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

in one of three precision modes, each an instance of the kernel, named by
the (trunk, heads) dtypes (`INSTANCE`): bf16 (f32 accumulation, each product
rounded to bf16 before the bf16 bias add, then ReLU), f32, or bf16_f32h, the
shipped mode (`bf16_matmuls` with `f32_heads`): the trunk, layers 0-7, in
bf16, then h upcast to f32 and the feature, sigma and view layers in f32
with f32 weights. xe is in the trunk's dtype; ve, ve2 and out in the
heads'. The epilogues (sigma noise and ReLU, sigmoids) run outside, in f32.
bf16_f32h computes its f32 heads on bf16 tensor cores from split products:
each f32 operand is three bf16 parts that sum to it exactly (`split_bf16`).

Weight layout (`kernel_buffers`): bf16 layers are K-slabs of 64 columns (the
view layer's last one 32), each the 128-byte (64-byte) swizzled K-major image
that the kernel's wgmma B descriptor reads, so the kernel copies a slab into
shared memory with one bulk copy. f32 layers are W^T row-major, staged by
the kernel in slabs of `f32_slab_rows` rows. A bf16_f32h pack is bytes: the
trunk's bf16 images, then the heads' three bf16 parts as the stream of bulk
copies the heads kernel consumes (`heads_image`; `PACK_BYTES`).

`fused_mlp_raw` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs `fused_mlp_reference`, the same function in
plain torch. Every launch on the card is counted in the tracer's table
(`utils/tracing.py`) as `k1.launches.<kernel>`, per instance (`INSTANCE`)
and backward kernel (`BWD_KERNELS`, `TRUNK_KERNELS`); `launches(kernels)`
reads them. Each call of the wrapper with other views also adds its points
x `n_sec` to `vis.sec_view_points` (`SEC_VIEW_POINTS`: the rows K1's view
branch runs for the other views, on the card or in the plain version), from
the shapes alone.

Inputs: `encode_inputs` writes (xe, ve, ve2) from the points and their view
directions. On CUDA tensors that is one launch of `k1_encode_kernel` (same
source), which reads a ray's direction once for all its samples and writes
the padded rows bit for bit as the torch chain `encode_reference` does
(`positional_encoding`, pad, cast), counted as `k1.launches.k1_encode`: on
the card every K1 launch of a path is fed by one. The kernel has no
backward, so CUDA inputs that autograd tracks raise; CPU tensors take
`encode_reference`, which stays differentiable.

Gradients: `FusedRaw` is the `torch.autograd.Function` around the wrapper
(the counterpart of `_make_fused_raw`, a `jax.custom_vjp`). It takes the
module's own parameters as inputs; its backward recomputes the raw output
with `raw_recompute`, a differentiable torch function with K1's numerics
(as `_raw_xla` is in JAX), and returns autograd's gradients of it: matrix
products outside any kernel, as in the JAX package. In the shipped mode
(bf16_f32h) the f32 heads' gradient (layers 8-11, d h, d PE(dir)) is
`heads_backward`, two hand-written kernels in `csrc/fused_mlp_bwd.cu` on the
bf16 tensor cores (`wgmma` fed by bulk copies) from the same split products
as the forward's heads (`heads_backward_reference` on CPU tensors); on the
card the trunk's is hand kernels too: `trunk_activations` recomputes it with
K1's own trunk code, keeping every layer's h, and `trunk_backward` takes
its gradient layer by layer (`trunk_backward_reference` is their plain
version; CPU tensors take autograd through `trunk_recompute`, which it
equals). `heads_backward_recompute`, autograd through the f32 heads of
`raw_recompute` on cuBLAS, is the heads backward's yardstick on no path.

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
from vipnerf_tpu_torch.core.sampling import ray_draw
from vipnerf_tpu_torch.core.scene_linear import scene_matmul
from vipnerf_tpu_torch.kernels import build
from vipnerf_tpu_torch.utils import tracing

PTS_IN = 64  # padded PE(pts) width (63 real)
VIEW_IN = 32  # padded PE(view dir) width (27 real)
NOUT = 8  # output columns
WIDTH = 256  # the trunk's
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
TRUNK_NUMEL = sum(n * k for n, k in LAYER_SHAPES[:FEATURE])  # layers 0-7, before the heads

# (trunk dtype, heads dtype) -> the instance of K1 that computes that mode
INSTANCE = {
    (torch.bfloat16, torch.bfloat16): "fused_mlp_bf16",
    (torch.float32, torch.float32): "fused_mlp_f32",
    (torch.bfloat16, torch.float32): "fused_mlp_bf16_f32h",
}
FORWARD = tuple(INSTANCE.values())
SEC_VIEW_POINTS = "vis.sec_view_points"  # counter: points x other views through the view branch
HEAD_NUMEL = W_NUMEL - TRUNK_NUMEL  # layers 8-11
SPLIT_PARTS = 3  # bf16 parts of an f32 head weight in the bf16_f32h pack
# bytes of one scene's packed weights, per instance
PACK_BYTES = {
    (torch.bfloat16, torch.bfloat16): 2 * W_NUMEL,
    (torch.float32, torch.float32): 4 * W_NUMEL,
    (torch.bfloat16, torch.float32): 2 * TRUNK_NUMEL + SPLIT_PARTS * 2 * HEAD_NUMEL,
}

# multiply-adds per point, real (unpadded) widths: trunk + heads + view branch
MACS_PER_POINT = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256 * 257 + 283 * 128 + 128 * 4
MACS_PER_SEC_VIEW = 283 * 128 + 128 * 4
TRUNK_MACS_PER_POINT = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256  # layers 0-7
# bf16 products per point of bf16_f32h's heads (real widths): 3 per MAC of
# the feature and sigma layers (h times the weight's three parts), 6 per MAC
# of the view and output layers (part pairs of two f32 operands); the view
# layer's feature columns once per point, its PE(dir) columns and the output
# layer per view (one output column for a secondary view)
F32H_SPLIT_MACS = 3 * (256 * 256 + 256) + 6 * (256 * 128 + 27 * 128 + 128 * 4)
F32H_SPLIT_MACS_PER_SEC_VIEW = 6 * (27 * 128 + 128)


class FusedWeights(NamedTuple):
    """Packed weights of one MLP for K1 and for its plain version."""

    layers: List[Tuple[torch.Tensor, torch.Tensor]]  # (W ([S,] out, in) its layer's dtype, b ([S,] out) f32)
    w_flat: torch.Tensor  # kernel layout, dtype (bytes for bf16_f32h); S packs one after the other
    b_flat: torch.Tensor  # f32, bf16-rounded for the bf16 layers
    dtype: torch.dtype  # the trunk's
    scenes: int = 1
    head_dtype: Optional[torch.dtype] = None  # the heads', when it is not the trunk's
    heads_bwd_stream: Optional[torch.Tensor] = None  # bf16_f32h: `heads_bwd_stream` of `heads_bwd_pack`'s image
    heads_bwd_small: Optional[torch.Tensor] = None  # bf16_f32h: `heads_bwd_pack`'s f32 biases and small layers

    @property
    def mode(self) -> Tuple[torch.dtype, torch.dtype]:
        """(trunk, heads) dtypes: the key of `INSTANCE`."""
        return self.dtype, self.head_dtype or self.dtype


def precision(bf16_matmuls: bool, f32_heads: bool) -> Tuple[torch.dtype, torch.dtype]:
    """(trunk, heads) dtypes of a config's precision mode, as models/mlp.py
    runs it: `f32_heads` matters only with `bf16_matmuls`."""
    dtype = torch.bfloat16 if bf16_matmuls else torch.float32
    return dtype, (torch.float32 if f32_heads else dtype)


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


def pack_layers(mlp, dtype: torch.dtype, head_dtype: Optional[torch.dtype] = None
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Pad the module's weights to the kernel's (out, in) shapes, the trunk's
    in `dtype`, the heads' in `head_dtype` (default `dtype`).

    Zero columns go where the inputs are zero-padded (PE(pts) 63->64, in front
    of h in the skip layer; PE(view) 27->32 at the end of the view concat);
    zero rows pad the 1-wide sigma and 4-wide view outputs to 8. A stacked
    MLP's layers keep their leading scene axis.
    """
    head_dtype = head_dtype or dtype
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
        for i, ((w, b), shape) in enumerate(zip(pairs, LAYER_SHAPES)):
            if tuple(w.shape[-2:]) != shape:
                raise ValueError(f"layer shape {tuple(w.shape[-2:])} != {shape}")
            dt = dtype if i < FEATURE else head_dtype
            layers.append((w.detach().to(dt).contiguous(), b.detach().to(dt).float()))
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


_PACK_INDEX: Dict[Tuple[Any, torch.device], torch.Tensor] = {}


def _positions(shapes, start: int = 0) -> List[torch.Tensor]:
    """Each (n, k) of `shapes` as a matrix of its entries' positions in the
    layers' flattened weights, one after the other from `start`."""
    out = []
    for n, k in shapes:
        out.append(torch.arange(start, start + n * k).reshape(n, k))
        start += n * k
    return out


def pack_index(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The kernel's weight layout as one gather: entry i of a packed buffer
    is entry pack_index[i] of the layers' flattened (out, in) weights, one
    after the other. Built once per device by laying out the entries' own
    positions, so that a training step packs with one gather, however many
    slabs and scenes there are."""
    key = (dtype, torch.device(device))
    if key not in _PACK_INDEX:
        _PACK_INDEX[key] = torch.cat([_layer_image(pos, dtype) for pos in _positions(LAYER_SHAPES)]).to(device)
    return _PACK_INDEX[key]


def split_bf16(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 -> three bf16 parts whose f32 sum is w exactly: each part rounds
    (to nearest even) what the parts before it leave, and those remainders
    are exact in f32. The bf16_f32h heads multiply parts (exact products in
    f32) instead of rounding an f32 operand once."""
    p0 = w.to(torch.bfloat16)
    rest = w - p0.float()
    p1 = rest.to(torch.bfloat16)
    return p0, p1, (rest - p1.float()).to(torch.bfloat16)


HEADS_HALF = 128  # feature columns per half in the heads kernel


def heads_image(parts) -> torch.Tensor:
    """The bf16_f32h heads' stream, flat bf16, from `parts[p]` = (W8, W9,
    W10, W11) of part p, in the order the heads kernel's bulk copies take it:
    W9's three parts (sigma, 4 K-slabs each); per half of the feature's rows,
    W8's part p on K-columns [128 sp, 128 sp + 128) for p, sp in order (32 KB
    chunks), then W10's part p on the half's feature columns (32 KB); last,
    the per-view chunk: W10's three parts on the PE(dir) columns (64-byte
    swizzle) and W11's three parts."""
    chunks = [pack_bf16(part[1]) for part in parts]
    for hf in range(WIDTH // HEADS_HALF):
        rows = slice(hf * HEADS_HALF, (hf + 1) * HEADS_HALF)
        chunks += [pack_bf16(part[0][rows, k0:k0 + HEADS_HALF])
                   for part in parts for k0 in range(0, WIDTH, HEADS_HALF)]
        chunks += [pack_bf16(part[2][:, rows]) for part in parts]
    chunks += [swizzled_slab(part[2][:, WIDTH:].contiguous()) for part in parts]
    chunks += [pack_bf16(part[3]) for part in parts]
    return torch.cat(chunks)


def heads_index(device: torch.device) -> torch.Tensor:
    """`heads_image` as one gather from the three parts' flattened head
    layers, part 0's four layers, then part 1's, then part 2's."""
    key = ("heads", torch.device(device))
    if key not in _PACK_INDEX:
        shapes = LAYER_SHAPES[FEATURE:]
        parts = [_positions(shapes, p * HEAD_NUMEL) for p in range(SPLIT_PARTS)]
        _PACK_INDEX[key] = heads_image(parts).to(device)
    return _PACK_INDEX[key]


TILE_ROWS = 128  # points per tile of the bf16 kernel and of bf16_f32h's trunk and heads kernels
BLOCK_ROWS_F32 = 64  # points per block of the f32 kernel
# bytes of `heads_image`'s per-view chunk: W10's PE(dir) columns and W11, each part
HEADS_VIEW_BYTES = SPLIT_PARTS * 2 * (LAYER_SHAPES[VIEW][0] * (LAYER_SHAPES[VIEW][1] - WIDTH)
                                      + LAYER_SHAPES[VIEW_OUT][0] * LAYER_SHAPES[VIEW_OUT][1])


def stream_bytes(instance: str, n: int, n_sec: int, scenes: int = 1) -> int:
    """Bytes one launch of `instance` on n points of `scenes` scenes streams
    from L2 by its design, beyond its inputs and outputs: each tile's (f32:
    each block's) pass over the packed weights, the view layers again per
    secondary view (bf16_f32h: the heads' per-view chunk), and bf16_f32h's h
    round trip through `h_scratch` (written, then read back). Counted from
    the pack's sizes, not measured."""
    tiles = scenes * -(-(n // scenes) // TILE_ROWS)
    blocks = scenes * -(-(n // scenes) // BLOCK_ROWS_F32)
    view = {dt: b[VIEW] + b[VIEW_OUT] for dt, b in LAYER_BYTES.items()}  # the view layers, whole
    if instance == "fused_mlp_bf16":
        return tiles * (PACK_BYTES[torch.bfloat16, torch.bfloat16] + n_sec * view[torch.bfloat16])
    if instance == "fused_mlp_f32":
        return blocks * (PACK_BYTES[torch.float32, torch.float32] + n_sec * view[torch.float32])
    if instance == "fused_mlp_bf16_f32h":
        return tiles * (2 * TRUNK_NUMEL + SPLIT_PARTS * 2 * HEAD_NUMEL + n_sec * HEADS_VIEW_BYTES) \
            + 2 * h_scratch_bytes(n, scenes)
    raise ValueError(f"no K1 instance {instance}")


def _images(part, dtype: torch.dtype) -> torch.Tensor:
    """The packed layout's first entries, for `part`'s layers, the first
    ones of `LAYER_SHAPES` (with their leading scene axis, if any)."""
    lead = part[0][0].shape[:-2]
    flat = torch.cat([w.reshape(*lead, -1) for w, _ in part], dim=-1)
    return flat[..., pack_index(dtype, flat.device)[:flat.shape[-1]]]


def kernel_buffers(layers, dtype: torch.dtype, head_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat weight and bias buffers in the kernel's layout (`_layer_image`
    of each layer in turn); stacked layers give each scene's pack in turn.
    With f32 heads on a bf16 trunk, each scene's pack is bytes: the trunk's
    bf16 images, then `heads_image` of the heads' `split_bf16` parts (one
    gather after the elementwise split)."""
    lead = layers[0][0].shape[:-2]  # () or (S,)
    head_dtype = head_dtype or dtype
    if head_dtype == dtype:
        w_flat = _images(layers, dtype)
    else:
        heads = torch.cat([w.reshape(*lead, -1) for w, _ in layers[FEATURE:]], dim=-1)
        parts = torch.cat(split_bf16(heads), dim=-1)
        w_flat = torch.cat([_images(layers[:FEATURE], dtype).view(torch.uint8),
                            parts[..., heads_index(parts.device)].view(torch.uint8)], dim=-1)
    return w_flat.reshape(-1), torch.cat([b for _, b in layers], dim=-1).reshape(-1)


# The shipped mode's heads backward (`heads_backward`) reads each f32 head
# weight as three bf16 parts (`split_bf16`), every matrix in the orientation
# its product contracts: rows n, K contiguous. Per scene, in this order, each
# matrix's three parts one after the other: W8 (feature = h W8^T), W10's
# feature columns and its PE(dir) columns (the view layer's forward), their
# transposes and W8's (d feature = D W10f, d h = d feature W8, d PE(dir) = d
# hv W10p). The per-point kernel reads this image's permutation
# `heads_bwd_stream`.
BWD_MATS = (("w8", WIDTH, WIDTH), ("w10f", 128, WIDTH), ("w10p", 128, VIEW_IN),
            ("w10ft", WIDTH, 128), ("w8t", WIDTH, WIDTH), ("w10pt", VIEW_IN, 128))
BWD_IMG_NUMEL = SPLIT_PARTS * sum(r * c for _, r, c in BWD_MATS)
BWD_SMALL_NUMEL = WIDTH + 128 + WIDTH + 4 * 128  # f32 b8, b10, W9, W11 (4 real rows)


def heads_bwd_pack(layers) -> Tuple[torch.Tensor, torch.Tensor]:
    """The heads backward's weights from packed bf16_f32h layers (with their
    scene axis, if any): the bf16 image of `BWD_MATS`' split parts, and the
    f32 biases and small layers its CUDA-core products read, each scene's in
    turn."""
    with torch.no_grad():
        lead = layers[0][0].shape[:-2]
        w8, w10 = layers[FEATURE][0], layers[VIEW][0]
        w10f, w10p = w10[..., :WIDTH], w10[..., WIDTH:]
        mats = (w8, w10f, w10p, w10f.transpose(-1, -2), w8.transpose(-1, -2), w10p.transpose(-1, -2))
        image = torch.cat([torch.stack(split_bf16(m.reshape(*lead, -1)), dim=-2).reshape(*lead, -1) for m in mats],
                          dim=-1)
        small = torch.cat([layers[FEATURE][1], layers[VIEW][1], layers[SIGMA][0][..., 0, :],
                           layers[VIEW_OUT][0][..., :4, :].reshape(*lead, -1)], dim=-1)
    return image.reshape(-1).contiguous(), small.reshape(-1).contiguous()


# The per-point kernel's weight stream: BWD_STREAM_CHUNKS chunks of
# BWD_CHUNK bytes per scene, in the order the kernel consumes them, one bulk
# copy each. A chunk is the three bf16 parts, one after the other, of a
# block (rows x 32 K) of a matrix of `BWD_MATS` (W10p^T's chunk: its four
# K-blocks in turn), each the 64-byte-swizzled K-major image (`swizzled_slab`)
# that wgmma's B descriptor reads.
BWD_CHUNK = 24576


def bwd_stream_blocks() -> List[Tuple[str, int, int, Tuple[int, ...]]]:
    """The stream's chunks in order: (matrix, first row, rows, first K
    column of each 32-wide block). Per half of the feature's 128 columns,
    W8's rows of the half over K in blocks of 32, then W10's feature columns
    of the half; W10's PE(dir) columns; their transpose; W10f^T and W8^T by
    halves of their rows, K in blocks of 32."""
    out = []
    for hf in range(2):
        out += [("w8", 128 * hf, 128, (32 * c,)) for c in range(8)]
        out += [("w10f", 0, 128, (128 * hf + 32 * c,)) for c in range(4)]
    out += [("w10p", 0, 128, (0,)), ("w10pt", 0, VIEW_IN, (0, 32, 64, 96))]
    out += [("w10ft", 128 * hf, 128, (32 * c,)) for hf in range(2) for c in range(4)]
    out += [("w8t", 128 * hh, 128, (32 * c,)) for hh in range(2) for c in range(8)]
    return out


BWD_STREAM_CHUNKS = len(bwd_stream_blocks())


def bwd_stream_index(device) -> torch.Tensor:
    """`heads_bwd_stream` as one gather from a scene's `heads_bwd_pack`
    image: entry i of the stream is entry index[i] of the image."""
    key = ("bwd_stream", torch.device(device))
    if key not in _PACK_INDEX:
        at, pos = 0, {}
        for name, rows, cols in BWD_MATS:
            pos[name] = torch.arange(at, at + SPLIT_PARTS * rows * cols).reshape(SPLIT_PARTS, rows, cols)
            at += SPLIT_PARTS * rows * cols
        chunks = [swizzled_slab(pos[name][p, r0:r0 + rows, k0:k0 + 32].contiguous())
                  for name, r0, rows, ks in bwd_stream_blocks() for p in range(SPLIT_PARTS) for k0 in ks]
        _PACK_INDEX[key] = torch.cat(chunks).to(device)
    return _PACK_INDEX[key]


def heads_bwd_stream(image: torch.Tensor, scenes: int = 1) -> torch.Tensor:
    """The per-point kernel's weight stream of each scene in turn, from the
    scenes' `heads_bwd_pack` images (flat, one after the other)."""
    return image.reshape(scenes, -1)[:, bwd_stream_index(image.device)].reshape(-1)


def prepare_weights(mlp, dtype: torch.dtype, f32_heads: bool = False) -> FusedWeights:
    """Packed weights of `mlp` for the instance of (`dtype`, `f32_heads`),
    cached on it per instance until a parameter changes."""
    head_dtype = torch.float32 if f32_heads else dtype
    params = list(mlp.parameters())
    # a tensor's _version counts its in-place updates (optimizer steps, loads)
    state = (params[0].device, tuple(p._version for p in params), tuple(p.data_ptr() for p in params))
    mode = (dtype, head_dtype)
    cache = getattr(mlp, "_fused_weights", None)
    if cache is None or cache[0] != state:
        cache = mlp._fused_weights = (state, {})
    if mode not in cache[1]:
        layers = pack_layers(mlp, dtype, head_dtype)
        w_flat, b_flat = kernel_buffers(layers, dtype, head_dtype)
        scenes, mixed = mlp.scenes or 1, head_dtype != dtype
        image, small = heads_bwd_pack(layers) if mixed else (None, None)
        cache[1][mode] = FusedWeights(layers, w_flat, b_flat, dtype, scenes, head_dtype if mixed else None,
                                      heads_bwd_stream(image, scenes) if mixed else None, small)
    return cache[1][mode]


ENCODE = "k1_encode"  # the kernel that writes K1's inputs, counted as k1.launches.k1_encode


def _per_point(view_dirs: torch.Tensor, n: int) -> torch.Tensor:
    """Per-ray directions (R, 3), each for n / R consecutive points, as one
    row per point (a copy); per-point ones as they are."""
    r = view_dirs.shape[0]
    return view_dirs if r == n else view_dirs[:, None, :].expand(r, n // r, 3).reshape(n, 3)


def encode_reference(
    pts: torch.Tensor,
    view_dirs: torch.Tensor,
    view_dirs2: Optional[torch.Tensor],
    dtype: torch.dtype,
    fast: bool = False,
    f32_heads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """`encode_inputs`' function in plain torch (`positional_encoding`, then
    the padding and the casts), on any device: CPU tensors take it, and the
    card's tests hold the encode kernel to it bit for bit."""
    npts = pts.shape[0]
    n_sec = view_dirs2.shape[1] if view_dirs2 is not None else 0
    head_dtype = torch.float32 if f32_heads else dtype
    xe = F.pad(positional_encoding(pts, 10, fast), (0, PTS_IN - 63)).to(dtype)
    ve = F.pad(positional_encoding(_per_point(view_dirs, npts), 4, fast), (0, VIEW_IN - 27)).to(head_dtype)
    if n_sec:
        enc2 = positional_encoding(view_dirs2.reshape(npts * n_sec, 3), 4, fast)
        ve2 = F.pad(enc2, (0, VIEW_IN - 27)).reshape(npts, n_sec * VIEW_IN).to(head_dtype)
    else:
        ve2 = ve
    return xe.contiguous(), ve.contiguous(), ve2.contiguous(), n_sec


def _check_encode(pts, view_dirs, view_dirs2, mode) -> Tuple[int, int]:
    """Raises on inputs the encode does not take; returns (points per
    direction, n_sec)."""
    if mode not in INSTANCE:
        raise TypeError(f"K1 has no instance for a {mode[0]} trunk with {mode[1]} heads")
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts has shape {tuple(pts.shape)}, expected (N, 3)")
    n, rays = pts.shape[0], view_dirs.shape[0]
    if view_dirs.dim() != 2 or view_dirs.shape[1] != 3 or (n and (not rays or n % rays)):
        raise ValueError(f"view_dirs has shape {tuple(view_dirs.shape)}, expected (R, 3) with R dividing {n}")
    if view_dirs2 is not None and (view_dirs2.dim() != 3 or view_dirs2.shape[0] != n or view_dirs2.shape[2] != 3):
        raise ValueError(f"view_dirs2 has shape {tuple(view_dirs2.shape)}, expected ({n}, n_sec, 3)")
    n_sec = view_dirs2.shape[1] if view_dirs2 is not None else 0
    if n_sec > MAX_SEC:
        raise ValueError(f"n_sec must be in 0..{MAX_SEC}, got {n_sec}")
    for name, t in (("pts", pts), ("view_dirs", view_dirs), ("view_dirs2", view_dirs2)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}, the encode takes torch.float32")
        if t is not None and t.device != pts.device:
            raise ValueError(f"{name} is on {t.device}, pts on {pts.device}")
    return (n // rays if n else 1), n_sec


def encode_inputs(
    pts: torch.Tensor,
    view_dirs: torch.Tensor,
    view_dirs2: Optional[torch.Tensor],
    dtype: torch.dtype,
    fast: bool = False,
    f32_heads: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """PE (the double-angle recurrence with `fast`, the config's
    `fast_encoding`) and zero-padding of the kernel's inputs: (xe, ve, ve2,
    n_sec), xe in `dtype`, ve and ve2 in the heads' dtype: f32, never
    rounded, with `f32_heads`. With no secondary view, K1 reads no ve2:
    `ve` stands in for it. pts (N, 3), view_dirs (N, 3) or one direction
    per ray, (R, 3) for R rays of N / R consecutive points each, view_dirs2
    (N, n_sec, 3), all f32.

    CUDA tensors launch the encode kernel (one pass, csrc/fused_mlp.cu
    `k1_encode_kernel`, counted as `k1.launches.k1_encode`), which reads a
    ray's direction through the sample stride, and has no backward: CUDA
    inputs that autograd tracks raise. CPU tensors take `encode_reference`,
    which stays differentiable."""
    mode = (dtype, torch.float32 if f32_heads else dtype)
    samples, n_sec = _check_encode(pts, view_dirs, view_dirs2, mode)
    if pts.device.type == "cpu":
        return encode_reference(pts, view_dirs, view_dirs2, dtype, fast, f32_heads)
    if pts.device.type != "cuda":
        raise ValueError(f"the encode runs on cuda or cpu tensors, not {pts.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (pts, view_dirs, view_dirs2)):
        raise ValueError("the encode kernel has no backward: on the card, pts and view directions "
                         "must not require grad")
    n, dev = pts.shape[0], pts.device
    xe = torch.empty((n, PTS_IN), dtype=mode[0], device=dev)
    ve = torch.empty((n, VIEW_IN), dtype=mode[1], device=dev)
    ve2 = torch.empty((n, VIEW_IN * n_sec), dtype=mode[1], device=dev) if n_sec else ve
    if n:
        fn = build.load("fused_mlp").vipnerf_k1_encode
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        inputs = [t.contiguous() for t in (pts, view_dirs)] + [view_dirs2.contiguous() if n_sec else None]
        with torch.cuda.device(dev):
            rc = fn(*(None if t is None else t.data_ptr() for t in inputs + [xe, ve, ve2 if n_sec else None]),
                    n, samples, n_sec, int(mode[0] == torch.float32), int(mode[1] == torch.float32), int(fast),
                    torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K1's encode launch failed: cudaError {rc}")
        tracing.count("k1.launches." + ENCODE)
    return xe, ve, ve2, n_sec


def fused_mlp_reference(
    layers, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, n_sec: int
) -> torch.Tensor:
    """K1's function in plain torch: f32 matmuls of dtype-valued tensors; in
    a bf16 layer each product is rounded to bf16 before the bias add, as the
    kernel does. Each layer runs in its packed weight's dtype: with f32 heads
    the trunk's bf16 h enters the heads exactly, and PE(dir) is f32. Returns
    (N, 8) in ve's dtype, the heads'. Stacked layers (S scenes) take S blocks
    of N/S rows, each through its own scene's layers, in turn."""
    if layers[0][0].dim() == 3:
        scenes = layers[0][0].shape[0]
        blocks = zip(*(t.chunk(scenes) for t in (xe, ve, ve2)))
        return torch.cat([fused_mlp_reference([(w[s], b[s]) for w, b in layers], *block, n_sec)
                          for s, block in enumerate(blocks)])

    def dense(x, i, relu):
        w, b = layers[i]
        y = x.float() @ w.float().t()
        y = (y.to(w.dtype).float() + b).to(w.dtype) if w.dtype == torch.bfloat16 else y + b
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
    return F.pad(out, (0, NOUT - out.shape[1])).to(ve.dtype)


def _entry(name: str, pointers: int):
    fn = getattr(build.load("fused_mlp"), "vipnerf_" + name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(dtype: torch.dtype, f32_heads: bool = False) -> Tuple[int, ...]:
    """Dynamic shared memory per CTA of each kernel the instance launches
    (builds them): bf16_f32h's trunk, then its heads."""
    lib = build.load("fused_mlp")
    if f32_heads and dtype == torch.bfloat16:
        return lib.vipnerf_fused_mlp_smem_bytes(1), lib.vipnerf_fused_mlp_smem_bytes(2)
    return (lib.vipnerf_fused_mlp_smem_bytes(int(dtype == torch.bfloat16)),)


def h_scratch_bytes(n: int, scenes: int) -> int:
    """Bytes of bf16_f32h's scratch for the trunk's h: a 32 KB slab image per
    64 rows, two per tile of each scene."""
    return scenes * -(-(n // scenes) // TILE_ROWS) * TILE_ROWS * WIDTH * 2


def h_scratch(n: int, scenes: int, device) -> torch.Tensor:
    """bf16_f32h's scratch for the trunk's h (`h_scratch_bytes`)."""
    return torch.empty((h_scratch_bytes(n, scenes) // (2 * WIDTH), WIDTH), dtype=torch.bfloat16, device=device)


def _check(weights: FusedWeights, xe, ve, ve2, n_sec: int):
    n = xe.shape[0]
    mode = weights.mode
    if mode not in INSTANCE:
        raise TypeError(f"K1 has no instance for a {mode[0]} trunk with {mode[1]} heads")
    if not 0 <= n_sec <= MAX_SEC:
        raise ValueError(f"n_sec must be in 0..{MAX_SEC}, got {n_sec}")
    expect = {
        "xe": (xe, (n, PTS_IN), mode[0]),
        "ve": (ve, (n, VIEW_IN), mode[1]),
        "ve2": (ve2, (n, VIEW_IN * max(n_sec, 1)), mode[1]),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, {INSTANCE[mode]} takes {dtype}")
        if t.device != xe.device:
            raise ValueError(f"{name} is on {t.device}, xe on {xe.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    w_bytes = weights.w_flat.numel() * weights.w_flat.element_size()
    if w_bytes != weights.scenes * PACK_BYTES[mode] or weights.b_flat.numel() != weights.scenes * B_NUMEL:
        raise ValueError("packed weights do not match the kernel's layer table")
    if n % weights.scenes:
        raise ValueError(f"{n} rows do not split into {weights.scenes} scenes")
    if weights.w_flat.device != xe.device:
        raise ValueError(f"weights on {weights.w_flat.device}, inputs on {xe.device}")


def _launch(fn, weights: FusedWeights, xe, n_sec: int, pointers) -> None:
    """Runs the C entry `fn` on the current stream: the tensors' pointers,
    then the scene count, the rows per scene, n_sec and the stream."""
    stream = torch.cuda.current_stream(xe.device).cuda_stream
    with torch.cuda.device(xe.device):
        rc = fn(*(t.data_ptr() for t in pointers), weights.scenes, xe.shape[0] // weights.scenes, n_sec, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")


def _output(weights: FusedWeights, xe) -> torch.Tensor:
    return torch.empty((xe.shape[0], NOUT), dtype=weights.mode[1], device=xe.device)


def fused_mlp_raw(
    weights: FusedWeights, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor,
    n_sec: int,
) -> torch.Tensor:
    """K1 on (xe, ve, ve2) -> raw (N, 8) outputs, in the heads' dtype; with
    stacked weights of S scenes, N/S rows per scene, one call for all. CPU
    tensors take the plain version; CUDA tensors launch the instance on the
    current stream (bf16_f32h: its trunk, then its heads, one count)."""
    _check(weights, xe, ve, ve2, n_sec)
    if n_sec:
        tracing.count(SEC_VIEW_POINTS, xe.shape[0] * n_sec)
    if xe.device.type == "cpu":
        return fused_mlp_reference(weights.layers, xe, ve, ve2, n_sec)
    if xe.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, not {xe.device}")
    out = _output(weights, xe)
    if xe.shape[0] == 0:
        return out
    mode = weights.mode
    tensors = [xe, ve, ve2, weights.w_flat, weights.b_flat]
    if mode[0] != mode[1]:  # bf16_f32h: scratch for the trunk's h, which its heads' kernel reads back
        tensors.append(h_scratch(xe.shape[0], weights.scenes, xe.device))
    _launch(_entry(INSTANCE[mode], len(tensors) + 1), weights, xe, n_sec, tensors + [out])
    tracing.count("k1.launches." + INSTANCE[mode])
    return out


def module_params(mlp) -> List[torch.Tensor]:
    """The flagship MLP's parameters in `raw_recompute`'s order: trunk 0..7
    (weight, bias each), feature, sigma head, view hidden, view output."""
    linears = list(mlp.pts_linears) + [
        mlp.feature_linear, mlp.pts_output_linear, mlp.views_linears[0],
        mlp.views_output_linear,
    ]
    return [p for lin in linears for p in (lin.weight, lin.bias)]


def _recompute_layers(params, dtype: torch.dtype, first: int = 0):
    """Layers first, first + 1, ... of the module's parameters
    (`module_params` order, from that layer on) in `dtype`, the zero padding
    built in from the real weights (so it takes no gradient)."""
    w = {first + i: p.to(dtype) for i, p in enumerate(params[0::2])}
    b = {first + i: p.to(dtype) for i, p in enumerate(params[1::2])}
    if 0 in w:
        w[0] = F.pad(w[0], (0, 1))
        w[5] = torch.cat([w[5][..., :63], w[5].new_zeros(*w[5].shape[:-1], 1), w[5][..., 63:]], dim=-1)
    if VIEW in w:
        w[VIEW] = F.pad(w[VIEW], (0, VIEW_IN - 27))
    return w, b


def _dense(x, w, b, relu):
    y = scene_matmul(x, w) + b[:, None] if x.dim() == 3 else F.linear(x, w) + b
    return torch.relu(y) if relu else y


def trunk_recompute(params, xe: torch.Tensor) -> torch.Tensor:
    """Layers 0-7 of `raw_recompute` on the trunk's parameters (the first 16
    of `module_params`): h after the last ReLU, in xe's dtype; (S, N/S, 256)
    for stacked parameters."""
    w, b = _recompute_layers(params, xe.dtype)
    if w[0].dim() == 3:  # (S, N/S, cols): a product per scene
        xe = xe.reshape(w[0].shape[0], -1, xe.shape[-1])
    h = _dense(xe, w[0], b[0], True)
    for i in range(1, 5):
        h = _dense(h, w[i], b[i], True)
    h = _dense(torch.cat([xe, h], dim=-1), w[5], b[5], True)
    for i in (6, 7):
        h = _dense(h, w[i], b[i], True)
    return h


def heads_recompute(params, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, n_sec: int) -> torch.Tensor:
    """Layers 8-11 of `raw_recompute` on h (the trunk's output, cast here to
    ve's dtype) and the heads' parameters (the last 8 of `module_params`):
    raw (N, 8). In f32 (TF32 off) on K1's own h (`trunk_activations`' h8)
    it is the plain version that the card holds bf16_f32h's tensor-core
    heads to."""
    n = ve.shape[0]
    w, b = _recompute_layers(params, ve.dtype, FEATURE)
    if w[FEATURE].dim() == 3:
        h, ve, ve2 = (t.reshape(w[FEATURE].shape[0], -1, t.shape[-1]) for t in (h, ve, ve2))
    h = h.to(ve.dtype)
    feature = _dense(h, w[FEATURE], b[FEATURE], False)
    sigma = _dense(h, w[SIGMA], b[SIGMA], False)

    def view_branch(enc_v):
        hv = _dense(torch.cat([feature, enc_v], dim=-1), w[VIEW], b[VIEW], True)
        return _dense(hv, w[VIEW_OUT], b[VIEW_OUT], False)

    cols = [sigma, view_branch(ve)]
    for j in range(n_sec):
        cols.append(view_branch(ve2[..., j * VIEW_IN:(j + 1) * VIEW_IN])[..., 3:4])
    out = torch.cat(cols, dim=-1)
    return F.pad(out, (0, NOUT - out.shape[-1])).reshape(n, NOUT)


def raw_recompute(
    params, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, n_sec: int
) -> torch.Tensor:
    """K1's raw (N, 8) output as a differentiable torch function of the
    module's real parameters (`module_params` order); the counterpart of
    `_raw_xla`. The trunk runs in xe's dtype, the heads in ve's (the
    instance's mode), on h cast to it after layer 7 as models/mlp.py does
    with f32 heads; the output is in ve's dtype. Zero padding is built from
    the real weights with `F.pad`/`torch.cat`, so it takes no gradient; in
    bf16 each product is rounded to bf16 before the bf16 bias add. Unlike
    `fused_mlp_reference`, the products run in the working dtype (cuBLAS on
    the card), as XLA's do. Stacked parameters (S scenes) take S blocks of
    N/S rows and run each layer as one batched product over the scenes."""
    return heads_recompute(params[2 * FEATURE:], trunk_recompute(params[:2 * FEATURE], xe), ve, ve2, n_sec)


def _secondary_grad_out(g: torch.Tensor, v: int) -> torch.Tensor:
    """d o_v, the upstream gradient of view v's output layer: g[:, 1:5] for
    the primary view, [0, 0, 0, g[:, 4 + v]] for secondary view v (only its
    visibility is an output)."""
    return g[:, 1:5] if v == 0 else F.pad(g[:, 4 + v:5 + v], (3, 0))


class HeadsIntermediates(NamedTuple):
    """The shipped mode's heads backward between its two kernels, per point
    (the rows of every scene in turn), with V = 1 + n_sec views: d h (N,
    256) bf16; f32 feature and d feature (N, 256), D = sum_v d hv_v (N,
    128), hv_v and d hv_v (N, V, 128); d ve (N, 32) and d ve2 (N, 32 n_sec),
    or None."""

    d_h: torch.Tensor
    feature: torch.Tensor
    d_feature: torch.Tensor
    D: torch.Tensor
    hv: torch.Tensor
    d_hv: torch.Tensor
    d_ve: Optional[torch.Tensor]
    d_ve2: Optional[torch.Tensor]


def heads_points_reference(params, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, g: torch.Tensor,
                           n_sec: int) -> HeadsIntermediates:
    """The per-point kernel's function in plain torch, in the parameters'
    dtype: on h (N, 256) bf16, the trunk's output, PE(dir) ve and ve2, the
    upstream gradient g (N, 8) and the heads' parameters (the last 8 of
    `module_params`: W8, b8, W9, b9, W10, b10, W11, b11, each with a leading
    scene axis for S scenes of N/S rows), it recomputes feature = h W8^T +
    b8 and each view's hv_v = relu([feature, pe_v] W10^T + b10), then d hv_v
    = (d o_v W11) [hv_v > 0], D, d feature = D W10[:, :256] and d h = d
    feature W8 + d sigma W9, rounded to bf16 where autograd's backward of
    the cast to f32 rounds it, and d pe_v = d hv_v W10[:, 256:] (zero on the
    padding columns)."""
    if params[0].dim() == 3:
        scenes = params[0].shape[0]
        per = [heads_points_reference([p[s] for p in params], *block, n_sec)
               for s, block in enumerate(zip(*(t.chunk(scenes) for t in (h, ve, ve2, g))))]
        return HeadsIntermediates(*(None if per[0][i] is None else torch.cat([r[i] for r in per])
                                    for i in range(len(per[0]))))
    w8, b8, w9, _, w10, b10, w11, _ = params
    feature = h.to(w8.dtype) @ w8.t() + b8
    views = [ve] + [ve2[:, j * VIEW_IN:(j + 1) * VIEW_IN] for j in range(n_sec)]
    hvs, d_hvs, d_pe = [], [], []
    for v, pe in enumerate(views):
        hv = torch.relu(torch.cat([feature, pe[:, :27]], dim=1) @ w10.t() + b10)
        d_hvs.append((_secondary_grad_out(g, v) @ w11) * (hv > 0))
        hvs.append(hv)
        d_pe.append(F.pad(d_hvs[-1] @ w10[:, WIDTH:], (0, VIEW_IN - 27)))
    D = sum(d_hvs)
    d_feature = D @ w10[:, :WIDTH]
    d_h = (d_feature @ w8 + g[:, :1] @ w9).to(torch.bfloat16)
    return HeadsIntermediates(d_h, feature, d_feature, D, torch.stack(hvs, 1), torch.stack(d_hvs, 1), d_pe[0],
                              torch.cat(d_pe[1:], dim=1) if n_sec else None)


def _view_rows(ve: torch.Tensor, ve2: torch.Tensor, g: torch.Tensor, n_sec: int):
    """PE(dir) (27 real columns) and d o of every (point, view) pair, in the
    order of the per-point intermediates' rows (point after point, its
    views in turn)."""
    pe = torch.stack([ve[:, :27]] + [ve2[:, j * VIEW_IN:j * VIEW_IN + 27] for j in range(n_sec)], 1)
    d_o = torch.stack([_secondary_grad_out(g, v) for v in range(1 + n_sec)], 1)
    return pe.reshape(-1, 27), d_o.reshape(-1, 4)


def heads_weights_reference(mid: HeadsIntermediates, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor,
                            g: torch.Tensor, scenes: int = 1, stacked: bool = False):
    """The weight-gradient kernel's function in plain torch, in the
    intermediates' dtype: per scene, dW8 = d feature^T h, dW9 = d sigma^T
    h, dW10 = [D^T feature, sum_v d hv_v^T pe_v], dW11 = sum_v d o_v^T
    hv_v, and the biases' column sums, in the module's shapes (with a
    leading scene axis if `stacked`). h, PE(dir) and g are the per-point
    kernel's inputs."""
    n_sec = mid.hv.shape[1] - 1
    per = []
    for s in range(scenes):
        t = [x.chunk(scenes)[s] for x in (h, ve, ve2, g, mid.feature, mid.d_feature, mid.D, mid.hv, mid.d_hv)]
        hs, ves, ve2s, gs, feature, d_feature, D, hv, d_hv = t
        hs = hs.to(feature.dtype)
        pe, d_o = _view_rows(ves.to(feature.dtype), ve2s.to(feature.dtype), gs.to(feature.dtype), n_sec)
        flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731  the (point, view) rows
        d_sigma = gs[:, :1].to(feature.dtype)
        per.append([d_feature.t() @ hs, d_feature.sum(0), d_sigma.t() @ hs, d_sigma.sum(0),
                    torch.cat([D.t() @ feature, flat(d_hv).t() @ pe], dim=1), D.sum(0),
                    d_o.t() @ flat(hv), d_o.sum(0)])
    if stacked:
        return [torch.stack([p[i] for p in per]) for i in range(8)]
    return per[0]


def heads_backward_reference(params, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, g: torch.Tensor,
                             n_sec: int):
    """The shipped mode's heads backward in plain torch, both kernels'
    functions in turn (`heads_points_reference`, then
    `heads_weights_reference`) in the parameters' dtype. Returns (d h, the 8
    parameters' gradients in their shapes, d ve, d ve2 (None with no
    secondary view))."""
    stacked = params[0].dim() == 3
    mid = heads_points_reference(params, h, ve, ve2, g.to(params[0].dtype), n_sec)
    grads = heads_weights_reference(mid, h, ve, ve2, g, params[0].shape[0] if stacked else 1, stacked)
    return mid.d_h, grads, mid.d_ve, mid.d_ve2


def heads_backward_recompute(params, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, g: torch.Tensor,
                             n_sec: int):
    """The heads backward as the shipped mode computed it before it had
    kernels: autograd through the f32 heads of `raw_recompute` (cuBLAS f32
    products on the card), the same returns as `heads_backward_reference`.
    The kernels' yardstick; nothing on a path calls it."""
    inputs = [t.detach().requires_grad_() for t in [h, ve, ve2] + list(params)]
    with torch.enable_grad():
        out = heads_recompute(inputs[3:], inputs[0], inputs[1], inputs[2] if n_sec else inputs[1], n_sec)
        grads = torch.autograd.grad(out, inputs if n_sec else inputs[:2] + inputs[3:], g.to(out.dtype))
    if not n_sec:
        grads = grads[:2] + (None,) + grads[2:]
    return grads[0].reshape(h.shape), list(grads[3:]), grads[1], grads[2]


# the heads backward's two kernels, in launch order (each wrapper has its name)
BWD_KERNELS = ("heads_bwd_points", "heads_bwd_weights")
# csrc/fused_mlp_bwd.cu's arithmetic: the per-point kernel's part products
# run BWD_CHAIN k16 steps into a fresh accumulator before they join the
# total; the weight kernel's accumulator runs BWD_PROMOTE k16 steps (a block
# of BWD_BLOCK points, its part products ordered by size over the block)
# before a Fast2Sum moves it into the total; a CTA reduces BWD_KSPLIT points
# (per view for dW10's PE(dir) columns), BWD_KSPLIT_SMALL for the small jobs
# (dW9, dW11, b9, b11, in f64 on the CUDA cores)
BWD_CHAIN = 1
BWD_PROMOTE = 2
BWD_BLOCK = 16 * BWD_PROMOTE
BWD_KSPLIT = 8192
BWD_KSPLIT_SMALL = 2048
# bf16 products per point of the two kernels (real widths, split products
# counted as `F32H_SPLIT_MACS` counts them): the per-point kernel's feature
# (h times W8's three parts), G = feature W10f^T, d feature and d h (six
# each); per view PE(dir) W10p^T, and d hv W10p where d PE(dir) is asked for
# (six each). The weight kernel's dW8 and dW9 (three), dW10's feature
# columns (six); per view dW10's PE(dir) columns and dW11's live rows (six):
# four for the primary view, one (column 3 of d o) for a secondary one.
BWD_POINT_MACS = 3 * WIDTH * WIDTH + 6 * (128 * WIDTH + WIDTH * 128 + WIDTH * WIDTH)
BWD_POINT_MACS_PER_VIEW = 6 * 27 * 128
BWD_WEIGHT_MACS = 3 * (WIDTH * WIDTH + WIDTH) + 6 * (128 * WIDTH + 3 * 128)
BWD_WEIGHT_MACS_PER_VIEW = 6 * (128 * 27 + 128)


def bwd_bytes(n: int, n_sec: int, scenes: int = 1, need_ve: bool = False) -> Tuple[int, int]:
    """Bytes each heads-backward kernel reads and writes once for n points:
    the per-point kernel's h, PE(dir), g and weight image in, d h and the
    intermediates of `HeadsIntermediates` (feature, d feature, D, hv_v, d
    hv_v) out; the weight kernel's intermediates, h, PE(dir) and g in, the
    gradients out."""
    views = 1 + n_sec
    inputs = n * (2 * WIDTH + 4 * VIEW_IN * views + 4 * NOUT)  # h, PE(dir), g
    mid = n * (4 * (2 * WIDTH + 128) + views * 4 * 2 * 128)  # feature, d feature, D; per view hv, d hv
    grads = scenes * 4 * (HEAD_NUMEL + WIDTH + 1 + 128 + 4)
    points = inputs + scenes * (2 * BWD_IMG_NUMEL + 4 * BWD_SMALL_NUMEL) + n * 2 * WIDTH + mid \
        + (n * 4 * VIEW_IN * views if need_ve else 0)
    return points, inputs + mid + grads


# The weight kernel's jobs in grid order: (name, X columns, Y columns of an
# output tile, tiles per scene), and the doubles of one CTA's share (the
# tile's entries, then X's column sums; the small jobs' dW11, dW9, b11, b9)
BWD_WEIGHT_JOBS = (("small", 0, 0, 1), ("dW10f", 128, 128, 2), ("dW8", 64, 256, 4), ("dW10p", 128, 32, 1))


def bwd_weight_grid(scenes: int, nps: int, n_sec: int) -> Dict[str, Any]:
    """The weight kernel's grids as csrc/fused_mlp_bwd.cu's make_wargs lays
    them out: per job its tiles, its CTAs per tile (a share each: BWD_KSPLIT
    points, per view for dW10p; BWD_KSPLIT_SMALL for the small jobs) and
    doubles per share; in all, the doubles of the shares, the first
    launch's CTAs and the second launch's threads (an entry of a tile's
    share each, summed over the tile's shares)."""
    nsplit = -(-nps // BWD_KSPLIT) if nps else 1
    jobs, entries, doubles, ctas = {}, 0, 0, 0
    for name, mt, nt, per_scene in BWD_WEIGHT_JOBS:
        if name == "small":
            splits, pw = (-(-nps // BWD_KSPLIT_SMALL) if nps else 1), 4 * 128 + WIDTH + 4 + 1
        else:
            splits, pw = nsplit * ((1 + n_sec) if name == "dW10p" else 1), mt * nt + (0 if name == "dW10p" else mt)
        jobs[name] = {"tiles": per_scene, "splits": splits, "share_doubles": pw, "cta0": ctas}
        entries += scenes * per_scene * pw
        doubles += scenes * per_scene * splits * pw
        ctas += scenes * per_scene * splits
    return {"jobs": jobs, "doubles": doubles, "ctas": ctas, "share_entries": entries}


def bwd_mn_layout(cols: int) -> Dict[str, int]:
    """One part of the weight kernel's MN-major operand slab for a block of
    BWD_BLOCK points and `cols` columns (csrc/fused_mlp_bwd.cu mn_off and
    the descriptors of its wgmma): the swizzle (bytes per row: 128, or 64
    for 32 columns), the leading byte offset (one atom of swizzle / 2
    columns to the next), the stride byte offset (8 rows to the next 8) and
    the part's bytes."""
    sw = 64 if cols == 32 else 128
    return {"swizzle": sw, "lbo": BWD_BLOCK * sw, "sbo": 8 * sw, "part_bytes": BWD_BLOCK * cols * 2}


def bwd_mn_offset(k: int, c: int, cols: int) -> int:
    """Byte offset of (point k of the block, column c) in that slab: atom c
    // (swizzle / 2), row k of it, the 16-byte piece XORed with k % 8 (128)
    or k // 2 % 4 (64), as the hardware's swizzle reads it."""
    lay = bwd_mn_layout(cols)
    sw = lay["swizzle"]
    atom = sw // 2
    piece = (c % atom) // 8 ^ (k % 8 if sw == 128 else k // 2 % 4)
    return (c // atom) * lay["lbo"] + k * sw + (piece << 4) + (c % 8) * 2


def bwd_stream_bytes(kernel: str, n: int, n_sec: int, scenes: int = 1, need_ve: bool = False) -> int:
    """Bytes one launch of a heads-backward kernel (`BWD_KERNELS`) on n
    points moves through L2 by its design, counted from its tiles, not
    measured: the per-point kernel's passes over the weight stream, one per
    128-point tile; the weight kernel's rows of X and Y, each CTA reading
    its output tile's columns of its points."""
    views, dve = 1 + n_sec, int(need_ve)
    tiles = scenes * -(-(n // scenes) // TILE_ROWS)
    if kernel == "heads_bwd_points":
        return tiles * (48 + views * (1 + dve)) * BWD_CHUNK
    if kernel == "heads_bwd_weights":  # dW8 (4 tiles), dW10f (2), dW10p per view, the small jobs
        per_point = 4 * (4 * 64 + 2 * WIDTH) + 2 * (4 * 128 + 4 * 128) + views * (4 * 128 + 4 * VIEW_IN) \
            + 4 * NOUT + 2 * WIDTH + views * 4 * 128
        return n * per_point
    raise ValueError(f"no heads-backward kernel {kernel}")


def _bwd_fns():
    """The heads backward's C entries: per-point, weights, scratch."""
    lib = build.load("fused_mlp_bwd")
    fns = [lib.vipnerf_heads_bwd_points, lib.vipnerf_heads_bwd_weights, lib.vipnerf_heads_bwd_scratch]
    if fns[0].argtypes is None:
        fns[0].argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fns[1].argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[2].argtypes = [ctypes.c_int] * 4
        fns[0].restype = fns[1].restype = ctypes.c_int
        fns[2].restype = ctypes.c_longlong
    return fns


def _check_heads_inputs(weights: FusedWeights, h, ve, ve2, g, n_sec: int):
    if weights.mode != (torch.bfloat16, torch.float32):
        raise TypeError(f"the heads backward takes bf16_f32h weights, not {INSTANCE[weights.mode]}'s")
    n = h.shape[0]
    _check(weights, torch.empty((n, PTS_IN), dtype=torch.bfloat16, device=h.device), ve, ve2, n_sec)
    if tuple(h.shape) != (n, WIDTH) or h.dtype != torch.bfloat16 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous ({n}, {WIDTH}) bf16 tensor")
    if tuple(g.shape) != (n, NOUT) or g.dtype != torch.float32 or g.device != h.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous ({n}, {NOUT}) f32 tensor on {h.device}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the heads backward runs on cuda or cpu tensors, not {h.device}")


def _launch_points(weights: FusedWeights, h, ve, ve2, g, n_sec: int, need_ve: bool, need_ve2: bool
                   ) -> HeadsIntermediates:
    """One launch of the per-point kernel on CUDA tensors (or none for no
    points): its outputs, allocated here."""
    n, views, dev = h.shape[0], 1 + n_sec, h.device
    f32 = dict(dtype=torch.float32, device=dev)
    mid = HeadsIntermediates(
        torch.empty((n, WIDTH), dtype=torch.bfloat16, device=dev), torch.empty((n, WIDTH), **f32),
        torch.empty((n, WIDTH), **f32), torch.empty((n, 128), **f32), torch.empty((n, views, 128), **f32),
        torch.empty((n, views, 128), **f32), torch.empty((n, VIEW_IN), **f32) if need_ve else None,
        torch.empty((n, VIEW_IN * n_sec), **f32) if need_ve2 and n_sec else None)
    if n:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            rc = _bwd_fns()[0](
                *map(ptr, (h, ve, ve2, g, weights.heads_bwd_stream, weights.heads_bwd_small, *mid)),
                weights.scenes, n // weights.scenes, n_sec, int(need_ve or need_ve2),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"heads backward, per-point kernel: launch failed: cudaError {rc}")
    return mid


def _launch_weights(mid: HeadsIntermediates, h, ve, ve2, g, scenes: int, stacked: bool):
    """One launch of the weight-gradient kernel on CUDA tensors: the 8
    gradients in the module's shapes (with the scene axis if `stacked`)."""
    n, dev = h.shape[0], h.device
    n_sec = mid.hv.shape[1] - 1
    shapes = ((h, (n, WIDTH)), (ve, (n, VIEW_IN)), (ve2, (n, VIEW_IN * max(n_sec, 1))), (g, (n, NOUT)))
    if n % scenes or mid.hv.shape[0] != n or mid.D.dtype != torch.float32 or h.dtype != torch.bfloat16 \
            or any(tuple(t.shape) != shape or not t.is_contiguous() or (t is not h and t.dtype != torch.float32)
                   for t, shape in shapes):
        raise ValueError("the per-point intermediates, h, PE(dir) and g do not match")
    _, launch, scratch = _bwd_fns()
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty((scenes, *shape), **f32) for shape in (
        (WIDTH, WIDTH), (1, WIDTH), (128, WIDTH), (128, VIEW_IN), (4, 128), (WIDTH,), (1,), (128,), (4,))]
    nps = n // scenes
    shares = torch.empty(max(scratch(scenes, nps, n_sec, 1), 1), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = launch(*(t.data_ptr() for t in (h, g, ve, ve2, mid.feature, mid.d_feature, mid.D, mid.hv, mid.d_hv,
                                             *outs, shares)),
                    scenes, nps, n_sec, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"heads backward, weight-gradient kernel: launch failed: cudaError {rc}")
    w8, w9, w10f, w10p, w11, b8, b9, b10, b11 = outs
    grads = [w8, b8, w9, b9, torch.cat([w10f, w10p[..., :27]], dim=-1), b10, w11, b11]
    return grads if stacked else [t[0] for t in grads]


def heads_bwd_points(weights: FusedWeights, params, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor,
                     g: torch.Tensor, n_sec: int, need_ve: bool = True, need_ve2: bool = True
                     ) -> HeadsIntermediates:
    """The heads backward's per-point kernel (`heads_points_reference`'s
    function) for bf16_f32h `weights` and the heads' parameters they were
    packed from: CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream (or raise), d PE(dir) only where
    `need_ve`/`need_ve2` ask."""
    _check_heads_inputs(weights, h, ve, ve2, g, n_sec)
    if h.device.type == "cpu":
        return heads_points_reference(params, h, ve, ve2, g, n_sec)
    mid = _launch_points(weights, h, ve, ve2, g, n_sec, need_ve, need_ve2)
    if h.shape[0]:
        tracing.count("k1.launches.heads_bwd_points")
    return mid


def heads_bwd_weights(mid: HeadsIntermediates, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor, g: torch.Tensor,
                      scenes: int = 1, stacked: bool = False):
    """The heads backward's weight-gradient kernel (`heads_weights_reference`'s
    function) on the per-point kernel's inputs (h, PE(dir), g, as
    `heads_bwd_points` took them) and outputs: CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream (or
    raise): split-K products over the points, each CTA's share in f64, the
    shares summed in a fixed order by a second launch."""
    if h.device.type == "cpu":
        return heads_weights_reference(mid, h, ve, ve2, g, scenes, stacked)
    grads = _launch_weights(mid, h, ve, ve2, g, scenes, stacked)
    tracing.count("k1.launches.heads_bwd_weights")
    return grads


def heads_backward(weights: FusedWeights, params, h: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor,
                   g: torch.Tensor, n_sec: int, need_ve: bool = True, need_ve2: bool = True):
    """The shipped mode's heads backward (`heads_backward_reference`'s
    function and returns) for bf16_f32h `weights` and the heads' parameters
    they were packed from: on CUDA tensors `heads_bwd_points`, then
    `heads_bwd_weights` (each launches its kernel); on CPU tensors
    `heads_backward_reference`."""
    if h.device.type == "cpu":
        _check_heads_inputs(weights, h, ve, ve2, g, n_sec)
        return heads_backward_reference(params, h, ve, ve2, g, n_sec)
    mid = heads_bwd_points(weights, params, h, ve, ve2, g, n_sec, need_ve, need_ve2)
    grads = heads_bwd_weights(mid, h, ve, ve2, g, weights.scenes, params[0].dim() == 3)
    return mid.d_h, grads, mid.d_ve, mid.d_ve2


def launches(kernels=FORWARD) -> Dict[str, int]:
    """Launches on the card of each of `kernels` since the tracer's last
    reset (by default K1's forward instances)."""
    table = tracing.counts("k1.launches.")
    return {k: table.get(f"k1.launches.{k}", 0) for k in kernels}


class FusedRaw(torch.autograd.Function):
    """K1 with a gradient: forward launches the kernel (the plain version on
    the CPU); backward recomputes through `raw_recompute` and differentiates
    that, for the parameters and for xe/ve/ve2 where they need it. In the
    shipped mode (bf16_f32h) the recompute stops at the trunk's h: the heads'
    gradients and d h come from `heads_backward`, and one autograd pass takes
    d h back through the trunk."""

    @staticmethod
    def forward(ctx, weights: FusedWeights, n_sec: int, xe, ve, ve2, *params):
        ctx.n_sec = n_sec
        ctx.weights = weights
        ctx.save_for_backward(xe, ve, ve2, *params)
        return fused_mlp_raw(weights, xe, ve, ve2, n_sec)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        if ctx.weights.mode == (torch.bfloat16, torch.float32):
            return (None, None) + _f32h_backward(ctx.weights, ctx.n_sec, saved, needs, g)
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        with torch.enable_grad():
            out = raw_recompute(inputs[3:], *inputs[:3], ctx.n_sec)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype), allow_unused=True))
        return (None, None) + tuple(next(grads) if t.requires_grad else None for t in inputs)


def _f32h_backward(weights: FusedWeights, n_sec: int, saved, needs, g):
    """FusedRaw's backward in the shipped mode. CUDA tensors: the trunk's
    recompute (`trunk_activations`), the heads' gradients and d h from
    `heads_backward`, then the trunk's gradients (`trunk_backward`), both
    trunk parts inside a `TRUNK_SPAN` span timed on the device; xe takes no
    gradient there (the encode kernel has none either), so a tracked xe
    raises. CPU tensors (the plain version): the trunk recomputed with
    autograd up to h, the heads as on the card, then one
    `torch.autograd.grad` of h for the trunk's parameters and xe. Returns
    the gradients of (xe, ve, ve2, *params)."""
    xe, ve, ve2, *params = saved
    head = 2 * FEATURE
    head_params = [p.detach() for p in params[head:]]
    need_ve, need_ve2 = needs[1], needs[2] and n_sec > 0
    if xe.device.type == "cuda":
        if needs[0]:
            raise ValueError("on the card the shipped mode's backward gives xe no gradient: "
                             "xe must not require grad")
        with tracing.span(TRUNK_SPAN, xe.device, part="recompute"):
            act = trunk_activations(weights, xe)
        d_h, head_grads, d_ve, d_ve2 = heads_backward(weights, head_params, act.h8, ve, ve2, g.float(), n_sec,
                                                      need_ve, need_ve2)
        with tracing.span(TRUNK_SPAN, xe.device, part="layers"):
            trunk_grads = [None] + trunk_backward(weights, act, d_h, params[0].dim() == 3)
    else:
        trunk = [t.detach().requires_grad_(need)
                 for t, need in zip([xe] + params[:head], (needs[0],) + needs[3:3 + head])]
        with torch.enable_grad():
            h = trunk_recompute(trunk[1:], trunk[0])
        d_h, head_grads, d_ve, d_ve2 = heads_backward(weights, head_params, h.detach().reshape(-1, WIDTH).contiguous(),
                                                      ve, ve2, g.float(), n_sec, need_ve, need_ve2)
        wanted = [t for t in trunk if t.requires_grad]
        grads = iter(torch.autograd.grad(h, wanted, d_h.reshape(h.shape), allow_unused=True) if wanted else ())
        trunk_grads = [next(grads) if t.requires_grad else None for t in trunk]
    trunk_grads = [gr if need else None for gr, need in zip(trunk_grads, needs[:1] + needs[3:3 + head])]
    head_grads = [gr if need else None for gr, need in zip(head_grads, needs[3 + head:])]
    return (trunk_grads[0], d_ve if needs[1] else None, d_ve2 if needs[2] else None,
            *trunk_grads[1:], *head_grads)


# The shipped mode's trunk backward on the card: the recompute kernel
# (csrc/fused_mlp.cu `trunk_recompute_kernel`, behind `trunk_activations`)
# and the layers' gradient kernels (csrc/fused_mlp_bwd.cu `trunk_bwd_*`,
# behind `trunk_backward`), each wrapper call counted as
# `k1.launches.<name>`; `TRUNK_SPAN` spans (`part` "recompute", "layers")
# time both on the device.
TRUNK_KERNELS = ("trunk_recompute", "trunk_backward")
TRUNK_SPAN = "k1.trunk_backward"
TRUNK_IMAGES = FEATURE - 1  # h1..h7 kept as images; h8 row-major


# multiply-adds per point of the trunk's backward, padded widths: the
# recompute (layers 0-7), the weight gradients (as many), the input
# gradients of layers 7..1 (h's 256 columns at layer 5; xe takes none)
TRUNK_BWD_MACS = 2 * TRUNK_NUMEL + 7 * WIDTH * WIDTH


def trunk_bwd_bytes(n: int, passes: int = 1) -> int:
    """Bytes the trunk's backward must move for n points if each layer's
    products read their (d, X) once (`passes` 1, the fused bound) or once
    per product (2, this design): the recompute reads xe and writes h1..h8,
    the backward reads d h and h8, then per layer reads d and X (xe's 64
    columns at layer 0, [xe, h5] at layer 5) and writes d of the layer
    below (but layer 0)."""
    d, x = 2 * WIDTH, [2 * k for k in (PTS_IN, WIDTH, WIDTH, WIDTH, WIDTH, PTS_IN + WIDTH, WIDTH, WIDTH)]
    per_layer = passes * (FEATURE * d + sum(x)) + (FEATURE - 1) * d
    return n * (2 * PTS_IN + FEATURE * d + 2 * d + per_layer)


class TrunkActivations(NamedTuple):
    """What the trunk's recompute keeps for its backward, for n points of
    `scenes` scenes: xe's and h1..h7's slab images (per 64 rows, the
    64-column slabs with the 128-byte swizzle that K1 holds in shared
    memory; 64-row blocks of each scene's 128-row tiles, as `h_scratch`),
    and h8, the trunk's output, (n, 256) row-major: the h the heads take."""

    xe_img: torch.Tensor  # (rows, 64) bf16, rows = h_scratch_bytes(n, scenes) / 512
    h_img: torch.Tensor  # (TRUNK_IMAGES, rows, 256) bf16
    h8: torch.Tensor  # (n, 256) bf16


def trunk_image(t: torch.Tensor, scenes: int = 1) -> torch.Tensor:
    """(n, c) rows of `scenes` scenes -> their slab image as `TrunkActivations`
    holds it (rows past a scene's end zero): the layout's definition in
    plain torch, for the tests."""
    n, c = t.shape
    nps = n // scenes
    per = -(-nps // TILE_ROWS) * TILE_ROWS
    padded = F.pad(t.reshape(scenes, nps, c), (0, 0, 0, per - nps)).reshape(-1, 64, c // SLAB_K, SLAB_K)
    r = torch.arange(64, device=t.device)[:, None]
    q = torch.arange(SLAB_K // 8, device=t.device)[None, :]
    blocks = padded.permute(0, 2, 1, 3).reshape(-1, c // SLAB_K, 64, SLAB_K // 8, 8)
    out = torch.empty_like(blocks)
    out[:, :, r, q ^ (r & 7)] = blocks
    return out.reshape(-1, c)


def _check_trunk(weights: FusedWeights, xe: torch.Tensor) -> None:
    if weights.mode != (torch.bfloat16, torch.float32):
        raise TypeError(f"the trunk's backward kernels take bf16_f32h weights, not {INSTANCE[weights.mode]}'s")
    if xe.dim() != 2 or xe.shape[1] != PTS_IN or xe.dtype != torch.bfloat16 or not xe.is_contiguous():
        raise ValueError(f"xe must be a contiguous (N, {PTS_IN}) bf16 tensor, not {tuple(xe.shape)} {xe.dtype}")
    if xe.device.type != "cuda":
        raise ValueError(f"the trunk's backward kernels run on cuda tensors only, not {xe.device}")
    if xe.shape[0] % weights.scenes:
        raise ValueError(f"{xe.shape[0]} rows do not split into {weights.scenes} scenes")
    if weights.w_flat.device != xe.device:
        raise ValueError(f"weights on {weights.w_flat.device}, xe on {xe.device}")


def trunk_activations(weights: FusedWeights, xe: torch.Tensor) -> TrunkActivations:
    """The trunk's recompute for its backward on the card: one launch of
    `trunk_recompute_kernel` (K1's trunk, layer for layer: h8 is K1's
    forward h bit for bit), counted as `k1.launches.trunk_recompute`."""
    _check_trunk(weights, xe)
    n, scenes, dev = xe.shape[0], weights.scenes, xe.device
    rows = h_scratch_bytes(n, scenes) // (2 * WIDTH)
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    act = TrunkActivations(torch.empty((rows, PTS_IN), **bf16), torch.empty((TRUNK_IMAGES, rows, WIDTH), **bf16),
                           torch.empty((n, WIDTH), **bf16))
    if n:
        fn = build.load("fused_mlp").vipnerf_trunk_recompute
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        with torch.cuda.device(dev):
            rc = fn(xe.data_ptr(), weights.w_flat.data_ptr(), weights.b_flat.data_ptr(), act.xe_img.data_ptr(),
                    act.h_img.data_ptr(), act.h8.data_ptr(), scenes, n // scenes, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the trunk's recompute launch failed: cudaError {rc}")
        tracing.count("k1.launches.trunk_recompute")
    return act


def trunk_grad_shapes(scenes: int) -> List[Tuple[int, ...]]:
    """The trunk's 16 parameters' shapes, `module_params` order, with the
    scene axis."""
    ins = [63, WIDTH, WIDTH, WIDTH, WIDTH, 319, WIDTH, WIDTH]
    return [shape for k in ins for shape in ((scenes, WIDTH, k), (scenes, WIDTH))]


def trunk_backward(weights: FusedWeights, act: TrunkActivations, d_h: torch.Tensor, stacked: bool = False
                   ) -> List[torch.Tensor]:
    """The trunk's gradients on the card from d h (n, 256) bf16 and the
    recompute's activations: one call of the layers' kernels (dX, dW and
    its reduce per layer, csrc/fused_mlp_bwd.cu), counted as
    `k1.launches.trunk_backward`. Returns the 16 parameters' f32 gradients
    (`module_params` order, the module's shapes; with the scene axis if
    `stacked`), `trunk_backward_reference`'s function."""
    n, scenes, dev = act.h8.shape[0], weights.scenes, act.h8.device
    if tuple(d_h.shape) != (n, WIDTH) or d_h.dtype != torch.bfloat16 or not d_h.is_contiguous() or d_h.device != dev:
        raise ValueError(f"d_h must be a contiguous ({n}, {WIDTH}) bf16 tensor on {dev}")
    alloc = torch.empty if n else torch.zeros
    grads = [alloc(shape, dtype=torch.float32, device=dev) for shape in trunk_grad_shapes(scenes)]
    if n:
        lib = build.load("fused_mlp_bwd")
        fn, floats = lib.vipnerf_trunk_backward, lib.vipnerf_trunk_bwd_share_floats
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            floats.argtypes, floats.restype = [ctypes.c_int], ctypes.c_longlong
        with torch.cuda.device(dev):
            shares = torch.empty(floats(scenes), dtype=torch.float32, device=dev)
            dbuf = [torch.empty_like(act.h_img[0]) for _ in range(2)]
            ptrs = (ctypes.c_void_p * len(grads))(*(t.data_ptr() for t in grads))
            rc = fn(weights.w_flat.data_ptr(), act.xe_img.data_ptr(), act.h_img.data_ptr(), act.h8.data_ptr(),
                    d_h.data_ptr(), dbuf[0].data_ptr(), dbuf[1].data_ptr(), shares.data_ptr(), ptrs, scenes,
                    n // scenes, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the trunk's backward launch failed: cudaError {rc}")
        tracing.count("k1.launches.trunk_backward")
    return grads if stacked else [t[0] for t in grads]


def trunk_backward_reference(params, xe: torch.Tensor, d_h: torch.Tensor) -> List[torch.Tensor]:
    """The trunk's backward written out layer by layer in the working dtype
    (xe's), rounding where autograd through `trunk_recompute` rounds: the
    forward keeps each layer's input and output; then per layer, 7 to 0, d
    masked by the output's ReLU (d is zero where the output is not
    positive), dW = d^T X (per scene for stacked parameters), db = the
    column sums of d, and d X = d W, of which layer 5 passes on h's
    columns. Returns the 16 parameters' gradients (`module_params` order),
    f32 at the module's shapes: w0's and w5's pad column dropped."""
    w, b = _recompute_layers(params, xe.dtype)
    stacked = w[0].dim() == 3
    x = xe.reshape(w[0].shape[0], -1, PTS_IN) if stacked else xe
    ins, outs, h = [], [], x
    with torch.no_grad():
        for i in range(FEATURE):
            ins.append(torch.cat([x, h], dim=-1) if i == 5 else h)
            h = _dense(ins[-1], w[i].detach(), b[i].detach(), True)
            outs.append(h)
        d = d_h.reshape(h.shape).to(xe.dtype)
        grads: List[torch.Tensor] = [None] * (2 * FEATURE)
        for i in reversed(range(FEATURE)):
            d = torch.where(outs[i] > 0, d, torch.zeros_like(d))
            if stacked:
                gw, gb = torch.stack([d[s].t().mm(ins[i][s]) for s in range(d.shape[0])]), d.sum(-2)
            else:
                gw, gb = d.t().mm(ins[i]), d.sum(0)
            if i in (0, 5):
                gw = torch.cat([gw[..., :63], gw[..., 64:]], dim=-1)
            grads[2 * i], grads[2 * i + 1] = gw.float(), gb.float()
            if i:
                d = torch.bmm(d, w[i].detach()) if stacked else d.mm(w[i].detach())
                d = d[..., PTS_IN:] if i == 5 else d
    return grads


def apply_fused_mlp(
    mlp,
    pts: torch.Tensor,
    view_dirs: torch.Tensor,
    view_dirs2: Optional[torch.Tensor] = None,
    *,
    raw_noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.bfloat16,
    f32_heads: bool = False,
) -> Dict[str, torch.Tensor]:
    """NeRFMLP.forward for the flagship config, through K1: the trunk in
    `dtype`, the heads in f32 with `f32_heads` (the bf16_f32h instance).
    Same output dict (sigma, rgb, rgb_view_dependent, visibility[,
    visibility2]), f32, and differentiable in the module's parameters (and
    pts/view dirs). A stacked MLP takes and gives (S, n, ...), in one call.
    `view_dirs` may hold one direction per ray instead of one per point:
    R rows for R rays of consecutive points (scene-major for a stacked
    MLP), which `encode_inputs` reads with the sample stride."""
    if not supports_config(mlp.cfg):
        raise ValueError("K1 implements the flagship 8x256 config only")
    lead = pts.shape[:-1]
    xe, ve, ve2, n_sec = encode_inputs(
        pts.reshape(-1, 3), view_dirs.reshape(-1, 3),
        None if view_dirs2 is None else view_dirs2.reshape(-1, *view_dirs2.shape[-2:]), dtype,
        mlp.cfg.get("fast_encoding", False), f32_heads)
    weights = prepare_weights(mlp, dtype, f32_heads)
    raw = FusedRaw.apply(weights, n_sec, xe, ve, ve2, *module_params(mlp)).float()
    sigma = raw[:, 0:1]
    if raw_noise_std > 0.0 and generator is not None:
        sigma = sigma + raw_noise_std * ray_draw(sigma.shape, generator, sigma.device, normal=True)
    out = {
        "sigma": torch.relu(sigma),
        "rgb_view_dependent": torch.sigmoid(raw[:, 1:4]),
        "visibility": torch.sigmoid(raw[:, 4:5]),
    }
    out["rgb"] = out["rgb_view_dependent"]
    if n_sec:
        out["visibility2"] = torch.sigmoid(raw[:, 5:5 + n_sec])[..., None]
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}
