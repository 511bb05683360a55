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
plain torch. It counts its launches in `fused_mlp_raw.launches`, and per
instance in `fused_mlp_raw.launches_by_instance`. `fused_mlp_raw_ffma` runs
the bf16_f32h function with FFMA heads on CUDA cores, the tensor-core heads'
yardstick; nothing else calls it.

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
from vipnerf_tpu_torch.core.sampling import ray_draw
from vipnerf_tpu_torch.core.scene_linear import scene_matmul
from vipnerf_tpu_torch.kernels import build

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
BLOCK_ROWS_F32 = 64  # points per block of the f32 kernel (and of the FFMA heads)
# bytes of `heads_image`'s per-view chunk: W10's PE(dir) columns and W11, each part
HEADS_VIEW_BYTES = SPLIT_PARTS * 2 * (LAYER_SHAPES[VIEW][0] * (LAYER_SHAPES[VIEW][1] - WIDTH)
                                      + LAYER_SHAPES[VIEW_OUT][0] * LAYER_SHAPES[VIEW_OUT][1])


def stream_bytes(instance: str, n: int, n_sec: int, scenes: int = 1) -> int:
    """Bytes one launch of `instance` (or of "fused_mlp_bf16_f32h_ffma", the
    FFMA yardstick) on n points of `scenes` scenes streams from L2 by its
    design, beyond its inputs and outputs: each tile's (f32: each block's)
    pass over the packed weights, the view layers again per secondary view
    (bf16_f32h: the heads' per-view chunk), and bf16_f32h's h round trip
    through `h_scratch` (written, then read back). Counted from the pack's
    sizes, not measured."""
    tiles = scenes * -(-(n // scenes) // TILE_ROWS)
    blocks = scenes * -(-(n // scenes) // BLOCK_ROWS_F32)
    view = {dt: b[VIEW] + b[VIEW_OUT] for dt, b in LAYER_BYTES.items()}  # the view layers, whole
    if instance == "fused_mlp_bf16":
        return tiles * (PACK_BYTES[torch.bfloat16, torch.bfloat16] + n_sec * view[torch.bfloat16])
    if instance == "fused_mlp_f32":
        return blocks * (PACK_BYTES[torch.float32, torch.float32] + n_sec * view[torch.float32])
    trunk = tiles * 2 * TRUNK_NUMEL + 2 * h_scratch_bytes(n, scenes)
    if instance == "fused_mlp_bf16_f32h":
        return trunk + tiles * (SPLIT_PARTS * 2 * HEAD_NUMEL + n_sec * HEADS_VIEW_BYTES)
    if instance == "fused_mlp_bf16_f32h_ffma":
        return trunk + blocks * (4 * HEAD_NUMEL + n_sec * view[torch.float32])
    raise ValueError(f"no K1 instance {instance}")


def _images(part, dtype: torch.dtype, lo: int) -> torch.Tensor:
    """The packed layout's entries from lo on, for `part`'s layers (with
    their leading scene axis, if any)."""
    lead = part[0][0].shape[:-2]
    flat = torch.cat([w.reshape(*lead, -1) for w, _ in part], dim=-1)
    return flat[..., pack_index(dtype, flat.device)[lo:lo + flat.shape[-1]] - lo]


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
        w_flat = _images(layers, dtype, 0)
    else:
        heads = torch.cat([w.reshape(*lead, -1) for w, _ in layers[FEATURE:]], dim=-1)
        parts = torch.cat(split_bf16(heads), dim=-1)
        w_flat = torch.cat([_images(layers[:FEATURE], dtype, 0).view(torch.uint8),
                            parts[..., heads_index(parts.device)].view(torch.uint8)], dim=-1)
    return w_flat.reshape(-1), torch.cat([b for _, b in layers], dim=-1).reshape(-1)


def ffma_heads(weights: "FusedWeights") -> torch.Tensor:
    """The FFMA heads' weights for `fused_mlp_raw_ffma`: layers 8-11 of a
    bf16_f32h pack's f32 layers as W^T, each scene's in turn."""
    return _images(weights.layers[FEATURE:], torch.float32, TRUNK_NUMEL).reshape(-1)


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
        cache[1][mode] = FusedWeights(layers, w_flat, b_flat, dtype, mlp.scenes or 1,
                                      head_dtype if head_dtype != dtype else None)
    return cache[1][mode]


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
    `ve` stands in for it."""
    npts = pts.shape[0]
    n_sec = view_dirs2.shape[1] if view_dirs2 is not None else 0
    head_dtype = torch.float32 if f32_heads else dtype
    xe = F.pad(positional_encoding(pts, 10, fast), (0, PTS_IN - 63)).to(dtype)
    ve = F.pad(positional_encoding(view_dirs, 4, fast), (0, VIEW_IN - 27)).to(head_dtype)
    if n_sec:
        enc2 = positional_encoding(view_dirs2.reshape(npts * n_sec, 3), 4, fast)
        ve2 = F.pad(enc2, (0, VIEW_IN - 27)).reshape(npts, n_sec * VIEW_IN).to(head_dtype)
    else:
        ve2 = ve
    return xe.contiguous(), ve.contiguous(), ve2.contiguous(), n_sec


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
    fused_mlp_raw.launches += 1
    fused_mlp_raw.launches_by_instance[INSTANCE[mode]] += 1
    return out


def fused_mlp_raw_ffma(
    weights: FusedWeights, heads32: torch.Tensor, xe: torch.Tensor, ve: torch.Tensor, ve2: torch.Tensor,
    n_sec: int,
) -> torch.Tensor:
    """The bf16_f32h function with the heads in FFMA on CUDA cores (the
    trunk kernel, then the f32 kernel's heads on `heads32`, `ffma_heads` of
    the same weights): the tensor-core heads' yardstick, CUDA tensors only.
    Counts its launches in `fused_mlp_raw_ffma.launches`."""
    _check(weights, xe, ve, ve2, n_sec)
    if weights.mode != (torch.bfloat16, torch.float32):
        raise TypeError(f"the FFMA heads take bf16_f32h weights, not {INSTANCE[weights.mode]}'s")
    if heads32.dtype != torch.float32 or heads32.numel() != weights.scenes * HEAD_NUMEL \
            or heads32.device != xe.device:
        raise ValueError("heads32 is not ffma_heads of these weights")
    if xe.device.type != "cuda":
        raise ValueError(f"the FFMA heads run on cuda tensors only, not {xe.device}")
    out = _output(weights, xe)
    if xe.shape[0] == 0:
        return out
    h = h_scratch(xe.shape[0], weights.scenes, xe.device)
    _launch(_entry("fused_mlp_bf16_f32h_ffma", 8), weights, xe, n_sec,
            [xe, ve, ve2, weights.w_flat, heads32, weights.b_flat, h, out])
    fused_mlp_raw_ffma.launches += 1
    return out


def reset_launch_counts():
    """Zeroes `fused_mlp_raw`'s counts. `fused_mlp_raw_ffma.launches`, a
    yardstick's on no path, runs on from 0 at import."""
    fused_mlp_raw.launches = 0
    fused_mlp_raw.launches_by_instance = dict.fromkeys(INSTANCE.values(), 0)


reset_launch_counts()
fused_mlp_raw_ffma.launches = 0


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
    module's real parameters (`module_params` order); the counterpart of
    `_raw_xla`. The trunk runs in xe's dtype, the heads in ve's (the
    instance's mode), on h cast to it after layer 7 as models/mlp.py does
    with f32 heads; the output is in ve's dtype. Zero padding is built from
    the real weights with `F.pad`/`torch.cat`, so it takes no gradient; in
    bf16 each product is rounded to bf16 before the bf16 bias add. Unlike
    `fused_mlp_reference`, the products run in the working dtype (cuBLAS on
    the card), as XLA's do. Stacked parameters (S scenes) take S blocks of
    N/S rows and run each layer as one batched product over the scenes."""
    dts = [xe.dtype] * FEATURE + [ve.dtype] * (len(LAYER_SHAPES) - FEATURE)
    w = [p.to(dt) for p, dt in zip(params[0::2], dts)]
    b = [p.to(dt) for p, dt in zip(params[1::2], dts)]
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
    h = h.to(ve.dtype)
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
    f32_heads: bool = False,
) -> Dict[str, torch.Tensor]:
    """NeRFMLP.forward for the flagship config, through K1: the trunk in
    `dtype`, the heads in f32 with `f32_heads` (the bf16_f32h instance).
    Same output dict (sigma, rgb, rgb_view_dependent, visibility[,
    visibility2]), f32, and differentiable in the module's parameters (and
    pts/view dirs). A stacked MLP takes and gives (S, n, ...), in one call."""
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
