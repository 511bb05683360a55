"""The yardstick's arithmetic, frozen here: the chip's peaks, the model's
multiply-adds per point, and the least time of K1's forward and of its
shipped-mode backward kernels (the counts of PERF.md's kernel table, PR 10
and PR 11: `chip_smoke.k1_bound_parts` and `heads_bound_parts` over
`kernels/fused_mlp.py`'s constants as they stood). A change to the program
does not move them.

The roofline counts the function's work, not the design's: each input byte
read once and each output byte written once; the trunk's multiply-adds at
the bf16 tensor-core peak; the f32 heads' at the cheapest f32-accurate rate
their operands allow on those tensor cores, 3 bf16 products per multiply-add
of a bf16 by an f32 operand and 6 of two f32 operands.
"""

# NVIDIA's data sheet, H100 SXM, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

WIDTH = 256
PTS_IN, VIEW_IN, NOUT = 64, 32, 8  # K1's padded input and output widths
# multiply-adds per point at the real widths: trunk (layers 0-7), heads
# (feature, sigma, view hidden, view output), and per secondary view
TRUNK_MACS = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
MACS_PER_POINT = TRUNK_MACS + 256 * 257 + 283 * 128 + 128 * 4
MACS_PER_SEC_VIEW = 283 * 128 + 128 * 4

# bf16 products per point of the f32 heads, forward: 3 per MAC of the feature
# and sigma layers, 6 of the view and output layers; the view layer's feature
# columns once per point, its PE(dir) columns and the output per view
F32H_SPLIT_MACS = 3 * (256 * 256 + 256) + 6 * (256 * 128 + 27 * 128 + 128 * 4)
F32H_SPLIT_MACS_PER_SEC_VIEW = 6 * (27 * 128 + 128)
# one scene's packed forward weights (bf16 trunk, three bf16 parts of each
# f32 head weight) and biases, bytes
_LAYERS = ((256, 64), (256, 256), (256, 256), (256, 256), (256, 256), (256, 320), (256, 256), (256, 256),
           (256, 256), (8, 256), (128, 288), (8, 128))
_TRUNK_NUMEL = sum(n * k for n, k in _LAYERS[:8])
_HEAD_NUMEL = sum(n * k for n, k in _LAYERS[8:])
_B_NUMEL = sum(n for n, _ in _LAYERS)
FWD_PACK_BYTES = 2 * _TRUNK_NUMEL + 3 * 2 * _HEAD_NUMEL + 4 * _B_NUMEL

# the shipped mode's heads backward, bf16 products per point
BWD_POINT_MACS = 3 * WIDTH * WIDTH + 6 * (128 * WIDTH + WIDTH * 128 + WIDTH * WIDTH)
BWD_POINT_MACS_PER_VIEW = 6 * 27 * 128
BWD_WEIGHT_MACS = 3 * (WIDTH * WIDTH + WIDTH) + 6 * (128 * WIDTH + 3 * 128)
BWD_WEIGHT_MACS_PER_VIEW = 6 * (128 * 27 + 128)
_BWD_IMG_NUMEL = 3 * (WIDTH * WIDTH + 128 * WIDTH + 128 * VIEW_IN + WIDTH * 128 + WIDTH * WIDTH + VIEW_IN * 128)
_BWD_SMALL_NUMEL = WIDTH + 128 + WIDTH + 4 * 128


def model_flops(points: int, n_sec: int, backward: bool) -> float:
    """The model's FLOPs on `points` points: 2 per multiply-add of the
    forward, 3 times that with the backward (recompute and split products
    not counted)."""
    return (6.0 if backward else 2.0) * points * (MACS_PER_POINT + n_sec * MACS_PER_SEC_VIEW)


def k1_fwd_bound_s(points: int, n_sec: int, scenes: int = 1) -> float:
    """Least seconds of K1's forward (the shipped instance) on `points`
    points of `scenes` scenes in one launch: operations or bytes."""
    ops = 2.0 * points * (TRUNK_MACS + F32H_SPLIT_MACS + n_sec * F32H_SPLIT_MACS_PER_SEC_VIEW) / PEAK_BF16_FLOPS
    nbytes = points * (2 * PTS_IN + 4 * (VIEW_IN * (1 + n_sec) + NOUT)) + scenes * FWD_PACK_BYTES
    return max(ops, nbytes / PEAK_BYTES)


def bwd_bytes(points: int, n_sec: int, scenes: int = 1):
    """Bytes the two heads-backward kernels read and write once: the
    per-point kernel's h, PE(dir), g and weight image in, d h and the
    intermediates out; the weight kernel's intermediates, h, PE(dir) and g
    in, the gradients out."""
    views = 1 + n_sec
    inputs = points * (2 * WIDTH + 4 * VIEW_IN * views + 4 * NOUT)
    mid = points * (4 * (2 * WIDTH + 128) + views * 4 * 2 * 128)
    grads = scenes * 4 * (_HEAD_NUMEL + WIDTH + 1 + 128 + 4)
    per_point = inputs + scenes * (2 * _BWD_IMG_NUMEL + 4 * _BWD_SMALL_NUMEL) + points * 2 * WIDTH + mid
    return per_point, inputs + mid + grads


def k1_bwd_bound_s(points: int, n_sec: int, scenes: int = 1) -> float:
    """Least seconds of the two heads-backward kernels on `points` points:
    each its operations or its bytes, summed."""
    b_points, b_weights = bwd_bytes(points, n_sec, scenes)
    ops_points = 2.0 * points * (BWD_POINT_MACS + (1 + n_sec) * BWD_POINT_MACS_PER_VIEW) / PEAK_BF16_FLOPS
    ops_weights = 2.0 * points * (BWD_WEIGHT_MACS + (1 + n_sec) * BWD_WEIGHT_MACS_PER_VIEW) / PEAK_BF16_FLOPS
    return max(ops_points, b_points / PEAK_BYTES) + max(ops_weights, b_weights / PEAK_BYTES)
