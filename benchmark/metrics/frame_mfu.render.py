"""frame_mfu.render: rendering's share of the bf16 peak, in %: 2 x the
forward multiply-adds of every rendered point (each pixel's coarse and
fine samples) of the measured window, over its host seconds, over 989
TFLOP/s."""

from harness import counts


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "render" or not c.get("frames"):
        return None
    coarse, fine = c["samples"]
    flops = counts.model_flops(c["pixels"] * (2 * coarse + fine), 0, False)
    return 100.0 * flops * c["frames"] / c["window_s"] / counts.PEAK_BF16_FLOPS
