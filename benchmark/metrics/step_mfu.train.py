"""step_mfu.train: the training step's share of the bf16 peak, in %: the
model's FLOPs (3 x 2 x the MLP's multiply-adds at the cell's shapes, the
trunk's recompute and the split products not counted) of every step of the
measured window, over the window's host seconds, over 989 TFLOP/s."""

from harness import counts


def read(run):
    c = run.get("counts", {})
    if c.get("kind") != "train" or not c.get("steps"):
        return None
    flops = sum(counts.model_flops(p, c["n_sec"], True) for p in c["points_per_step"].values())
    return 100.0 * flops * c["steps"] / c["window_s"] / counts.PEAK_BF16_FLOPS
