"""k1_bwd_roofline.train: the shipped mode's two heads-backward kernels in
the traced training chunks, in %: their summed least time over their
summed device time."""

from harness import counts


def read(run):
    c, prof = run.get("counts", {}), run.get("profile")
    if c.get("kind") != "train" or not prof or not prof["seconds"]["k1_bwd"]:
        return None
    bound = sum(counts.k1_bwd_bound_s(p, c["n_sec"], c["scenes"]) for p in c["points_per_step"].values())
    return 100.0 * bound * c["trace_steps"] / prof["seconds"]["k1_bwd"]
