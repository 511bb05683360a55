"""k1_fwd_roofline.train: K1's forward in the traced training chunks, in %:
the summed least time of its launches (coarse and fine, each step, all scenes in one launch) over the
summed device time of its kernels."""

from harness import counts


def read(run):
    c, prof = run.get("counts", {}), run.get("profile")
    if c.get("kind") != "train" or not prof or not prof["seconds"]["k1_fwd"]:
        return None
    bound = sum(counts.k1_fwd_bound_s(p, c["n_sec"], c["scenes"]) for p in c["points_per_step"].values())
    return 100.0 * bound * c["trace_steps"] / prof["seconds"]["k1_fwd"]
