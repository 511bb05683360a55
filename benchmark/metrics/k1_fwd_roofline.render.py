"""k1_fwd_roofline.render: K1's forward in the traced frames, in %: the
summed least time of each tile's launches (coarse and fine, on the tile's
real rays) over the summed device time of its kernels."""

from harness import counts


def read(run):
    c, prof = run.get("counts", {}), run.get("profile")
    if c.get("kind") != "render" or not prof or not prof["seconds"]["k1_fwd"]:
        return None
    coarse, fine = c["samples"]
    tiles = [min(c["chunk"], c["pixels"] - a) for a in range(0, c["pixels"], c["chunk"])]
    bound = sum(counts.k1_fwd_bound_s(r * coarse, 0) + counts.k1_fwd_bound_s(r * (coarse + fine), 0)
                for r in tiles)
    return 100.0 * bound * c["trace_frames"] / prof["seconds"]["k1_fwd"]
