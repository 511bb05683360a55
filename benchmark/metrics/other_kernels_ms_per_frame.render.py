"""other_kernels_ms_per_frame.render: device ms per traced frame of every
kernel that is not K1's: sampling, encoding, concatenation, compositing,
copies."""


def read(run):
    c, prof = run.get("counts", {}), run.get("profile")
    if c.get("kind") != "render" or not prof or not c.get("trace_frames"):
        return None
    return 1e3 * prof["seconds"]["other"] / c["trace_frames"]
