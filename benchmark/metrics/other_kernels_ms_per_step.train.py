"""other_kernels_ms_per_step.train: device ms per training step of every
kernel that is neither K1's (forward or backward) nor a cuBLAS product: the
renderer, the losses, the autograd around them, Adam, copies."""


def read(run):
    c, prof = run.get("counts", {}), run.get("profile")
    if c.get("kind") != "train" or not prof or not c.get("trace_steps"):
        return None
    return 1e3 * prof["seconds"]["other"] / c["trace_steps"]
