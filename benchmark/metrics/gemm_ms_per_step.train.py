"""gemm_ms_per_step.train: device ms per training step of cuBLAS products
(`*gemm*`, `nvjet_*`): the trunk's recompute and its gradient."""


def read(run):
    c, prof = run.get("counts", {}), run.get("profile")
    if c.get("kind") != "train" or not prof or not c.get("trace_steps"):
        return None
    return 1e3 * prof["seconds"]["gemm"] / c["trace_steps"]
