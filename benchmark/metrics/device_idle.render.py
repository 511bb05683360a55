"""device_idle.render: the share of the traced frames in which no operation
ran on the device, in %: 1 - busy / window."""


def read(run):
    prof = run.get("profile")
    if run.get("counts", {}).get("kind") != "render" or not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
