"""The traced window: torch.profiler over whole steps or frames, reduced
to what the per-layer metrics read. Device kernels are classed by name:

- `k1_fwd`: K1's forward kernels (`fused_mlp_*_kernel`);
- `k1_bwd`: the shipped mode's heads-backward kernels (`heads_bwd_*`);
- `gemm`: cuBLAS products (`*gemm*`, and `nvjet_*`, cuBLASLt's on Hopper);
- `other`: every other kernel, copy and set.

Busy time is the union of the device's intervals; the traced window runs
from the first device interval's start to the last one's end. Idle gaps
are named by the innermost host operation running at their midpoint."""

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

import torch

CLASSES = ("k1_fwd", "k1_bwd", "gemm", "other")


def kernel_class(name: str) -> str:
    if "heads_bwd_" in name:
        return "k1_bwd"
    if "fused_mlp_" in name and "_kernel" in name:
        return "k1_fwd"
    if "gemm" in name.lower() or name.startswith("nvjet_"):
        return "gemm"
    return "other"


def start_profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    return prof


def _device_us(evt) -> float:
    """A device event's microseconds: its own interval on the device's timeline."""
    return float(evt.time_range.end - evt.time_range.start)


def reduce_profile(prof) -> Optional[Dict[str, object]]:
    """Seconds per class, busy and window seconds, the ten device
    operations that took most time and the ten longest idle gaps by host
    operation; None when the trace holds no device time."""
    device_type = torch.autograd.DeviceType.CUDA
    intervals, by_name = [], defaultdict(float)
    seconds = dict.fromkeys(CLASSES, 0.0)
    host = []
    for e in prof.events():
        if e.device_type == device_type:
            if getattr(e, "is_user_annotation", False):
                continue
            us = _device_us(e)
            if us <= 0:
                continue
            start = e.time_range.start
            intervals.append((start, start + us))
            seconds[kernel_class(e.name)] += us * 1e-6
            by_name[e.name[:120]] += us * 1e-6
        else:
            host.append((e.time_range.start, e.time_range.end, e.name))
    if not intervals:
        return None
    intervals.sort()
    busy, gaps = 0.0, []
    cur_start, cur_end = intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            gaps.append((start - cur_end, cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window_us = intervals[-1][1] - intervals[0][0]
    gaps.sort(reverse=True)
    return {"seconds": seconds, "busy_s": busy * 1e-6, "window_s": window_us * 1e-6,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": _name_gaps(gaps[:10], host)}


def _name_gaps(gaps, host) -> List[List[object]]:
    """Each gap as [innermost host operation at its midpoint, seconds]."""
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        best = None
        for start, end, name in host[max(0, bisect.bisect_right(starts, mid) - 2000):
                                     bisect.bisect_right(starts, mid)]:
            if end >= mid and (best is None or end - start < best[1] - best[0]):
                best = (start, end, name)
        out.append([f"host: {best[2][:100]}" if best else "host: python between operations", length * 1e-6])
    return out
