"""The benchmark's arithmetic: peaks, bytes from shapes, and statistics.

Kept with the benchmark so that what a metric means cannot move with the
program. Every function here is plain Python over numbers the harness
recorded; none reads a clock or a device.
"""

from __future__ import annotations

import math
import statistics

#: HBM bytes per second by `torch.cuda.get_device_name()`: NVIDIA's data
#: sheet for the H100 SXM5 (80 GB HBM3), the peak at its 700 W limit
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def gf_hbm_bytes(k: int, r: int, row_bytes: int) -> int:
    """Least HBM traffic of a GF(2^8) matrix of r x k applied to k chunk rows
    of `row_bytes` each: the k input rows read once, the r output rows
    written once. Encode has r = m, a decode r = the chunks it rebuilds;
    the planar and the byte API move the same bytes."""
    return (k + r) * row_bytes


def rate(total: float, seconds: float) -> float:
    """All the work over all the time it took."""
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return total / seconds


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def spread(values) -> float:
    """Distance between the first and third quartile (Python's
    `statistics.quantiles(values, n=4)`) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
