"""Sub-stripe EC overwrite algebra + in-flight extent coordination.

The reference's EC overwrite pipeline (ECBackend::start_rmw,
src/osd/ECBackend.cc:1830; ECTransaction::generate_transactions,
src/osd/ECTransaction.cc:101) reads only the stripes a partial write
touches, re-encodes those, and ships per-shard sub-extents; overlapping
in-flight writes coordinate through an ExtentCache
(src/osd/ExtentCache.h:1) so pipelined RMWs see each other's pending
bytes instead of stale store state.

The planar layout makes the same plan simpler. An EC object here is
a single (k, chunk_size) stripe whose parity is a per-byte-column
GF(2^8) matmul (ceph_tpu_torch.ec.rs.ErasureCodeRs: every technique reduces
to `gen @ data` applied column-wise), so byte column c of every parity
chunk depends ONLY on byte column c of the k data chunks. "The stripes
a write touches" are therefore intra-chunk COLUMN INTERVALS: a 4 KiB
write into a 4 MiB object touches one small column window, and the RMW
reads exactly those columns of the k data shards, re-encodes that
window (through the batch EncodeService — the window is just a smaller
planar encode), and ships per-shard sub-extents via Transaction.write_at.

Coordination: writes whose column windows overlap would race on the
parity columns they share (each computes full new parity for its
window), so the ExtentCache serializes overlapping reservations in
arrival order and lets disjoint windows proceed concurrently — which
the whole-object path (everything under the PG lock) never could. This
trades the reference's pending-extent read-through for arrival-order
serialization: same consistency contract, no cross-write data plumbing.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

Interval = tuple[int, int]  # [lo, hi) byte columns within a chunk


def _align_down(x: int, unit: int) -> int:
    return x - x % unit


def _align_up(x: int, unit: int) -> int:
    return x + (unit - x % unit) % unit


def merge_intervals(ivals: list[Interval]) -> list[Interval]:
    """Sorted, coalesced (touching intervals merge)."""
    out: list[Interval] = []
    for lo, hi in sorted(ivals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def overlaps(a: list[Interval], b: list[Interval]) -> bool:
    for lo1, hi1 in a:
        for lo2, hi2 in b:
            if lo1 < hi2 and lo2 < hi1:
                return True
    return False


def write_column_intervals(
    writes: list[tuple[int, int]], bs: int, unit: int
) -> list[Interval]:
    """Column windows a set of (offset, length) object writes touch.

    Object byte X lives in logical chunk X//bs at column X%bs (the
    contiguous-split layout EncodeService.encode uses), so a write maps
    to one column segment per chunk it crosses; segments from all
    writes merge into aligned windows. Alignment to `unit` keeps every
    window a size the codec's get_chunk_size treats as its own chunk
    size, so the window re-encodes through the unmodified planar path.
    """
    ivals: list[Interval] = []
    for off, length in writes:
        if length <= 0:
            continue
        end = off + length
        for chunk in range(off // bs, (end - 1) // bs + 1):
            lo = max(off - chunk * bs, 0)
            hi = min(end - chunk * bs, bs)
            ivals.append((
                _align_down(lo, unit), min(_align_up(hi, unit), bs)
            ))
    return merge_intervals(ivals)


def patch_window(
    window: bytearray, interval: Interval, k: int,
    writes: list[tuple[int, int, bytes]], bs: int,
) -> None:
    """Apply client writes into a column-window buffer in place.

    `window` holds columns [lo,hi) of the k data chunks back to back
    (logical chunk l at window[l*W:(l+1)*W]); `writes` are
    (object_offset, length, data) in op order.
    """
    lo, hi = interval
    w = hi - lo
    for off, length, data in writes:
        end = off + length
        for chunk in range(off // bs, max(off, end - 1) // bs + 1):
            if chunk >= k:
                break
            seg_lo = max(off - chunk * bs, 0)
            seg_hi = min(end - chunk * bs, bs)
            c0, c1 = max(seg_lo, lo), min(seg_hi, hi)
            if c0 >= c1:
                continue
            src = chunk * bs + c0 - off
            dst = chunk * w + (c0 - lo)
            window[dst: dst + (c1 - c0)] = data[src: src + (c1 - c0)]


@dataclass
class _Reservation:
    name: str
    intervals: list[Interval]
    event: asyncio.Event = field(default_factory=asyncio.Event)


class ExtentCache:
    """Per-PG in-flight sub-write coordination (ExtentCache.h role).

    reserve() admits a write's column windows when no earlier in-flight
    reservation on the same object overlaps them; release() wakes the
    queue. Arrival order is preserved (no starvation: a waiter only
    yields to reservations that arrived before it).
    """

    def __init__(self) -> None:
        self._queue: list[_Reservation] = []
        self.reservations = 0
        self.conflicts = 0

    async def reserve(
        self, name: str, intervals: list[Interval]
    ) -> _Reservation:
        r = _Reservation(name, list(intervals))
        self._queue.append(r)
        self.reservations += 1
        while True:
            mine = self._queue.index(r)
            blocker = next(
                (
                    q for q in self._queue[:mine]
                    if q.name == name
                    and overlaps(q.intervals, r.intervals)
                ),
                None,
            )
            if blocker is None:
                return r
            self.conflicts += 1
            await blocker.event.wait()

    def release(self, r: _Reservation) -> None:
        if r in self._queue:  # idempotent: error paths may double-release
            self._queue.remove(r)
        r.event.set()
