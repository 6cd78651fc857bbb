"""Extent allocator for BlockStore — the Allocator + FreelistManager roles.

The reference splits block-space management in two (src/os/bluestore):
an in-memory `Allocator` (Allocator.h; bitmap/avl/stupid variants) that
answers "give me N bytes of free extents", and a `FreelistManager`
(FreelistManager.h) that persists which extents are free as KV rows in the
same RocksDB transaction as the metadata they pay for — which is exactly
what makes allocation crash-consistent: an extent changes state only when
the batch that references it commits.

`ExtentAllocator` collapses both roles at our scale: a coalesced
offset->length map served first-fit in address order (the stupid/avl
discipline; address order keeps reuse dense so the block file stays
compact), min_alloc_size rounding (bluestore_min_alloc_size), and
`flush()` which emits only the CHANGED free-list rows into the caller's
KV batch — the delta discipline FreelistManager's merge ops give the
reference, sized for a Python dict instead of a bitmap.

The device is a grow-on-demand file by default: allocation beyond the
current high-water mark extends `size` (persisted alongside the rows).
An optional `capacity` cap (`blockstore_block_size`) plays the
fixed-disk role: an allocation that cannot be met from free space plus
growth headroom raises `StoreError("ENOSPC")` *before* mutating any
state — clean, un-fenced, and retryable once frees land. `check()` is
the fsck cross-check: given every
extent the onodes reference, verify allocated ∪ free tiles [0, size)
exactly — overlaps and leaks are each reported, never repaired silently.
"""

from __future__ import annotations

from ceph_tpu_torch.common.encoding import Encoder
from ceph_tpu_torch.osd.objectstore import StoreError


def _row_key(off: int) -> bytes:
    # big-endian so ordered KV iteration walks the device address order
    return off.to_bytes(8, "big")


class ExtentAllocator:
    """First-fit extent allocator with persistent free-list deltas."""

    def __init__(self, min_alloc_size: int = 4096, capacity: int = 0):
        if min_alloc_size <= 0 or min_alloc_size & (min_alloc_size - 1):
            raise ValueError(
                f"min_alloc_size must be a power of two, got {min_alloc_size}"
            )
        self.min_alloc_size = min_alloc_size
        #: hard device-size cap (bytes; the fixed-disk role): allocation
        #: that would grow past it raises ENOSPC; 0 = grow-on-demand
        self.capacity = capacity
        #: disjoint, coalesced free extents: offset -> length
        self.free: dict[int, int] = {}
        #: device high-water mark (the grow-on-demand "disk size")
        self.size = 0
        self._persisted: dict[int, int] = {}
        self._persisted_size = 0

    # -- state ----------------------------------------------------------------

    def init(self, free: dict[int, int], size: int) -> None:
        """Adopt the persisted state a (re)opening store loaded."""
        self.free = dict(free)
        self.size = size
        self._persisted = dict(free)
        self._persisted_size = size

    def round_up(self, n: int) -> int:
        m = self.min_alloc_size
        return (n + m - 1) // m * m

    def free_bytes(self) -> int:
        return sum(self.free.values())

    def allocated_bytes(self) -> int:
        return self.size - self.free_bytes()

    # -- allocate / release ----------------------------------------------------

    def allocate(self, length: int) -> list[tuple[int, int]]:
        """Return disjoint extents totalling round_up(length) bytes —
        free extents first (address order), then an end-of-device
        extension. May span multiple extents (BlueStore PExtentVector).

        Prefers the first free extent that fits the whole ask (so the
        common allocation is one contiguous run the vectored device IO
        path serves with a single pwrite/pread) before falling back to
        first-fit spanning across fragments; spanning still beats
        growing the device, which keeps the block file compact."""
        need = self.round_up(length)
        # capacity gate BEFORE any mutation, so a failed ask leaves the
        # free map untouched: ENOSPC must be clean and retryable after
        # frees — never a half-allocated state
        if self.capacity and need > self.free_bytes() + max(
            0, self.capacity - self.size
        ):
            raise StoreError(
                "ENOSPC",
                f"allocating {need} bytes: {self.free_bytes()} free + "
                f"{max(0, self.capacity - self.size)} growable of a "
                f"{self.capacity}-byte device",
            )
        if need:
            for off in sorted(self.free):
                ln = self.free[off]
                if ln >= need:
                    self.free.pop(off)
                    if need < ln:
                        self.free[off + need] = ln - need
                    return [(off, need)]
        got: list[tuple[int, int]] = []
        for off in sorted(self.free):
            if not need:
                break
            ln = self.free.pop(off)
            take = min(ln, need)
            got.append((off, take))
            if take < ln:
                self.free[off + take] = ln - take
            need -= take
        if need:
            got.append((self.size, need))
            self.size += need
        return got

    def allocate_many(
        self, lengths: list[int]
    ) -> list[list[tuple[int, int]]]:
        """One allocator pass for a whole batch (the deferred-flush
        shape): allocate round_up(sum) bytes once, then carve the
        returned extents into per-length runs at min_alloc boundaries.
        Cheaper than N allocate() calls and it lands the batch in one
        (usually contiguous) device region, so the flush coalesces into
        very few writes."""
        pool = self.allocate(sum(self.round_up(n) for n in lengths))
        out: list[list[tuple[int, int]]] = []
        for n in lengths:
            need = self.round_up(n)
            got: list[tuple[int, int]] = []
            while need:
                off, ln = pool[0]
                take = min(ln, need)
                got.append((off, take))
                if take < ln:
                    pool[0] = (off + take, ln - take)
                else:
                    pool.pop(0)
                need -= take
            out.append(got)
        return out

    def release(self, extents) -> None:
        """Return extents to the free map, coalescing neighbors."""
        if not extents:
            return
        for off, ln in extents:
            self.free[off] = ln
        merged: dict[int, int] = {}
        last = None
        for off in sorted(self.free):
            ln = self.free[off]
            if last is not None and last + merged[last] == off:
                merged[last] += ln
            else:
                merged[off] = ln
                last = off
        self.free = merged

    # -- persistence -----------------------------------------------------------

    def flush(self, kv, table: bytes, meta_table: bytes,
              size_key: bytes = b"size") -> None:
        """Emit the free-list rows that changed since the last flush into
        `kv` (the caller's batch), so free-space state commits atomically
        with the onodes that allocated/released it."""
        for off in self._persisted.keys() - self.free.keys():
            kv.rm(table, _row_key(off))
        for off, ln in self.free.items():
            if self._persisted.get(off) != ln:
                kv.set(table, _row_key(off), Encoder().u64(ln).bytes())
        if self.size != self._persisted_size:
            kv.set(meta_table, size_key, Encoder().u64(self.size).bytes())
        self._persisted = dict(self.free)
        self._persisted_size = self.size

    # -- fsck ------------------------------------------------------------------

    def check(self, allocated) -> list[str]:
        """Cross-check onode extents vs the free list: allocated ∪ free
        must tile [0, size) with no overlap. Returns error strings."""
        errors: list[str] = []
        marks = [(off, ln, "allocated") for off, ln in allocated]
        marks += [(off, ln, "free") for off, ln in self.free.items()]
        marks.sort()
        pos = 0
        for off, ln, kind in marks:
            if ln <= 0 or off % self.min_alloc_size or ln % self.min_alloc_size:
                errors.append(f"misaligned {kind} extent ({off}, {ln})")
            if off + ln > self.size:
                errors.append(
                    f"{kind} extent ({off}, {ln}) beyond device size {self.size}"
                )
            if off < pos:
                errors.append(
                    f"{kind} extent ({off}, {ln}) overlaps the previous extent"
                )
            elif off > pos:
                errors.append(f"leaked space [{pos}, {off})")
            pos = max(pos, off + ln)
        if pos < self.size:
            errors.append(f"leaked space [{pos}, {self.size})")
        return errors
