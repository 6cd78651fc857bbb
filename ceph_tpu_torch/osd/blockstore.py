"""BlockStore: the BlueStore-analogue local object store.

Re-expresses the reference's src/os/bluestore design at our scale: object
**data** lives as allocator-managed extents in one raw block file; all
**metadata** — onodes (extent map + per-block checksums), xattrs, omap,
collections, and the allocator free list — lives in the `KeyValueDB`
(RocksDB's role). A `Transaction` still commits as exactly one KV batch,
and the ordering discipline is BlueStore's:

  * **big writes** (>= min_alloc_size) go to freshly-allocated extents —
    never to space a live onode references — and the device is fsynced
    *before* the KV batch commits, so a crash at any point leaves the old
    onode pointing at intact old bytes (copy-on-write, no torn data);
  * **small writes** (< min_alloc_size) are *deferred*: the payload rides
    the KV WAL batch itself (the commit point) and `flush_deferred` later
    moves it onto the device, repointing the onode in a second batch —
    BlueStore's deferred-write path, crash-safe because the WAL row stays
    authoritative until that second batch commits;
  * **frees** are quarantined until the batch that drops them commits —
    reusing a freed extent earlier could clobber bytes the previous onode
    still references across a crash.

Every checksum block (bluestore_csum_block_size) of the stored payload is
crc32c-summed on write and verified on every device read; a mismatch
raises `StoreError("EIO", ...)`, which the OSD's deep scrub surfaces as a
`read_error` inconsistency and repairs from healthy peers. Optional
compression-on-write runs the payload through the compressor registry
(BlueStore's compression_mode/required_ratio policy) with the compressed
length tracked per blob. `fsck(deep=...)` cross-checks onode extents vs
the free list (allocated ∪ free must tile the device exactly) and — deep —
re-reads every blob against its stored checksums.

The fast path (BlueStore's cache trio + deferred aging):

  * an **onode LRU** (`blockstore_onode_cache_size`) keeps decoded
    onodes so hot objects skip the KV fetch + decode; entries fold in
    only after the KV batch that changes them commits, so the cache is
    always committed truth (aborted compiles never pollute it);
  * a **buffer cache** (`blockstore_buffer_cache_bytes`, LRU by bytes,
    write-through) keeps recently read/written logical object data so
    re-reads skip the device and the checksum re-verify entirely.
    `read_verify` bypasses it (and refreshes it) — deep scrub and fsck
    always see device truth, so cached data can never mask at-rest
    corruption; `drop_caches` is the restart-equivalent hook tests use;
  * a **background flusher** drains the deferred backlog once its oldest
    entry exceeds `blockstore_deferred_max_age_ms` (BlueStore's
    deferred_try_submit aging), instead of only on byte pressure. It
    starts lazily on the first commit that leaves a backlog — a store
    opened for inspection (fsck / objectstore_tool) never spawns one —
    and is joined before the device closes. Crash-safety is unchanged:
    the flush is the same WAL-row-authoritative two-phase move;
  * **vectored device IO**: adjacent extents coalesce into single
    pwrite/pread calls (writev/readv discipline), and the deferred flush
    batches the whole backlog into ONE allocator pass + one coalesced
    write plan + one fsync + one KV batch.

Per-store `PerfCounters` (cache hits/misses, deferred queue depth/age,
flush latency, device call/segment counts) make the wins observable via
`perf dump` when a daemon adopts the block.

The device fault layer (the one fault domain `ms_inject_*` can't reach):

  * **injection** — config-driven hooks at the device IO sites, the
    `_InjectingStream` idiom with its disabled-cost rule (one cached
    flag check per site): `blockstore_inject_read_eio` /
    `blockstore_inject_write_eio` / `blockstore_inject_fsync_fail` as
    1-in-N rates, plus `inject_data_error()` — the `injectdataerr`
    admin-command analogue — arming a deterministic per-object read EIO
    that clears when the object is rewritten (so a write-back repair
    genuinely heals it). Injected counts ride the perf block;
  * **error taxonomy** (see `StoreError`): a READ error is `EIO` and
    recoverable above the store — the OSD heals the object from
    replicas/EC survivors; a WRITE or FSYNC error is `StoreFatalError`
    and **fences** the store: it flips read-only (`fenced`), refuses
    every further transaction with `EROFS` so no ack can lie about
    durability, and fires `on_fatal` so the owning OSD can fail-stop
    (report itself to the mon and shut down). ENOSPC from a
    capacity-capped allocator (`blockstore_block_size`) is transient:
    nothing fences, and frees make the store writable again.
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.common.kv import KeyValueDB, KVTransaction
from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.osd.allocator import ExtentAllocator
from ceph_tpu_torch.osd.objectstore import (
    _ATTR,
    _OMAP,
    KStore,
    StoreError,
    StoreFatalError,
    _encode_attrs,
    _okey,
    _okey_decode,
)

_ONODE = b"ond"  # onode rows: size, flags, extent map, csums (O prefix)
_DEFER = b"dfw"  # deferred sub-min_alloc payloads riding the KV WAL
_FREE = b"fre"   # allocator free-list rows (FreelistManager's B prefix)
_BMETA = b"bmt"  # store meta: device size + pinned geometry

_CSUM_SEED = 0xFFFFFFFF

FLAG_INLINE = 1      # payload lives in the _DEFER row, not on the device
FLAG_COMPRESSED = 2  # stored payload is comp_alg-compressed


@dataclass
class Onode:
    """Per-object metadata row (bluestore_onode_t + its blob/extent maps,
    flattened: one blob per object at our scale)."""

    size: int = 0         # logical object size
    flags: int = 0
    comp_alg: str = ""    # compressor name when FLAG_COMPRESSED
    stored_len: int = 0   # physical payload length (== size when raw)
    csum_block: int = 4096
    extents: list = field(default_factory=list)  # [(offset, length)]
    csums: list = field(default_factory=list)    # u32 per csum block

    def encode(self) -> bytes:
        def body(b):
            b.u8(self.flags).u64(self.size).string(self.comp_alg)
            b.u64(self.stored_len).u32(self.csum_block)
            b.list(self.extents, lambda e, x: e.u64(x[0]).u64(x[1]))
            b.list(self.csums, lambda e, c: e.u32(c))

        return Encoder().struct(1, 1, body).bytes()

    @staticmethod
    def decode(raw: bytes) -> "Onode":
        def body(b, _version):
            on = Onode(flags=b.u8(), size=b.u64(), comp_alg=b.string())
            on.stored_len = b.u64()
            on.csum_block = b.u32()
            on.extents = b.list(lambda d: (d.u64(), d.u64()))
            on.csums = b.list(lambda d: d.u32())
            return on

        on = Decoder(raw).struct(1, body)
        on.size, on.stored_len = int(on.size), int(on.stored_len)
        return on


def _coalesce(extents) -> list[tuple[int, int]]:
    """Merge device-adjacent extents into runs: [(0,4096),(4096,4096)]
    -> [(0,8192)]. Inputs are in payload order; only extents adjacent in
    BOTH payload and device order merge, so a run is always one
    contiguous pread/pwrite of in-order payload bytes."""
    runs: list[list[int]] = []
    for off, ln in extents:
        if runs and runs[-1][0] + runs[-1][1] == off:
            runs[-1][1] += ln
        else:
            runs.append([off, ln])
    return [(off, ln) for off, ln in runs]


# ---------------------------------------------------------------------------
# Block devices (KernelDevice's role, reduced to pread/pwrite/flush)


class MemBlockDevice:
    """bytearray-backed device — the MemStore-tier BlockStore for tests
    (and the bit-rot injection surface: flip bytes in `buf`)."""

    path = None

    def __init__(self) -> None:
        self.buf = bytearray()

    def pwrite(self, off: int, data: bytes) -> None:
        end = off + len(data)
        if len(self.buf) < end:
            self.buf.extend(b"\x00" * (end - len(self.buf)))
        self.buf[off:end] = data

    def pwritev(self, off: int, buffers) -> None:
        """One contiguous vectored write (writev at a device offset)."""
        self.pwrite(off, b"".join(buffers))

    def pread(self, off: int, length: int) -> bytes:
        out = bytes(self.buf[off:off + length])
        return out + b"\x00" * (length - len(out))  # sparse tail is zeros

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class FileBlockDevice:
    """One raw block file, grow-on-demand; flush() is a real fsync — the
    write-before-commit ordering the crash story depends on.

    All IO is raw positional fd syscalls (os.pread/os.pwrite(v)) —
    KernelDevice's shape — deliberately avoiding Python's buffered file
    objects: mixing a BufferedRandom's seek-within-buffer fast path with
    raw vectored writes on the same fd can serve stale bytes."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        self._closed = False

    def pwrite(self, off: int, data: bytes) -> None:
        view = memoryview(data)
        while view:
            n = os.pwrite(self._fd, view, off)
            off += n
            view = view[n:]

    def pwritev(self, off: int, buffers) -> None:
        """One contiguous vectored write: os.pwritev when the platform
        has it (one syscall for the whole coalesced run, the io_uring-ish
        shape), else a joined pwrite."""
        buffers = [b for b in buffers if b]
        if not buffers:
            return
        if len(buffers) == 1 or not hasattr(os, "pwritev"):
            self.pwrite(off, buffers[0] if len(buffers) == 1
                        else b"".join(buffers))
            return
        queue = [memoryview(b) for b in buffers]
        while queue:
            n = os.pwritev(self._fd, queue, off)
            off += n
            while queue and n >= len(queue[0]):
                n -= len(queue[0])
                queue.pop(0)
            if queue and n:
                queue[0] = queue[0][n:]

    def pread(self, off: int, length: int) -> bytes:
        out = os.pread(self._fd, length, off)
        while len(out) < length:  # short reads only happen at EOF...
            more = os.pread(self._fd, length - len(out), off + len(out))
            if not more:
                break
            out += more
        return out + b"\x00" * (length - len(out))  # ...sparse tail: zeros

    def flush(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            os.close(self._fd)


# ---------------------------------------------------------------------------


class BlockStore(KStore):
    """ObjectStore with data on a block device; see module docstring.

    Inherits the collection/attr/omap row handling from KStore and
    overrides only the data-bearing ops — the BlueStore/KStore contract
    difference is *where bytes live*, not what a Transaction means.

    Thread model: the data path is the owning (event-loop) thread plus
    the one background flusher; every entry point that touches the KV
    table, device, allocator, or caches serializes on `_lock` (an RLock
    so transaction compilation may re-enter `read`).
    """

    KIND = "blockstore"

    def __init__(self, db: KeyValueDB | None = None, config=None,
                 block_path: str | None = None):
        super().__init__(db)
        if config is None:
            from ceph_tpu_torch.common.config import Config

            config = Config()
        min_alloc = int(config.get("blockstore_min_alloc_size"))
        self.csum_block = int(config.get("blockstore_csum_block_size"))
        # geometry is pinned at mkfs: a later config change must not skew
        # how an existing store's checksums were laid out
        geom = self.db.get(_BMETA, b"geometry")
        if geom is not None:
            d = Decoder(geom)
            min_alloc, self.csum_block = int(d.u64()), int(d.u64())
        self.alloc = ExtentAllocator(
            min_alloc, capacity=int(config.get("blockstore_block_size"))
        )
        self.comp_mode = config.get("blockstore_compression_mode")
        self.comp_min = int(
            config.get("blockstore_compression_min_blob_size")
        )
        self._compressor = None
        if self.comp_mode != "none":
            from ceph_tpu_torch.common.compressor import factory

            self._compressor = factory(
                config.get("blockstore_compression_algorithm")
            )
        self.deferred_batch_bytes = int(
            config.get("blockstore_deferred_batch_bytes")
        )
        self.deferred_max_age = (
            int(config.get("blockstore_deferred_max_age_ms")) / 1000.0
        )
        self.onode_cache_size = int(
            config.get("blockstore_onode_cache_size")
        )
        self.buffer_cache_bytes = int(
            config.get("blockstore_buffer_cache_bytes")
        )
        if block_path is None:
            block_path = config.get("blockstore_block_path") or None
        if block_path is None and isinstance(
            getattr(self.db, "path", None), str
        ):
            block_path = os.path.join(self.db.path, "block")
        self.device = (
            FileBlockDevice(block_path) if block_path else MemBlockDevice()
        )
        # caches: committed truth only (folded in at commit points)
        self._onode_cache: OrderedDict[bytes, Onode] = OrderedDict()
        self._buffer_cache: OrderedDict[bytes, bytes] = OrderedDict()
        self._buffer_bytes = 0
        # one lock serializes the data path against the flusher thread
        self._lock = threading.RLock()
        self._flusher: threading.Thread | None = None
        self._flusher_stop = threading.Event()
        # set whenever the deferred backlog is empty — an event-driven
        # "WAL drained" signal (tests and external drivers wait on it
        # instead of polling the _DEFER prefix)
        self._deferred_drained = threading.Event()
        self._deferred_drained.set()
        self._closed = False
        # device fault layer: cached 1-in-N rates (config-observed so
        # injectargs flips them live) + the deterministic per-object set;
        # `_inj_read_armed` folds both into the ONE flag the read hot
        # path checks (the _InjectingStream disabled-cost rule)
        self._inj_read_rate = int(config.get("blockstore_inject_read_eio"))
        self._inj_write_rate = int(
            config.get("blockstore_inject_write_eio")
        )
        self._inj_fsync_rate = int(
            config.get("blockstore_inject_fsync_fail")
        )
        self._inject_read_keys: set[bytes] = set()
        self._inj_read_armed = bool(self._inj_read_rate)
        self._inj_rng = random.Random()
        config.observe("blockstore_inject_read_eio", self._on_inj_read)
        config.observe("blockstore_inject_write_eio", self._on_inj_write)
        config.observe("blockstore_inject_fsync_fail", self._on_inj_fsync)
        #: fail-stop state: a write/fsync device error flips this and the
        #: store refuses every further transaction with EROFS
        self._fenced = False
        #: callback(reason) fired exactly once when the store fences —
        #: the owning OSD hooks its fail-stop here; may be invoked from
        #: the flusher thread, so implementations must only schedule
        self.on_fatal = None
        self.perf = self._make_perf()
        # per-transaction compile state
        self._staged: dict[bytes, tuple[Onode, bytes]] = {}
        self._pending_release: list[tuple[int, int]] = []
        self._batch_allocs: list[tuple[int, int]] = []
        self._batch_drops: set[bytes] = set()
        self._batch_deferred_n = 0
        self._batch_big_n = 0
        self._last_deferred_n = 0
        self._last_big_n = 0
        self._mount(geom is None)

    def _make_perf(self) -> PerfCounters:
        perf = PerfCounters("blockstore")
        for key, desc in (
            ("onode_hit", "onode served from the LRU (no KV decode)"),
            ("onode_miss", "onode fetched from KV and decoded"),
            ("buffer_hit", "read served from the buffer cache "
                           "(no device IO, no checksum verify)"),
            ("buffer_miss", "read that went to the WAL row / device"),
            ("buffer_evict_bytes", "bytes LRU-evicted from the buffer "
                                   "cache"),
            ("write_big", "writes that took the COW big-write path"),
            ("write_deferred", "sub-min_alloc writes deferred onto the "
                               "KV WAL"),
            ("deferred_flush", "deferred-backlog flushes"),
            ("deferred_flush_aged", "flushes triggered by max-age, not "
                                    "byte pressure"),
            ("deferred_flush_ops", "payloads moved WAL -> device by "
                                   "flushes"),
            ("deferred_flush_errors", "background flush attempts that "
                                      "raised (retried next tick)"),
            ("dev_read_calls", "device pread calls issued"),
            ("dev_read_segments", "extents those preads covered "
                                  "(segments - calls = coalescing win)"),
            ("dev_write_calls", "device pwrite(v) calls issued"),
            ("dev_write_segments", "extents those pwrites covered"),
            ("inject_read_eio", "reads failed by the fault-injection "
                                "layer (rate or per-object)"),
            ("inject_write_eio", "device writes failed by injection "
                                 "(each one fences the store)"),
            ("inject_fsync_fail", "device fsyncs failed by injection "
                                  "(each one fences the store)"),
        ):
            perf.add_u64_counter(key, desc)
        for key, desc in (
            ("deferred_bytes", "deferred backlog riding the KV WAL"),
            ("deferred_peak_bytes", "high-watermark of the deferred "
                                    "backlog since mount"),
            ("deferred_ops", "deferred payload rows queued"),
            ("deferred_age_ms", "age of the oldest queued deferred "
                                "write at the last queue/flush event"),
            ("buffer_bytes", "bytes held by the buffer cache"),
            ("onode_entries", "onodes held by the LRU"),
            ("fenced", "1 when a write/fsync error has fenced the store "
                       "(read-only fail-stop state)"),
        ):
            perf.add_u64(key, desc)
        perf.add_time_avg(
            "l_flush", "deferred flush wall time (alloc+write+fsync+KV)"
        )
        return perf

    def _mount(self, mkfs: bool) -> None:
        raw = self.db.get(_BMETA, b"size")
        size = Decoder(raw).u64() if raw is not None else 0
        free = {
            int.from_bytes(k[1], "big"): Decoder(v).u64()
            for k, v in self.db.iterate(_FREE)
        }
        self.alloc.init(free, size)
        rows = list(self.db.iterate(_DEFER))
        self._deferred_bytes = sum(len(v) for _k, v in rows)
        self._deferred_ops = len(rows)
        # a backlog inherited across a crash starts its age clock at
        # mount; the flusher itself stays lazy (first write commit) so a
        # store opened only for inspection never mutates itself
        self._deferred_since = time.monotonic() if rows else None
        if rows:
            self._deferred_drained.clear()
        self._sync_gauges()
        if mkfs:
            kv = KVTransaction()
            kv.set(
                _BMETA, b"geometry",
                Encoder().u64(self.alloc.min_alloc_size)
                .u64(self.csum_block).bytes(),
            )
            self.db.submit_transaction(kv)

    # -- device fault layer (injection + fail-stop fencing) --------------------

    def _on_inj_read(self, _n, v) -> None:
        self._inj_read_rate = int(v)
        self._inj_read_armed = bool(
            self._inj_read_rate or self._inject_read_keys
        )

    def _on_inj_write(self, _n, v) -> None:
        self._inj_write_rate = int(v)

    def _on_inj_fsync(self, _n, v) -> None:
        self._inj_fsync_rate = int(v)

    @property
    def fenced(self) -> bool:
        return self._fenced

    def inject_data_error(self, coll: str, name: str) -> None:
        """Arm a deterministic read EIO for one object (the reference's
        `injectdataerr` admin command): every read of it fails until a
        write rewrites the object — which is exactly what a write-back
        repair does, so a healed object reads clean again. Drops the
        object's cached data so the next read really hits the fault."""
        with self._lock:
            key = _okey(coll, name)
            self._inject_read_keys.add(key)
            self._inj_read_armed = True
            self._buffer_drop(key)

    def _maybe_inject_read(self, key: bytes, label: str) -> None:
        """Slow path behind the single `_inj_read_armed` check."""
        if key in self._inject_read_keys:
            self.perf.inc("inject_read_eio")
            raise StoreError(
                "EIO", f"{label}: injected per-object read error"
            )
        rate = self._inj_read_rate
        if rate and self._inj_rng.randrange(rate) == 0:
            self.perf.inc("inject_read_eio")
            raise StoreError(
                "EIO",
                f"{label}: injected device read error (1-in-{rate})",
            )

    def _fatal(self, reason: str) -> None:
        """Fail-stop: fence the store (no further acks can lie about
        durability), fire on_fatal ONCE, and raise the fatal error. The
        callback only schedules (it may run on the flusher thread)."""
        if not self._fenced:
            self._fenced = True
            self.perf.set("fenced", 1)
            cb = self.on_fatal
            if cb is not None:
                try:
                    cb(reason)
                # cephlint: disable=error-taxonomy (fencing must proceed even if a death-callback misbehaves)
                except Exception:  # noqa: BLE001 - fencing must proceed
                    pass
        raise StoreFatalError("EIO", f"store fenced: {reason}")

    def _device_flush(self) -> None:
        """The one fsync site: injection check, then the real flush; a
        failure of either fences the store — an fsync error can never be
        retried-and-forgotten."""
        if (
            self._inj_fsync_rate
            and self._inj_rng.randrange(self._inj_fsync_rate) == 0
        ):
            self.perf.inc("inject_fsync_fail")
            self._fatal("injected fsync failure")
        try:
            self.device.flush()
        except OSError as e:
            self._fatal(f"device fsync failed: {e}")

    # -- caches ---------------------------------------------------------------

    def _sync_gauges(self) -> None:
        self.perf.set("deferred_bytes", self._deferred_bytes)
        self.perf.set_max("deferred_peak_bytes", self._deferred_bytes)
        self.perf.set("deferred_ops", self._deferred_ops)
        self.perf.set(
            "deferred_age_ms", int(self.deferred_age_s() * 1000)
        )
        self.perf.set("buffer_bytes", self._buffer_bytes)
        self.perf.set("onode_entries", len(self._onode_cache))

    def _onode_put(self, key: bytes, on: Onode) -> None:
        if self.onode_cache_size <= 0:
            return
        oc = self._onode_cache
        oc[key] = on
        oc.move_to_end(key)
        while len(oc) > self.onode_cache_size:
            oc.popitem(last=False)

    def _get_onode(self, key: bytes) -> Onode | None:
        """Committed onode for `key`, LRU first. None when absent."""
        on = self._onode_cache.get(key)
        if on is not None:
            self._onode_cache.move_to_end(key)
            self.perf.inc("onode_hit")
            return on
        raw = self.db.get(_ONODE, key)
        if raw is None:
            return None
        self.perf.inc("onode_miss")
        on = Onode.decode(raw)
        self._onode_put(key, on)
        return on

    def _buffer_drop(self, key: bytes) -> None:
        old = self._buffer_cache.pop(key, None)
        if old is not None:
            self._buffer_bytes -= len(old)

    def _buffer_put(self, key: bytes, data: bytes) -> None:
        if self.buffer_cache_bytes <= 0:
            return
        self._buffer_drop(key)
        if len(data) > self.buffer_cache_bytes:
            return
        self._buffer_cache[key] = data
        self._buffer_bytes += len(data)
        while self._buffer_bytes > self.buffer_cache_bytes:
            _k, v = self._buffer_cache.popitem(last=False)
            self._buffer_bytes -= len(v)
            self.perf.inc("buffer_evict_bytes", len(v))

    def drop_caches(self) -> None:
        """Forget every cached onode and data buffer — the cache state an
        OSD restart implies. The next reads hit the KV layer and the
        device, which is what makes injected at-rest bit-rot visible to a
        plain `read` again (deep scrub never needs this: `read_verify`
        bypasses the buffer cache by construction)."""
        with self._lock:
            self._onode_cache.clear()
            self._buffer_cache.clear()
            self._buffer_bytes = 0
            self._sync_gauges()

    # -- transaction compilation ----------------------------------------------

    def queue_transaction(self, txn) -> None:
        if self._fenced:
            # fail-stop contract: a fenced store refuses every write up
            # front — acking from a store that failed a write/fsync
            # would lie about durability
            raise StoreError(
                "EROFS",
                "store is fenced after a device write/fsync error; "
                "refusing writes",
            )
        sp = None if self.tracer is None else self.tracer.child(
            "blockstore_txn", tags={"ops": len(txn.ops)}
        )
        try:
            with self._lock:
                super().queue_transaction(txn)
                if sp is not None:
                    # write-path classification of the batch just
                    # committed (deferred = rode the KV WAL)
                    sp.set_tag("deferred", self._last_deferred_n)
                    sp.set_tag("big", self._last_big_n)
        finally:
            if sp is not None:
                sp.finish()

    def _begin_batch(self) -> None:
        self._staged = {}
        self._pending_release = []
        self._batch_allocs = []
        self._batch_drops = set()
        self._batch_deferred_n = 0
        self._batch_big_n = 0

    def _abort_batch(self) -> None:
        # compile failed before the commit point: hand batch allocations
        # back (their device bytes are garbage in free space — harmless),
        # re-derive the deferred backlog from committed rows, and drop
        # every touched cache entry (committed truth is re-readable)
        self.alloc.release(self._batch_allocs)
        rows = list(self.db.iterate(_DEFER))
        self._deferred_bytes = sum(len(v) for _k, v in rows)
        self._deferred_ops = len(rows)
        if not rows:
            self._deferred_since = None
            self._deferred_drained.set()
        for key in set(self._staged) | self._batch_drops:
            self._onode_cache.pop(key, None)
            self._buffer_drop(key)
        self._sync_gauges()
        self._begin_batch()

    def _commit_batch(self, kv: KVTransaction) -> None:
        # frees quarantined during compile join the allocator only now —
        # nothing between here and the KV submit allocates, so a freed
        # extent can never be rewritten before the free itself commits
        self.alloc.release(self._pending_release)
        self.alloc.flush(kv, _FREE, _BMETA)
        self._device_flush()  # data durable BEFORE metadata references it
        self.db.submit_transaction(kv)
        # the batch is durable: fold its effects into the caches (drops
        # first — a remove-then-write of one key re-stages it)
        for key in self._batch_drops:
            self._onode_cache.pop(key, None)
            self._buffer_drop(key)
        for key, (on, data) in self._staged.items():
            self._onode_put(key, on)
            self._buffer_put(key, data)
        if self._deferred_bytes > 0:
            if self._deferred_since is None:
                self._deferred_since = time.monotonic()
            self._deferred_drained.clear()
            self._maybe_start_flusher()
        else:
            self._deferred_since = None
            self._deferred_drained.set()
        self._sync_gauges()
        self._last_deferred_n = self._batch_deferred_n
        self._last_big_n = self._batch_big_n
        self._begin_batch()
        if self._deferred_bytes > self.deferred_batch_bytes:
            try:
                self.flush_deferred()
            except StoreError as e:
                # the batch ITSELF committed; a full device just leaves
                # the backlog on the (still authoritative) KV WAL until
                # frees open headroom — fatal errors still propagate
                if e.code != "ENOSPC":
                    raise

    def _compile_op(self, kv: KVTransaction, op: tuple) -> None:
        kind = op[0]
        if kind == "touch":
            _, coll, name = op
            key = _okey(coll, name)
            if key not in self._staged and self._get_onode(key) is None:
                on = Onode(csum_block=self.csum_block)
                kv.set(_ONODE, key, on.encode())
                self._staged[key] = (on, b"")
        elif kind == "write":
            _, coll, name, data, attrs = op
            key = _okey(coll, name)
            self._stage_write(kv, key, data)
            if attrs is not None:
                kv.set(_ATTR, key, _encode_attrs(attrs))
        elif kind == "write_at":
            _, coll, name, off, data = op
            key = _okey(coll, name)
            cur = self._compile_read(coll, name, key)
            if len(cur) < off:
                cur = cur + b"\x00" * (off - len(cur))
            self._stage_write(
                kv, key, cur[:off] + data + cur[off + len(data):]
            )
        elif kind == "remove":
            _, coll, name = op
            key = _okey(coll, name)
            self._forget(kv, key)
            self._batch_drops.add(key)
            kv.rm(_ONODE, key)
            kv.rm(_ATTR, key)
            for k, _v in list(self.db.iterate(_OMAP)):
                if k[1].startswith(key):
                    kv.rm(_OMAP, k[1])
        elif kind == "rmcoll":
            prefix = Encoder().string(op[1]).bytes()
            for k, _v in list(self.db.iterate(_ONODE)):
                if k[1].startswith(prefix):
                    self._forget(kv, k[1])
                    self._batch_drops.add(k[1])
            super()._compile_op(kv, op)  # coll row + rows via _rows_of
        else:
            super()._compile_op(kv, op)

    def _forget(self, kv: KVTransaction, key: bytes) -> None:
        """Release whatever payload the current onode (staged by an
        earlier op in this batch, else committed) holds for `key`."""
        staged = self._staged.pop(key, None)
        if staged is not None:
            on = staged[0]
        else:
            on = self._get_onode(key)
            if on is None:
                return
        if on.flags & FLAG_INLINE:
            kv.rm(_DEFER, key)
            self._deferred_bytes -= on.stored_len
            self._deferred_ops -= 1
        else:
            self._pending_release.extend(on.extents)

    def _stage_write(self, kv: KVTransaction, key: bytes,
                     data: bytes) -> None:
        self._forget(kv, key)
        data = bytes(data)
        payload, alg = data, ""
        if self._compressor is not None and len(data) >= self.comp_min:
            compressed, out = self._compressor.maybe_compress(
                data, mode=self.comp_mode
            )
            if compressed and len(out) < len(data):
                payload, alg = out, self._compressor.name
        on = Onode(
            size=len(data),
            flags=FLAG_COMPRESSED if alg else 0,
            comp_alg=alg,
            stored_len=len(payload),
            csum_block=self.csum_block,
        )
        on.csums = [
            ceph_crc32c(_CSUM_SEED, payload[i:i + self.csum_block])
            for i in range(0, len(payload), self.csum_block)
        ]
        if payload and len(payload) < self.alloc.min_alloc_size:
            on.flags |= FLAG_INLINE
            kv.set(_DEFER, key, payload)
            self._deferred_bytes += len(payload)
            self._deferred_ops += 1
            self._batch_deferred_n += 1
            self.perf.inc("write_deferred")
        elif payload:
            on.extents = self.alloc.allocate(len(payload))
            self._batch_allocs.extend(on.extents)
            self._write_extents(on.extents, payload)
            self._batch_big_n += 1
            self.perf.inc("write_big")
        kv.set(_ONODE, key, on.encode())
        self._staged[key] = (on, data)
        if self._inject_read_keys:
            # a rewrite replaces the faulty extents, so the armed
            # per-object error heals with the data (injectdataerr
            # semantics: repair write-backs read clean afterwards)
            self._inject_read_keys.discard(key)
            self._inj_read_armed = bool(
                self._inj_read_rate or self._inject_read_keys
            )

    def _compile_read(self, coll: str, name: str, key: bytes) -> bytes:
        """Object content as visible to the op being compiled: what an
        earlier op in this batch staged, else committed state."""
        staged = self._staged.get(key)
        if staged is not None:
            return staged[1]
        try:
            return self.read(coll, name)
        except StoreError as e:
            if e.code == "ENOENT":
                return b""
            raise

    # -- vectored device IO ----------------------------------------------------

    def _write_extents(self, extents, payload: bytes) -> None:
        self._write_plan(self._extent_chunks(extents, payload))

    @staticmethod
    def _extent_chunks(extents, payload: bytes):
        """[(device offset, chunk)] for a payload across its extents.
        Chunks are zero-padded to the extent length — the extents are
        freshly-allocated COW space, reads stop at stored_len, and full
        min_alloc-granular chunks let device-adjacent extents (even of
        different objects in a deferred batch) coalesce into one
        pwrite."""
        pos = 0
        plan = []
        for off, ln in extents:
            chunk = payload[pos:pos + ln]
            pos += len(chunk)
            if len(chunk) < ln:
                chunk = chunk + b"\x00" * (ln - len(chunk))
            if chunk:
                plan.append((off, chunk))
        return plan

    def _write_plan(self, plan) -> None:
        """Issue [(device offset, bytes)] writes, coalescing runs that
        are adjacent on the device into single vectored pwrites. A device
        write failure — injected or real — fences the store (fail-stop):
        the bytes under an extent the metadata is about to reference can
        no longer be trusted."""
        if not plan:
            return
        if (
            self._inj_write_rate
            and self._inj_rng.randrange(self._inj_write_rate) == 0
        ):
            self.perf.inc("inject_write_eio")
            self._fatal("injected device write error")
        plan = sorted(plan)
        run_off, run = plan[0][0], [plan[0][1]]
        run_end = run_off + len(plan[0][1])
        calls = 0
        try:
            for off, data in plan[1:]:
                if off == run_end:
                    run.append(data)
                else:
                    self.device.pwritev(run_off, run)
                    calls += 1
                    run_off, run = off, [data]
                run_end = off + len(data)
            self.device.pwritev(run_off, run)
        except OSError as e:
            self._fatal(f"device write failed: {e}")
        self.perf.inc("dev_write_calls", calls + 1)
        self.perf.inc("dev_write_segments", len(plan))

    # -- deferred writes -------------------------------------------------------

    def deferred_age_s(self) -> float:
        """Seconds the oldest queued deferred write has been waiting."""
        since = self._deferred_since
        return 0.0 if since is None else time.monotonic() - since

    def wait_deferred_drained(self, timeout: float | None = None) -> bool:
        """Block until the deferred backlog is empty — event-driven: the
        aging flusher, byte pressure, or an explicit flush sets the
        event the moment the last WAL row commits to the device. Returns
        False on timeout."""
        return self._deferred_drained.wait(timeout)

    def tick(self) -> int:
        """Age-based deferred flush: drain the backlog iff its oldest
        entry exceeds blockstore_deferred_max_age_ms. Called by the
        background flusher; also callable from an external driver loop
        (an OSD tick) when the flusher is disabled. Returns payloads
        moved."""
        with self._lock:
            self._sync_gauges()
            if self._closed or self._fenced or self._deferred_bytes <= 0:
                return 0
            if self.deferred_max_age <= 0:
                return 0
            if self.deferred_age_s() < self.deferred_max_age:
                return 0
            self.perf.inc("deferred_flush_aged")
            return self.flush_deferred()

    def _maybe_start_flusher(self) -> None:
        """Lazily spawn the aging flusher — only ever from a write
        commit, so read-only opens (fsck, objectstore_tool) never start
        one and never mutate the store under examination."""
        if (
            self._flusher is None
            and not self._closed
            and self.deferred_max_age > 0
        ):
            self._flusher = threading.Thread(
                target=self._flusher_main,
                name="blockstore-flusher",
                daemon=True,
            )
            self._flusher.start()

    def _flusher_main(self) -> None:
        interval = max(0.01, self.deferred_max_age / 4)
        while not self._flusher_stop.wait(interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - keep aging; retry next tick
                self.perf.inc("deferred_flush_errors")

    def _stop_flusher(self) -> None:
        """Join the flusher (outside the lock — it may hold it mid-flush)
        so no thread can touch the device after close."""
        t = self._flusher
        if t is None:
            return
        self._flusher_stop.set()
        t.join()
        self._flusher = None

    def flush_deferred(self) -> int:
        """Move every deferred payload onto the device (BlueStore's
        deferred_try_submit / _deferred_replay): ONE allocator pass for
        the whole backlog, one coalesced vectored write plan, one fsync,
        then ONE KV batch repoints the onodes and drops the WAL rows.
        Crash-safe at any point — until that batch commits, the _DEFER
        rows remain authoritative. Returns the number of payloads moved."""
        # flushes are their own (root) traces: they run from the aging
        # thread or byte pressure, not inside any one client op
        sp = None if self.tracer is None else self.tracer.start(
            "blockstore_flush", tags={"deferred": True}
        )
        try:
            return self._flush_deferred_inner(sp)
        finally:
            if sp is not None:
                sp.finish()

    def _flush_deferred_inner(self, sp) -> int:
        with self._lock:
            if self._fenced:
                return 0  # rows stay authoritative on the WAL; no acks lie
            t0 = time.perf_counter()
            rows = [(k[1], v) for k, v in self.db.iterate(_DEFER)]
            if not rows:
                self._deferred_bytes = 0
                self._deferred_ops = 0
                self._deferred_since = None
                self._deferred_drained.set()
                self._sync_gauges()
                return 0
            kv = KVTransaction()
            moved: list[tuple[bytes, Onode, bytes]] = []
            for key, payload in rows:
                raw = self.db.get(_ONODE, key)
                on = Onode.decode(raw) if raw is not None else None
                if on is None or not on.flags & FLAG_INLINE:
                    kv.rm(_DEFER, key)  # orphan WAL row: drop
                    continue
                moved.append((key, on, payload))
            if moved:
                extent_lists = self.alloc.allocate_many(
                    [len(p) for _k, _on, p in moved]
                )
                plan = []
                for (key, on, payload), extents in zip(
                    moved, extent_lists
                ):
                    on.extents = extents
                    on.flags &= ~FLAG_INLINE
                    kv.set(_ONODE, key, on.encode())
                    kv.rm(_DEFER, key)
                    plan.extend(self._extent_chunks(extents, payload))
                self._write_plan(plan)
            self.alloc.flush(kv, _FREE, _BMETA)
            self._device_flush()
            self.db.submit_transaction(kv)
            for key, on, _payload in moved:
                if key in self._onode_cache:
                    self._onode_cache[key] = on
            self._deferred_bytes = 0
            self._deferred_ops = 0
            self._deferred_since = None
            self._deferred_drained.set()
            self.perf.inc("deferred_flush")
            self.perf.inc("deferred_flush_ops", len(moved))
            self.perf.tinc("l_flush", time.perf_counter() - t0)
            if sp is not None:
                sp.set_tag("ops", len(moved))
            self._sync_gauges()
            return len(moved)

    def compact(self) -> None:
        """Flush the deferred backlog, then fold the KV WAL."""
        with self._lock:
            self.flush_deferred()
            if hasattr(self.db, "compact"):
                self.db.compact()

    def umount(self) -> None:
        """Clean shutdown: join the flusher BEFORE the device closes,
        drain deferred writes, close device + DB."""
        self._stop_flusher()
        with self._lock:
            if not self._closed:
                try:
                    self.flush_deferred()
                except StoreError:
                    # full (ENOSPC) or failing device at shutdown: the
                    # WAL rows stay authoritative and replay on the next
                    # mount — close must still proceed
                    pass
            self._closed = True
            self.device.close()
            if hasattr(self.db, "close"):
                self.db.close()

    def close(self) -> None:
        """Read-only close (fsck/tool path): no deferred flush, so an
        inspection never mutates the store under examination. A flusher
        is never *started* by this path (it spawns only from write
        commits), but one left over from earlier writes is still joined
        before the device goes away."""
        self._stop_flusher()
        with self._lock:
            self._closed = True
            self.device.close()
            if hasattr(self.db, "close"):
                self.db.close()

    # -- reads ----------------------------------------------------------------

    def exists(self, coll: str, name: str) -> bool:
        with self._lock:
            key = _okey(coll, name)
            if key in self._onode_cache:
                return True
            return self.db.get(_ONODE, key) is not None

    def read(self, coll: str, name: str) -> bytes:
        sp = None if self.tracer is None else self.tracer.child(
            "blockstore_read"
        )
        try:
            with self._lock:
                key = _okey(coll, name)
                data = self._buffer_cache.get(key)
                if data is not None:
                    self._buffer_cache.move_to_end(key)
                    self.perf.inc("buffer_hit")
                    if sp is not None:
                        sp.set_tag("cache", "hit")
                    return data
                self.perf.inc("buffer_miss")
                if sp is not None:
                    sp.set_tag("cache", "miss")
                return self._read_cold(coll, name, key)
        finally:
            if sp is not None:
                sp.finish()

    def read_verify(self, coll: str, name: str) -> bytes:
        """Read device truth: bypass the buffer cache, re-run the stored
        checksum verification, and refresh the cache with the verified
        bytes. Deep scrub reads through this so cached data can never
        mask at-rest corruption."""
        sp = None if self.tracer is None else self.tracer.child(
            "blockstore_read", tags={"verify": True, "cache": "bypass"}
        )
        try:
            with self._lock:
                return self._read_cold(coll, name, _okey(coll, name))
        finally:
            if sp is not None:
                sp.finish()

    def _read_cold(self, coll: str, name: str, key: bytes) -> bytes:
        on = self._get_onode(key)
        if on is None:
            raise StoreError("ENOENT", f"{coll}/{name} does not exist")
        payload = self._read_payload(key, on, f"{coll}/{name}")
        if on.flags & FLAG_COMPRESSED:
            from ceph_tpu_torch.common.compressor import factory

            try:
                data = factory(on.comp_alg).decompress(payload)
            except Exception as e:  # noqa: BLE001 - surfaced as EIO
                raise StoreError(
                    "EIO", f"{coll}/{name}: decompression failed: {e}"
                ) from e
            if len(data) != on.size:
                raise StoreError(
                    "EIO",
                    f"{coll}/{name}: decompressed to {len(data)} bytes, "
                    f"onode says {on.size}",
                )
        else:
            data = payload
        self._buffer_put(key, data)
        return data

    def _read_payload(self, key: bytes, on: Onode, label: str) -> bytes:
        if self._inj_read_armed:
            self._maybe_inject_read(key, label)
        if on.flags & FLAG_INLINE:
            payload = self.db.get(_DEFER, key)
            if payload is None:
                raise StoreError(
                    "EIO", f"{label}: deferred payload row missing"
                )
        else:
            takes = []
            remaining = on.stored_len
            for off, ln in on.extents:
                take = min(ln, remaining)
                if take:
                    takes.append((off, take))
                remaining -= take
            runs = _coalesce(takes)
            try:
                parts = [self.device.pread(off, ln) for off, ln in runs]
            except OSError as e:
                # a read error is recoverable ABOVE the store (the OSD
                # heals from replicas/EC survivors): surface, don't fence
                raise StoreError(
                    "EIO", f"{label}: device read failed: {e}"
                ) from e
            self.perf.inc("dev_read_calls", len(runs))
            self.perf.inc("dev_read_segments", len(takes))
            payload = b"".join(parts)
            if len(payload) != on.stored_len:
                raise StoreError(
                    "EIO",
                    f"{label}: extent map covers {len(payload)} of "
                    f"{on.stored_len} stored bytes",
                )
        bs = on.csum_block or self.csum_block
        want = (len(payload) + bs - 1) // bs
        if len(on.csums) != want:
            raise StoreError(
                "EIO",
                f"{label}: {len(on.csums)} checksums for {want} blocks",
            )
        for i, c in enumerate(on.csums):
            if ceph_crc32c(_CSUM_SEED, payload[i * bs:(i + 1) * bs]) != c:
                raise StoreError(
                    "EIO",
                    f"{label}: checksum mismatch in block {i} "
                    f"(at-rest corruption)",
                )
        return payload

    def list_objects(self, coll: str) -> list[str]:
        with self._lock:
            prefix = Encoder().string(coll).bytes()
            return [
                _okey_decode(k[1])[1]
                for k, _v in self.db.iterate(_ONODE)
                if k[1].startswith(prefix)
            ]

    def _rows_of(self, coll: str):
        prefix = Encoder().string(coll).bytes()
        for table in (_ONODE, _DEFER, _ATTR, _OMAP):
            for k, _v in list(self.db.iterate(table)):
                if k[1].startswith(prefix):
                    yield table, k[1]

    # the flusher thread mutates the (single) KV table dict mid-batch;
    # every reader that iterates it must hold the lock too
    def getattrs(self, coll: str, name: str) -> dict:
        with self._lock:
            return super().getattrs(coll, name)

    def omap_get(self, coll: str, name: str) -> dict[bytes, bytes]:
        with self._lock:
            return super().omap_get(coll, name)

    def collection_exists(self, coll: str) -> bool:
        with self._lock:
            return super().collection_exists(coll)

    def list_collections(self) -> list[str]:
        with self._lock:
            return super().list_collections()

    def used_bytes(self) -> int:
        """KV footprint (metadata + deferred WAL rows) plus the bytes the
        allocator has handed to live blobs."""
        with self._lock:
            return super().used_bytes() + self.alloc.allocated_bytes()

    def compression_stats(self) -> dict:
        """Per-blob compressed-length bookkeeping rolled up for `ceph
        df` (the bluestore_compressed/_original stat pair): logical vs
        stored bytes of every compressed onode. Scans the onode rows —
        the statfs caller caches, so the scan is off the hot path."""
        original = stored = blobs = 0
        with self._lock:
            for _k, raw in list(self.db.iterate(_ONODE)):
                try:
                    on = Onode.decode(raw)
                # cephlint: disable=error-taxonomy (undecodable onode is fsck's department, not stats')
                except Exception:  # fsck's department, not stats'
                    continue
                if on.flags & FLAG_COMPRESSED:
                    blobs += 1
                    original += on.size
                    stored += on.stored_len
        return {
            "compressed_blobs": blobs,
            "data_compressed_original": original,
            "data_compressed": stored,
        }

    # -- fsck -----------------------------------------------------------------

    def fsck(self, deep: bool = False) -> list[dict]:
        """Cross-check the whole store; returns one dict per error.

        Shallow: every onode decodes; inline onodes have their WAL row and
        no extents; no orphan WAL rows; onode extents vs the free list
        tile [0, device size) exactly (no overlap, no leak). Deep: also
        re-read every blob and verify its stored checksums (and that
        compressed blobs still decompress to the logical size). Reads go
        straight to the KV rows and the device — never the caches."""
        with self._lock:
            return self._fsck_locked(deep)

    def _fsck_locked(self, deep: bool) -> list[dict]:
        errors: list[dict] = []
        onodes: list[tuple[str, str, bytes, Onode]] = []
        allocated: list[tuple[int, int]] = []
        for k, raw in list(self.db.iterate(_ONODE)):
            key = k[1]
            try:
                coll, name = _okey_decode(key)
                on = Onode.decode(raw)
            except Exception as e:  # noqa: BLE001 - each row reported
                errors.append(
                    {"key": key.hex(), "error": f"undecodable onode: {e}"}
                )
                continue
            onodes.append((coll, name, key, on))
            allocated.extend(on.extents)
            if on.flags & FLAG_INLINE:
                if on.extents:
                    errors.append({
                        "object": f"{coll}/{name}",
                        "error": "inline onode with extents",
                    })
                if self.db.get(_DEFER, key) is None:
                    errors.append({
                        "object": f"{coll}/{name}",
                        "error": "deferred payload row missing",
                    })
        inline_keys = {
            key for _c, _n, key, on in onodes if on.flags & FLAG_INLINE
        }
        for k, _v in list(self.db.iterate(_DEFER)):
            if k[1] not in inline_keys:
                errors.append({
                    "key": k[1].hex(),
                    "error": "orphan deferred row (no inline onode)",
                })
        for msg in self.alloc.check(allocated):
            errors.append({"error": msg})
        if deep:
            for coll, name, key, on in onodes:
                try:
                    payload = self._read_payload(key, on, f"{coll}/{name}")
                    if on.flags & FLAG_COMPRESSED:
                        from ceph_tpu_torch.common.compressor import factory

                        out = factory(on.comp_alg).decompress(payload)
                        if len(out) != on.size:
                            raise StoreError(
                                "EIO", "decompressed size mismatch"
                            )
                except Exception as e:  # noqa: BLE001
                    errors.append(
                        {"object": f"{coll}/{name}", "error": str(e)}
                    )
        return errors
