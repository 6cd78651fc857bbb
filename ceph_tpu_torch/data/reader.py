"""Dataset reader: deterministic sharded shuffle + prefetching iterator.

The iterator yields HOST BATCHES of records for one host of a multi-host
job. Its record order is a pure function of (ingest_id, seed, epoch,
num_hosts, host): an epoch-keyed Philox permutation globally shuffles
the dataset, `parallel.sharding.host_slice` cuts the shuffled sequence
into balanced contiguous per-host ranges, and position simply counts
records this host has yielded — so every process computes identical
sequences with no coordination, and a cursor (epoch, position) resumes
mid-epoch with the exact remaining records, no duplicates, no gaps.

Fetching is pipelined like the checkpoint restore (ckpt/reader.py): a
bounded number of upcoming batches prefetch in the background, with the
IO half (index fetch + ranged striper reads) split from the decode half
(decompress + crc + batch assembly) so RADOS round trips overlap decode
CPU. `data_prefetch_batches` bounds the readahead; 0 disables the
pipeline (serial fetch-on-demand — the bench baseline).

Readahead is block-granular: an EC primary must gather k shards and
decode the WHOLE sub-object to serve any ranged read of it, so a
shuffled batch's scattered per-record reads would re-decode the same
blocks over and over. The pipeline instead fetches whole striper
sub-objects — one decode each — into a `data_cache_bytes`-bounded LRU
and slices records out client-side; concurrent batches share in-flight
block fetches. The fetch-on-demand baseline (prefetch 0) keeps exact
coalesced per-record ranged reads: fewest bytes moved, one round trip
per run — the classic latency-vs-bandwidth readahead trade.

Reads go out on a cloned IoCtx whose qos_class is the mclock
data_prefetch class, so under `osd_op_queue=mclock` background prefetch
dequeues at `osd_mclock_data_weight` against foreground clients instead
of competing head-to-head.
"""

from __future__ import annotations

import asyncio
import json
from collections import OrderedDict, deque

import numpy as np

from ceph_tpu_torch.common.op_queue import QOS_DATA_PREFETCH
from ceph_tpu_torch.data import layout
from ceph_tpu_torch.parallel.sharding import host_slice
from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound
from ceph_tpu_torch.rados.striper import RadosStriper


class DataReader:
    def __init__(self, ioctx, name: str, *, config=None, perf=None):
        self.ioctx = ioctx
        self.name = name
        self.config = config if config is not None else ioctx.objecter.config
        self.perf = perf
        # prefetch traffic rides its own mclock class; metadata (head,
        # manifest) stays on the caller's handle. The caller's read
        # policy carries over: under balance/localize the bulk fetches
        # spread across clean replicas / go direct to EC data shards
        self._data_ioctx = IoCtx(ioctx.objecter, ioctx.pool_id)
        self._data_ioctx.qos_class = QOS_DATA_PREFETCH
        self._data_ioctx.read_policy = ioctx.read_policy

    @property
    def tracer(self):
        return self.ioctx.objecter.tracer

    # -- metadata --------------------------------------------------------------

    async def read_head(self) -> dict | None:
        try:
            raw = await self.ioctx.read(layout.head_object(self.name))
        except ObjectNotFound:
            return None
        if not raw:
            return None  # xattr-created head object, nothing committed
        return json.loads(raw.decode())

    async def read_manifest(self, ingest_id: str | None = None) -> dict:
        if ingest_id is None:
            head = await self.read_head()
            if head is None or not head.get("save_id"):
                raise ObjectNotFound(
                    f"dataset {self.name!r} has no committed ingest"
                )
            ingest_id = head["save_id"]
        raw = await self.ioctx.read(
            layout.manifest_object(self.name, ingest_id)
        )
        manifest = layout.decode_manifest(raw)
        if manifest["name"] != self.name:
            raise ValueError(
                f"manifest name {manifest['name']!r} != {self.name!r}"
            )
        return manifest

    # -- iteration -------------------------------------------------------------

    async def iterator(
        self, *, seed: int = 0, epoch: int = 0, position: int = 0,
        num_hosts: int = 1, host: int = 0, batch_size: int = 1,
        num_epochs: int | None = 1, ingest_id: str | None = None,
        partition: str = "slice", base: int = 0,
    ) -> "DataIterator":
        manifest = await self.read_manifest(ingest_id)
        return DataIterator(
            self, manifest,
            seed=seed, epoch=epoch, position=position,
            num_hosts=num_hosts, host=host, batch_size=batch_size,
            num_epochs=num_epochs, partition=partition, base=base,
        )

    async def resume(self, cursor: dict,
                     num_epochs: int | None = 1) -> "DataIterator":
        """An iterator positioned exactly where `cursor` (an iterator's
        `state()`, possibly round-tripped through a checkpoint via
        layout.cursor_array) left off."""
        if cursor["name"] != self.name:
            raise ValueError(
                f"cursor is for dataset {cursor['name']!r}, not "
                f"{self.name!r}"
            )
        return await self.iterator(
            seed=cursor["seed"], epoch=cursor["epoch"],
            position=cursor["position"], num_hosts=cursor["num_hosts"],
            host=cursor["host"], batch_size=cursor["batch_size"],
            num_epochs=num_epochs, ingest_id=cursor["ingest_id"],
            partition=cursor.get("partition", "slice"),
            base=cursor.get("base", 0),
        )

    # -- verify ----------------------------------------------------------------

    async def verify(self, ingest_id: str | None = None) -> dict:
        """Fetch every shard and check every record against its index
        crc32c; returns per-shard accounting, raises DataCorrupt on the
        first bad record."""
        manifest = await self.read_manifest(ingest_id)
        striper = self._striper(manifest)
        alg = manifest.get("compress") or ""
        shards = []
        for s in manifest["shards"]:
            soid = layout.shard_soid(
                self.name, manifest["ingest_id"], s["index"]
            )
            stream = await striper.read(soid)
            entries = await self._read_index(manifest, s["index"])
            for e in entries:
                layout.decode_record(stream[e[0]:e[0] + e[1]], e, alg)
            shards.append({"index": s["index"], "records": len(entries),
                           "bytes": s["bytes"]})
        return {
            "name": self.name,
            "ingest_id": manifest["ingest_id"],
            "record_count": manifest["record_count"],
            "total_bytes": manifest["total_bytes"],
            "shards": shards,
        }

    # -- internals shared with DataIterator ------------------------------------

    def _striper(self, manifest: dict) -> RadosStriper:
        # committed shards are immutable, so one header round trip per
        # shard soid serves every ranged read after it (header_cache)
        return RadosStriper(
            self._data_ioctx,
            layout.shard_layout(
                manifest["sub_object"], manifest["sub_object"]
            ),
            header_cache={},
        )

    async def _read_index(self, manifest: dict, shard: int) -> list:
        raw = await self._data_ioctx.read(
            layout.shard_index_object(
                self.name, manifest["ingest_id"], shard
            )
        )
        return layout.decode_index(raw)


class DataIterator:
    """Async iterator over one host's shuffled record sequence.

    `async for batch in it` yields lists of bytes records, or stacked
    (batch, *shape) numpy arrays for fixed-schema tensor datasets.
    `state()` at any point is a resumable cursor for the NEXT unyielded
    record.
    """

    def __init__(self, reader: DataReader, manifest: dict, *, seed, epoch,
                 position, num_hosts, host, batch_size, num_epochs,
                 partition: str = "slice", base: int = 0):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if partition not in layout.PARTITIONS:
            raise ValueError(f"unknown partition {partition!r}")
        self.reader = reader
        self.manifest = manifest
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.position = int(position)
        self.num_hosts = int(num_hosts)
        self.host = int(host)
        self.batch_size = int(batch_size)
        self.num_epochs = num_epochs
        self.partition = partition
        #: permuted ids below `base` belong to PREVIOUS host sets (a
        #: fleet rebase mid-epoch); only meaningful for "stride"
        self.base = int(base)
        self._epochs_done = 0
        self._starts = layout.shard_starts(manifest)
        self._striper = reader._striper(manifest)
        self._index_cache: dict[int, list] = {}
        self._host_ids: np.ndarray | None = None
        depth = int(reader.config.get("data_prefetch_batches"))
        self._prefetch = max(0, depth)
        #: bounds the IO half of in-flight batch fetches
        self._io_window = asyncio.Semaphore(
            max(1, reader.config.get("data_max_inflight"))
        )
        #: (epoch, position, task) readahead queue, front = next batch
        self._pending: deque[tuple[int, int, asyncio.Task]] = deque()
        #: sub-object block LRU ((shard, blockno) -> bytes) — readahead
        #: fetches whole blocks so the OSD decodes each EC sub-object
        #: once, not once per record; only active with the pipeline on
        self._cache_cap = (
            int(reader.config.get("data_cache_bytes"))
            if self._prefetch > 0 else 0
        )
        self._blocks: "OrderedDict[tuple[int, int], bytes]" = OrderedDict()
        self._block_bytes = 0
        #: in-flight block fetches, shared between concurrent batches
        self._block_tasks: dict[tuple[int, int], asyncio.Task] = {}
        self._schema = manifest.get("schema")
        self._alg = manifest.get("compress") or ""

    @property
    def perf(self):
        return self.reader.perf

    # -- deterministic plan ----------------------------------------------------

    def _epoch_ids(self) -> np.ndarray:
        """This host's record-id sequence for the current epoch."""
        if self._host_ids is None:
            n = self.manifest["record_count"]
            if self.perf is not None:
                with self.perf.time("shuffle_latency"):
                    perm = layout.epoch_permutation(n, self.seed, self.epoch)
            else:
                perm = layout.epoch_permutation(n, self.seed, self.epoch)
            if self.partition == "stride":
                self._host_ids = perm[self.base + self.host::self.num_hosts]
            else:
                self._host_ids = perm[
                    host_slice(n, self.num_hosts, self.host)
                ]
        return self._host_ids

    def _advance_epoch(self) -> bool:
        self._epochs_done += 1
        if (self.num_epochs is not None
                and self._epochs_done >= self.num_epochs):
            return False
        self.epoch += 1
        self.position = 0
        self.base = 0  # rebase offsets are an intra-epoch artifact
        self._host_ids = None
        return True

    def state(self) -> dict:
        """The resumable cursor for the next unyielded record (persist
        alongside a checkpoint via layout.cursor_array)."""
        return layout.cursor_state(
            name=self.reader.name,
            ingest_id=self.manifest["ingest_id"],
            seed=self.seed, epoch=self.epoch, position=self.position,
            num_hosts=self.num_hosts, host=self.host,
            batch_size=self.batch_size,
            partition=self.partition, base=self.base,
        )

    # -- batch fetch (IO half vs decode half) ----------------------------------

    async def _fetch_batch(self, epoch: int, position: int):
        """Fetch + decode the batch at (epoch, position). The IO —
        index fetches and coalesced ranged striped reads — runs under
        the shared readahead window; decode runs outside it so the next
        batch's reads overlap this batch's CPU."""
        tracer = self.reader.tracer
        span = tracer.start(
            "data_fetch",
            tags={"name": self.reader.name, "epoch": epoch,
                  "position": position},
            op_type="read",
        )
        token = tracer.use(span) if span is not None else None
        try:
            ids = self._batch_ids(epoch, position)
            # group the batch's global record ids by shard
            by_shard: dict[int, list[tuple[int, int]]] = {}
            for slot, rid in enumerate(ids):
                si, local = layout.locate(self.manifest, self._starts,
                                          int(rid))
                by_shard.setdefault(si, []).append((slot, local))

            async with self._io_window:
                shard_chunks = await asyncio.gather(*(
                    self._fetch_shard_entries(si, slots)
                    for si, slots in sorted(by_shard.items())
                ))
            batch = self._decode(span, ids, shard_chunks)
            if span is not None:
                span.set_tag("records", len(ids))
            if self.perf is not None:
                self.perf.inc("records_out", len(ids))
                self.perf.inc("batches_out")
            return batch
        except BaseException as e:
            if span is not None:
                span.set_tag("error", str(e) or type(e).__name__)
            raise
        finally:
            if span is not None:
                tracer.release(token)
                span.finish()
                self.reader.ioctx.objecter._report_trace(span.trace_id)

    def _batch_ids(self, epoch: int, position: int) -> np.ndarray:
        assert epoch == self.epoch, "prefetch crossed an epoch boundary"
        ids = self._epoch_ids()
        return ids[position:position + self.batch_size]

    async def _fetch_shard_entries(self, si: int, slots):
        """(batch slot, index entry, stored record bytes) triples for
        the requested local records of shard `si`."""
        entries = self._index_cache.get(si)
        if entries is None:
            entries = await self.reader._read_index(self.manifest, si)
            self._index_cache[si] = entries
        wanted = {}
        for slot, local in slots:
            wanted.setdefault(local, []).append(slot)
        if self._cache_cap > 0:
            by_offset = await self._stored_from_blocks(
                si, [entries[lo] for lo in wanted]
            )
        else:
            by_offset = await self._stored_from_runs(
                si, [entries[lo] for lo in wanted]
            )
        out = []
        for local, slot_list in wanted.items():
            e = entries[local]
            for slot in slot_list:
                out.append((slot, *by_offset[e[0]]))
        return out

    async def _stored_from_runs(self, si: int, want_entries) -> dict:
        """Fetch-on-demand path (pipeline off): one coalesced ranged
        read per adjacent run of records — fewest bytes moved."""
        runs = layout.coalesce_entries(want_entries)
        soid = layout.shard_soid(
            self.reader.name, self.manifest["ingest_id"], si
        )
        blobs = await asyncio.gather(*(
            self._striper.read(soid, r["offset"], r["length"])
            for r in runs
        ))
        if self.perf is not None:
            self.perf.inc("fetch_bytes", sum(len(b) for b in blobs))
            self.perf.inc("fetch_runs", len(runs))
        by_offset = {}
        for run, blob in zip(runs, blobs):
            off = run["offset"]
            for e in run["entries"]:
                rel = e[0] - off
                by_offset[e[0]] = (e, blob[rel:rel + e[1]])
        return by_offset

    async def _stored_from_blocks(self, si: int, want_entries) -> dict:
        """Readahead path (pipeline on): fetch the whole sub-object
        blocks covering the records — the OSD decodes each EC block
        once, the LRU serves every later record that lands in it."""
        sub = self.manifest["sub_object"]
        bids = sorted({
            bno
            for e in want_entries
            for bno in range(e[0] // sub, (e[0] + max(e[1], 1) - 1) // sub + 1)
        })
        blocks = dict(zip(bids, await asyncio.gather(
            *(self._block(si, bno) for bno in bids)
        )))
        by_offset = {}
        for e in want_entries:
            out = bytearray()
            off, left = e[0], e[1]
            while left > 0:
                bno, boff = divmod(off, sub)
                take = min(left, sub - boff)
                out += blocks[bno][boff:boff + take]
                off += take
                left -= take
            by_offset[e[0]] = (e, bytes(out))
        return by_offset

    async def _block(self, si: int, bno: int) -> bytes:
        key = (si, bno)
        blk = self._blocks.get(key)
        if blk is not None:
            self._blocks.move_to_end(key)
            if self.perf is not None:
                self.perf.inc("cache_hit_blocks")
            return blk
        task = self._block_tasks.get(key)
        if task is not None:
            # another in-flight batch is already fetching this block;
            # shield so our cancellation can't kill their fetch
            return await asyncio.shield(task)
        task = asyncio.create_task(self._fetch_block(si, bno))
        self._block_tasks[key] = task
        try:
            blk = await task
        finally:
            self._block_tasks.pop(key, None)
        self._blocks[key] = blk
        self._block_bytes += len(blk)
        while self._block_bytes > self._cache_cap and len(self._blocks) > 1:
            _, old = self._blocks.popitem(last=False)
            self._block_bytes -= len(old)
        return blk

    async def _fetch_block(self, si: int, bno: int) -> bytes:
        sub = self.manifest["sub_object"]
        soid = layout.shard_soid(
            self.reader.name, self.manifest["ingest_id"], si
        )
        blk = await self._striper.read(soid, bno * sub, sub)
        if self.perf is not None:
            self.perf.inc("fetch_bytes", len(blk))
            self.perf.inc("fetch_runs")
            self.perf.inc("cache_fetch_blocks")
        return blk

    def _decode(self, span, ids, shard_chunks):
        """Decode half: decompress + crc-check every record, assemble
        the batch in shuffled order (pure CPU, no IO)."""
        tracer = self.reader.tracer
        child = None
        if span is not None:
            child = tracer.child("record_decode",
                                 tags={"records": len(ids)})
        try:
            payloads: list[bytes | None] = [None] * len(ids)
            if self.perf is not None:
                with self.perf.time("decode_latency"):
                    for slot, entry, stored in (
                        p for chunk in shard_chunks for p in chunk
                    ):
                        payloads[slot] = layout.decode_record(
                            stored, entry, self._alg
                        )
            else:
                for slot, entry, stored in (
                    p for chunk in shard_chunks for p in chunk
                ):
                    payloads[slot] = layout.decode_record(
                        stored, entry, self._alg
                    )
            assert all(p is not None for p in payloads)
            if self._schema is None:
                return payloads
            dtype = np.dtype(self._schema["dtype"])
            shape = tuple(self._schema["shape"])
            return np.stack([
                np.frombuffer(p, dtype=dtype).reshape(shape)
                for p in payloads
            ])
        finally:
            if child is not None:
                child.finish()

    # -- the prefetch pipeline -------------------------------------------------

    def _spawn_ahead(self) -> None:
        """Top the readahead queue up to prefetch depth + the batch
        being consumed, without crossing the current epoch (the next
        epoch's permutation doesn't exist until this one finishes)."""
        ids = self._epoch_ids()
        while len(self._pending) < self._prefetch + 1:
            last_pos = (self._pending[-1][1] + self.batch_size
                        if self._pending else self.position)
            if last_pos >= len(ids):
                break
            self._pending.append((
                self.epoch, last_pos,
                asyncio.create_task(self._fetch_batch(self.epoch, last_pos)),
            ))
            if self.perf is not None:
                self.perf.set_max("prefetch_peak", len(self._pending) - 1)

    def __aiter__(self):
        return self

    async def __anext__(self):
        while True:
            if self.position < len(self._epoch_ids()):
                break
            for _, _, t in self._pending:
                t.cancel()
            self._pending.clear()
            if not self._advance_epoch():
                raise StopAsyncIteration
        if self._prefetch == 0:
            batch = await self._fetch_batch(self.epoch, self.position)
            if self.perf is not None:
                self.perf.inc("prefetch_waits")
        else:
            self._spawn_ahead()
            epoch, pos, task = self._pending.popleft()
            assert (epoch, pos) == (self.epoch, self.position)
            if self.perf is not None:
                self.perf.inc(
                    "prefetch_hits" if task.done() else "prefetch_waits"
                )
            batch = await task
            self._spawn_ahead()
        self.position += len(batch)
        return batch

    async def aclose(self) -> None:
        for _, _, t in self._pending:
            t.cancel()
        for _, _, t in self._pending:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._pending.clear()
