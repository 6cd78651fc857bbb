"""DataStore: the user-facing dataset handle (ingest/iterate/resume/
ls/verify over one IoCtx + dataset name), with the per-store perf
block the acceptance tests and data_tool read — the CkptStore shape,
for training data."""

from __future__ import annotations

import json

from ceph_tpu_torch.ckpt import gc as gc_mod
from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.data import layout
from ceph_tpu_torch.data.reader import DataIterator, DataReader
from ceph_tpu_torch.data.writer import DataWriter
from ceph_tpu_torch.rados.client import ObjectNotFound


class DataStore:
    def __init__(self, ioctx, name: str, *, config=None):
        self.ioctx = ioctx
        self.name = name
        self.config = config if config is not None else ioctx.objecter.config
        self.perf = self._make_perf(name)

    @staticmethod
    def _make_perf(name: str) -> PerfCounters:
        p = PerfCounters(f"data.{name}")
        p.add_u64_counter("ingest_records", "records written by ingests")
        p.add_u64_counter("ingest_bytes", "logical record bytes ingested")
        p.add_u64_counter(
            "ingest_stored_bytes",
            "shard-stream bytes after compression (compare with "
            "ingest_bytes for the compression ratio)",
        )
        p.add_u64_counter("ingest_shards", "shard objects written")
        p.add_u64_counter("ingest_commits", "HEAD CAS publishes")
        p.add_u64_counter("records_out", "records yielded to iterators")
        p.add_u64_counter("batches_out", "batches yielded to iterators")
        p.add_u64_counter(
            "fetch_bytes",
            "shard bytes fetched by iterators (coalesced ranged reads)",
        )
        p.add_u64_counter(
            "fetch_runs",
            "ranged reads issued (records_out / fetch_runs is the "
            "coalescing factor)",
        )
        p.add_u64_counter(
            "cache_fetch_blocks",
            "sub-object blocks fetched by readahead (one EC decode "
            "each at the OSD)",
        )
        p.add_u64_counter(
            "cache_hit_blocks",
            "record fetches served from the resident block LRU",
        )
        p.add_u64_counter(
            "prefetch_hits",
            "batches already resident when the consumer asked",
        )
        p.add_u64_counter(
            "prefetch_waits",
            "batches the consumer had to block for",
        )
        p.add_u64("inflight_peak", "peak concurrent shard puts")
        p.add_u64(
            "prefetch_peak",
            "peak batches in the readahead pipeline (bounded by "
            "data_prefetch_batches)",
        )
        p.add_time_avg("ingest_latency", "wall time per ingest()")
        p.add_time_avg(
            "shuffle_latency", "epoch permutation compute per epoch"
        )
        p.add_time_avg(
            "decode_latency",
            "decompress + crc + assembly CPU per batch (the half the "
            "prefetch pipeline overlaps with IO)",
        )
        return p

    # -- write path ------------------------------------------------------------

    def writer(self, *, ingest_id: str | None = None) -> DataWriter:
        """A staged writer (prepare/put_shards/put_manifest/commit) —
        the crash-consistency tests drive the stages directly."""
        return DataWriter(
            self.ioctx, self.name,
            ingest_id=ingest_id, config=self.config, perf=self.perf,
        )

    async def ingest(self, records, *,
                     ingest_id: str | None = None) -> str:
        return await self.writer(ingest_id=ingest_id).ingest(records)

    # -- read path -------------------------------------------------------------

    def reader(self) -> DataReader:
        return DataReader(
            self.ioctx, self.name, config=self.config, perf=self.perf
        )

    async def iterator(self, **kw) -> DataIterator:
        return await self.reader().iterator(**kw)

    async def resume(self, cursor, *,
                     num_epochs: int | None = 1) -> DataIterator:
        """Resume from a cursor dict or a checkpoint-embedded cursor
        array (layout.cursor_array round trip)."""
        if not isinstance(cursor, dict):
            cursor = layout.cursor_from_array(cursor)
        return await self.reader().resume(cursor, num_epochs=num_epochs)

    async def head(self) -> dict | None:
        try:
            raw = await self.ioctx.read(layout.head_object(self.name))
        except ObjectNotFound:
            return None
        return json.loads(raw.decode())

    async def ls(self) -> dict:
        """Every ingest_id present in the pool for this name, annotated
        with HEAD/manifest status (aborted ingests show
        committed=False)."""
        head = await self.head()
        head_id = None if head is None else head.get("save_id")
        history = [] if head is None else head.get("history") or []
        ingests: dict[str, dict] = {}
        for obj in await gc_mod.list_objects(
            self.ioctx, prefix=f"{self.name}@"
        ):
            iid = layout.ingest_id_of(obj, self.name)
            entry = ingests.setdefault(
                iid, {"ingest_id": iid, "objects": 0, "manifest": False}
            )
            entry["objects"] += 1
            if obj == layout.manifest_object(self.name, iid):
                entry["manifest"] = True
        for iid, entry in ingests.items():
            entry["committed"] = iid in history or iid == head_id
            if entry["manifest"]:
                try:
                    m = await self.reader().read_manifest(iid)
                    entry["record_count"] = m["record_count"]
                    entry["total_bytes"] = m["total_bytes"]
                    entry["shards"] = len(m["shards"])
                except (ObjectNotFound, ValueError):
                    pass
        return {
            "name": self.name,
            "head": head_id,
            "history": history,
            "ingests": sorted(
                ingests.values(), key=lambda e: e["ingest_id"]
            ),
        }

    async def verify(self, ingest_id: str | None = None) -> dict:
        return await self.reader().verify(ingest_id)

    def perf_dump(self) -> dict:
        return self.perf.dump()
