"""Dataset writer: staged shard puts + atomic HEAD commit.

The ingest mirrors the checkpoint writer's crash-consistency staging
(ckpt/writer.py) so the same boundary tests apply:

  prepare()       records -> shard buffers + per-shard record indexes +
                  manifest (pure, no IO)
  put_shards()    bounded-window parallel striped writes, one
                  `<name>@<id>/shard.%08x` striped object + one `.idx`
                  object per shard; every record crc32c'd (and
                  optionally compressed) before it enters the stream
  put_manifest()  the shard-table manifest object
  commit()        compare-and-swap of `<name>.data-head` (the same
                  cls ckpt.cas_head primitive, keyed on this dataset's
                  ingest_id) — THE publish point

`ingest()` runs all four under one traced `data_ingest` root. Dying
before commit() leaves the previous committed dataset readable and the
partial ingest's shards as unreferenced orphans — a partial ingest is
never visible to readers.
"""

from __future__ import annotations

import asyncio
import json
import uuid

from ceph_tpu_torch.ckpt.layout import BF16_SCHEMA, host_array, is_bf16
from ceph_tpu_torch.common.compressor import factory as compressor_factory
from ceph_tpu_torch.data import layout
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError
from ceph_tpu_torch.rados.striper import RadosStriper


class DataConflict(RadosError):
    """Another ingest advanced the dataset HEAD between read and CAS."""


class DataWriter:
    def __init__(self, ioctx, name: str, *, ingest_id: str | None = None,
                 config=None, perf=None):
        self.ioctx = ioctx
        self.name = name
        self.config = config if config is not None else ioctx.objecter.config
        self.perf = perf
        self.ingest_id = ingest_id or uuid.uuid4().hex[:16]
        self.manifest: dict | None = None
        #: shard index -> (stream bytes, index entries)
        self._shards: list[tuple[bytes, list]] = []
        self._alg = self.config.get("data_compression_algorithm")
        self._compressor = compressor_factory(self._alg) if self._alg else None

    @property
    def tracer(self):
        return self.ioctx.objecter.tracer

    # -- stage 1: layout (pure) ----------------------------------------------

    def prepare(self, records) -> dict:
        """Cut `records` (an iterable of bytes, or of equi-shaped numpy
        arrays — then the manifest carries a fixed {dtype, shape} schema
        and the iterator yields stacked batches) into shard streams of
        ~data_shard_bytes, each with its [offset, stored, length, crc,
        compressed] record index. A record may also be a torch tensor, on
        any device: it leaves the device once."""
        shard_target = max(4096, int(self.config.get("data_shard_bytes")))
        alignment = layout.pool_alignment(
            self.ioctx.objecter.osdmap, self.ioctx.pool_id
        )
        schema = None
        payloads: list[bytes] = []
        for i, rec in enumerate(records):
            if isinstance(rec, (bytes, bytearray, memoryview)):
                if i == 0:
                    schema = None
                elif schema is not None:
                    raise ValueError("mixed tensor/bytes records")
                payloads.append(bytes(rec))
                continue
            arr = host_array(rec)  # a bfloat16 record: its raw bits as int16
            sch = {"dtype": BF16_SCHEMA if is_bf16(rec) else str(arr.dtype),
                   "shape": list(arr.shape)}
            if i == 0:
                schema = sch
            elif schema != sch:
                raise ValueError(
                    f"record {i} schema {sch} != record 0 schema {schema}"
                )
            payloads.append(arr.tobytes())

        self._shards = []
        buf = bytearray()
        entries: list = []

        def seal():
            if entries:
                self._shards.append((bytes(buf), list(entries)))
                buf.clear()
                entries.clear()

        for payload in payloads:
            stored, entry = layout.encode_record(
                payload, len(buf), self._compressor
            )
            buf.extend(stored)
            entries.append(entry)
            if len(buf) >= shard_target:
                seal()
        seal()

        self.manifest = layout.build_manifest(
            self.name, self.ingest_id,
            [
                {
                    "index": i,
                    "records": len(ents),
                    "bytes": sum(e[2] for e in ents),
                    "stored": len(stream),
                }
                for i, (stream, ents) in enumerate(self._shards)
            ],
            shard_bytes=shard_target,
            sub_object=layout.sub_object_bytes(alignment, shard_target),
            compress=self._alg or "",
            schema=schema,
        )
        return self.manifest

    # -- stage 2: shard puts ---------------------------------------------------

    async def put_shards(self) -> None:
        assert self.manifest is not None, "call prepare() first"
        striper = RadosStriper(
            self.ioctx,
            layout.shard_layout(
                self.manifest["sub_object"], self.manifest["sub_object"]
            ),
        )
        window = asyncio.Semaphore(
            max(1, self.config.get("data_max_inflight"))
        )
        inflight = 0

        async def put(i: int) -> None:
            nonlocal inflight
            async with window:
                inflight += 1
                if self.perf is not None:
                    self.perf.set_max("inflight_peak", inflight)
                try:
                    await self._put_one(striper, i)
                finally:
                    inflight -= 1

        await asyncio.gather(*(put(i) for i in range(len(self._shards))))

    async def _put_one(self, striper: RadosStriper, i: int) -> None:
        stream, entries = self._shards[i]
        soid = layout.shard_soid(self.name, self.ingest_id, i)
        span = self.tracer.child(
            "shard_put",
            tags={"object": soid, "bytes": len(stream),
                  "records": len(entries)},
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            await striper.write(soid, stream)
            await self.ioctx.write_full(
                layout.shard_index_object(self.name, self.ingest_id, i),
                layout.encode_index(entries),
            )
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
        if self.perf is not None:
            self.perf.inc("ingest_shards")
            self.perf.inc("ingest_records", len(entries))
            self.perf.inc("ingest_bytes", sum(e[2] for e in entries))
            self.perf.inc("ingest_stored_bytes", len(stream))

    # -- stage 3: manifest -----------------------------------------------------

    async def put_manifest(self) -> None:
        assert self.manifest is not None
        await self.ioctx.write_full(
            layout.manifest_object(self.name, self.ingest_id),
            layout.encode_manifest(self.manifest),
        )

    # -- stage 4: HEAD CAS (the publish point) ---------------------------------

    async def read_head(self):
        """Current committed ingest_id, or None before the first."""
        try:
            raw = await self.ioctx.read(layout.head_object(self.name))
        except ObjectNotFound:
            return None
        if not raw:
            return None  # xattr-created head object, nothing committed
        return json.loads(raw.decode()).get("save_id")

    _UNSET = object()

    async def commit(self, expect=_UNSET) -> str:
        """CAS the dataset HEAD to this ingest. The cas_head cls keys
        on "save_id", so the head dict carries ingest_id under that key
        (the cls is generic over what the id means)."""
        assert self.manifest is not None
        if expect is self._UNSET:
            expect = await self.read_head()
        head = {
            "name": self.name,
            "save_id": self.ingest_id,
            "manifest": layout.manifest_object(self.name, self.ingest_id),
            "record_count": self.manifest["record_count"],
            "total_bytes": self.manifest["total_bytes"],
            "shards": len(self.manifest["shards"]),
        }
        try:
            await self.ioctx.exec(
                layout.head_object(self.name), "ckpt", "cas_head",
                {"expect": expect, "head": head},
            )
        except RadosError as e:
            if "ECANCELED" in str(e):
                raise DataConflict(str(e)) from e
            raise
        if self.perf is not None:
            self.perf.inc("ingest_commits")
        return self.ingest_id

    # -- the whole ingest, traced ----------------------------------------------

    async def ingest(self, records=None) -> str:
        span = self.tracer.start(
            "data_ingest",
            tags={"name": self.name, "ingest_id": self.ingest_id},
            op_type="write",
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            if self.manifest is None:
                self.prepare(records if records is not None else [])
            if self.perf is not None:
                with self.perf.time("ingest_latency"):
                    await self.put_shards()
                    await self.put_manifest()
                    ingest_id = await self.commit()
            else:
                await self.put_shards()
                await self.put_manifest()
                ingest_id = await self.commit()
            if span is not None:
                span.set_tag("records", self.manifest["record_count"])
                span.set_tag("bytes", self.manifest["total_bytes"])
            return ingest_id
        except BaseException as e:
            if span is not None:
                span.set_tag("error", str(e) or type(e).__name__)
            raise
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
                self.ioctx.objecter._report_trace(span.trace_id)
