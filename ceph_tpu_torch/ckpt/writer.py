"""Checkpoint writer: parallel chunk puts + atomic HEAD commit.

The save is staged so crash-consistency is testable at every boundary:

  prepare()       pytree -> manifest + serialized stream (no IO)
  put_chunks()    fingerprint every chunk, diff against the previous
                  committed manifest (incremental dedup: unchanged
                  chunks are REFERENCED from the prior save, not
                  re-uploaded), then bounded-window parallel
                  `write_full` per remaining chunk, each crc32c'd (and
                  optionally compressed) before send
  put_manifest()  the manifest object
  commit()        compare-and-swap of the HEAD pointer (cls ckpt.cas_head
                  inside the primary) — THE commit point

`save()` runs all four under one traced root. Dying before commit()
(the kill -9 window) leaves HEAD on the previous complete checkpoint;
the new save's chunks are orphans for gc.py. Dedup composes with that
story because gc is manifest-reachability based: a referenced chunk of
an old save stays live while any retained manifest points at it.

Port of ceph_tpu/ckpt/writer.py. A leaf on a card leaves it once, as one
device-to-host copy (`layout.host_array`); a MeshArray leaf's slots stand
in for a jax array's addressable shards.
"""

from __future__ import annotations

import asyncio
import json
import uuid

import numpy as np

from ceph_tpu_torch.ckpt import layout
from ceph_tpu_torch.common.compressor import factory as compressor_factory
from ceph_tpu_torch.parallel.sharding import MeshArray
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError


class CkptConflict(RadosError):
    """Another saver advanced HEAD between our read and our CAS."""


class CkptAborted(RadosError):
    """A fleet-parallel save was aborted before commit (a writer died
    mid-put, or the leader gave up): HEAD still points at the previous
    complete checkpoint; the staged chunks are gc debris."""


class CkptWriter:
    def __init__(self, ioctx, name: str, tree, *, save_id: str | None = None,
                 config=None, perf=None):
        self.ioctx = ioctx
        self.name = name
        self.tree = tree
        self.config = config if config is not None else ioctx.objecter.config
        self.perf = perf
        self.save_id = save_id or uuid.uuid4().hex[:16]
        self.manifest: dict | None = None
        self._stream: bytes | None = None
        #: fleet-parallel state: this writer's rank, the writer count,
        #: the un-serialized leaf records and the per-chunk payload
        #: cache (owned chunks only — the ≤ tree_bytes/N working set)
        self.rank: int | None = None
        self._records: list[dict] | None = None
        self._chunk_cache: dict[str, bytes] = {}
        self._np_blocks: dict[int, tuple[int, np.ndarray]] = {}
        alg = self.config.get("ckpt_compression_algorithm")
        self._compressor = compressor_factory(alg) if alg else None

    @property
    def tracer(self):
        return self.ioctx.objecter.tracer

    # -- stage 1: layout (pure) ----------------------------------------------

    def _chunk_size(self) -> int:
        alignment = layout.pool_alignment(
            self.ioctx.objecter.osdmap, self.ioctx.pool_id
        )
        return layout.chunk_bytes(
            self.config.get("ckpt_chunk_target_bytes"), alignment
        )

    def prepare(self) -> dict:
        records = layout.flatten_tree(self.tree)
        self.manifest = layout.build_manifest(
            self.name, self.save_id, records,
            chunk_size=self._chunk_size(),
            compress=self.config.get("ckpt_compression_algorithm"),
        )
        # one device-to-host copy per leaf; row-major bytes, manifest order
        self._stream = b"".join(
            layout.host_array(r["leaf"]).tobytes() for r in records
        )
        assert len(self._stream) == self.manifest["stream_bytes"]
        if self.perf is not None:
            self.perf.inc("save_prepared_bytes", len(self._stream))
        return self.manifest

    def prepare_parallel(self, num_hosts: int, rank: int, *,
                         parent: str | None = None) -> dict:
        """The fleet-parallel stage 1: the SAME deterministic manifest
        on every rank (chunk cuts slab-aligned, every chunk carrying
        its writer), but NO stream snapshot — owned chunks serialize
        lazily, slab by slab, so this rank's peak prepared host bytes
        stay ≈ tree_bytes / num_hosts (save_prepared_bytes-verified).
        `parent` is the dedup baseline pinned in the staging record so
        all ranks diff against the same committed save."""
        if not 0 <= rank < num_hosts:
            raise ValueError(f"rank {rank} outside [0, {num_hosts})")
        self.rank = rank
        self._records = layout.flatten_tree(self.tree)
        self.manifest = layout.build_manifest(
            self.name, self.save_id, self._records,
            chunk_size=self._chunk_size(),
            compress=self.config.get("ckpt_compression_algorithm"),
            parent=parent, writers=num_hosts,
        )
        return self.manifest

    def owned_chunks(self) -> list[tuple[int, dict]]:
        """(index, chunk) pairs this rank writes."""
        assert self.manifest is not None and self.rank is not None
        return [(i, c) for i, c in enumerate(self.manifest["chunks"])
                if c.get("writer") == self.rank]

    # -- stage 2: incremental diff + chunk puts -------------------------------

    _NO_PIN = object()

    async def _load_parent(self, parent_id=_NO_PIN) -> dict | None:
        """The dedup-baseline manifest. By default the committed HEAD's;
        a fleet-parallel save passes the parent save_id PINNED in the
        staging record (all ranks must diff against the same baseline)
        or an explicit None (no baseline). Returns None when incremental
        saving is off or the manifest is unreadable — every chunk then
        uploads; correctness never depends on the diff."""
        if not self.config.get("ckpt_incremental"):
            return None
        try:
            if parent_id is self._NO_PIN:
                raw = await self.ioctx.read(layout.head_object(self.name))
                parent_id = json.loads(raw.decode()).get("save_id")
            if not parent_id:
                return None
            raw = await self.ioctx.read(
                layout.manifest_object(self.name, parent_id)
            )
            return layout.decode_manifest(raw)
        except (ObjectNotFound, ValueError):
            return None

    def _fingerprint(self, chunks: list[dict]) -> None:
        # fingerprint first (pure CPU): the crc every put needs anyway,
        # composed into the content hash the dedup diff keys on
        for chunk in chunks:
            chunk["hash"] = layout.chunk_fingerprint(self._payload(chunk))
            chunk["crc"] = int(chunk["hash"][16:], 16)

    def _note_reused(self, chunks: list[dict], reused: int) -> None:
        if self.perf is not None and reused:
            self.perf.inc("save_chunks_reused", reused)
            self.perf.inc("save_bytes_reused", sum(
                c["length"] for c in chunks if c.get("reused")
            ))

    async def _put_all(self, chunks: list[dict]) -> None:
        """Bounded-window parallel puts of every non-reused chunk."""
        window = asyncio.Semaphore(
            max(1, self.config.get("ckpt_max_inflight"))
        )
        inflight = 0

        async def put(chunk: dict) -> None:
            nonlocal inflight
            async with window:
                inflight += 1
                if self.perf is not None:
                    self.perf.set_max("inflight_peak", inflight)
                try:
                    await self._put_one(chunk)
                finally:
                    inflight -= 1

        await asyncio.gather(
            *(put(c) for c in chunks if not c.get("reused"))
        )

    async def put_chunks(self) -> None:
        assert self.manifest is not None, "call prepare() first"
        chunks = self.manifest["chunks"]
        self._fingerprint(chunks)
        parent = await self._load_parent()
        reused = layout.diff_chunks(self.manifest, parent)
        if parent is not None:
            self.manifest["parent"] = parent["save_id"]
        self._note_reused(chunks, reused)
        await self._put_all(chunks)

    async def put_rank_chunks(self) -> list[tuple[int, dict]]:
        """The fleet-parallel stage 2, rank-local: fingerprint, dedup
        and put ONLY the chunks this rank owns. The diff runs against
        the parent pinned at prepare_parallel — rank-local fingerprints,
        merged into the manifest by the leader. Returns the owned
        (index, chunk) pairs (the rank-meta payload)."""
        own = self.owned_chunks()
        chunks = [c for _, c in own]
        self._fingerprint(chunks)
        parent = await self._load_parent(self.manifest.get("parent"))
        reused = layout.diff_chunks({"chunks": chunks}, parent)
        self._note_reused(chunks, reused)
        await self._put_all(chunks)
        self._chunk_cache.clear()
        self._np_blocks.clear()
        return own

    def _payload(self, chunk: dict) -> bytes:
        if self._stream is not None:
            return self._stream[
                chunk["offset"]:chunk["offset"] + chunk["length"]
            ]
        cached = self._chunk_cache.get(chunk["object"])
        if cached is None:
            cached = self._assemble(chunk)
            self._chunk_cache[chunk["object"]] = cached
            if self.perf is not None:
                self.perf.inc("save_prepared_bytes", len(cached))
        return cached

    def _block(self, ai: int) -> tuple[int, np.ndarray]:
        """(base_row, rows) covering every chunk this rank assembles of
        array `ai`, materialized to host memory ONCE: fleet-sharded
        arrays fetch just this rank's slab (a MeshArray slot's block when
        one matches — no device gather, no per-chunk dispatch), other
        leaves their (replicated, host-local) whole."""
        cached = self._np_blocks.get(ai)
        if cached is not None:
            return cached
        a = self.manifest["arrays"][ai]
        leaf = self._records[ai]["leaf"]
        shape = a["shape"]
        nrows = shape[0] if shape else 0
        writers = self.manifest.get("writers", 0)
        if (a["spec"] and shape
                and layout.fleet_sharded(a["spec"][0], nrows, writers)):
            sl = layout.fleet_slab(nrows, writers, self.rank)
            block = None
            for index, data in (leaf.slots if isinstance(leaf, MeshArray) else ()):
                if index and index[0] == sl:
                    block = layout.host_array(data)
                    break
            if block is None:
                block = layout.host_array(leaf)[sl]
            cached = (sl.start, np.ascontiguousarray(block))
        else:
            cached = (0, np.ascontiguousarray(layout.host_array(leaf)))
        self._np_blocks[ai] = cached
        return cached

    def _assemble(self, chunk: dict) -> bytes:
        """Serialize JUST the stream range [offset, offset+length) from
        the materialized row blocks: on a real multi-host fleet the
        rows that leave the device are exactly this rank's addressable
        shards (slab-aligned cuts), plus whole small replicated leaves."""
        lo = chunk["offset"]
        hi = lo + chunk["length"]
        out = []
        for ai, a in enumerate(self.manifest["arrays"]):
            a_off, a_end = a["offset"], a["offset"] + a["nbytes"]
            if a_end <= lo or a_off >= hi:
                continue
            s, e = max(lo, a_off) - a_off, min(hi, a_end) - a_off
            shape = a["shape"]
            base, block = self._block(ai)
            if shape and shape[0] > 0:
                row = a["nbytes"] // shape[0]
                r0, r1 = s // row, -(-e // row)
                raw = block[r0 - base:r1 - base].tobytes()
                out.append(raw[s - r0 * row:e - r0 * row])
            else:
                out.append(block.tobytes()[s:e])
        payload = b"".join(out)
        assert len(payload) == chunk["length"]
        return payload

    async def _put_one(self, chunk: dict) -> None:
        payload = self._payload(chunk)
        if self._compressor is not None:
            compressed, payload = self._compressor.maybe_compress(payload)
            chunk["compressed"] = bool(compressed)
        chunk["stored"] = len(payload)
        span = self.tracer.child(
            "chunk_put",
            tags={"object": chunk["object"], "bytes": len(payload)},
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            await self.ioctx.write_full(chunk["object"], payload)
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
        if self.perf is not None:
            self.perf.inc("save_chunks")
            self.perf.inc("save_bytes", chunk["length"])

    # -- fleet-parallel rank metadata -----------------------------------------

    _META_FIELDS = ("object", "hash", "crc", "stored", "compressed",
                    "reused")

    async def put_rank_meta(self, own: list[tuple[int, dict]]) -> None:
        """Publish this rank's completion record: the final chunk-table
        fields for every owned chunk. Written AFTER the chunks land, so
        its presence certifies the rank's share is durable — the leader
        commits only when every rank's record exists."""
        meta = {
            "save_id": self.save_id,
            "rank": self.rank,
            "chunks": {
                str(i): {f: c[f] for f in self._META_FIELDS}
                for i, c in own
            },
        }
        await self.ioctx.write_full(
            layout.rank_meta_object(self.name, self.save_id, self.rank),
            json.dumps(meta, sort_keys=True).encode(),
        )

    async def read_rank_meta(self, rank: int) -> dict | None:
        try:
            raw = await self.ioctx.read(
                layout.rank_meta_object(self.name, self.save_id, rank)
            )
            return json.loads(raw.decode())
        except (ObjectNotFound, ValueError):
            return None

    def merge_rank_meta(self, metas: list[dict]) -> None:
        """Leader-side manifest merge: fold every rank's chunk fields
        (fingerprints, dedup decisions, stored sizes) into the one
        manifest that gets committed. Raises CkptAborted if any chunk
        remains uncovered — a writer died before publishing."""
        assert self.manifest is not None
        chunks = self.manifest["chunks"]
        for meta in metas:
            for i, fields in meta.get("chunks", {}).items():
                chunk = chunks[int(i)]
                for f in self._META_FIELDS:
                    chunk[f] = fields[f]
        missing = [i for i, c in enumerate(chunks) if c["crc"] is None]
        if missing:
            raise CkptAborted(
                f"save {self.save_id}: {len(missing)} chunks have no "
                f"writer record (first: {missing[0]})"
            )

    async def cleanup_rank_meta(self, num_hosts: int) -> None:
        """Best-effort removal of the per-rank records after commit or
        abort (gc would reclaim them as unreferenced debris anyway)."""
        for r in range(num_hosts):
            try:
                await self.ioctx.remove(
                    layout.rank_meta_object(self.name, self.save_id, r)
                )
            except RadosError:
                pass

    # -- stage 3: manifest -----------------------------------------------------

    async def put_manifest(self) -> None:
        assert self.manifest is not None
        await self.ioctx.write_full(
            layout.manifest_object(self.name, self.save_id),
            layout.encode_manifest(self.manifest),
        )

    # -- stage 4: HEAD CAS (the commit point) ---------------------------------

    async def read_head(self):
        """Current HEAD save_id, or None before the first commit."""
        try:
            raw = await self.ioctx.read(layout.head_object(self.name))
        except ObjectNotFound:
            return None
        if not raw:
            # the object can pre-exist HEAD with empty data: taking the
            # committer lock (an xattr) creates it
            return None
        return json.loads(raw.decode()).get("save_id")

    _UNSET = object()

    async def commit(self, expect=_UNSET) -> str:
        """CAS the HEAD pointer to this save. `expect` pins the HEAD the
        caller observed (lost-update guard for concurrent savers); by
        default the current HEAD is read just before the swap."""
        assert self.manifest is not None
        if expect is self._UNSET:
            expect = await self.read_head()
        head = {
            "name": self.name,
            "save_id": self.save_id,
            "manifest": layout.manifest_object(self.name, self.save_id),
            "stream_bytes": self.manifest["stream_bytes"],
            "chunks": len(self.manifest["chunks"]),
        }
        try:
            await self.ioctx.exec(
                layout.head_object(self.name), "ckpt", "cas_head",
                {"expect": expect, "head": head},
            )
        except RadosError as e:
            if "ECANCELED" in str(e):
                raise CkptConflict(str(e)) from e
            raise
        if self.perf is not None:
            self.perf.inc("save_commits")
        return self.save_id

    # -- the whole save, traced ------------------------------------------------

    async def save(self) -> str:
        span = self.tracer.start(
            "ckpt_save",
            tags={"name": self.name, "save_id": self.save_id},
            op_type="write",
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            if self.manifest is None:
                self.prepare()
            if self.perf is not None:
                with self.perf.time("save_latency"):
                    await self.put_chunks()
                    await self.put_manifest()
                    save_id = await self.commit()
            else:
                await self.put_chunks()
                await self.put_manifest()
                save_id = await self.commit()
            if span is not None:
                span.set_tag("bytes", self.manifest["stream_bytes"])
            return save_id
        except BaseException as e:
            if span is not None:
                span.set_tag("error", str(e) or type(e).__name__)
            raise
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
                self.ioctx.objecter._report_trace(span.trace_id)
