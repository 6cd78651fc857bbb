"""Checkpoint reader: pipelined crc-verified full restore + sharding-
aware partial restore (reshard-on-load).

Full restore is a bounded-window PIPELINE, mirroring the writer: up to
`ckpt_restore_readahead` ranged chunk reads are in flight at once (0
inherits `ckpt_max_inflight`), and each chunk's decompress/crc/placement
runs AFTER its read releases the window slot — so the next read is
already on the wire while this chunk verifies and lands in the
preallocated stream buffer. Restore is no longer read-then-place serial.

Sharded restore resolves each array's saved PartitionSpec against the
mesh present NOW (parallel/sharding.device_slices) and fetches ONLY the
byte runs the addressable shards need — partial chunk reads, accounted
in the `restore_read_bytes` counter so tests can assert a single-shard
restore really moved fewer bytes. A mesh with a different device count
than the save mesh just yields different slabs: reshard-on-load needs
no resave. Dedup'd manifests need no special casing anywhere here: a
reused chunk's `object` already names the save that stored the bytes.

Port of ceph_tpu/ckpt/reader.py. A full restore gives torch tensors on the
device the caller names (cuda by default, which raises without a card): one
host-to-device copy per leaf. A mesh restore gives
`parallel.sharding.MeshArray`s: each distinct slab is fetched once and
copied once to each device whose slots hold it.
"""

from __future__ import annotations

import asyncio
import bisect
import json

import numpy as np
import torch

from ceph_tpu_torch.ckpt import layout
from ceph_tpu_torch.common.compressor import factory as compressor_factory
from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.parallel.sharding import (
    MeshArray, _kept, _slab_key, device_slices, slab_shape, slice_byte_runs,
)
from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound
from ceph_tpu_torch.rados.striper import read_runs


class CkptCorrupt(Exception):
    """A chunk failed its manifest crc/length check."""


class CkptReader:
    def __init__(self, ioctx, name: str, *, config=None, perf=None):
        self.ioctx = ioctx
        self.name = name
        self.config = config if config is not None else ioctx.objecter.config
        self.perf = perf
        # chunk data reads ride their own handle carrying the caller's
        # read policy: a restore is exactly the N-reader fan-in balanced
        # reads exist for (every host hammering the same chunk objects'
        # primaries), and EC chunk ranges go direct to the data shards.
        # Metadata (head, manifest) stays on the caller's handle — tiny,
        # and freshest at the primary.
        self._data_ioctx = IoCtx(ioctx.objecter, ioctx.pool_id)
        self._data_ioctx.qos_class = ioctx.qos_class
        self._data_ioctx.read_policy = ioctx.read_policy

    @property
    def tracer(self):
        return self.ioctx.objecter.tracer

    async def read_head(self) -> dict:
        raw = await self.ioctx.read(layout.head_object(self.name))
        if not raw:
            # xattr-only head object (committer lock taken, nothing
            # committed yet) reads as empty — same as no checkpoint
            raise ObjectNotFound(
                f"checkpoint {self.name!r} has no committed HEAD"
            )
        return json.loads(raw.decode())

    async def read_manifest(self, save_id: str | None = None) -> dict:
        if save_id is None:
            save_id = (await self.read_head())["save_id"]
        raw = await self.ioctx.read(
            layout.manifest_object(self.name, save_id)
        )
        return layout.decode_manifest(raw)

    # -- chunk fetch -----------------------------------------------------------

    def _window(self) -> asyncio.Semaphore:
        """The readahead window: how many chunk reads may be on the
        wire at once while completed chunks decode and place."""
        depth = self.config.get("ckpt_restore_readahead") or \
            self.config.get("ckpt_max_inflight")
        return asyncio.Semaphore(max(1, depth))

    async def _read_chunk(self, chunk: dict) -> bytes:
        """The IO half of a chunk fetch: raw (possibly compressed)
        payload off the wire, traced, byte-accounted."""
        span = self.tracer.child(
            "chunk_get", tags={"object": chunk["object"]}
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            payload = await self._data_ioctx.read(chunk["object"])
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
        if self.perf is not None:
            self.perf.inc("restore_read_bytes", len(payload))
        return payload

    def _decode_chunk(
        self, chunk: dict, payload: bytes, *, verify: bool = True
    ) -> bytes:
        """The pure half: decompress + length/crc checks. Runs OUTSIDE
        the readahead window so it overlaps the reads still in flight."""
        if chunk["stored"] is not None and len(payload) != chunk["stored"]:
            raise CkptCorrupt(
                f"{chunk['object']}: stored {len(payload)} bytes, "
                f"manifest says {chunk['stored']}"
            )
        if chunk["compressed"]:
            alg = self._manifest_compress
            payload = compressor_factory(alg).decompress(payload)
        if len(payload) != chunk["length"]:
            raise CkptCorrupt(
                f"{chunk['object']}: {len(payload)} bytes after "
                f"decompress, manifest says {chunk['length']}"
            )
        if verify and chunk["crc"] is not None:
            crc = ceph_crc32c(0xFFFFFFFF, payload)
            if crc != chunk["crc"]:
                raise CkptCorrupt(
                    f"{chunk['object']}: crc {crc:#x} != "
                    f"manifest {chunk['crc']:#x}"
                )
        return payload

    async def _fetch_chunk(self, chunk: dict, *, verify: bool = True) -> bytes:
        """One whole chunk, decompressed, crc-checked."""
        return self._decode_chunk(
            chunk, await self._read_chunk(chunk), verify=verify
        )

    _manifest_compress = ""

    # -- full restore ----------------------------------------------------------

    async def restore(self, *, mesh=None, save_id: str | None = None, device=None):
        """The tree of one save (HEAD by default): tensors on `device`
        (cuda by default), or MeshArrays on `mesh` when one is given."""
        device = resolve_device(device) if mesh is None else None
        span = self.tracer.start(
            "ckpt_restore", tags={"name": self.name}, op_type="read"
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            manifest = await self.read_manifest(save_id)
            self._manifest_compress = manifest.get("compress", "")
            if self.perf is not None:
                with self.perf.time("restore_latency"):
                    tree = await self._restore_inner(manifest, mesh, device)
            else:
                tree = await self._restore_inner(manifest, mesh, device)
            if span is not None:
                span.set_tag("save_id", manifest["save_id"])
            return tree
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
                self.ioctx.objecter._report_trace(span.trace_id)

    async def _restore_inner(self, manifest: dict, mesh, device):
        if mesh is None:
            return await self._restore_full(manifest, device)
        return await self._restore_sharded(manifest, mesh)

    async def _restore_full(self, manifest: dict, device):
        window = self._window()
        chunks = manifest["chunks"]
        # placement target: one preallocated buffer, filled per chunk
        # as its read lands (no read-then-place barrier, no join copy)
        buf = bytearray(manifest["stream_bytes"])
        if self.perf is not None:
            self.perf.inc("restore_host_bytes", manifest["stream_bytes"])
        inflight = 0

        async def get(chunk):
            nonlocal inflight
            async with window:
                inflight += 1
                if self.perf is not None:
                    self.perf.set_max("restore_readahead_peak", inflight)
                try:
                    payload = await self._read_chunk(chunk)
                finally:
                    inflight -= 1
            # decode + place with the window slot RELEASED: the next
            # chunk's read is already in flight while this one verifies
            payload = self._decode_chunk(chunk, payload)
            buf[chunk["offset"]:chunk["offset"] + chunk["length"]] = payload

        await asyncio.gather(*(get(c) for c in chunks))
        stream = buf  # np.frombuffer reads the bytearray zero-copy
        records = []
        for a in manifest["arrays"]:
            arr = np.frombuffer(
                stream, dtype=np.dtype(a["dtype"]),
                count=int(np.prod(a["shape"], dtype=np.int64)),
                offset=a["offset"],
            ).reshape(a["shape"]).copy()
            records.append((a["path"], torch.from_numpy(arr).to(device)))
            if self.perf is not None:
                self.perf.inc("restore_bytes", a["nbytes"])
        return layout.unflatten(records)

    # -- sharded restore (reshard-on-load) ------------------------------------

    async def _read_range(
        self, manifest: dict, offset: int, length: int,
        window: asyncio.Semaphore, cache: dict,
    ) -> bytes:
        """`length` bytes at stream `offset`, spliced across chunks with
        partial object reads (the fewer-bytes fast path). Compressed
        chunks cannot be ranged — they fetch whole, once, via `cache`.
        Chunk lookup bisects the offset table (cached per manifest):
        fleet-parallel manifests cut chunks at shard slab boundaries, so
        chunk lengths are NOT uniform."""
        chunks = manifest["chunks"]
        offs = manifest.get("_chunk_offs")
        if offs is None:
            # read-side cache only; never serialized back
            offs = manifest["_chunk_offs"] = [c["offset"] for c in chunks]
        out = []
        while length > 0:
            ci = bisect.bisect_right(offs, offset) - 1
            chunk = chunks[ci]
            off_in = offset - chunk["offset"]
            take = min(length, chunk["length"] - off_in)
            if chunk["compressed"]:
                if ci not in cache:
                    async with window:
                        if ci not in cache:
                            cache[ci] = await self._fetch_chunk(chunk)
                out.append(cache[ci][off_in:off_in + take])
            else:
                # ranged sub-object read via the shared striper helper
                # (offset/length pushdown; the same path the dataset
                # iterator's coalesced record runs ride)
                [part] = await read_runs(
                    self._data_ioctx,
                    [(chunk["object"], off_in, take)],
                    window,
                )
                if self.perf is not None:
                    self.perf.inc("restore_read_bytes", len(part))
                out.append(part)
            offset += take
            length -= take
        return b"".join(out)

    async def fetch_block(
        self, manifest: dict, a: dict, idx,
        window: asyncio.Semaphore | None = None,
        cache: dict | None = None,
    ) -> np.ndarray:
        """One shard slab of array entry `a`: ONLY the byte runs `idx`
        covers leave the cluster (slice_byte_runs coalescing), which is
        what the restore_read_bytes counter verifies."""
        window = window if window is not None else self._window()
        cache = cache if cache is not None else {}
        dtype = np.dtype(a["dtype"])
        runs = slice_byte_runs(a["shape"], dtype.itemsize, idx)
        if self.perf is not None:
            # host-resident bytes this slab materializes: the counter
            # the zero-reassembly bound is verified against (shard
            # bytes, not full-array bytes)
            self.perf.inc("restore_host_bytes",
                          sum(r[1] for r in runs))
        parts = await asyncio.gather(*(
            self._read_range(
                manifest, a["offset"] + off, length, window, cache
            )
            for off, length in runs
        ))
        shape = slab_shape(idx, a["shape"])
        block = np.frombuffer(b"".join(parts), dtype=dtype)
        return block.reshape(shape)

    async def read_shard(
        self, path_key: str, idx, *, save_id: str | None = None, device=None,
    ) -> torch.Tensor:
        """Single-shard restore: the slab `idx` of the array whose
        joined path is `path_key` (e.g. "params/w"), fetching only the
        bytes that shard needs — the per-host primitive a multi-host
        restore is made of — as a tensor on `device` (cuda by default)."""
        device = resolve_device(device)
        manifest = await self.read_manifest(save_id)
        self._manifest_compress = manifest.get("compress", "")
        for a in manifest["arrays"]:
            if "/".join(str(e[1]) for e in a["path"]) == path_key:
                block = await self.fetch_block(manifest, a, idx)
                return torch.from_numpy(block.copy()).to(device)
        raise KeyError(path_key)

    async def _restore_sharded(self, manifest: dict, mesh):
        window = self._window()
        #: whole-chunk cache shared across arrays (compressed chunks)
        cache: dict[int, bytes] = {}
        devices = mesh.slot_devices()

        async def restore_array(a: dict):
            shape = tuple(a["shape"])
            spec = _kept(a["spec"], mesh, len(shape))
            idxs = device_slices(shape, spec, mesh)
            # fetch each UNIQUE slab once; replicated slots share it
            unique = {}
            for idx in idxs:
                unique.setdefault(_slab_key(idx, shape), idx)
            blocks = dict(zip(
                unique.keys(),
                await asyncio.gather(*(
                    self.fetch_block(manifest, a, idx, window, cache)
                    for idx in unique.values()
                )),
            ))
            if self.perf is not None:
                self.perf.inc("restore_bytes", a["nbytes"])
            # one copy of a slab per device that holds it
            placed: dict = {}
            slots = []
            for idx, dev in zip(idxs, devices):
                key = (_slab_key(idx, shape), dev)
                if key not in placed:
                    placed[key] = torch.from_numpy(
                        blocks[key[0]].copy()).to(dev)
                slots.append((idx, placed[key]))
            dtype = torch.from_numpy(np.empty(0, np.dtype(a["dtype"]))).dtype
            return MeshArray(shape, dtype, spec, mesh, slots)

        arrays = await asyncio.gather(
            *(restore_array(a) for a in manifest["arrays"])
        )
        return layout.unflatten([
            (a["path"], arr)
            for a, arr in zip(manifest["arrays"], arrays)
        ])

    # -- verify ----------------------------------------------------------------

    async def verify(self, save_id: str | None = None) -> dict:
        """Fetch + crc-check every chunk of one save; report without
        raising so ckpt_tool can print the damage."""
        manifest = await self.read_manifest(save_id)
        self._manifest_compress = manifest.get("compress", "")
        window = self._window()
        bad: list[dict] = []

        async def check(chunk):
            async with window:
                try:
                    await self._fetch_chunk(chunk)
                except (CkptCorrupt, ObjectNotFound) as e:
                    bad.append({
                        "object": chunk["object"], "error": str(e)
                    })

        await asyncio.gather(*(check(c) for c in manifest["chunks"]))
        return {
            "name": self.name,
            "save_id": manifest["save_id"],
            "chunks": len(manifest["chunks"]),
            "stream_bytes": manifest["stream_bytes"],
            "bad": sorted(bad, key=lambda b: b["object"]),
            "ok": not bad,
        }
