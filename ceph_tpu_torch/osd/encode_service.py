"""EncodeService: coalesce concurrent per-object EC work into planar launches.

Port of ceph_tpu/osd/encode_service.py. A 4 KiB object write encodes 512 B
chunks — far too small to feed a device — but N concurrent writes stacked end
to end along the chunk axis are one wide (k, N·chunk/4) planar `encode_words`
call on the CUDA kernel (ceph_tpu_torch.ops.gf_cuda). The reference's analogue
is ECBackend's op pipelining (start_rmw batches in-flight ops,
ECBackend.cc:1830) feeding ISA-L's wide SIMD units.

Mechanics: the first enqueue arms a latency-bound flush (the batch window);
everything that arrives while the window is open rides the same launch.
`launches`/`objects` counters let tests assert the coalescing actually
happened (objects >> launches under concurrency).

Paths, chosen per batch by the codec's `device`:
  * cuda — the host pack, one host-to-device copy, one
    `encode_words`/`decode_words` kernel launch, one device-to-host copy.
    The flush runs on the event-loop thread; the device-to-host copy waits
    for the kernel, so results are complete before any future resolves.
  * cpu — the exact table-driven numpy path (`gf_region_matmul`).
  * mesh — a planar batch of at least `mesh_min_bytes` columns when the
    service has a device mesh (`parallel.sharding`): the width, zero-padded
    to a multiple of the mesh's slots, folds onto the (stripe, byte) mesh,
    and every slot encodes or decodes its block with one B3 launch on its
    device and stream (B8); the padding is cut off again. The mesh is the
    `mesh=` argument, else the largest power-of-2 set of the visible cards
    when there are several of them; on one card there is none, and the
    cuda path above serves every batch.
The service's own `device` (default cuda) picks no path: a planar codec on
another kind of device is refused when its op is enqueued.

Codecs without the planar API fall back to their per-object paths.
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ops.gf import gf_region_matmul


def _bucket_pad(words: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad the planar width up to a power-of-2 bucket (zero columns encode to
    zero parity; sliced off). The reference package pads so batches reuse a
    handful of jit compilations. The CUDA kernel masks its ragged edge and
    compiles once, so this service launches at the exact width and does not
    call it; it stays for callers that want bucketed shapes."""
    w = words.shape[-1]
    bucket = max(256, 1 << (w - 1).bit_length())
    if bucket == w:
        return words, w
    padded = np.zeros((*words.shape[:-1], bucket), dtype=words.dtype)
    padded[..., :w] = words
    return padded, w


def _mesh_pad(planes: np.ndarray, slots: int) -> tuple[np.ndarray, int]:
    """Zero-pad the planar width to a multiple of the mesh's slots, so it
    folds evenly onto the mesh (zero columns code to zero; cut off after)."""
    w = planes.shape[-1]
    padded_w = -(-w // slots) * slots
    if padded_w == w:
        return planes, w
    padded = np.zeros((*planes.shape[:-1], padded_w), dtype=planes.dtype)
    padded[..., :w] = planes
    return padded, w


_UNSET = object()


def pack_objects(k: int, items) -> np.ndarray:
    """Planar (k, W) uint8 from whole objects: `items` are (data, block
    size); object data fills its k blocks in order, zero-padded at the end."""
    items = list(items)
    planes = np.zeros((k, sum(bs for _data, bs in items)), dtype=np.uint8)
    off = 0
    for data, bs in items:
        src = np.frombuffer(data, dtype=np.uint8)
        view = planes[:, off: off + bs]
        full, rest = divmod(len(src), bs)
        view[:full] = src[: full * bs].reshape(full, bs)
        if rest:
            view[full, :rest] = src[full * bs:]
        off += bs
    return planes


def pack_survivors(codec, present, items) -> np.ndarray:
    """Planar (len(present), W) uint8 from per-object chunk maps: `items` are
    (chunks, block size); row i holds each object's chunk of logical id
    present[i], end to end."""
    items = list(items)
    planes = np.empty((len(present), sum(bs for _c, bs in items)), dtype=np.uint8)
    off = 0
    for chunks, bs in items:
        for i, logical in enumerate(present):
            planes[i, off: off + bs] = np.frombuffer(
                chunks[codec.chunk_index(logical)], dtype=np.uint8
            )
        off += bs
    return planes


class EncodeService:
    def __init__(
        self, window: float = 0.002, max_batch: int = 128,
        mesh_min_bytes: int = 8192, tracer=None, device=None, mesh=None,
    ):
        #: optional distributed tracer: traced ops get an encode_wait
        #: span (enqueue -> result) and each launch an encode_batch span
        #: tagged with batch size and whether this planar shape is new
        self.tracer = tracer
        #: the kind of device every planar codec served must live on
        self.device = resolve_device(device)
        #: (path, k, n, width) planar shapes already launched
        self._seen_shapes: set[tuple] = set()
        #: seconds the first op of a batch waits for company
        self.window = window
        self.max_batch = max_batch
        self._enc_q: dict[int, list] = {}
        self._dec_q: dict[tuple, list] = {}
        self._codecs: dict[int, object] = {}
        #: armed window timers, cancelled on flush (a stale timer from a
        #: max_batch-flushed batch would otherwise cut the NEXT window
        #: short and erode coalescing under sustained load). Decode
        #: timers are keyed per CODEC: one shared window drains every
        #: erasure signature queued for it (mass-failure recovery waves
        #: mix signatures; a window per signature would serialize them)
        self._enc_timers: dict[int, object] = {}
        self._dec_timers: dict[int, object] = {}
        #: launches / objects served — the coalescing evidence
        self.launches = 0
        self.objects = 0
        #: planar widths >= this dispatch through the device mesh: the
        #: batch's byte axis folds onto the (stripe, byte) mesh with no
        #: communication; below it one device serves the batch
        self.mesh_min_bytes = mesh_min_bytes
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"a mesh of {mesh.device_type} devices given to an "
                f"EncodeService on {self.device}"
            )
        self._mesh_cache = _UNSET if mesh is None else mesh
        #: launches that went through the sharded mesh path
        self.mesh_launches = 0

    def _mesh(self, width_bytes: int):
        """The device mesh for a planar launch of `width_bytes`, or None
        (one device, or a width too small to amortize the dispatch)."""
        if width_bytes < self.mesh_min_bytes:
            return None
        if self._mesh_cache is _UNSET:
            n = torch.cuda.device_count() if self.device.type == "cuda" else 1
            self._mesh_cache = None
            if n > 1:
                from ceph_tpu_torch.parallel import sharding

                # largest power-of-2 subset, as the reference takes
                self._mesh_cache = sharding.ec_mesh(1 << (n.bit_length() - 1))
        return self._mesh_cache

    # -- the device round trip -------------------------------------------------

    def _check_codec(self, codec) -> None:
        if codec.device.type != self.device.type:
            raise ValueError(
                f"codec on {codec.device} given to an EncodeService on "
                f"{self.device}"
            )

    @staticmethod
    def _on_device(planes: np.ndarray, device: torch.device, launch) -> np.ndarray:
        """Host (rows, W) uint8 planes -> one copy to `device`, `launch`
        (int32 words on the device -> int32 words), one device-to-host
        copy -> (out rows, W) uint8."""
        words = torch.from_numpy(planes.view(np.int32)).to(device)
        out = launch(words).cpu().numpy()
        return out.view(np.uint8).reshape(out.shape[0], -1)

    # -- encode ---------------------------------------------------------------

    async def encode(self, codec, data: bytes) -> dict[int, bytes]:
        """All k+m chunks for one object, batched across callers."""
        blocksize = codec.get_chunk_size(len(data))
        if not hasattr(codec, "encode_words") or blocksize % 4:
            self.launches += 1
            self.objects += 1
            return codec.encode(range(codec.get_chunk_count()), data)
        self._check_codec(codec)
        loop = asyncio.get_running_loop()
        key = id(codec)
        self._codecs[key] = codec
        fut = loop.create_future()
        q = self._enc_q.setdefault(key, [])
        q.append((data, blocksize, fut))
        sp = None if self.tracer is None else self.tracer.child(
            "encode_wait", tags={"bytes": len(data)}
        )
        if len(q) >= self.max_batch:
            self._flush_encode(key)
        elif len(q) == 1:
            # call_later captures the current context, so the flush
            # callback's encode_batch span parents to THIS op's trace
            self._enc_timers[key] = loop.call_later(
                self.window, self._flush_encode, key
            )
        if sp is None:
            return await fut
        try:
            return await fut
        finally:
            sp.finish()

    def _flush_encode(self, key: int) -> None:
        timer = self._enc_timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        q = self._enc_q.pop(key, [])
        if not q:
            return
        codec = self._codecs[key]
        sp = None if self.tracer is None else self.tracer.child(
            "encode_batch", tags={"batch": len(q)}
        )
        try:
            self._flush_encode_inner(q, codec, sp)
        finally:
            if sp is not None:
                sp.finish()

    def _encode_planes(self, codec, planes: np.ndarray) -> np.ndarray:
        """(k, W) uint8 data planes -> (m, W) uint8 parity planes."""
        mesh = self._mesh(planes.shape[1])
        if mesh is not None:
            from ceph_tpu_torch.parallel import sharding

            padded, width = _mesh_pad(planes, mesh.size)
            parity = sharding.mesh_encode_planar(codec, padded, mesh)[:, :width]
            self.mesh_launches += 1
            return parity
        if codec.device.type == "cuda":
            return self._on_device(planes, codec.device, codec.encode_words)
        # off-device: exact table-driven numpy planar path
        if getattr(codec, "_xor_ok", False):
            return np.bitwise_xor.reduce(planes, axis=0)[None]
        return gf_region_matmul(codec._gen[codec.k:], planes)

    def _flush_encode_inner(self, q, codec, sp) -> None:
        try:
            k, n = codec.k, codec.get_chunk_count()
            # pack every object's chunk j end to end into planar row j
            planes = pack_objects(k, ((data, bs) for data, bs, _fut in q))
            path = "mesh" if self._mesh(planes.shape[1]) is not None else codec.device.type
            self._note_launch(sp, path, k, n, planes.shape[1], len(q))
            parity = self._encode_planes(codec, planes)
            self.launches += 1
            self.objects += len(q)
            off = 0
            for data, bs, fut in q:
                chunks: dict[int, bytes] = {}
                for logical in range(k):
                    chunks[codec.chunk_index(logical)] = (
                        planes[logical, off: off + bs].tobytes()
                    )
                for logical in range(k, n):
                    chunks[codec.chunk_index(logical)] = parity[
                        logical - k, off: off + bs
                    ].tobytes()
                off += bs
                if not fut.done():
                    fut.set_result(chunks)
        except Exception as e:
            for _data, _bs, fut in q:
                if not fut.done():
                    fut.set_exception(e)

    def _note_launch(
        self, sp, path: str, k: int, n: int, width: int, batch: int
    ) -> None:
        """Tag the batch span with the launch's path and shape, and whether
        this planar shape was seen before."""
        shape = (path, k, n, width)
        fresh = shape not in self._seen_shapes
        self._seen_shapes.add(shape)
        if sp is not None:
            sp.set_tag("path", path)
            sp.set_tag("width", width)
            sp.set_tag("compile", fresh)
            sp.set_tag("batch", batch)

    # -- decode ---------------------------------------------------------------

    async def decode(
        self, codec, want_to_read, chunks: dict[int, bytes]
    ) -> dict[int, bytes]:
        """Batched degraded-read decode: objects sharing an erasure
        signature (same survivors/targets) decode in one launch."""
        want = set(want_to_read)
        have = set(chunks)
        if want <= have:
            return {i: bytes(chunks[i]) for i in want}
        blocksize = len(next(iter(chunks.values())))
        if not hasattr(codec, "decode_words") or blocksize % 4:
            self.launches += 1
            self.objects += 1
            return codec.decode(want, chunks)
        self._check_codec(codec)
        present = tuple(
            sorted(codec.logical_index(p) for p in have)
        )[: codec.k]
        targets = tuple(
            sorted(codec.logical_index(p) for p in want - have)
        )
        loop = asyncio.get_running_loop()
        key = (id(codec), present, targets)
        self._codecs[id(codec)] = codec
        fut = loop.create_future()
        q = self._dec_q.setdefault(key, [])
        q.append((chunks, blocksize, want, fut))
        if len(q) >= self.max_batch:
            self._flush_decode(key)
            if not any(k[0] == id(codec) for k in self._dec_q):
                timer = self._dec_timers.pop(id(codec), None)
                if timer is not None:
                    timer.cancel()
        elif id(codec) not in self._dec_timers:
            # ONE window per codec, not per signature: a mass-failure
            # recovery wave decodes with many erasure signatures at
            # once, and paying a fresh window per signature would
            # serialize exactly when throughput matters most — window
            # expiry drains EVERY signature queued for this codec
            # (one launch each, shared window)
            self._dec_timers[id(codec)] = loop.call_later(
                self.window, self._flush_decode_all, id(codec)
            )
        return await fut

    def _flush_decode_all(self, codec_id: int) -> None:
        """Window expiry: drain every signature queued for this codec."""
        self._dec_timers.pop(codec_id, None)
        for key in [k for k in self._dec_q if k[0] == codec_id]:
            self._flush_decode(key)

    def _flush_decode(self, key: tuple) -> None:
        q = self._dec_q.pop(key, None)
        if not q:
            return
        codec_id, present, targets = key
        codec = self._codecs[codec_id]
        sp = None if self.tracer is None else self.tracer.child(
            "decode_batch",
            tags={"batch": len(q), "targets": len(targets)},
        )
        try:
            self._flush_decode_inner(key, q, codec)
        finally:
            if sp is not None:
                sp.finish()

    def _decode_planes(self, codec, present, targets, planes) -> np.ndarray:
        """(k, W) uint8 survivor planes -> (len(targets), W) rebuilt planes."""
        mesh = self._mesh(planes.shape[1])
        if mesh is not None:
            from ceph_tpu_torch.parallel import sharding

            padded, width = _mesh_pad(planes, mesh.size)
            rebuilt = sharding.mesh_decode_planar(
                codec, list(present), list(targets), padded, mesh)[:, :width]
            self.mesh_launches += 1
            return rebuilt
        if codec.device.type == "cuda":
            return self._on_device(
                planes, codec.device,
                lambda words: codec.decode_words(list(present), list(targets), words),
            )
        dm = matrices.decode_matrix(
            codec._gen, codec.k, list(present), list(targets)
        )
        return gf_region_matmul(dm, planes)

    def _flush_decode_inner(self, key, q, codec) -> None:
        _codec_id, present, targets = key
        try:
            planes = pack_survivors(
                codec, present, ((chunks, bs) for chunks, bs, _w, _f in q)
            )
            rebuilt = self._decode_planes(codec, present, targets, planes)
            self.launches += 1
            self.objects += len(q)
            off = 0
            for chunks, bs, want, fut in q:
                out = {
                    i: bytes(chunks[i]) for i in want if i in chunks
                }
                for t, logical in enumerate(targets):
                    phys = codec.chunk_index(logical)
                    if phys in want:
                        out[phys] = rebuilt[t, off: off + bs].tobytes()
                off += bs
                if not fut.done():
                    fut.set_result(out)
        except Exception as e:
            for _c, _b, _w, fut in q:
                if not fut.done():
                    fut.set_exception(e)
