"""Client-side striping — the libradosstriper / Striper analogue.

Port of ceph_tpu/rados/striper.py (a copy). Re-expresses the reference's
src/osdc/Striper.cc:file_to_extents (the RADOS striping layout: stripe_unit
su, stripe_count sc, object_size os) and libradosstriper's write/read: a
large logical "file" is cut into su-sized blocks dealt round-robin across sc
objects per object set, objects named `<soid>.%016x` exactly as the reference
formats them (Striper.cc:47 "%s.%016llx").

One logical stream fans out across many RADOS objects, each of which the
data path then places via CRUSH and erasure-codes on the device. The
checkpoint store names its chunk objects with `object_name` and reads ranges
of them with `read_runs`.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass


@dataclass(frozen=True)
class StripeLayout:
    """file_layout_t's placement-relevant subset."""

    stripe_unit: int = 1 << 16
    stripe_count: int = 4
    object_size: int = 1 << 18

    def __post_init__(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0:
            raise ValueError("stripe_unit and stripe_count must be positive")
        if self.object_size < self.stripe_unit:
            raise ValueError("object_size must be >= stripe_unit")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of stripe_unit")


def file_to_extents(
    layout: StripeLayout, offset: int, length: int
) -> dict[int, list[tuple[int, int, int]]]:
    """[offset, offset+length) -> {object_no: [(obj_off, len, file_off)]}.

    The loop is the reference's block walk (Striper.cc:129-166): block ->
    (stripeno, stripepos) -> object set -> object number and intra-object
    offset."""
    su = layout.stripe_unit
    sc = layout.stripe_count
    if sc == 1:
        su = layout.object_size  # Striper.cc:132-135
    stripes_per_object = layout.object_size // su

    extents: dict[int, list[tuple[int, int, int]]] = {}
    cur = offset
    left = length
    while left > 0:
        blockno = cur // su
        stripeno = blockno // sc
        stripepos = blockno % sc
        objectsetno = stripeno // stripes_per_object
        objectno = objectsetno * sc + stripepos
        block_start = (stripeno % stripes_per_object) * su
        block_off = cur % su
        n = min(left, su - block_off)
        extents.setdefault(objectno, []).append(
            (block_start + block_off, n, cur)
        )
        cur += n
        left -= n
    return extents


def object_name(soid: str, objectno: int) -> str:
    return f"{soid}.{objectno:016x}"  # Striper.cc:47 object_format


async def read_runs(
    ioctx,
    runs: list[tuple[str, int, int]],
    window: asyncio.Semaphore | None = None,
) -> list[bytes]:
    """Ranged sub-object reads: [(object, offset, length)] -> payloads.

    The offset/length pair is pushed down to the primary (`ioctx.read`
    partial-read path) instead of fetching whole objects — the striped
    read, the dataset iterator's coalesced record runs, and the ckpt
    partial restore all fund exactly the bytes they consume. Reads run
    concurrently under `window` when given (the caller's readahead
    semaphore), else all at once. Short objects zero-pad to `length`,
    matching the striper's sparse-tail semantics."""

    async def one(obj: str, off: int, length: int) -> bytes:
        if length <= 0:
            return b""
        if window is None:
            data = await ioctx.read(obj, off=off, length=length)
        else:
            async with window:
                data = await ioctx.read(obj, off=off, length=length)
        if len(data) < length:
            data = data + b"\0" * (length - len(data))
        return data

    return list(await asyncio.gather(*(one(*r) for r in runs)))


class Striper:
    """libradosstriper-style striped write/read over a MiniCluster pool."""

    def __init__(self, cluster, pool_id: int,
                 layout: StripeLayout | None = None):
        self.cluster = cluster
        self.pool_id = pool_id
        self.layout = layout or StripeLayout()
        #: striped-object sizes (libradosstriper keeps this in a striper.size
        #: xattr on the first object; the mini data path has no partial-object
        #: xattr API, so the striper tracks it — same recovery properties,
        #: since MiniCluster.registry already plays the PG-log role)
        self.sizes: dict[str, int] = {}

    def write(self, soid: str, data: bytes) -> int:
        """Full-object striped write; returns the number of RADOS objects."""
        extents = file_to_extents(self.layout, 0, len(data))
        for objectno, runs in sorted(extents.items()):
            end = max(obj_off + n for obj_off, n, _ in runs)
            buf = bytearray(end)
            for obj_off, n, file_off in runs:
                buf[obj_off : obj_off + n] = data[file_off : file_off + n]
            self.cluster.put(
                self.pool_id, object_name(soid, objectno), bytes(buf)
            )
        self.sizes[soid] = len(data)
        return len(extents)

    def read(self, soid: str, offset: int = 0,
             length: int | None = None) -> bytes:
        size = self.sizes.get(soid)
        if size is None:
            raise KeyError(f"no striped object {soid!r}")
        if length is None:
            length = size - offset
        length = max(0, min(length, size - offset))
        if length == 0:
            return b""
        out = bytearray(length)
        objects: dict[int, bytes] = {}
        for objectno, runs in file_to_extents(
            self.layout, offset, length
        ).items():
            if objectno not in objects:
                objects[objectno] = self.cluster.get(
                    self.pool_id, object_name(soid, objectno)
                )
            blob = objects[objectno]
            for obj_off, n, file_off in runs:
                out[file_off - offset : file_off - offset + n] = blob[
                    obj_off : obj_off + n
                ]
        return bytes(out)


class RadosStriper:
    """libradosstriper over a LIVE cluster IoCtx (async twin of Striper).

    The reference's libradosstriper stores the logical size AND the
    file_layout_t in xattrs on the first object (StriperImpl) — the layout
    must travel with the data, or a reader configured differently would
    silently permute bytes. Plain writes here replace user xattrs, so a
    tiny `<soid>.striperhdr` object carries both; reads always use the
    layout recorded at write time, never the handle's default.
    """

    def __init__(self, ioctx, layout: StripeLayout | None = None,
                 header_cache: dict | None = None):
        self.ioctx = ioctx
        self.layout = layout or StripeLayout()
        #: optional soid -> (size, layout) cache: readers of immutable
        #: striped objects (committed dataset shards) pay ONE header
        #: round trip per soid instead of one per ranged read. Callers
        #: that overwrite striped objects must not share a cache with
        #: their readers.
        self._hdr_cache = header_cache

    @staticmethod
    def _hdr_name(soid: str) -> str:
        return f"{soid}.striperhdr"

    async def _read_header(self, soid: str) -> tuple[int, StripeLayout]:
        import json

        if self._hdr_cache is not None and soid in self._hdr_cache:
            return self._hdr_cache[soid]
        h = json.loads(await self.ioctx.read(self._hdr_name(soid)))
        got = h["size"], StripeLayout(
            stripe_unit=h["su"], stripe_count=h["sc"],
            object_size=h["os"],
        )
        if self._hdr_cache is not None:
            self._hdr_cache[soid] = got
        return got

    async def write(self, soid: str, data: bytes) -> int:
        # shrinking overwrite: trim data objects the new extent set no
        # longer covers, or they would leak (and remove() after a later
        # header rewrite would miss them)
        try:
            old_total, old_layout = await self._read_header(soid)
        # cephlint: disable=error-taxonomy (no/unreadable header: treat as a fresh object)
        except Exception:
            old_total, old_layout = 0, None
        extents = file_to_extents(self.layout, 0, len(data))
        if old_layout is not None and old_total:
            for objectno in file_to_extents(old_layout, 0, old_total):
                if objectno not in extents:
                    try:
                        await self.ioctx.remove(
                            object_name(soid, objectno)
                        )
                    # cephlint: disable=error-taxonomy (shrink cleanup: the tail object may never have existed)
                    except Exception:
                        pass
        for objectno, runs in sorted(extents.items()):
            end = max(obj_off + n for obj_off, n, _ in runs)
            buf = bytearray(end)
            for obj_off, n, file_off in runs:
                buf[obj_off: obj_off + n] = data[file_off: file_off + n]
            await self.ioctx.write_full(
                object_name(soid, objectno), bytes(buf)
            )
        import json

        await self.ioctx.write_full(
            self._hdr_name(soid),
            json.dumps(
                {"size": len(data), "su": self.layout.stripe_unit,
                 "sc": self.layout.stripe_count,
                 "os": self.layout.object_size}
            ).encode(),
        )
        if self._hdr_cache is not None:
            self._hdr_cache[soid] = (len(data), self.layout)
        return len(extents)

    async def size(self, soid: str) -> int:
        return (await self._read_header(soid))[0]

    async def read(self, soid: str, offset: int = 0,
                   length: int | None = None,
                   window: asyncio.Semaphore | None = None) -> bytes:
        """Ranged striped read: every extent is a sub-object PARTIAL
        read (offset/length pushed down via read_runs), so a small read
        of a large striped object moves only its own bytes — the
        dataset iterator's record-run fast path."""
        total, layout = await self._read_header(soid)
        if length is None:
            length = total - offset
        length = max(0, min(length, total - offset))
        if length == 0:
            return b""
        out = bytearray(length)
        flat: list[tuple[str, int, int]] = []
        placements: list[tuple[int, int]] = []
        for objectno, runs in file_to_extents(
            layout, offset, length
        ).items():
            obj = object_name(soid, objectno)
            for obj_off, n, file_off in runs:
                flat.append((obj, obj_off, n))
                placements.append((file_off - offset, n))
        pieces = await read_runs(self.ioctx, flat, window)
        for (dst, n), piece in zip(placements, pieces):
            out[dst: dst + n] = piece
        return bytes(out)

    async def remove(self, soid: str) -> None:
        """Delete every data object + the header (rados_striper_remove)."""
        total, layout = await self._read_header(soid)
        for objectno in file_to_extents(layout, 0, max(total, 1)):
            try:
                await self.ioctx.remove(object_name(soid, objectno))
            # cephlint: disable=error-taxonomy (sparse/already-gone objects)
            except Exception:
                pass  # sparse/already-gone objects
        await self.ioctx.remove(self._hdr_name(soid))
