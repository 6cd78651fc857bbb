"""MemStore: the in-memory ObjectStore used by the mini data path.

Plays the role of the reference's MemStore (src/os/memstore) —
the disk-free ObjectStore every OSD-logic test runs against — with the fault
hooks the qa suites drive through config injection
(`ms_inject_socket_failures`, options.cc:1044-1066; EIO corruption via
test-erasure-eio.sh): a store can be killed (OSD death), individual objects
can be poisoned with EIO, and a transient-failure rate makes ops fail
intermittently so callers exercise their retry paths.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


class ObjectStoreError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code  # "EIO" | "ENOENT" | "ECONN" | "EDOWN"


@dataclass
class MemStore:
    """One OSD's object store: key -> bytes, plus fault state."""

    osd_id: int
    objects: dict[tuple, bytes] = field(default_factory=dict)
    #: key -> xattr map (HashInfo etc.), like ObjectStore::getattrs
    attrs: dict[tuple, dict] = field(default_factory=dict)
    alive: bool = True
    eio_keys: set = field(default_factory=set)
    #: 1-in-N transient op failure (0 = off), ms_inject_socket_failures-style
    inject_transient_every: int = 0
    _rng: random.Random = field(default_factory=lambda: random.Random(0))
    reads: int = 0
    bytes_read: int = 0
    writes: int = 0

    def _gate(self, key=None) -> None:
        if not self.alive:
            raise ObjectStoreError("EDOWN", f"osd.{self.osd_id} is down")
        if self.inject_transient_every and (
            self._rng.randrange(self.inject_transient_every) == 0
        ):
            raise ObjectStoreError(
                "ECONN", f"osd.{self.osd_id} injected transient failure"
            )
        if key is not None and key in self.eio_keys:
            raise ObjectStoreError("EIO", f"osd.{self.osd_id} EIO on {key}")

    def write(self, key: tuple, data: bytes, attrs: dict | None = None) -> None:
        self._gate()
        self.objects[key] = bytes(data)
        if attrs is not None:
            self.attrs[key] = dict(attrs)
        self.writes += 1

    def getattrs(self, key: tuple) -> dict:
        """Object attributes (the xattr map real stores keep per object)."""
        self._gate(key)
        return self.attrs.get(key, {})

    def read(self, key: tuple, offset: int = 0, length: int | None = None) -> bytes:
        self._gate(key)
        if key not in self.objects:
            raise ObjectStoreError("ENOENT", f"osd.{self.osd_id}: no {key}")
        self.reads += 1
        data = self.objects[key]
        out = data[offset:] if length is None else data[offset : offset + length]
        self.bytes_read += len(out)
        return out

    def read_runs(self, key: tuple, runs, unit: int) -> bytes:
        """Gather (offset, count) sub-chunk runs of `unit` bytes each —
        the partial-read shape minimum_to_decode hands back for array codes."""
        return b"".join(
            self.read(key, off * unit, count * unit) for off, count in runs
        )

    def remove(self, key: tuple) -> None:
        self._gate()
        self.objects.pop(key, None)
        self.attrs.pop(key, None)

    def keys(self):
        return list(self.objects)
