"""KeyValueDB: the KV abstraction under the object store and monitor.

The reference routes all small persistent state through a `KeyValueDB`
interface (src/kv/KeyValueDB.h) with RocksDB behind it
(src/kv/RocksDBStore.cc): atomic write batches, prefix-scoped keys, ordered
iteration. BlueStore keeps its metadata there; the monitor's entire state is
one (MonitorDBStore over the same interface).

Two backends here:

  * `MemDB` — dict-backed (the reference ships one too, src/kv/MemDB.cc);
    used by tests and by in-memory object stores.
  * `FileDB` — durable single-file store: a snapshot plus an append-only
    write-ahead log of denc-encoded batches, each protected by crc32c and
    applied atomically on replay (a truncated/corrupt tail — the torn-write
    crash case — is discarded whole, never half-applied). `compact()` folds
    the log into a new snapshot via write-to-temp + rename. This is the WAL
    discipline RocksDB gives the reference, sized for our state (maps,
    object metadata, mon store), not an LSM tree — scans are served from the
    in-memory table.

Keys are (prefix, key) pairs of bytes, matching the reference's
prefix-per-subsystem convention ("osdmap", "pgmeta", ...).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.common.encoding import DecodeError, Decoder, Encoder


class KVTransaction:
    """An atomic batch (KeyValueDB::Transaction): ops apply all-or-nothing."""

    def __init__(self) -> None:
        #: (op, prefix, key, value) with op in {"set", "rm", "rm_prefix",
        #: "setr"}
        self.ops: list[tuple[str, bytes, bytes, bytes]] = []

    def set(self, prefix: bytes, key: bytes, value: bytes) -> "KVTransaction":
        self.ops.append(("set", bytes(prefix), bytes(key), bytes(value)))
        return self

    def set_range(
        self, prefix: bytes, key: bytes, off: int, value: bytes
    ) -> "KVTransaction":
        """Patch `value` into the row at byte offset `off` (zero-extending a
        shorter row). The WAL records only the delta, which is what makes a
        sub-stripe EC overwrite's store traffic proportional to the bytes
        touched instead of the object size (RocksDB merge-operator role)."""
        self.ops.append((
            "setr", bytes(prefix), bytes(key),
            Encoder().u64(off).blob(bytes(value)).bytes(),
        ))
        return self

    def rm(self, prefix: bytes, key: bytes) -> "KVTransaction":
        self.ops.append(("rm", bytes(prefix), bytes(key), b""))
        return self

    def rm_prefix(self, prefix: bytes) -> "KVTransaction":
        self.ops.append(("rm_prefix", bytes(prefix), b"", b""))
        return self

    def encode(self) -> bytes:
        def one(e, op):
            kind, prefix, key, value = op
            e.string(kind).blob(prefix).blob(key).blob(value)

        return Encoder().list(self.ops, one).bytes()

    @staticmethod
    def decode(raw: bytes) -> "KVTransaction":
        t = KVTransaction()

        def one(d):
            return (d.string(), d.blob(), d.blob(), d.blob())

        t.ops = Decoder(raw).list(one)
        return t


class KeyValueDB:
    """Interface: submit_transaction is the only mutator."""

    def get(self, prefix: bytes, key: bytes) -> bytes | None:
        raise NotImplementedError

    def iterate(self, prefix: bytes):
        """Yield (key, value) in key order."""
        raise NotImplementedError

    def submit_transaction(self, txn: KVTransaction) -> None:
        raise NotImplementedError

    # -- shared in-memory application ----------------------------------------

    def _apply(self, table: dict, txn: KVTransaction) -> None:
        for kind, prefix, key, value in txn.ops:
            if kind == "set":
                table[(prefix, key)] = value
            elif kind == "setr":
                d = Decoder(value)
                off, data = d.u64(), d.blob()
                cur = table.get((prefix, key), b"")
                if len(cur) < off + len(data):
                    cur = cur + b"\x00" * (off + len(data) - len(cur))
                table[(prefix, key)] = (
                    cur[:off] + data + cur[off + len(data):]
                )
            elif kind == "rm":
                table.pop((prefix, key), None)
            elif kind == "rm_prefix":
                for k in [k for k in table if k[0] == prefix]:
                    del table[k]
            else:
                raise ValueError(f"unknown kv op {kind!r}")


@dataclass
class MemDB(KeyValueDB):
    table: dict = field(default_factory=dict)
    #: bytes a durable backend would have logged for the same batches —
    #: len(encode()) per batch, so tests can assert store-traffic scaling
    #: identically against MemDB and FileDB
    bytes_logged: int = 0

    def get(self, prefix: bytes, key: bytes) -> bytes | None:
        return self.table.get((bytes(prefix), bytes(key)))

    def iterate(self, prefix: bytes):
        prefix = bytes(prefix)
        for (p, k) in sorted(k for k in self.table if k[0] == prefix):
            yield (p, k), self.table[(p, k)]

    def submit_transaction(self, txn: KVTransaction) -> None:
        self.bytes_logged += len(txn.encode())
        self._apply(self.table, txn)


class FileDB(KeyValueDB):
    """Snapshot + crc-framed WAL in `path/`; see module docstring."""

    SNAP = "snapshot"
    WAL = "wal"

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.table: dict = {}
        self.bytes_logged = 0
        self._load()
        self._wal = open(os.path.join(path, self.WAL), "ab")

    # -- recovery -------------------------------------------------------------

    def _load(self) -> None:
        snap_path = os.path.join(self.path, self.SNAP)
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                raw = f.read()
            d = Decoder(raw)

            def entry(dd):
                return (dd.blob(), dd.blob()), dd.blob()

            for k, v in d.list(entry):
                self.table[k] = v
        wal_path = os.path.join(self.path, self.WAL)
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                raw = f.read()
            off = 0
            while off < len(raw):
                try:
                    d = Decoder(raw, off)
                    body = d.blob()
                    crc = d.u32()
                except DecodeError:
                    break  # torn tail: discard
                if ceph_crc32c(0xFFFFFFFF, body) != crc:
                    break  # corrupt tail: discard whole record
                self._apply(self.table, KVTransaction.decode(body))
                off = d.offset

    # -- api ------------------------------------------------------------------

    def get(self, prefix: bytes, key: bytes) -> bytes | None:
        return self.table.get((bytes(prefix), bytes(key)))

    def iterate(self, prefix: bytes):
        prefix = bytes(prefix)
        for (p, k) in sorted(k for k in self.table if k[0] == prefix):
            yield (p, k), self.table[(p, k)]

    def submit_transaction(self, txn: KVTransaction) -> None:
        body = txn.encode()
        rec = (
            Encoder().blob(body).u32(ceph_crc32c(0xFFFFFFFF, body)).bytes()
        )
        self._wal.write(rec)
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self.bytes_logged += len(body)  # same measure as MemDB
        self._apply(self.table, txn)

    def compact(self) -> None:
        """Fold the WAL into a fresh snapshot (temp + rename + truncate)."""
        snap_path = os.path.join(self.path, self.SNAP)
        tmp = snap_path + ".tmp"

        def entry(e, item):
            (prefix, key), value = item
            e.blob(prefix).blob(key).blob(value)

        raw = Encoder().list(sorted(self.table.items()), entry).bytes()
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, snap_path)
        # fsync the parent directory: rename() durability is a property
        # of the DIRECTORY entry, not the file — without this a power
        # loss can revert the snapshot to the old (or no) inode even
        # though the new bytes were fsynced (the classic rename-without-
        # dirsync hole; process death alone never hits it)
        dirfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._wal.close()
        self._wal = open(os.path.join(self.path, self.WAL), "wb")
        self._wal.flush()
        os.fsync(self._wal.fileno())

    def close(self) -> None:
        self._wal.close()
