"""ObjectStore: the OSD's transactional persistence contract, two backends.

The reference's `ObjectStore` interface (src/os/ObjectStore.h +
Transaction.h) is the OSD's only persistence contract: every mutation —
object data, xattrs, omap, collection membership, and the PG log itself —
rides one `Transaction` applied atomically, which is what makes PG state
crash-consistent (SURVEY §5 checkpoint/resume: durability *is* the
transaction log). Implementations differ in media: BlueStore (raw block),
FileStore, MemStore, and KStore, which stores everything in the KV layer.

Two backends implement the contract here, selected by the
`osd_objectstore` config option (`create_store`):

  * `KStore` (this module; src/os/kstore design): objects, attrs, and omap
    are rows in a `KeyValueDB`, a Transaction compiles to one KV batch, and
    the KV WAL (ceph_tpu.common.kv.FileDB) provides atomicity + crash
    recovery. Backed by `MemDB` it is the MemStore equivalent; backed by
    `FileDB` it survives process death — an OSD daemon reopening its store
    resumes from the last committed transaction exactly like an OSD restart
    replaying its journal.
  * `BlockStore` (ceph_tpu.osd.blockstore; src/os/bluestore design): object
    *data* lives as allocator-managed extents in a raw block file with a
    crc32c per checksum block, verified on every read; *metadata* (onode
    extent maps, attrs, omap, the free list) stays in the KV layer —
    BlueStore's data/RocksDB split. Sub-min_alloc writes ride the KV WAL
    batch (deferred writes) and `fsck(deep=True)` re-reads every blob
    against its stored checksum.

The per-op compilation is factored through `_compile_op`/`_begin_batch`/
`_commit_batch` so BlockStore overrides only the data-bearing ops and
inherits collection/attr/omap handling unchanged.

Object identity is (collection, name) where a collection is a PG
(coll_t, src/osd/osd_types.h); keys are denc-encoded so ordered KV
iteration yields collection listings.
"""

from __future__ import annotations

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.common.kv import KeyValueDB, KVTransaction, MemDB

_DATA = b"dat"  # object payload rows
_ATTR = b"atr"  # xattr rows
_OMAP = b"omp"  # omap rows
_COLL = b"col"  # collection existence rows


class StoreError(Exception):
    """Typed store error — the errno taxonomy the OSD's handling keys on:

      * ``ENOENT`` / ``EEXIST`` — namespace errors, client-visible as-is.
      * ``ENOSPC`` — allocation failed against a capacity-capped device.
        Transient by contract: nothing is fenced, reads keep working, and
        frees make the store writable again.
      * ``EIO`` on a READ — at-rest corruption or a device read error.
        Recoverable above the store: the primary heals the object from
        replicas/EC survivors before the client ever sees it.
      * ``EIO`` on a WRITE/FSYNC path — raised as `StoreFatalError`: the
        store can no longer promise that an ack implies durability, so it
        fences itself (fail-stop) and the owning daemon must go down.
      * ``EROFS`` — the store is already fenced; every further write is
        refused up front so no ack can lie about durability.
    """

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code  # "ENOENT" | "EEXIST" | "ENOSPC" | "EIO" | "EROFS"


class StoreFatalError(StoreError):
    """A write-path or fsync device error (the fail-stop class): the
    lesson of Rebello et al., "Can Applications Recover from fsync
    Failures?" (ATC '20) layered on RADOS's fail-stop OSD assumption —
    an fsync error must never be retried-and-forgotten. The store fences
    itself before raising this; the owning OSD reports itself to the mon
    and shuts down rather than ack another write."""


def _okey(coll: str, name: str, extra: bytes = b"") -> bytes:
    return Encoder().string(coll).string(name).raw(extra).bytes()


def _okey_decode(key: bytes) -> tuple[str, str]:
    d = Decoder(key)
    return d.string(), d.string()


class Transaction:
    """An ordered op list applied atomically (ObjectStore::Transaction).

    Ops mirror the reference's: create/remove collection, write (full
    object — the EC data path always writes whole shards), remove, setattrs,
    omap set/rm. `touch` is write-if-absent of an empty object."""

    def __init__(self) -> None:
        self.ops: list[tuple] = []

    def create_collection(self, coll: str) -> "Transaction":
        self.ops.append(("mkcoll", coll))
        return self

    def remove_collection(self, coll: str) -> "Transaction":
        self.ops.append(("rmcoll", coll))
        return self

    def touch(self, coll: str, name: str) -> "Transaction":
        self.ops.append(("touch", coll, name))
        return self

    def write(
        self, coll: str, name: str, data: bytes, attrs: dict | None = None
    ) -> "Transaction":
        self.ops.append(("write", coll, name, bytes(data), attrs))
        return self

    def write_at(
        self, coll: str, name: str, off: int, data: bytes
    ) -> "Transaction":
        """Patch `data` into the object at byte offset `off` without
        rewriting the rest (ObjectStore::Transaction::write(off,len) — the
        sub-extent shape ECBackend's overwrite path ships,
        src/osd/ECTransaction.cc:101). Compiles to a KV set_range so both
        the WAL record and the wire stay proportional to len(data)."""
        self.ops.append(("write_at", coll, name, off, bytes(data)))
        return self

    def remove(self, coll: str, name: str) -> "Transaction":
        self.ops.append(("remove", coll, name))
        return self

    def setattrs(self, coll: str, name: str, attrs: dict) -> "Transaction":
        self.ops.append(("setattrs", coll, name, attrs))
        return self

    def omap_setkeys(
        self, coll: str, name: str, kv: dict[bytes, bytes]
    ) -> "Transaction":
        self.ops.append(("omap_set", coll, name, dict(kv)))
        return self

    def omap_rmkeys(self, coll: str, name: str, keys) -> "Transaction":
        self.ops.append(("omap_rm", coll, name, list(keys)))
        return self


def _encode_attrs(attrs: dict) -> bytes:
    """Attrs are xattr blobs in the reference; ours carry version stamps and
    HashInfo, encoded with typed denc tags so the bytes are deterministic
    and decoding never runs arbitrary constructors."""
    from ceph_tpu_torch.osd.ecutil import HashInfo

    def value(e, v):
        if isinstance(v, bool):
            e.u8(4).boolean(v)
        elif isinstance(v, int):
            e.u8(1).s64(v)
        elif isinstance(v, bytes):
            e.u8(2).blob(v)
        elif isinstance(v, str):
            e.u8(3).string(v)
        elif isinstance(v, HashInfo):
            e.u8(5).u64(v.total_chunk_size).list(
                v.cumulative_shard_hashes, lambda ee, h: ee.u64(h)
            )
        else:
            raise TypeError(f"unencodable attr value type {type(v)!r}")

    return (
        Encoder()
        .mapping(attrs, lambda e, k: e.string(k), value)
        .bytes()
    )


def _decode_attrs(raw: bytes) -> dict:
    from ceph_tpu_torch.osd.ecutil import HashInfo

    def value(d):
        tag = d.u8()
        if tag == 1:
            return d.s64()
        if tag == 2:
            return d.blob()
        if tag == 3:
            return d.string()
        if tag == 4:
            return d.boolean()
        if tag == 5:
            return HashInfo(d.u64(), d.list(lambda dd: dd.u64()))
        raise ValueError(f"unknown attr tag {tag}")

    return Decoder(raw).mapping(lambda d: d.string(), value)


class KStore:
    """ObjectStore over a KeyValueDB; see module docstring."""

    KIND = "kstore"
    #: optional distributed tracer (set by the owning daemon): traced
    #: ops get a journal_commit span per transaction; untraced cost is
    #: one attribute check
    tracer = None

    def __init__(self, db: KeyValueDB | None = None):
        self.db = db if db is not None else MemDB()

    def used_bytes(self) -> int:
        """Current store footprint (ObjectStore::statfs 'used' role):
        live keys + values, so deletes genuinely free space — unlike the
        WAL's cumulative bytes_logged. O(rows); fine at test scale, a
        maintained counter when stores grow."""
        return sum(
            len(k[1]) + len(v) for k, v in self.db.table.items()
        )

    # -- transactions ---------------------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        """Compile to one KV batch and commit atomically."""
        sp = None if self.tracer is None else self.tracer.child(
            "journal_commit",
            tags={"store": self.KIND, "ops": len(txn.ops)},
        )
        try:
            kv = KVTransaction()
            self._begin_batch()
            try:
                for op in txn.ops:
                    self._compile_op(kv, op)
            except BaseException:
                self._abort_batch()
                raise
            self._commit_batch(kv)
        finally:
            if sp is not None:
                sp.finish()

    def _begin_batch(self) -> None:
        """Per-transaction compile state reset (backend hook)."""

    def _abort_batch(self) -> None:
        """Undo compile-time side effects after a failed compile (backend
        hook; the KV batch itself was never submitted)."""

    def _commit_batch(self, kv: KVTransaction) -> None:
        """Make the compiled batch durable — THE commit point."""
        self.db.submit_transaction(kv)

    def _compile_op(self, kv: KVTransaction, op: tuple) -> None:
        kind = op[0]
        if kind == "mkcoll":
            kv.set(_COLL, op[1].encode(), b"")
        elif kind == "rmcoll":
            coll = op[1]
            kv.rm(_COLL, coll.encode())
            for table, row_key in self._rows_of(coll):
                kv.rm(table, row_key)
        elif kind == "touch":
            _, coll, name = op
            if self.db.get(_DATA, _okey(coll, name)) is None:
                kv.set(_DATA, _okey(coll, name), b"")
        elif kind == "write":
            _, coll, name, data, attrs = op
            kv.set(_DATA, _okey(coll, name), data)
            if attrs is not None:
                kv.set(_ATTR, _okey(coll, name), _encode_attrs(attrs))
        elif kind == "write_at":
            _, coll, name, off, data = op
            kv.set_range(_DATA, _okey(coll, name), off, data)
        elif kind == "remove":
            _, coll, name = op
            kv.rm(_DATA, _okey(coll, name))
            kv.rm(_ATTR, _okey(coll, name))
            for k, _v in list(self.db.iterate(_OMAP)):
                if k[1].startswith(_okey(coll, name)):
                    kv.rm(_OMAP, k[1])
        elif kind == "setattrs":
            _, coll, name, attrs = op
            merged = dict(self.getattrs(coll, name))
            merged.update(attrs)
            kv.set(_ATTR, _okey(coll, name), _encode_attrs(merged))
        elif kind == "omap_set":
            _, coll, name, pairs = op
            for k, v in pairs.items():
                kv.set(_OMAP, _okey(coll, name, k), v)
        elif kind == "omap_rm":
            _, coll, name, keys = op
            for k in keys:
                kv.rm(_OMAP, _okey(coll, name, k))
        else:
            raise ValueError(f"unknown transaction op {kind!r}")

    def _rows_of(self, coll: str):
        prefix = Encoder().string(coll).bytes()
        for table in (_DATA, _ATTR, _OMAP):
            for k, _v in list(self.db.iterate(table)):
                if k[1].startswith(prefix):
                    yield table, k[1]

    # -- reads ----------------------------------------------------------------

    def collection_exists(self, coll: str) -> bool:
        return self.db.get(_COLL, coll.encode()) is not None

    def list_collections(self) -> list[str]:
        return [k[1].decode() for k, _ in self.db.iterate(_COLL)]

    def exists(self, coll: str, name: str) -> bool:
        return self.db.get(_DATA, _okey(coll, name)) is not None

    def read(self, coll: str, name: str) -> bytes:
        data = self.db.get(_DATA, _okey(coll, name))
        if data is None:
            raise StoreError("ENOENT", f"{coll}/{name} does not exist")
        return data

    def getattrs(self, coll: str, name: str) -> dict:
        raw = self.db.get(_ATTR, _okey(coll, name))
        return {} if raw is None else _decode_attrs(raw)

    def omap_get(self, coll: str, name: str) -> dict[bytes, bytes]:
        prefix = _okey(coll, name)
        out = {}
        for k, v in self.db.iterate(_OMAP):
            if k[1].startswith(prefix):
                out[k[1][len(prefix):]] = v
        return out

    def list_objects(self, coll: str) -> list[str]:
        prefix = Encoder().string(coll).bytes()
        out = []
        for k, _v in self.db.iterate(_DATA):
            if k[1].startswith(prefix):
                out.append(_okey_decode(k[1])[1])
        return out

    # -- fsck -----------------------------------------------------------------

    def fsck(self, deep: bool = False) -> list[dict]:
        """Consistency check (ceph-objectstore-tool --op fsck surface).

        KStore keeps everything in KV rows the WAL already crc-frames, so
        there is no allocator or at-rest checksum to cross-check — fsck
        verifies the rows themselves decode: object keys, attr blobs, and
        (deep) that every data row is readable. BlockStore overrides this
        with the real extent/free-list/checksum cross-checks."""
        errors: list[dict] = []
        for k, _v in list(self.db.iterate(_DATA)):
            try:
                _okey_decode(k[1])
            except Exception as e:  # noqa: BLE001 - each row reported
                errors.append(
                    {"key": k[1].hex(), "error": f"undecodable key: {e}"}
                )
        for k, v in list(self.db.iterate(_ATTR)):
            try:
                coll, name = _okey_decode(k[1])
                _decode_attrs(v)
            except Exception as e:  # noqa: BLE001
                errors.append(
                    {"key": k[1].hex(), "error": f"undecodable attrs: {e}"}
                )
        if deep:
            for k, _v in list(self.db.iterate(_DATA)):
                try:
                    coll, name = _okey_decode(k[1])
                    self.read(coll, name)
                except Exception as e:  # noqa: BLE001
                    errors.append(
                        {"key": k[1].hex(), "error": f"unreadable: {e}"}
                    )
        return errors


def create_store(db: KeyValueDB | None = None, config=None):
    """Build the ObjectStore the `osd_objectstore` option names.

    `kstore-file`/`memstore` differ only in the KeyValueDB the caller
    passes (FileDB vs MemDB) — both get a KStore. `blockstore` gets the
    allocator/at-rest-checksum store; its block file defaults to
    `<db.path>/block` beside a FileDB's WAL, or an in-memory device over
    MemDB (the MemStore-tier equivalent for tests)."""
    kind = config.get("osd_objectstore") if config is not None else None
    if kind == "blockstore":
        from ceph_tpu_torch.osd.blockstore import BlockStore

        return BlockStore(db, config=config)
    return KStore(db)
