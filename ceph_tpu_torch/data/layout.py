"""Dataset layout: record shards, per-shard indexes, manifests, and the
deterministic shuffle/partition math the iterator is built on.

A dataset ingest mirrors the checkpoint subsystem's crash-consistency
shape (ckpt/layout.py): records stream into striper-named shard objects
under soid `<name>@<ingest_id>/shard.%08x` (each shard's sub-objects use
the striper's `%016x` convention and are sized to a full EC stripe, so
shard puts never read-modify-write), every record carries a crc32c over
its raw payload in the shard's index object, and a manifest + HEAD CAS
(cls ckpt.cas_head — generic over the object it guards) publish the
ingest atomically: a kill -9 mid-ingest leaves the previous committed
dataset readable and the new shards as orphans.

Everything in this module is pure. In particular the shuffle math —
`epoch_permutation` (counter-based Philox keyed on (seed, epoch)) and
`parallel.sharding.host_slice` — is deterministic across processes and
platforms, which is what makes per-host iteration coordination-free and
cursors resumable: any process can recompute exactly which records any
host yields at any position of any epoch.
"""

from __future__ import annotations

import json

import numpy as np

from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.ckpt.layout import MIN_ALIGN, chunk_bytes, pool_alignment  # noqa: F401  (re-exported: the data writer aligns with the same rules)
from ceph_tpu_torch.rados.striper import StripeLayout

FORMAT = 1

#: striper sub-object target for shard objects (pre-alignment): shards
#: larger than this fan out across multiple whole-stripe sub-objects
SUB_OBJECT_TARGET = 1 << 20


# -- naming -------------------------------------------------------------------


def head_object(name: str) -> str:
    return f"{name}.data-head"


def ingest_soid(name: str, ingest_id: str) -> str:
    return f"{name}@{ingest_id}"


def manifest_object(name: str, ingest_id: str) -> str:
    return f"{ingest_soid(name, ingest_id)}.manifest"


def shard_soid(name: str, ingest_id: str, index: int) -> str:
    """Logical (striped) name of shard `index`: the `<dataset>/shard.%08x`
    convention, namespaced by ingest for crash consistency/gc."""
    return f"{ingest_soid(name, ingest_id)}/shard.{index:08x}"


def shard_index_object(name: str, ingest_id: str, index: int) -> str:
    """The shard's record index (offset/length/crc per record)."""
    return f"{shard_soid(name, ingest_id, index)}.idx"


def ingest_id_of(obj: str, name: str) -> str | None:
    """The ingest_id of a `<name>@<ingest_id>[/shard...][.suffix]`
    object, else None (ckpt's save_id_of, aware of the shard `/`)."""
    prefix = f"{name}@"
    if not obj.startswith(prefix):
        return None
    rest = obj[len(prefix):]
    return rest.split("/", 1)[0].split(".", 1)[0]


def sub_object_bytes(alignment: int, shard_target: int) -> int:
    """Shard sub-object size: the striper object_size, rounded UP to the
    pool alignment (a full EC stripe) so every full sub-object write
    encodes whole stripes — only a shard's tail sub-object is partial."""
    return chunk_bytes(min(SUB_OBJECT_TARGET, max(shard_target, 1)),
                       alignment)


def shard_layout(alignment: int, shard_target: int) -> StripeLayout:
    sub = sub_object_bytes(alignment, shard_target)
    return StripeLayout(stripe_unit=sub, stripe_count=1, object_size=sub)


# -- record encode/decode -----------------------------------------------------
#
# A shard is the concatenation of its records' STORED payloads; the index
# entry per record is the compact list
#
#   [offset, stored, length, crc, compressed]
#
# offset/stored locate the bytes within the shard stream, length is the
# raw (decompressed) size, crc is crc32c over the RAW payload (so a
# decompress bug and a wire flip are both caught), compressed is 0/1.


class DataCorrupt(Exception):
    """A record failed its index crc/length check."""


def encode_record(payload: bytes, offset: int, compressor=None):
    """(stored_bytes, entry) for one record at shard-stream `offset`."""
    crc = ceph_crc32c(0xFFFFFFFF, payload)
    stored = payload
    compressed = 0
    if compressor is not None:
        did, stored = compressor.maybe_compress(payload)
        compressed = 1 if did else 0
    return stored, [offset, len(stored), len(payload), crc, compressed]


def decode_record(stored: bytes, entry, alg: str = "",
                  verify: bool = True) -> bytes:
    """Stored bytes -> raw payload, length/crc checked against `entry`."""
    offset, stored_len, length, crc, compressed = entry
    if len(stored) != stored_len:
        raise DataCorrupt(
            f"record @{offset}: {len(stored)} stored bytes, "
            f"index says {stored_len}"
        )
    payload = stored
    if compressed:
        from ceph_tpu_torch.common.compressor import factory

        try:
            payload = factory(alg).decompress(stored)
        except Exception as e:
            raise DataCorrupt(
                f"record @{offset}: {alg or 'unknown'} decompress "
                f"failed: {e}"
            ) from e
    if len(payload) != length:
        raise DataCorrupt(
            f"record @{offset}: {len(payload)} bytes after decompress, "
            f"index says {length}"
        )
    if verify:
        got = ceph_crc32c(0xFFFFFFFF, payload)
        if got != crc:
            raise DataCorrupt(
                f"record @{offset}: crc {got:#x} != index {crc:#x}"
            )
    return payload


def encode_index(entries: list) -> bytes:
    return json.dumps({"format": FORMAT, "records": entries}).encode()


def decode_index(raw: bytes) -> list:
    d = json.loads(raw.decode())
    if d.get("format") != FORMAT:
        raise ValueError(f"unsupported index format {d.get('format')!r}")
    return d["records"]


# -- manifest -----------------------------------------------------------------


def build_manifest(
    name: str,
    ingest_id: str,
    shards: list[dict],
    *,
    shard_bytes: int,
    sub_object: int,
    compress: str = "",
    schema: dict | None = None,
) -> dict:
    """The shard table. `shards` entries carry {index, records, bytes,
    stored}; soids/index objects are derived by name so the manifest
    stays compact. `schema` is {dtype, shape} for fixed-schema tensor
    records (every record the same dtype/shape — the iterator then
    yields stacked arrays), else None (records yield as bytes)."""
    return {
        "format": FORMAT,
        "name": name,
        "ingest_id": ingest_id,
        "compress": compress,
        "shard_bytes": int(shard_bytes),
        "sub_object": int(sub_object),
        "schema": schema,
        "record_count": int(sum(s["records"] for s in shards)),
        "total_bytes": int(sum(s["bytes"] for s in shards)),
        "stored_bytes": int(sum(s["stored"] for s in shards)),
        "shards": [
            {
                "index": int(s["index"]),
                "records": int(s["records"]),
                "bytes": int(s["bytes"]),
                "stored": int(s["stored"]),
            }
            for s in shards
        ],
    }


def encode_manifest(manifest: dict) -> bytes:
    return json.dumps(manifest, sort_keys=True).encode()


def decode_manifest(raw: bytes) -> dict:
    m = json.loads(raw.decode())
    if m.get("format") != FORMAT:
        raise ValueError(f"unsupported manifest format {m.get('format')!r}")
    return m


def shard_starts(manifest: dict) -> np.ndarray:
    """Cumulative record-count table: global record id r lives in shard
    i = searchsorted(starts, r, 'right') - 1 at local index r - starts[i]."""
    counts = np.array(
        [s["records"] for s in manifest["shards"]], dtype=np.int64
    )
    return np.concatenate(([0], np.cumsum(counts)))[:-1]


def locate(manifest: dict, starts: np.ndarray, rid: int) -> tuple[int, int]:
    """Global record id -> (shard index, local record index)."""
    si = int(np.searchsorted(starts, rid, side="right")) - 1
    return si, rid - int(starts[si])


# -- deterministic shuffle / partition ----------------------------------------


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    """The epoch's global shuffle: a permutation of [0, n) from a
    counter-based Philox generator keyed on (seed, epoch) — identical on
    every process and platform, no coordination, O(1) state."""
    key = np.array(
        [np.uint64(seed & (2**64 - 1)), np.uint64(epoch & (2**64 - 1))],
        dtype=np.uint64,
    )
    rng = np.random.Generator(np.random.Philox(key=key))
    return rng.permutation(np.int64(n))


def coalesce_entries(entries: list) -> list[dict]:
    """Adjacent stored-byte runs of index entries (sorted by offset):
    entries whose stored extents touch merge into one ranged read —
    {"offset", "length", "entries": [entry...]}. The iterator fetches
    one run per RADOS op instead of one per record."""
    runs: list[dict] = []
    for e in sorted(entries, key=lambda e: e[0]):
        off, stored = e[0], e[1]
        if runs and runs[-1]["offset"] + runs[-1]["length"] == off:
            runs[-1]["length"] += stored
            runs[-1]["entries"].append(e)
        else:
            runs.append({"offset": off, "length": stored, "entries": [e]})
    return runs


# -- resumable cursor ---------------------------------------------------------
#
# The cursor is the iterator's full deterministic coordinates: with
# (ingest_id, seed, epoch, position, num_hosts, host) any process can
# recompute the exact remaining record sequence — no replay, no gaps.

CURSOR_FORMAT = 1

#: how an epoch's permuted record ids are split across hosts:
#:   "slice"  — balanced contiguous runs (parallel.sharding.host_slice);
#:   "stride" — host h owns perm[base + h :: num_hosts]. The stride
#: form is what fleet resume needs: at any position p that all hosts
#: have reached, the globally consumed prefix is EXACTLY
#: perm[base : base + p*num_hosts], so `rebase_cursor` can hand the
#: remainder to a different host count with zero duplicate or missing
#: records — impossible to do exactly with contiguous runs.
PARTITIONS = ("slice", "stride")


def cursor_state(
    *, name: str, ingest_id: str, seed: int, epoch: int, position: int,
    num_hosts: int, host: int, batch_size: int,
    partition: str = "slice", base: int = 0,
) -> dict:
    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}")
    return {
        "format": CURSOR_FORMAT,
        "name": name,
        "ingest_id": ingest_id,
        "seed": int(seed),
        "epoch": int(epoch),
        "position": int(position),
        "num_hosts": int(num_hosts),
        "host": int(host),
        "batch_size": int(batch_size),
        "partition": partition,
        "base": int(base),
    }


def rebase_cursor(cursor: dict, *, num_hosts: int, host: int) -> dict:
    """Re-partition a synchronized stride cursor onto a new host set
    (fleet membership changed between save and resume). All old hosts
    must have reached `position`; the consumed global prefix
    perm[base : base + position*old_hosts] is folded into the new base,
    so the new hosts' sequences tile the remainder exactly."""
    if cursor.get("partition", "slice") != "stride":
        raise ValueError(
            "only stride-partitioned cursors re-partition exactly; "
            f"got {cursor.get('partition', 'slice')!r}"
        )
    base = cursor.get("base", 0) + cursor["position"] * cursor["num_hosts"]
    return dict(cursor, base=base, position=0,
                num_hosts=int(num_hosts), host=int(host))


def cursor_array(state: dict) -> np.ndarray:
    """Cursor -> uint8 array, embeddable as a leaf of a checkpoint
    pytree (tree["data_cursor"] = cursor_array(it.state())) so CkptStore
    persists and restores it alongside the model state."""
    if state.get("format") != CURSOR_FORMAT:
        raise ValueError(f"unsupported cursor format {state.get('format')!r}")
    return np.frombuffer(
        json.dumps(state, sort_keys=True).encode(), dtype=np.uint8
    ).copy()


def cursor_from_array(arr) -> dict:
    state = json.loads(bytes(np.asarray(arr, dtype=np.uint8)).decode())
    if state.get("format") != CURSOR_FORMAT:
        raise ValueError(f"unsupported cursor format {state.get('format')!r}")
    return state
