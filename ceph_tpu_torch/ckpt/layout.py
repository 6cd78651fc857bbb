"""Checkpoint layout: pytree -> deterministic manifest + chunk table.

The manifest records, per array, dtype/shape/PartitionSpec and the byte
offset of its row-major serialization in one concatenated stream; the
stream is cut into fixed-size chunk objects whose size is rounded UP to a
full EC stripe (k * stripe_unit) so chunk puts on EC pools are whole-
object, whole-stripe writes — never a read-modify-write. Chunk objects
reuse the striper's `<soid>.%016x` naming (rados/striper.py contract,
property-tested in tests/test_striper.py) with soid = `<name>@<save_id>`.

Everything here is pure and deterministic: the same pytree + save_id
yields byte-identical manifests, which is what makes `verify` and the
crash-consistency story auditable.

Port of ceph_tpu/ckpt/layout.py. The pytree is flattened with
`torch.utils._pytree`, but plain dicts go in sorted key order, as jax
flattens them (torch keeps insertion order), and None holds no leaf, as in
jax: the same tree gives `ceph_tpu`'s manifest byte for byte. Leaves are
torch tensors (on any device), `parallel.sharding.MeshArray`s (whose spec is
recorded), numpy arrays or scalars.
"""

from __future__ import annotations

import collections
import json

import numpy as np

import torch
from torch.utils import _pytree

from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.parallel.sharding import MeshArray
from ceph_tpu_torch.rados.striper import object_name

FORMAT = 1
#: replicated pools have no stripe constraint; align to the allocator page
MIN_ALIGN = 4096
#: the fleet mesh axis name (coord/mesh.py builds meshes with this axis;
#: specs naming it on axis 0 slab-align the parallel-save chunk cuts)
FLEET_AXIS = "fleet"

try:  # the container ships xxhash; blake2b keeps the layout importable
    import xxhash as _xxhash

    def _xxh64(payload: bytes) -> int:
        return _xxhash.xxh64(payload).intdigest()
except ImportError:  # pragma: no cover - environment-dependent fallback
    import hashlib as _hashlib

    def _xxh64(payload: bytes) -> int:
        return int.from_bytes(
            _hashlib.blake2b(payload, digest_size=8).digest(), "big"
        )


def chunk_fingerprint(payload: bytes) -> str:
    """Content fingerprint of one UNCOMPRESSED chunk payload: xxhash64
    composed with crc32c (24 hex chars). Two independent hash families
    make an accidental collision — which would silently alias two
    different chunks across saves — vanishingly unlikely, and the crc
    half reuses the checksum the chunk put computes anyway."""
    return (
        f"{_xxh64(payload):016x}"
        f"{ceph_crc32c(0xFFFFFFFF, payload):08x}"
    )


def diff_chunks(manifest: dict, prev: dict | None) -> int:
    """Incremental-save diff: mark every chunk of `manifest` whose
    (fingerprint, length) matches a chunk of the previous committed
    manifest as REUSED — its entry flips to the prior save's object
    name (transitively the ultimate owner: a reused entry in `prev`
    already points at the save that really stored the bytes) and its
    crc/stored/compressed travel along so restore needs no special
    case. Chunks must already carry their `hash` (the writer
    fingerprints the payloads first). Returns the number reused."""
    if not prev:
        return 0
    by_print = {
        (c.get("hash"), c["length"]): c
        for c in prev.get("chunks", ())
        if c.get("hash") and c.get("crc") is not None
    }
    reused = 0
    for chunk in manifest["chunks"]:
        old = by_print.get((chunk.get("hash"), chunk["length"]))
        if old is None:
            continue
        chunk["object"] = old["object"]
        chunk["crc"] = old["crc"]
        chunk["stored"] = old["stored"]
        chunk["compressed"] = old["compressed"]
        chunk["reused"] = True
        reused += 1
    return reused


def manifest_dedup(manifest: dict) -> dict:
    """Per-save dedup accounting: owned vs referenced chunk counts and
    the byte ratio ckpt_tool's `ls` and the bench line report."""
    chunks = manifest.get("chunks", ())
    reused = [c for c in chunks if c.get("reused")]
    total = sum(c["length"] for c in chunks)
    reused_bytes = sum(c["length"] for c in reused)
    return {
        "chunks": len(chunks),
        "chunks_owned": len(chunks) - len(reused),
        "chunks_referenced": len(reused),
        "bytes": total,
        "bytes_referenced": reused_bytes,
        "dedup_ratio": round(reused_bytes / total, 4) if total else 0.0,
    }


def head_object(name: str) -> str:
    return f"{name}.ckpt-head"


def staging_object(name: str) -> str:
    """The fleet-parallel save's staging record: a HEAD-CAS document
    (same cls guard as the commit point) naming the in-flight save_id,
    its ordered writer set and dedup parent. gc pins whatever it says
    is `staged` so concurrent gc never reclaims a rank's uncommitted
    chunks mid-parallel-save."""
    return f"{name}.ckpt-staging"


def rank_meta_object(name: str, save_id: str, rank: int) -> str:
    """Rank `rank`'s per-save completion record: the chunk fields
    (hash/crc/stored/compressed/reused/object) for the chunks that rank
    owned, merged into the manifest by the leader after the arrival
    barrier."""
    return f"{save_soid(name, save_id)}.rank-{rank:04d}"


def save_soid(name: str, save_id: str) -> str:
    return f"{name}@{save_id}"


def manifest_object(name: str, save_id: str) -> str:
    return f"{save_soid(name, save_id)}.manifest"


def chunk_object_name(name: str, save_id: str, index: int) -> str:
    """Chunk `index` of one save: the striper's `%016x` convention."""
    return object_name(save_soid(name, save_id), index)


def pool_alignment(osdmap, pool_id: int) -> int:
    """Chunk-size alignment for a pool: a full EC stripe (k data chunks
    of stripe_unit each) so every chunk put encodes whole stripes, or
    the allocator page for replicated pools."""
    pool = osdmap.pools[pool_id]
    profile = osdmap.erasure_code_profiles.get(
        getattr(pool, "erasure_code_profile", "") or ""
    )
    if not profile:
        return MIN_ALIGN
    k = int(profile.get("k", 1))
    stripe_unit = int(profile.get("stripe_unit", 1 << 16))
    return max(k * stripe_unit, MIN_ALIGN)


def chunk_bytes(target: int, alignment: int) -> int:
    """Round the configured chunk target UP to the pool alignment."""
    target = max(int(target), 1)
    return ((target + alignment - 1) // alignment) * alignment


# -- fleet-parallel slab math --------------------------------------------------
#
# An axis of n rows sharded over N mesh devices goes in ceil(n/N) slabs
# (the GSPMD padding convention); parallel/sharding.device_slices computes
# it. The chunk cutter must agree exactly, so each chunk of a fleet-sharded
# array falls inside ONE rank's slab (exactly one writer, zero-reassembly
# restore); fleet_slab() is that convention as pure math.


def fleet_slab(n: int, num_hosts: int, rank: int) -> slice:
    """Rank `rank`'s row slab of an axis of `n` rows sharded over
    `num_hosts` fleet positions, in jax's ceil-div convention (the last
    ranks may run short or empty when num_hosts does not divide n)."""
    if num_hosts <= 0:
        raise ValueError("num_hosts must be positive")
    if not 0 <= rank < num_hosts:
        raise ValueError(f"rank {rank} outside [0, {num_hosts})")
    shard = -(-n // num_hosts) if n else 0
    return slice(min(n, rank * shard), min(n, (rank + 1) * shard))


def fleet_sharded(entry, nrows: int, num_hosts: int) -> bool:
    """Does this leading-axis spec entry shard over the fleet axis?"""
    if num_hosts <= 1 or nrows <= 0:
        return False
    if isinstance(entry, (tuple, list)):
        return FLEET_AXIS in entry and len(entry) == 1
    return entry == FLEET_AXIS


def writer_regions(
    arrays: list[dict], num_hosts: int,
) -> list[tuple[int, int, int | None]]:
    """Partition the serialized stream into (start, end, writer) regions:
    each fleet-sharded array contributes one region per rank slab (that
    rank is the sole writer), everything else pools into writer=None
    regions whose chunks round-robin across ranks. Regions are disjoint,
    exhaustive, and sorted; empty slabs are dropped."""
    regions: list[tuple[int, int, int | None]] = []

    def emit(start: int, end: int, writer: int | None) -> None:
        if end <= start:
            return
        if (writer is None and regions and regions[-1][2] is None
                and regions[-1][1] == start):
            regions[-1] = (regions[-1][0], end, None)
            return
        regions.append((start, end, writer))

    for a in arrays:
        spec = a.get("spec")
        shape = a["shape"]
        nrows = int(shape[0]) if shape else 0
        if (spec and shape
                and fleet_sharded(spec[0], nrows, num_hosts)):
            row = a["nbytes"] // nrows
            for r in range(num_hosts):
                sl = fleet_slab(nrows, num_hosts, r)
                emit(a["offset"] + sl.start * row,
                     a["offset"] + sl.stop * row, r)
        else:
            emit(a["offset"], a["offset"] + a["nbytes"], None)
    return regions


# -- pytree <-> flat paths ----------------------------------------------------
#
# Paths serialize as [["k", key] | ["i", index], ...] so restore can
# rebuild dict/list/tuple nests without a pickled treedef (the manifest
# stays JSON, inspectable by ckpt_tool).


def _path_entries(path) -> list:
    out = []
    for entry in path:
        if isinstance(entry, _pytree.MappingKey):
            out.append(["k", entry.key])
        elif isinstance(entry, _pytree.SequenceKey):
            out.append(["i", entry.idx])
        elif isinstance(entry, _pytree.GetAttrKey):
            out.append(["k", entry.name])
        else:  # FlattenedIndexKey and friends
            out.append(["i", getattr(entry, "key", 0)])
    return out


def _spec_of(leaf):
    """The leaf's spec as JSON (None | str | [str...] entries), or None
    for an array laid out on no mesh."""
    if not isinstance(leaf, MeshArray):
        return None
    spec = leaf.spec
    out = []
    for entry in tuple(spec):
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            out.append(list(entry))
        else:
            out.append(entry)
    return out


#: torch's bfloat16 has no numpy dtype. Its raw bits travel as int16, under
#: the names ceph_tpu's numpy (ml_dtypes) gives the type: '<V2' in a
#: checkpoint manifest (np.dtype(ml_dtypes.bfloat16).str) and "bfloat16" in
#: a dataset schema (str(np.dtype(ml_dtypes.bfloat16))). Both restore as
#: torch.bfloat16, bit for bit.
BF16_MANIFEST = "<V2"
BF16_SCHEMA = "bfloat16"


def dtype_str(dtype) -> str:
    """A torch or numpy dtype as a manifest records it (numpy's `.str`;
    '<V2' for bfloat16, as ceph_tpu writes it)."""
    if dtype is torch.bfloat16:
        return BF16_MANIFEST
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype.str
    return np.dtype(dtype).str


def is_bf16(leaf) -> bool:
    """True for a bfloat16 tensor or MeshArray."""
    return getattr(leaf, "dtype", None) is torch.bfloat16


def host_array(leaf) -> np.ndarray:
    """A leaf's values on the host. A tensor on a card leaves it once (one
    device-to-host copy); a MeshArray gathers each distinct slab once. A
    bfloat16 leaf gives its raw bits as int16 (`is_bf16` tells it apart)."""
    if isinstance(leaf, MeshArray):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype is torch.bfloat16:
            leaf = leaf.view(torch.int16)
        return leaf.numpy()
    return np.asarray(leaf)


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a manifest dtype string ('<V2' is bfloat16)."""
    if dtype == BF16_MANIFEST:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host array read back from a manifest entry of `dtype` as a tensor
    sharing its memory: a '<V2' (bfloat16) array's bits as torch.bfloat16."""
    if dtype == BF16_MANIFEST:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _sorted_dicts(tree):
    """The tree's containers rebuilt with plain dicts in sorted key order
    (jax's flatten order for dicts); leaves are not copied."""
    if type(tree) is dict or isinstance(tree, collections.defaultdict):
        return {k: _sorted_dicts(tree[k]) for k in sorted(tree)}
    if isinstance(tree, collections.OrderedDict):
        return collections.OrderedDict((k, _sorted_dicts(v)) for k, v in tree.items())
    if isinstance(tree, list):
        return [_sorted_dicts(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_sorted_dicts(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def flatten_tree(tree) -> list[dict]:
    """Pytree -> ordered leaf records {path, dtype, shape, spec, leaf}.

    Order is jax's flatten order (deterministic per structure); arrays
    stay as-is — serialization happens in the writer so each leaf leaves
    its device once."""
    leaves, _ = _pytree.tree_flatten_with_path(
        _sorted_dicts(tree), is_leaf=lambda x: isinstance(x, MeshArray))
    records = []
    for path, leaf in leaves:
        if leaf is None:  # jax flattens None to no leaf
            continue
        arr = np.asarray(leaf) if np.isscalar(leaf) else leaf
        records.append({
            "path": _path_entries(path),
            "dtype": dtype_str(arr.dtype),
            "shape": [int(d) for d in arr.shape],
            "spec": _spec_of(leaf),
            "leaf": leaf,
        })
    return records


def unflatten(records: list[tuple[list, object]]):
    """[(path_entries, value)] -> the nested dict/list/tuple structure.
    Lists are rebuilt as lists (tuple-ness is not round-tripped; training
    states are dict-of-dict pytrees in practice)."""
    if not records:
        return {}
    if records == [([], records[0][1])]:
        return records[0][1]
    root: dict | list = [] if records[0][0][0][0] == "i" else {}

    def put(container, entries, value):
        kind, key = entries[0]
        if len(entries) == 1:
            if kind == "i":
                while len(container) <= key:
                    container.append(None)
                container[key] = value
            else:
                container[key] = value
            return
        nxt_kind = entries[1][0]
        if kind == "i":
            while len(container) <= key:
                container.append(None)
            if container[key] is None:
                container[key] = [] if nxt_kind == "i" else {}
            put(container[key], entries[1:], value)
        else:
            if key not in container:
                container[key] = [] if nxt_kind == "i" else {}
            put(container[key], entries[1:], value)

    for entries, value in records:
        put(root, entries, value)
    return root


# -- manifest -----------------------------------------------------------------


def build_manifest(
    name: str,
    save_id: str,
    records: list[dict],
    *,
    chunk_size: int,
    compress: str = "",
    parent: str | None = None,
    writers: int = 0,
) -> dict:
    """The array table + chunk table (crc/stored fields filled by the
    writer as chunks go out).

    `writers=0` (the single-committer path) cuts the stream at every
    `chunk_size` boundary, exactly as always. `writers=N` is the
    fleet-parallel layout: the stream is FIRST cut at shard slab
    boundaries (writer_regions) so each chunk lies inside one rank's
    slab, THEN every `chunk_size` within a region; each chunk carries a
    `writer` rank (slab regions: the slab's rank; replicated regions:
    round-robin). Pure and deterministic, so every rank computes the
    SAME manifest locally from the staging record — nothing but the
    save_id travels between hosts before the chunks themselves."""
    arrays, offset = [], 0
    for r in records:
        nbytes = int(np.dtype(r["dtype"]).itemsize * int(np.prod(r["shape"], dtype=np.int64)))
        arrays.append({
            "path": r["path"],
            "dtype": r["dtype"],
            "shape": r["shape"],
            "spec": r["spec"],
            "offset": offset,
            "nbytes": nbytes,
        })
        offset += nbytes
    stream = offset

    def cuts():
        if writers <= 0:
            for off in range(0, stream, chunk_size):
                yield off, min(chunk_size, stream - off), None
            return
        for start, end, writer in writer_regions(arrays, writers):
            for off in range(start, end, chunk_size):
                yield off, min(chunk_size, end - off), writer

    chunks = []
    for i, (off, length, writer) in enumerate(cuts()):
        chunk = {
            "object": chunk_object_name(name, save_id, i),
            "offset": off,
            "length": length,
            "crc": None,        # crc32c of the uncompressed payload
            "stored": None,     # bytes on the wire (== length uncompressed)
            "compressed": False,
            "hash": None,       # chunk_fingerprint of the payload
            "reused": False,    # True: `object` lives in a prior save
        }
        if writers > 0:
            chunk["writer"] = i % writers if writer is None else writer
        chunks.append(chunk)
    manifest = {
        "format": FORMAT,
        "name": name,
        "save_id": save_id,
        "parent": parent,       # committed HEAD this save diffed against
        "chunk_bytes": chunk_size,
        "compress": compress,
        "stream_bytes": stream,
        "arrays": arrays,
        "chunks": chunks,
    }
    if writers > 0:
        manifest["writers"] = writers
    return manifest


def encode_manifest(manifest: dict) -> bytes:
    return json.dumps(manifest, sort_keys=True).encode()


def decode_manifest(raw: bytes) -> dict:
    m = json.loads(raw.decode())
    if m.get("format") != FORMAT:
        raise ValueError(f"unsupported manifest format {m.get('format')!r}")
    return m
