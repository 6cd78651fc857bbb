"""ceph_tpu_torch.ckpt: crash-consistent, sharding-aware training-checkpoint
store over RADOS (the framework's Orbax/TensorStore role).

A checkpoint is a pytree of arrays laid out as:

  <name>@<save_id>.%016x       fixed-size chunk objects (striper naming),
                               EC-full-stripe aligned, per-chunk crc32c
  <name>@<save_id>.manifest    the deterministic manifest (layout.py)
  <name>.ckpt-head             HEAD pointer, advanced by an in-OSD
                               compare-and-swap (cls ckpt.cas_head)

Commit order is chunks -> manifest -> HEAD CAS, so a crash at ANY instant
leaves the previous complete checkpoint restorable; `gc` reclaims the
orphans of aborted saves under retention policies (keep-last-N /
every-Nth), by manifest reachability. Saves are INCREMENTAL: each chunk
carries a content fingerprint and unchanged chunks are referenced from
the previous committed save instead of re-uploaded. `save_async`
snapshots to host and persists in the background (PendingSave handle,
bounded by ckpt_async_max_pending), so the train-visible stall is the
snapshot, not the upload. Restore is pipelined (readahead window
overlapping reads with decompress/crc/placement) and sharding-aware:
each host fetches only the byte ranges its addressable shards need and
a checkpoint saved under one device mesh restores under a different
device count (reshard-on-load via parallel/sharding.py).

Port of ceph_tpu/ckpt: leaves are torch tensors and
`parallel.sharding.MeshArray`s; the manifest and every chunk object are
byte-identical to `ceph_tpu`'s for the same tree and save_id.
"""

from ceph_tpu_torch.ckpt.async_save import AsyncSaver, PendingSave  # noqa: F401
from ceph_tpu_torch.ckpt.layout import (  # noqa: F401
    build_manifest,
    chunk_fingerprint,
    chunk_object_name,
    head_object,
    manifest_dedup,
    manifest_object,
    pool_alignment,
)
from ceph_tpu_torch.ckpt.store import CkptStore  # noqa: F401
