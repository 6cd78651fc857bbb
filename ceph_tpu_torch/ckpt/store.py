"""CkptStore: the user-facing checkpoint handle (save/save_async/
restore/ls/verify/gc over one IoCtx + checkpoint name), with the
per-store perf block the acceptance tests and ckpt_tool read.

Port of ceph_tpu/ckpt/store.py: `restore` takes the device its tensors
land on (cuda by default, which raises without a card)."""

from __future__ import annotations

import json

from ceph_tpu_torch.ckpt import gc as gc_mod
from ceph_tpu_torch.ckpt import layout
from ceph_tpu_torch.ckpt.async_save import AsyncSaver, PendingSave
from ceph_tpu_torch.ckpt.reader import CkptReader
from ceph_tpu_torch.ckpt.writer import CkptWriter
from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.rados.client import ObjectNotFound


class CkptStore:
    def __init__(self, ioctx, name: str, *, config=None):
        self.ioctx = ioctx
        self.name = name
        self.config = config if config is not None else ioctx.objecter.config
        self.perf = self._make_perf(name)
        self._async: AsyncSaver | None = None

    @staticmethod
    def _make_perf(name: str) -> PerfCounters:
        p = PerfCounters(f"ckpt.{name}")
        p.add_u64_counter("save_bytes", "logical bytes written by saves")
        p.add_u64_counter("save_chunks", "chunk objects written")
        p.add_u64_counter(
            "save_chunks_reused",
            "chunk uploads skipped by the incremental diff (referenced "
            "from the previous committed save instead)",
        )
        p.add_u64_counter(
            "save_bytes_reused",
            "logical bytes those reused chunks would have re-uploaded",
        )
        p.add_u64_counter("save_commits", "HEAD CAS commits")
        p.add_u64_counter(
            "save_prepared_bytes",
            "host bytes serialized for saves (a fleet-parallel rank "
            "prepares only its owned chunks: ≈ tree_bytes / num_hosts)",
        )
        p.add_u64_counter("save_async_submits", "save_async() snapshots")
        p.add_u64(
            "save_async_pending_peak",
            "peak background saves in flight at once (bounded by "
            "ckpt_async_max_pending)",
        )
        p.add_time_avg(
            "save_block_latency",
            "train-visible stall per save_async (snapshot + "
            "backpressure wait; compare with save_latency wall time)",
        )
        p.add_u64_counter("restore_bytes", "logical bytes restored")
        p.add_u64_counter(
            "restore_read_bytes",
            "bytes actually fetched from RADOS (partial-read savings "
            "show up here)",
        )
        p.add_u64_counter(
            "restore_host_bytes",
            "host bytes materialized by restores (a mesh restore is "
            "bounded by this host's shard bytes, never the full tree)",
        )
        p.add_u64_counter("gc_removed", "orphaned objects reclaimed")
        p.add_u64("inflight_peak", "peak concurrent chunk ops")
        p.add_u64(
            "restore_readahead_peak",
            "peak concurrent chunk reads during pipelined restore",
        )
        p.add_time_avg("save_latency", "wall time per save()")
        p.add_time_avg("restore_latency", "wall time per restore()")
        return p

    # -- write path ------------------------------------------------------------

    def writer(self, tree, *, save_id: str | None = None) -> CkptWriter:
        """A staged writer (prepare/put_chunks/put_manifest/commit) —
        the crash-consistency tests drive the stages directly."""
        return CkptWriter(
            self.ioctx, self.name, tree,
            save_id=save_id, config=self.config, perf=self.perf,
        )

    async def save(self, tree, *, save_id: str | None = None) -> str:
        return await self.writer(tree, save_id=save_id).save()

    # -- async write path ------------------------------------------------------

    @property
    def async_saver(self) -> AsyncSaver:
        if self._async is None:
            self._async = AsyncSaver(self)
        return self._async

    async def save_async(
        self, tree, *, save_id: str | None = None
    ) -> PendingSave:
        """Snapshot `tree` to host NOW and persist it in the
        background; returns a PendingSave immediately (its blocking_s
        is the train-visible stall). Commits land in submission order;
        `ckpt_async_max_pending` bounds the snapshots in flight."""
        return await self.async_saver.submit(tree, save_id=save_id)

    @property
    def pending_saves(self) -> list[PendingSave]:
        return [] if self._async is None else self._async.pending

    async def drain(self) -> list[str]:
        """Join every pending async save (epilogue / clean shutdown)."""
        return [] if self._async is None else await self._async.drain()

    # -- read path -------------------------------------------------------------

    def reader(self) -> CkptReader:
        return CkptReader(
            self.ioctx, self.name, config=self.config, perf=self.perf
        )

    async def restore(self, *, mesh=None, save_id: str | None = None, device=None):
        """HEAD's tree (or `save_id`'s): tensors on `device` (cuda by
        default), or MeshArrays on `mesh`."""
        return await self.reader().restore(mesh=mesh, save_id=save_id, device=device)

    async def head(self) -> dict | None:
        try:
            raw = await self.ioctx.read(layout.head_object(self.name))
        except ObjectNotFound:
            return None
        return json.loads(raw.decode())

    async def ls(self) -> dict:
        """Every save_id present in the pool for this name, annotated
        with HEAD/manifest status (aborted saves show committed=False)
        and, where a manifest exists, incremental-dedup accounting
        (owned vs referenced chunk counts + byte ratio)."""
        head = await self.head()
        head_id = None if head is None else head.get("save_id")
        history = [] if head is None else head.get("history") or []
        saves: dict[str, dict] = {}
        for obj in await gc_mod.list_objects(
            self.ioctx, prefix=f"{self.name}@"
        ):
            sid = gc_mod.save_id_of(obj, self.name)
            entry = saves.setdefault(
                sid, {"save_id": sid, "objects": 0, "manifest": False}
            )
            entry["objects"] += 1
            if obj == layout.manifest_object(self.name, sid):
                entry["manifest"] = True
        for sid, entry in saves.items():
            entry["committed"] = sid in history or sid == head_id
            if entry["manifest"]:
                try:
                    manifest = await self.reader().read_manifest(sid)
                    entry["dedup"] = layout.manifest_dedup(manifest)
                    entry["parent"] = manifest.get("parent")
                except (ObjectNotFound, ValueError):
                    pass
        return {
            "name": self.name,
            "head": head_id,
            "history": history,
            "saves": sorted(saves.values(), key=lambda e: e["save_id"]),
        }

    async def verify(self, save_id: str | None = None) -> dict:
        return await self.reader().verify(save_id)

    async def gc(
        self, *, keep=(), keep_last: int | None = None,
        keep_every_nth: int | None = None,
    ) -> dict:
        return await gc_mod.collect(
            self.ioctx, self.name, keep=keep, keep_last=keep_last,
            keep_every_nth=keep_every_nth, perf=self.perf,
        )

    def perf_dump(self) -> dict:
        return self.perf.dump()
