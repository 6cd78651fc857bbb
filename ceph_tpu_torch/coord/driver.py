"""coord.driver: wire the Fleet to the ckpt + data stores.

The multi-host training contract:

  * **fleet-parallel saves** (`save_async`) — every live host calls it
    collectively with the SAME sharded PyTree; the leader CASes a
    *staging* record (save_id, ordered writer set, dedup parent) on
    `<name>.ckpt-staging`, every rank independently computes the SAME
    slab-aligned manifest and puts ONLY the chunks its rank owns
    (peak prepared host bytes ≈ tree_bytes / N), ranks meet at a
    per-save sub-group barrier, and the leader ALONE merges the rank
    records and performs the one atomic HEAD CAS. kill -9 of any
    writer before that CAS keeps the previous checkpoint bit-exact:
    a missing rank record turns the save into an abort, never a
    partial commit.
  * **exactly-one-committer saves** (`save`) — the legacy single-host
    path: only the elected leader snapshots + persists, while holding
    the `committer` lease lock on the HEAD object. A leader that dies
    mid-save leaves an expired lease; the next leader breaks it
    (cls-side `if_expired` guard) and commits its own save.
  * **mesh-native restore** (`restore_mesh` / `restore_rank_shards`)
    — the manifest's chunks map straight onto the fleet mesh's slabs
    (the cuts were slab-aligned at save), so restore is ranged reads
    + one host-to-device copy per slab, with zero host-side full-array
    reassembly;
    a roster that shrank since the save just resolves to bigger
    slabs (elastic reshard).
  * **exact data resume** — iterators run the "stride" partition, so a
    cursor saved at a synchronized step re-partitions onto the
    SURVIVING host set with zero duplicate and zero missing records
    (`layout.rebase_cursor`).

Port of ceph_tpu/coord/driver.py: `FleetDriver(devices=)` names the
devices of the fleet mesh that `mesh()` and `restore_mesh()` build (by
default the visible cards); `restore(device=)` gives tensors on that
device (cuda by default). Mesh restores give `MeshArray`s.
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid

from ceph_tpu_torch.ckpt import layout as ckpt_layout
from ceph_tpu_torch.ckpt.writer import CkptAborted, CkptConflict
from ceph_tpu_torch.coord.lock import Lock
from ceph_tpu_torch.data import layout as data_layout
from ceph_tpu_torch.parallel.sharding import host_slice
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError


class _Takeover(Exception):
    """Internal: a follower won the leader election mid-wait (the
    incumbent died); switch roles instead of waiting forever."""


class ParallelSave:
    """Handle to one rank's share of a collective fleet-parallel save
    (the driver-level analogue of ckpt.async_save.PendingSave)."""

    def __init__(self):
        #: the collective save_id — on a follower, set once the staging
        #: record is observed
        self.save_id: str | None = None
        self.leader: bool = False
        self._task: asyncio.Task | None = None

    @property
    def done(self) -> bool:
        return self._task is not None and self._task.done()

    async def wait(self) -> str:
        """Join this rank's share; returns the committed save_id or
        raises CkptAborted/TimeoutError. Shielded like PendingSave."""
        return await asyncio.shield(self._task)

    @property
    def error(self) -> BaseException | None:
        if not self.done or self._task.cancelled():
            return None
        return self._task.exception()


class FleetDriver:
    def __init__(self, fleet, ckpt=None, data=None, *, devices=None):
        self.fleet = fleet
        self.ckpt = ckpt  # CkptStore
        self.data = data  # DataReader
        #: the fleet mesh's devices (None: the visible cards)
        self.devices = devices
        self._committer: Lock | None = None
        #: last staging save_id this rank joined (follower side): the
        #: next collective save must present a NEWER one
        self._seen_staging: str | None = None

    # -- checkpoint write path -------------------------------------------------

    def committer_lock(self) -> Lock:
        """The lease lock serializing committers, on the HEAD object
        itself so it travels with the checkpoint name."""
        if self._committer is None:
            self._committer = Lock(
                self.ckpt.ioctx, ckpt_layout.head_object(self.ckpt.name),
                "committer",
                owner=self.fleet.host_id, cookie=self.fleet.host_id,
                lease=self.fleet.lease, description="fleet ckpt committer",
                perf=self.fleet.perf,
            )
        return self._committer

    async def save(self, tree, *, iterator=None, save_id=None,
                   timeout: float | None = None):
        """Leader-only async save; returns the PendingSave, or None on
        a non-leader (callers just keep training). Fills a vacant
        leader seat first, so any survivor calling save() after the
        leader died re-elects and takes over committing. When
        `iterator` is given, its cursor rides along as the
        "data_cursor" leaf."""
        if not await self.fleet.elect():
            return None
        lk = self.committer_lock()
        if not lk.locked:
            await lk.acquire(block=True, timeout=timeout, break_dead=True)
        if iterator is not None:
            tree = dict(tree)
            tree["data_cursor"] = data_layout.cursor_array(
                iterator.state()
            )
        return await self.ckpt.save_async(tree, save_id=save_id)

    async def drain(self) -> list[str]:
        """Join pending saves and give up the committer lease."""
        try:
            return await self.ckpt.drain()
        finally:
            if self._committer is not None:
                await self._committer.release()

    # -- fleet-parallel save (every host writes only its shards) ---------------

    @property
    def _staging_obj(self) -> str:
        return ckpt_layout.staging_object(self.ckpt.name)

    async def _read_staging(self) -> dict | None:
        try:
            raw = await self.ckpt.ioctx.read(self._staging_obj)
            return json.loads(raw.decode()) if raw else None
        except (ObjectNotFound, ValueError):
            return None

    async def _staging_cas(self, doc: dict) -> None:
        """Publish/update the staging record (HEAD-CAS on the staging
        object — atomic vs racing leaders) and nudge watchers."""
        while True:
            cur = await self._read_staging()
            try:
                await self.ckpt.ioctx.exec(
                    self._staging_obj, "ckpt", "cas_head",
                    {"expect": None if cur is None else cur["save_id"],
                     "head": doc},
                )
                break
            except RadosError as e:
                if "ECANCELED" not in str(e):
                    raise
                if doc.get("state") != "staged":
                    return  # flip lost to a newer staged save: superseded
        try:
            await self.ckpt.ioctx.notify(
                self._staging_obj,
                json.dumps({"save_id": doc["save_id"],
                            "state": doc["state"]}),
                timeout=1.0,
            )
        # cephlint: disable=error-taxonomy (staging wakeups are best-effort; pollers converge)
        except Exception:  # noqa: BLE001
            pass

    async def _staging_wait(self, accept, *, timeout: float | None,
                            tick=None):
        """Poll + watch the staging object until `accept(doc)` returns
        non-None; the same watch/poll discipline as Lock waiters.
        `tick` (async, optional) runs every iteration — waiters use it
        to keep the fleet healthy (sweep the dead, fill a vacant leader
        seat) so a dead leader can't strand its followers."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        wake = asyncio.Event()
        cookie = f"stg.{self.fleet.host_id}"
        watching = False
        poll = float(self.fleet.config.get("coord_barrier_poll"))
        try:
            try:
                await self.ckpt.ioctx.watch(
                    self._staging_obj, lambda n, p: wake.set(),
                    cookie=cookie,
                )
                watching = True
            except RadosError:
                pass
            while True:
                if tick is not None:
                    await tick()
                doc = await self._read_staging()
                got = accept(doc)
                if got is not None:
                    return got
                wake.clear()
                wait = poll
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"parallel save: staging record on "
                            f"{self._staging_obj} did not settle"
                        )
                    wait = min(poll, remaining)
                try:
                    await asyncio.wait_for(wake.wait(), timeout=wait)
                except asyncio.TimeoutError:
                    pass
        finally:
            if watching:
                try:
                    await self.ckpt.ioctx.unwatch(
                        self._staging_obj, cookie=cookie
                    )
                except RadosError:
                    pass

    async def save_async(self, tree, *, save_id: str | None = None,
                         timeout: float | None = None) -> ParallelSave:
        """The collective fleet-parallel save: EVERY live host calls
        this with the same (sharded) PyTree at the same step. Returns a
        ParallelSave immediately; this rank's share (slab-aligned chunk
        puts of ONLY the chunks it owns, the per-save barrier, and — on
        the leader — the merge + atomic HEAD CAS) runs in the
        background. `await handle.wait()` yields the committed save_id,
        or raises CkptAborted when a writer died before commit (HEAD
        untouched — survivors just call save_async again)."""
        ps = ParallelSave()
        ps._task = asyncio.create_task(
            self._parallel_save(tree, save_id, timeout, ps)
        )
        return ps

    async def _parallel_save(self, tree, save_id, timeout, ps) -> str:
        if await self.fleet.elect():
            ps.leader = True
            return await self._lead_parallel(tree, save_id, timeout, ps)
        try:
            return await self._follow_parallel(tree, timeout, ps)
        except _Takeover:
            # the incumbent died before staging anything and we
            # inherited the seat: stage our own save over the
            # (now shrunken) live roster
            ps.leader = True
            return await self._lead_parallel(tree, save_id, timeout, ps)

    async def _elect_tick(self) -> None:
        """Run from staging-wait loops: self-heal the fleet, and bail
        out of the follower role the moment we become leader."""
        await self.fleet._maintain()
        if self.fleet.is_leader:
            raise _Takeover

    async def _lead_parallel(self, tree, save_id, timeout, ps) -> str:
        lk = self.committer_lock()
        if not lk.locked:
            await lk.acquire(block=True, timeout=timeout,
                             break_dead=True)
        hosts = await self.fleet.live_members()
        rank = hosts.index(self.fleet.host_id)
        sid = save_id or uuid.uuid4().hex[:16]
        ps.save_id = self._seen_staging = sid
        writer = self.ckpt.writer(tree, save_id=sid)
        expect_head = await writer.read_head()
        parent = (expect_head
                  if self.ckpt.config.get("ckpt_incremental") else None)
        await self._staging_cas({
            "save_id": sid, "state": "staged", "hosts": hosts,
            "parent": parent,
        })
        try:
            writer.prepare_parallel(len(hosts), rank, parent=parent)
            own = await writer.put_rank_chunks()
            await writer.put_rank_meta(own)
            await self.fleet.barrier(tag=f"save.{sid}", members=hosts,
                                     timeout=timeout)
            metas = [m for m in await asyncio.gather(*(
                writer.read_rank_meta(r) for r in range(len(hosts))
            )) if m is not None]
            # a missing record means a writer died before its share
            # was durable: merge raises CkptAborted, HEAD stays put
            writer.merge_rank_meta(metas)
            await writer.put_manifest()
            await writer.commit(expect=expect_head)
        except BaseException:
            await self._staging_cas(dict(
                save_id=sid, state="aborted", hosts=hosts,
                parent=parent,
            ))
            await writer.cleanup_rank_meta(len(hosts))
            raise
        await self._staging_cas(dict(
            save_id=sid, state="committed", hosts=hosts, parent=parent,
        ))
        await writer.cleanup_rank_meta(len(hosts))
        try:  # groom the per-save barrier object
            await self.ckpt.ioctx.remove(
                self.fleet._barrier_obj(0, f"save.{sid}")
            )
        except RadosError:
            pass
        return sid

    async def _follow_parallel(self, tree, timeout, ps) -> str:
        def fresh(doc):
            if (doc and doc.get("state") == "staged"
                    and doc.get("save_id") != self._seen_staging
                    and self.fleet.host_id in doc.get("hosts", ())):
                return doc
            return None

        doc = await self._staging_wait(fresh, timeout=timeout,
                                       tick=self._elect_tick)
        sid = doc["save_id"]
        ps.save_id = self._seen_staging = sid
        hosts = doc["hosts"]
        writer = self.ckpt.writer(tree, save_id=sid)
        writer.prepare_parallel(
            len(hosts), hosts.index(self.fleet.host_id),
            parent=doc.get("parent"),
        )
        own = await writer.put_rank_chunks()
        await writer.put_rank_meta(own)
        await self.fleet.barrier(tag=f"save.{sid}", members=hosts,
                                 timeout=timeout)
        try:
            return await self._await_outcome(writer, sid, timeout)
        except _Takeover:
            # the leader died AFTER staging: we inherited the seat and
            # must settle ITS save — commit if every rank's share is
            # durable, abort (HEAD untouched) otherwise
            ps.leader = True
            return await self._takeover_commit(writer, doc, timeout)

    async def _await_outcome(self, writer, sid, timeout) -> str:
        """Follower epilogue: the save is settled by the LEADER's HEAD
        CAS; the staging state is the signal, the commit history the
        fallback (covers a leader dying between the CAS and the flip)."""
        committed: list[bool] = []

        def settled(doc):
            if doc is not None and doc.get("save_id") == sid:
                state = doc.get("state")
                if state == "staged":
                    return None
                committed.append(state == "committed")
                return doc
            # superseded (or vanished): a newer save staged over ours —
            # ours settled first; the commit history says which way
            return doc or {}

        await self._staging_wait(settled, timeout=timeout,
                                 tick=self._elect_tick)
        if committed:
            ok = committed[0]
        else:
            ok = await self._sid_committed(sid)
        if not ok:
            raise CkptAborted(
                f"parallel save {sid} aborted (HEAD unchanged)"
            )
        return sid

    async def _sid_committed(self, sid) -> bool:
        head = await self.ckpt.head()
        history = [] if head is None else head.get("history") or []
        return sid in history or (head or {}).get("save_id") == sid

    async def _takeover_commit(self, writer, doc, timeout) -> str:
        """New-leader epilogue for a save the DEAD leader staged: all
        rank shares (ours included) are already durable, so the only
        work left is the merge + atomic HEAD CAS the incumbent never
        got to. The exclusive leader lease guarantees one taker; a
        zombie incumbent racing us loses the cas_head either way."""
        sid, hosts = doc["save_id"], doc["hosts"]
        lk = self.committer_lock()
        if not lk.locked:
            await lk.acquire(block=True, timeout=timeout,
                             break_dead=True)
        cur = await self._read_staging()
        if not (cur and cur.get("save_id") == sid
                and cur.get("state") == "staged"):
            # settled (or superseded) under us — judge by the record
            if ((cur or {}).get("save_id") == sid
                    and cur.get("state") == "committed"):
                return sid
            if await self._sid_committed(sid):
                return sid
            raise CkptAborted(
                f"parallel save {sid} aborted (HEAD unchanged)"
            )
        metas = [m for m in await asyncio.gather(*(
            writer.read_rank_meta(r) for r in range(len(hosts))
        )) if m is not None]
        try:
            writer.merge_rank_meta(metas)
            await writer.put_manifest()
            await writer.commit(expect=await writer.read_head())
        except CkptConflict:
            # the zombie incumbent's CAS landed first; same sid means
            # the save IS committed — anything else means it isn't
            if not await self._sid_committed(sid):
                await self._staging_cas(dict(
                    save_id=sid, state="aborted", hosts=hosts,
                    parent=doc.get("parent"),
                ))
                await writer.cleanup_rank_meta(len(hosts))
                raise CkptAborted(
                    f"parallel save {sid} lost the HEAD CAS"
                )
        except BaseException:
            await self._staging_cas(dict(
                save_id=sid, state="aborted", hosts=hosts,
                parent=doc.get("parent"),
            ))
            await writer.cleanup_rank_meta(len(hosts))
            raise
        await self._staging_cas(dict(
            save_id=sid, state="committed", hosts=hosts,
            parent=doc.get("parent"),
        ))
        await writer.cleanup_rank_meta(len(hosts))
        try:
            await self.ckpt.ioctx.remove(
                self.fleet._barrier_obj(0, f"save.{sid}")
            )
        except RadosError:
            pass
        return sid

    # -- mesh-native restore ---------------------------------------------------

    async def mesh(self):
        """(mesh, rank, num_hosts) for the current roster."""
        from ceph_tpu_torch.coord import mesh as coord_mesh

        return await coord_mesh.from_fleet(self.fleet, devices=self.devices)

    async def restore_mesh(self, *, save_id=None):
        """Full-tree mesh restore: manifest chunks map to device slabs
        per the fleet spec with NO host-side full-array reassembly (the
        reader fetches per-slab byte runs and copies each to its slot). A
        roster that shrank since the save resolves the same specs to
        bigger slabs — elastic reshard, no resave."""
        m, _, _ = await self.mesh()
        return await self.ckpt.restore(mesh=m, save_id=save_id)

    async def restore_rank_shards(self, *, save_id=None) -> dict:
        """This rank's slab of every array (replicated arrays fetch
        whole): {path_key: (block, idx)}. The per-host working set of a
        multi-host restore — restore_host_bytes is bounded by this
        rank's shard bytes, which the acceptance tests verify."""
        rank, num_hosts = await self.fleet.rank()
        reader = self.ckpt.reader()
        manifest = await reader.read_manifest(save_id)
        reader._manifest_compress = manifest.get("compress", "")
        out = {}
        for a in manifest["arrays"]:
            shape = tuple(a["shape"])
            spec = a["spec"]
            if (spec and shape and ckpt_layout.fleet_sharded(
                    spec[0], shape[0], num_hosts)):
                idx = (ckpt_layout.fleet_slab(shape[0], num_hosts, rank),
                       ) + tuple(slice(None) for _ in shape[1:])
            else:
                idx = tuple(slice(None) for _ in shape)
            block = await reader.fetch_block(manifest, a, idx)
            key = "/".join(str(e[1]) for e in a["path"])
            out[key] = (block, idx)
        return out

    # -- checkpoint read path --------------------------------------------------

    async def restore(self, *, mesh=None, save_id=None, device=None):
        """Whole-tree restore on every host (reshard-on-load when a
        mesh is given, else tensors on `device`, cuda by default); the
        committed HEAD is the same for all hosts."""
        return await self.ckpt.restore(mesh=mesh, save_id=save_id,
                                       device=device)

    async def restore_shard(self, path_key: str, *, axis: int = 0,
                            save_id=None):
        """This rank's slab of one array: rows split contiguously along
        `axis` across the live roster. Returns (array, index) where
        `index` is the tuple of slices fetched — only those bytes moved."""
        rank, num_hosts = await self.fleet.rank()
        reader = self.ckpt.reader()
        manifest = await reader.read_manifest(save_id)
        for a in manifest["arrays"]:
            if "/".join(str(e[1]) for e in a["path"]) == path_key:
                shape = tuple(a["shape"])
                idx = tuple(
                    host_slice(shape[d], num_hosts, rank)
                    if d == axis else slice(None)
                    for d in range(len(shape))
                )
                reader._manifest_compress = manifest.get("compress", "")
                block = await reader.fetch_block(manifest, a, idx)
                return block, idx
        raise KeyError(path_key)

    async def restore_cursor(self, *, save_id=None) -> dict | None:
        """The data cursor embedded in the committed checkpoint,
        rebased onto the CURRENT live roster — or None when the
        checkpoint carries none."""
        shard = None
        try:
            reader = self.ckpt.reader()
            manifest = await reader.read_manifest(save_id)
            for a in manifest["arrays"]:
                key = "/".join(str(e[1]) for e in a["path"])
                if key == "data_cursor":
                    reader._manifest_compress = manifest.get(
                        "compress", ""
                    )
                    idx = tuple(slice(None) for _ in a["shape"])
                    shard = await reader.fetch_block(manifest, a, idx)
                    break
        except KeyError:
            return None
        if shard is None:
            return None
        cursor = data_layout.cursor_from_array(shard)
        rank, num_hosts = await self.fleet.rank()
        return data_layout.rebase_cursor(
            cursor, num_hosts=num_hosts, host=rank
        )

    # -- data path -------------------------------------------------------------

    async def data_iterator(self, *, seed: int = 0, batch_size: int = 1,
                            num_epochs: int | None = 1):
        """A fresh stride-partitioned iterator for this rank."""
        rank, num_hosts = await self.fleet.rank()
        return await self.data.iterator(
            seed=seed, batch_size=batch_size, num_epochs=num_epochs,
            num_hosts=num_hosts, host=rank, partition="stride",
        )

    async def resume_iterator(self, cursor: dict,
                              num_epochs: int | None = 1):
        """Resume from a (possibly differently-partitioned-fleet)
        cursor: rebased onto the current roster, exactly."""
        rank, num_hosts = await self.fleet.rank()
        cur = data_layout.rebase_cursor(
            cursor, num_hosts=num_hosts, host=rank
        )
        return await self.data.resume(cur, num_epochs=num_epochs)
