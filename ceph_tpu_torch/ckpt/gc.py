"""Checkpoint garbage collection: retention policies + manifest-
reachability orphan collection.

Retention runs FIRST: from the name's commit history (maintained
atomically by cls ckpt.cas_head) the policy keeps the newest
`ckpt_gc_keep_last` saves plus every `ckpt_gc_keep_every_nth`-th one
(HEAD is always kept), and anything the caller pins via `keep`.

Collection is then REACHABILITY based, which is what lets incremental
dedup and gc compose safely: a chunk object is live while ANY retained
save's manifest references it — including chunks a dedup'd manifest
references from an older, expired save. Everything else under
`<name>@` (aborted-save debris, expired saves' unshared chunks and
manifests) is removed; each reclaimed save_id is reported to the mon
cluster log and pruned from the commit history (cls
ckpt.prune_history), all idempotently — a half-finished gc just leaves
work for the next pass.

The one documented race: a save that is between put_chunks and commit
when gc runs looks orphaned. gc is an operator/ckpt_tool action, not a
background loop, so the operator serializes it against in-flight saves
(pin them via `keep` otherwise; pinned save_ids are kept by prefix even
without a manifest). The reference's rados-level gc tools share this
contract.

Port of ceph_tpu/ckpt/gc.py (a copy).
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.ckpt import layout
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError


def save_id_of(obj: str, name: str) -> str | None:
    """The save_id of a `<name>@<save_id>[...]` object, else None."""
    prefix = f"{name}@"
    if not obj.startswith(prefix):
        return None
    rest = obj[len(prefix):]
    return rest.split(".", 1)[0]


def select_retained(
    history: list[str], *, keep_last: int = 1, keep_every_nth: int = 0,
) -> list[str]:
    """Retention over the commit history (oldest-first): the newest
    `keep_last` saves, plus — when `keep_every_nth` is set — every Nth
    committed save counting from the first (the keep-hourly/daily
    analogue). HEAD (the last entry) is always retained. Pure, so the
    policy is unit-testable without a cluster."""
    keep = set(history[-max(1, int(keep_last)):])
    if keep_every_nth:
        keep.update(history[::int(keep_every_nth)])
    if history:
        keep.add(history[-1])
    return [sid for sid in history if sid in keep]


async def list_objects(ioctx, prefix: str = "") -> list[str]:
    """Pool enumeration via PGLS on every up OSD (each reports the head
    objects of the PGs it leads; the union covers the pool)."""
    objecter = ioctx.objecter
    osdmap = objecter.osdmap
    names: set[str] = set()

    async def ls(osd: int) -> None:
        try:
            rep = await objecter.osd_admin(
                osd, "pg ls", {"pool": ioctx.pool_id}
            )
        except (RadosError, asyncio.TimeoutError):
            return  # a down/slow OSD's PGs have failed over; peers report
        names.update(rep.get("objects", []))

    await asyncio.gather(*(
        ls(osd) for osd in range(osdmap.max_osd) if osdmap.osd_up[osd]
    ))
    return sorted(n for n in names if n.startswith(prefix))


async def collect(
    ioctx, name: str, *, keep=(), keep_last: int | None = None,
    keep_every_nth: int | None = None, perf=None, clog: bool = True,
) -> dict:
    """Apply retention, then remove every `<name>@*` object that is
    neither owned by a retained/pinned save_id nor referenced by a
    retained manifest. Returns {"head", "retained", "removed", "kept",
    "reclaimed_saves"}."""
    config = ioctx.objecter.config
    if keep_last is None:
        keep_last = config.get("ckpt_gc_keep_last")
    if keep_every_nth is None:
        keep_every_nth = config.get("ckpt_gc_keep_every_nth")

    try:
        head = json.loads(
            (await ioctx.read(layout.head_object(name))).decode()
        )
        head_id = head.get("save_id")
        history = head.get("history") or ([head_id] if head_id else [])
    except ObjectNotFound:
        head_id, history = None, []

    retained = set(select_retained(
        history, keep_last=keep_last, keep_every_nth=keep_every_nth
    ))
    if head_id is not None:
        retained.add(head_id)
    pinned = retained | set(keep)

    # a fleet-parallel save between its staging CAS and the leader's
    # HEAD CAS has live chunks with no manifest: the staging record
    # auto-pins that save_id so a concurrent gc can never reclaim
    # another rank's uncommitted put_chunks output. A stale `staged`
    # record (leader died before flipping it) over-pins harmlessly —
    # the next successful save CASes it away.
    try:
        staging = json.loads(
            (await ioctx.read(layout.staging_object(name))).decode()
        )
        if staging.get("state") == "staged" and staging.get("save_id"):
            pinned.add(staging["save_id"])
    except (ObjectNotFound, ValueError):
        pass

    # reachability: chunks ANY retained/pinned manifest references stay
    # live, even when their owning save_id is being reclaimed (dedup)
    reachable: set[str] = set()
    for sid in sorted(pinned):
        try:
            manifest = layout.decode_manifest(
                await ioctx.read(layout.manifest_object(name, sid))
            )
        except (ObjectNotFound, ValueError):
            continue  # e.g. a pinned in-flight save: kept by prefix
        reachable.update(c["object"] for c in manifest["chunks"])

    removed, kept = [], []
    reclaimed: dict[str, int] = {}
    for obj in await list_objects(ioctx, prefix=f"{name}@"):
        sid = save_id_of(obj, name)
        if sid in pinned or obj in reachable:
            kept.append(obj)
            continue
        try:
            await ioctx.remove(obj)
            removed.append(obj)
            reclaimed[sid] = reclaimed.get(sid, 0) + 1
        except ObjectNotFound:
            pass  # lost a race with another gc; already gone

    mon = getattr(ioctx.objecter, "mon", None)
    if clog and mon is not None:
        for sid in sorted(reclaimed):
            mon.cluster_log(
                "INF",
                f"ckpt {name}: gc reclaimed save {sid} "
                f"({reclaimed[sid]} objects)",
            )
    prune = [sid for sid in reclaimed if sid in history]
    if prune and head_id is not None:
        try:
            await ioctx.exec(
                layout.head_object(name), "ckpt", "prune_history",
                {"remove": prune},
            )
        except RadosError:
            pass  # stale entries re-prune on the next pass

    if perf is not None:
        perf.inc("gc_removed", len(removed))
    return {
        "head": head_id,
        "retained": sorted(pinned),
        "removed": removed,
        "kept": kept,
        "reclaimed_saves": sorted(reclaimed),
    }
