"""Journaler + MirroredImage + ImageReplayer; see package docstring.

Journal object layout ("journal.<name>"): json
{"head": last_pos, "commit": committed_pos, "entries": [{pos, event}...]}
mutated only by the `journal` object class — append assigns the next
position atomically at the primary (Journaler::append), commit_and_trim
advances the consumer position and drops covered entries
(Journaler::committed + trim).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.osd.cls import RD, WR
from ceph_tpu_torch.rados.client import ObjectNotFound
from ceph_tpu_torch.rbd.image import Image, ImageNotFound


# -- the journal object class -------------------------------------------------

def _j_load(ctx) -> dict:
    if not ctx.exists():
        return {"head": 0, "commit": 0, "entries": []}
    return json.loads(ctx.read().decode())


def _j_store(ctx, j: dict) -> None:
    ctx.write(json.dumps(j, sort_keys=True).encode())


def _j_append(ctx, inp):
    j = _j_load(ctx)
    j["head"] += 1
    j["entries"].append({"pos": j["head"], "event": inp["event"]})
    _j_store(ctx, j)
    return {"pos": j["head"]}


def _j_read(ctx, inp):
    j = _j_load(ctx)
    frm = inp.get("from", 0)
    limit = int(inp.get("limit", 1000))
    out = [e for e in j["entries"] if e["pos"] > frm][:limit]
    return {"entries": out, "head": j["head"], "commit": j["commit"]}


def _j_commit_and_trim(ctx, inp):
    j = _j_load(ctx)
    pos = int(inp["pos"])
    if pos > j["commit"]:
        j["commit"] = min(pos, j["head"])
    j["entries"] = [e for e in j["entries"] if e["pos"] > j["commit"]]
    _j_store(ctx, j)
    return {"commit": j["commit"]}


def register_journal_classes(osd_service) -> None:
    h = osd_service.cls
    h.register("journal", "append", RD | WR, _j_append)
    h.register("journal", "read", RD, _j_read)
    h.register("journal", "commit_and_trim", RD | WR, _j_commit_and_trim)


# -- client-side journaler ----------------------------------------------------

class Journaler:
    def __init__(self, ioctx, name: str):
        self.ioctx = ioctx
        self.obj = f"journal.{name}"

    async def append(self, event: dict) -> int:
        r = await self.ioctx.exec(
            self.obj, "journal", "append", {"event": event}
        )
        return r["pos"]

    async def read(self, from_pos: int = 0, limit: int = 1000) -> dict:
        try:
            return await self.ioctx.exec(
                self.obj, "journal", "read",
                {"from": from_pos, "limit": limit},
            )
        except ObjectNotFound:
            return {"entries": [], "head": 0, "commit": 0}

    async def commit_and_trim(self, pos: int) -> int:
        r = await self.ioctx.exec(
            self.obj, "journal", "commit_and_trim", {"pos": pos}
        )
        return r["commit"]


# -- journaled image + mirror replayer ----------------------------------------

class MirroredImage:
    """rbd Image with the journaling feature: events append BEFORE the
    write applies (librbd::Journal), so a replayer can always reach at
    least the state any completed write observed."""

    def __init__(self, image: Image, journal: Journaler):
        self.image = image
        self.journal = journal

    @classmethod
    async def create(cls, ioctx, name: str, size: int,
                     order: int = 22) -> "MirroredImage":
        img = await Image.create(ioctx, name, size, order)
        j = Journaler(ioctx, f"img.{name}")
        await j.append({"op": "create", "size": size, "order": order})
        return cls(img, j)

    async def write(self, off: int, data: bytes) -> None:
        await self.journal.append(
            {"op": "write", "off": off, "data": data.hex()}
        )
        await self.image.write(off, data)

    async def resize(self, new_size: int) -> None:
        await self.journal.append({"op": "resize", "size": new_size})
        await self.image.resize(new_size)

    async def read(self, off: int, length: int) -> bytes:
        return await self.image.read(off, length)


class ImageReplayer:
    """rbd-mirror's per-image core: tail the SOURCE journal, replay onto
    the DESTINATION cluster, advance commit, trim."""

    def __init__(self, src_ioctx, dst_ioctx, name: str):
        self.src_journal = Journaler(src_ioctx, f"img.{name}")
        self.dst_ioctx = dst_ioctx
        self.name = name

    async def run_once(self, batch: int = 100) -> int:
        """Replay everything past the commit position; returns the number
        of events applied."""
        applied = 0
        while True:
            page = await self.src_journal.read(limit=batch)
            entries = [
                e for e in page["entries"] if e["pos"] > page["commit"]
            ]
            if not entries:
                return applied
            for entry in entries:
                await self._apply(entry["event"])
                await self.src_journal.commit_and_trim(entry["pos"])
                applied += 1

    async def _apply(self, ev: dict) -> None:
        if ev["op"] == "create":
            try:
                await Image.open(self.dst_ioctx, self.name)
            except ImageNotFound:
                await Image.create(
                    self.dst_ioctx, self.name, ev["size"], ev["order"]
                )
            return
        img = await Image.open(self.dst_ioctx, self.name)
        if ev["op"] == "write":
            await img.write(ev["off"], bytes.fromhex(ev["data"]))
        elif ev["op"] == "resize":
            await img.resize(ev["size"])
        else:
            raise ValueError(f"unknown journal event {ev['op']!r}")
