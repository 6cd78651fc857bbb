"""FileSystem: paths over directory objects + striped file data.

See the package docstring for the design; reference parity anchors:
dirfrag-style atomic entry updates (src/mds/CDir.cc's commit of dentry
changes), inotable allocation (src/mds/InoTable.cc), file striping
(src/osdc/Striper.cc via RadosStriper).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.osd.cls import RD, WR, ClsError
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError
from ceph_tpu_torch.rados.striper import RadosStriper, StripeLayout

ROOT_INO = 1


class FsError(RadosError):
    pass


# -- object classes (registered on every OSD) ---------------------------------

def _dir_link(ctx, inp):
    """Dentries are real omap rows (name -> json {ino,type}): dirfrag
    commits touch one row, not a whole-directory blob (CDir dentry
    storage is omap in the reference too)."""
    name = inp["name"].encode()
    if ctx.omap_get_val(name) is not None and not inp.get(
        "replace", False
    ):
        raise ClsError("EEXIST", f"entry {inp['name']!r} exists")
    ctx.omap_set(
        {name: json.dumps(
            {"ino": inp["ino"], "type": inp["type"]}
        ).encode()}
    )
    # post-insert dentry count, computed INSIDE the primary: the MDS's
    # dirfrag split trigger reads it for free instead of listing the
    # whole fragment over the wire per create
    return {"count": len(ctx.omap_get_vals())}


def _dir_unlink(ctx, inp):
    name = inp["name"].encode()
    raw = ctx.omap_get_val(name)
    if raw is None:
        raise ClsError("ENOENT", f"no entry {inp['name']!r}")
    entry = json.loads(raw)
    if inp.get("must_be") and entry["type"] != inp["must_be"]:
        raise ClsError("EINVAL", f"{inp['name']!r} is {entry['type']}")
    ctx.omap_rm([name])
    return {"removed": entry}


def _dir_list(ctx, inp):
    return {
        "entries": {
            k.decode(): json.loads(v)
            for k, v in ctx.omap_get_vals().items()
        }
    }


def _ino_alloc(ctx, inp):
    n = int(ctx.read().decode()) if ctx.exists() else ROOT_INO
    n += 1
    ctx.write(str(n).encode())
    return {"ino": n}


def register_fs_classes(osd_service) -> None:
    h = osd_service.cls
    h.register("fs_dir", "link", RD | WR, _dir_link)
    h.register("fs_dir", "unlink", RD | WR, _dir_unlink)
    h.register("fs_dir", "list", RD, _dir_list)
    h.register("fs_ino", "alloc", RD | WR, _ino_alloc)


# -- the client ---------------------------------------------------------------

def _dir_obj(ino: int) -> str:
    return f"dir.{ino}"


def _file_soid(ino: int) -> str:
    return f"ino.{ino}"


class FileSystem:
    def __init__(self, ioctx, layout: StripeLayout | None = None):
        self.ioctx = ioctx
        self.striper = RadosStriper(ioctx, layout)

    async def mkfs(self) -> None:
        """Create the root directory + inode table (ceph fs new)."""
        await self.ioctx.write_full(_dir_obj(ROOT_INO), b"")
        await self.ioctx.write_full("fs.inotable", str(ROOT_INO).encode())

    async def _alloc_ino(self) -> int:
        r = await self.ioctx.exec("fs.inotable", "fs_ino", "alloc", {})
        return r["ino"]

    @staticmethod
    def _split(path: str) -> list[str]:
        parts = [p for p in path.strip("/").split("/") if p]
        if any(p in (".", "..") for p in parts):
            raise FsError("'.'/'..' not supported")
        return parts

    async def _resolve_dir(self, parts: list[str]) -> int:
        """Walk directory inodes; returns the ino of the last element."""
        ino = ROOT_INO
        for name in parts:
            listing = await self.ioctx.exec(
                _dir_obj(ino), "fs_dir", "list", {}
            )
            entry = listing["entries"].get(name)
            if entry is None:
                raise FsError(f"no such directory {name!r}")
            if entry["type"] != "dir":
                raise FsError(f"{name!r} is not a directory")
            ino = entry["ino"]
        return ino

    async def _parent_and_name(self, path: str) -> tuple[int, str]:
        parts = self._split(path)
        if not parts:
            raise FsError("path refers to the root")
        return await self._resolve_dir(parts[:-1]), parts[-1]

    # -- namespace ops --------------------------------------------------------

    async def mkdir(self, path: str) -> int:
        parent, name = await self._parent_and_name(path)
        ino = await self._alloc_ino()
        await self.ioctx.write_full(_dir_obj(ino), b"{}")
        await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "link",
            {"name": name, "ino": ino, "type": "dir"},
        )
        return ino

    async def listdir(self, path: str = "/") -> dict:
        ino = await self._resolve_dir(self._split(path))
        listing = await self.ioctx.exec(_dir_obj(ino), "fs_dir", "list", {})
        return listing["entries"]

    async def rmdir(self, path: str) -> None:
        parent, name = await self._parent_and_name(path)
        listing = await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "list", {}
        )
        entry = listing["entries"].get(name)
        if entry is None:
            raise FsError(f"no such entry {name!r}")
        if entry["type"] != "dir":
            raise FsError(f"{name!r} is not a directory")
        children = await self.ioctx.exec(
            _dir_obj(entry["ino"]), "fs_dir", "list", {}
        )
        if children["entries"]:
            raise FsError(f"directory {name!r} not empty")
        await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "unlink",
            {"name": name, "must_be": "dir"},
        )
        await self.ioctx.remove(_dir_obj(entry["ino"]))

    async def write_file(self, path: str, data: bytes) -> int:
        """Create-or-replace a regular file; returns its ino."""
        parent, name = await self._parent_and_name(path)
        listing = await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "list", {}
        )
        entry = listing["entries"].get(name)
        if entry is not None:
            if entry["type"] != "file":
                raise FsError(f"{name!r} is a directory")
            ino = entry["ino"]
        else:
            ino = await self._alloc_ino()
            await self.ioctx.exec(
                _dir_obj(parent), "fs_dir", "link",
                {"name": name, "ino": ino, "type": "file"},
            )
        await self.striper.write(_file_soid(ino), data)
        return ino

    async def read_file(self, path: str) -> bytes:
        parent, name = await self._parent_and_name(path)
        listing = await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "list", {}
        )
        entry = listing["entries"].get(name)
        if entry is None or entry["type"] != "file":
            raise FsError(f"no such file {path!r}")
        return await self.striper.read(_file_soid(entry["ino"]))

    async def unlink(self, path: str) -> None:
        parent, name = await self._parent_and_name(path)
        removed = await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "unlink",
            {"name": name, "must_be": "file"},
        )
        # reclaim the striped data (inos are never reused, so an orphaned
        # ino would leak its objects forever)
        ino = removed["removed"]["ino"]
        try:
            await self.striper.remove(_file_soid(ino))
        except ObjectNotFound:
            pass  # created but never written

    async def rename(self, src: str, dst: str) -> None:
        """Move an entry. Like the reference across dirfrags, this is two
        updates (link at dst, unlink at src) — a crash between them leaves
        the entry visible at both names, never lost."""
        sparent, sname = await self._parent_and_name(src)
        dparent, dname = await self._parent_and_name(dst)
        listing = await self.ioctx.exec(
            _dir_obj(sparent), "fs_dir", "list", {}
        )
        entry = listing["entries"].get(sname)
        if entry is None:
            raise FsError(f"no such entry {src!r}")
        await self.ioctx.exec(
            _dir_obj(dparent), "fs_dir", "link",
            {"name": dname, "ino": entry["ino"],
             "type": entry["type"], "replace": True},
        )
        await self.ioctx.exec(
            _dir_obj(sparent), "fs_dir", "unlink", {"name": sname}
        )

    async def stat(self, path: str) -> dict:
        parent, name = await self._parent_and_name(path)
        listing = await self.ioctx.exec(
            _dir_obj(parent), "fs_dir", "list", {}
        )
        entry = listing["entries"].get(name)
        if entry is None:
            raise FsError(f"no such entry {path!r}")
        out = dict(entry)
        if entry["type"] == "file":
            try:
                out["size"] = await self.striper.size(
                    _file_soid(entry["ino"])
                )
            except ObjectNotFound:
                out["size"] = 0
        return out
