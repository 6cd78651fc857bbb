"""Image: create/open/read/write/resize/snapshots/clones on a striped
layout, with an object-map accelerating existence checks.

Layout parity with the reference (src/librbd/ImageCtx + ObjectMap +
CloneRequest/CopyupRequest):

  header   "rbd_header.<name>"   json {size, order, snaps, parent,
           protected, children} — metadata
  data     "rbd_data.<name>.<objectno:016x>" — 2^order bytes each, sparse
  map      "rbd_object_map.<name>[.<snapid:x>]" — one bit per object
           (exists); snapshots freeze a copy, like the reference's
           per-snap object maps

`read` returns zeros for unwritten ranges (holes); for a CLONE, a hole in
the child reads through to the parent's protected snapshot within the
overlap (librbd's parent read-through). `write` to an absent child object
first copies the parent's content up (CopyupRequest) so the child object
carries full data from then on. `flatten` copies every still-inherited
object up and severs the parent link (Operations::flatten); the parent
tracks a child count so `snap_unprotect` refuses while clones exist
(the rbd_children registry role).

Snapshots ride RADOS self-managed snaps (librbd::Operations::snap_create):
the image allocates a pool snap id, records it in the header, and every
data write carries the snap context, so object clones happen server-side
on first-write-after-snap. `snap_rollback` copies each object's at-snap
state back over the head.

The object map is consulted on reads (an absent bit skips the RADOS read
entirely — the fast-diff/existence role, src/librbd/ObjectMap.cc), kept
exact on write/remove/resize/rollback/flatten, and rebuildable from a
full stat sweep (`object_map_rebuild`, the `rbd object-map rebuild`
CLI role).
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.rados.client import IoCtx, ObjectNotFound, RadosError

DEFAULT_ORDER = 22  # 4 MiB objects, the reference default (rbd_default_order)

RBD_LOCK_NAME = "rbd_lock"  # the reference's RBD_LOCK_NAME


class _ClsHeaderLock:
    """Cluster-side image lock on the header object via cls_lock (the
    librbd ManagedLock/ExclusiveLock role, src/librbd/ManagedLock.h:28).

    Replaces round-4's in-process `_header_locks` dict: exclusion now
    lives IN the cluster (an atomic cls op on the header at its primary
    OSD), so two clients in different processes — the deployment that
    exists since the vstart work — serialize clone/flatten/unprotect
    header RMWs and open-for-write ownership correctly.

    Owner identity is "entity/nonce" (this messenger instance), which is
    exactly the OSDMap blocklist's per-instance key: `break_lock`
    blocklists the dead holder BEFORE removing its lock, so its delayed
    writes are refused at every OSD (blacklist_on_break_lock).
    """

    def __init__(self, ioctx: IoCtx, header_name: str):
        self.ioctx = ioctx
        self.header = header_name
        m = ioctx.objecter.messenger
        self.owner = f"{ioctx.objecter.name}/{m.instance_nonce}"
        # cookie = client id: `rbd lock ls` equivalents show WHICH
        # client holds the image, not just which messenger instance
        self.cookie = ioctx.objecter.name

    async def acquire(self, timeout: float = 10.0) -> None:
        """Bounded-retry exclusive acquire (maintenance ops hold the
        lock briefly; open-for-write holders keep it until release)."""
        loop = asyncio.get_event_loop()
        end = loop.time() + timeout
        while True:
            try:
                await self.ioctx.exec(
                    self.header, "lock", "lock",
                    {"name": RBD_LOCK_NAME, "type": "exclusive",
                     "owner": self.owner, "cookie": self.cookie},
                )
                return
            except RadosError as e:
                if "EBUSY" not in str(e) or loop.time() > end:
                    raise
                await asyncio.sleep(0.05)

    async def release(self) -> None:
        try:
            await self.ioctx.exec(
                self.header, "lock", "unlock",
                {"name": RBD_LOCK_NAME, "owner": self.owner,
                 "cookie": self.cookie},
            )
        except RadosError:
            pass  # already broken/expired: release is best-effort

    async def holders(self) -> list:
        info = await self.ioctx.exec(
            self.header, "lock", "get_info", {"name": RBD_LOCK_NAME}
        )
        return info.get("holders", [])

    async def break_lock(
        self, owner: str, blocklist: bool = True,
        blocklist_expire: float = 3600.0,
    ) -> None:
        """Take a dead holder's lock away: blocklist its messenger
        instance in the OSDMap FIRST (its in-flight writes die at every
        OSD), then remove the holder entry."""
        if blocklist:
            await self.ioctx.objecter.mon.command(
                "osd blocklist",
                {"op": "add", "entity": owner,
                 "expire": blocklist_expire},
            )
        await self.ioctx.exec(
            self.header, "lock", "break_lock",
            {"name": RBD_LOCK_NAME, "owner": owner},
        )
        try:
            self.ioctx.objecter.mon.cluster_log(
                "WRN", f"lock broken: {self.header}/{RBD_LOCK_NAME} "
                       f"holder {owner!r} by {self.owner!r}"
            )
        # cephlint: disable=error-taxonomy (break-lock already succeeded; the WRN line is best-effort)
        except Exception:  # noqa: BLE001
            pass


class _HeaderLockCtx:
    """`async with` sugar for a brief maintenance hold."""

    def __init__(self, ioctx: IoCtx, header_name: str):
        self.lock = _ClsHeaderLock(ioctx, header_name)

    async def __aenter__(self):
        await self.lock.acquire()
        return self.lock

    async def __aexit__(self, *exc):
        await self.lock.release()


def _header_lock(ioctx: IoCtx, image_name: str) -> _HeaderLockCtx:
    return _HeaderLockCtx(ioctx, f"rbd_header.{image_name}")


class ImageNotFound(RadosError):
    pass


class Image:
    def __init__(self, ioctx: IoCtx, name: str, size: int, order: int,
                 snaps: dict | None = None, parent: dict | None = None,
                 protected: list | None = None, children: int = 0,
                 migration: dict | None = None):
        # a private IoCtx: the snap context is per-image state and must
        # not leak onto other users of the caller's pool handle
        self.ioctx = IoCtx(ioctx.objecter, ioctx.pool_id)
        self.name = name
        self.size = size
        self.order = order
        #: snap name -> {"id": snapid, "size": image size at snap}
        self.snaps: dict = snaps or {}
        #: {"pool": id, "image": name, "snap": name, "snapid": id,
        #:  "overlap": bytes} for a clone, else None
        self.parent: dict | None = parent
        #: snap names protected against removal (clone prerequisites)
        self.protected: list = list(protected or [])
        #: number of clones whose parent is a snap of this image
        self.children = children
        #: {"pool": id, "image": name} while this image is the TARGET of
        #: a live migration: holes read through to the source's head and
        #: writes copy up, exactly the clone machinery minus the snap
        #: (librbd/api/Migration.cc role)
        self.migration: dict | None = migration
        self._parent_image: "Image | None" = None
        self._migration_src: "Image | None" = None
        #: head object map bits (1 = object exists); loaded lazily
        self._omap_bits: bytearray | None = None
        #: fast-diff clean bits (unchanged since the latest snap)
        self._clean_bits: bytearray | None = None
        self._apply_snapc()

    def _apply_snapc(self) -> None:
        ids = sorted((s["id"] for s in self.snaps.values()), reverse=True)
        if ids:
            self.ioctx.set_selfmanaged_snap_context(ids[0], ids)
        else:
            self.ioctx.snapc = None

    # -- lifecycle ------------------------------------------------------------

    @staticmethod
    def _header_name(name: str) -> str:
        return f"rbd_header.{name}"

    def _data_name(self, objectno: int) -> str:
        return f"rbd_data.{self.name}.{objectno:016x}"

    def _map_name(self, snapid: int | None = None) -> str:
        base = f"rbd_object_map.{self.name}"
        return base if snapid is None else f"{base}.{snapid:x}"

    @classmethod
    async def create(
        cls, ioctx: IoCtx, name: str, size: int,
        order: int = DEFAULT_ORDER,
    ) -> "Image":
        try:
            await ioctx.stat(cls._header_name(name))
            raise RadosError(f"image {name!r} exists")
        except ObjectNotFound:
            pass
        await ioctx.write_full(
            cls._header_name(name),
            json.dumps({"size": size, "order": order}).encode(),
        )
        return cls(ioctx, name, size, order)

    @classmethod
    async def open(
        cls, ioctx: IoCtx, name: str, exclusive: bool = False,
        force: bool = False,
    ) -> "Image":
        """`exclusive=True` = open-for-write under the cluster-side
        exclusive lock (librbd's exclusive-lock feature): held until
        `close()`/`lock_release()`, visible to every other client via
        `lock_holders()`, breakable with `break_lock` when the holder
        died (which blocklists it first). A second writer fails with
        EBUSY immediately; `force=True` is the `rbd lock rm`-style
        operator override — break every current holder (blocklisting
        their instances) and take the lock."""
        try:
            header = json.loads(await ioctx.read(cls._header_name(name)))
        except ObjectNotFound as e:
            raise ImageNotFound(f"no image {name!r}") from e
        img = cls(ioctx, name, header["size"], header["order"],
                  snaps=header.get("snaps"),
                  parent=header.get("parent"),
                  protected=header.get("protected"),
                  children=header.get("children", 0),
                  migration=header.get("migration"))
        if exclusive:
            try:
                await img.lock_acquire(timeout=0.0)
            except RadosError as e:
                if "EBUSY" not in str(e) or not force:
                    raise
                for h in await img.lock_holders():
                    await img.break_lock(h["owner"])
                await img.lock_acquire(timeout=0.0)
        return img

    # -- the exclusive lock (ManagedLock.h:28 surface) -------------------------

    @property
    def _lock(self) -> _ClsHeaderLock:
        return _ClsHeaderLock(self.ioctx, self._header_name(self.name))

    async def lock_acquire(self, timeout: float = 10.0) -> None:
        await self._lock.acquire(timeout=timeout)
        self._lock_held = True

    async def lock_release(self) -> None:
        await self._lock.release()
        self._lock_held = False

    async def lock_holders(self) -> list:
        return await self._lock.holders()

    async def break_lock(self, owner: str, blocklist: bool = True) -> None:
        await self._lock.break_lock(owner, blocklist=blocklist)

    async def close(self) -> None:
        # release only what THIS handle acquired: a read-only handle's
        # close must not strip the exclusive lock a sibling handle of
        # the same client (same owner/cookie at the cls) still relies on
        if getattr(self, "_lock_held", False):
            await self.lock_release()

    async def _save_header(self) -> None:
        # the header itself is never snapshotted: strip the snapc
        saved, self.ioctx.snapc = self.ioctx.snapc, None
        try:
            await self.ioctx.write_full(
                self._header_name(self.name),
                json.dumps({"size": self.size, "order": self.order,
                            "snaps": self.snaps,
                            "parent": self.parent,
                            "protected": self.protected,
                            "children": self.children,
                            "migration": self.migration}).encode(),
            )
        finally:
            self.ioctx.snapc = saved

    async def remove(self) -> None:
        await self._refresh()
        if self.children:
            raise RadosError(
                f"image {self.name!r} has {self.children} clone(s)"
            )
        bits = await self._load_map()
        objsize = 1 << self.order
        for objectno in range((self.size + objsize - 1) // objsize):
            if not self._map_get(bits, objectno):
                continue  # object-map fast path: known-absent
            try:
                await self.ioctx.remove(self._data_name(objectno))
            except ObjectNotFound:
                pass
        for snap in self.snaps.values():
            try:
                await self.ioctx.remove(self._map_name(snap["id"]))
            except ObjectNotFound:
                pass
        for oname in (
            self._map_name(), self._map_name() + ".clean",
            self._header_name(self.name),
        ):
            try:
                await self.ioctx.remove(oname)
            except ObjectNotFound:
                pass
        if self.parent is not None:
            await self._detach_parent()

    # -- object map (src/librbd/ObjectMap.cc role) -----------------------------

    def _map_get(self, bits: bytearray, objectno: int) -> bool:
        byte = objectno >> 3
        return byte < len(bits) and bool(
            bits[byte] & (1 << (objectno & 7))
        )

    async def _load_map(self) -> bytearray:
        if self._omap_bits is None:
            saved, self.ioctx.snapc = self.ioctx.snapc, None
            try:
                self._omap_bits = bytearray(
                    await self.ioctx.read(self._map_name())
                )
            except ObjectNotFound:
                # no map yet (older image or fresh create): rebuild from
                # a stat sweep so existing images upgrade transparently
                self._omap_bits = await self._stat_sweep()
                await self._persist_map()
            finally:
                self.ioctx.snapc = saved
        return self._omap_bits

    async def _stat_sweep(self) -> bytearray:
        objsize = 1 << self.order
        n = (self.size + objsize - 1) // objsize
        bits = bytearray((n + 7) // 8)
        for objectno in range(n):
            try:
                await self.ioctx.stat(self._data_name(objectno))
            except ObjectNotFound:
                continue
            bits[objectno >> 3] |= 1 << (objectno & 7)
        return bits

    async def _persist_map(self) -> None:
        saved, self.ioctx.snapc = self.ioctx.snapc, None
        try:
            await self.ioctx.write_full(
                self._map_name(), bytes(self._omap_bits)
            )
        finally:
            self.ioctx.snapc = saved

    @staticmethod
    def _set_bit(bits: bytearray, objectno: int, exists: bool) -> None:
        byte = objectno >> 3
        if byte >= len(bits):
            bits.extend(b"\x00" * (byte + 1 - len(bits)))
        if exists:
            bits[byte] |= 1 << (objectno & 7)
        else:
            bits[byte] &= ~(1 << (objectno & 7)) & 0xFF

    async def _map_set(self, objectno: int, exists: bool) -> None:
        bits = await self._load_map()
        self._set_bit(bits, objectno, exists)
        await self._persist_map()

    async def object_map_rebuild(self) -> None:
        """`rbd object-map rebuild`: recompute from a full stat sweep."""
        self._omap_bits = await self._stat_sweep()
        await self._persist_map()

    async def _load_clean(self) -> bytearray:
        """Bits for objects UNCHANGED since the latest snap_create (the
        fast-diff EXISTS_CLEAN state); absent map = nothing known clean,
        which only ever makes diff pessimistic, never wrong."""
        if self._clean_bits is None:
            saved, self.ioctx.snapc = self.ioctx.snapc, None
            try:
                self._clean_bits = bytearray(
                    await self.ioctx.read(self._map_name() + ".clean")
                )
            except ObjectNotFound:
                self._clean_bits = bytearray()
            finally:
                self.ioctx.snapc = saved
        return self._clean_bits

    async def _persist_clean(self) -> None:
        saved, self.ioctx.snapc = self.ioctx.snapc, None
        try:
            await self.ioctx.write_full(
                self._map_name() + ".clean", bytes(self._clean_bits)
            )
        finally:
            self.ioctx.snapc = saved

    async def diff(self, from_snap: str) -> list[int]:
        """Object numbers that changed between `from_snap` and the head
        (rbd diff --whole-object, the fast-diff contract): computed from
        the frozen per-snap exists-bitmap, the head's, and the
        clean-bitmap the head maintains since its latest snap — no data
        object is read. Against an older snap the clean bits only say
        "changed since the LATEST snap", so anything not provably clean
        is reported — pessimistic, never missing a change."""
        meta = self.snaps.get(from_snap)
        if meta is None:
            raise RadosError(f"no snap {from_snap!r}")
        saved, self.ioctx.snapc = self.ioctx.snapc, None
        try:
            try:
                snap_bits = bytearray(
                    await self.ioctx.read(self._map_name(meta["id"]))
                )
            except ObjectNotFound:
                snap_bits = bytearray()
        finally:
            self.ioctx.snapc = saved
        head_bits = await self._load_map()
        clean = await self._load_clean()
        latest = max(
            self.snaps.values(), key=lambda m: m["id"]
        )["id"] == meta["id"]
        objsize = 1 << self.order
        n = (self.size + objsize - 1) // objsize
        changed = []
        for objectno in range(n):
            was = self._map_get(snap_bits, objectno)
            now = self._map_get(head_bits, objectno)
            if was != now:
                changed.append(objectno)
            elif now and not (
                latest and self._map_get(clean, objectno)
            ):
                changed.append(objectno)
        return changed

    async def object_map_check(self) -> list[int]:
        """Objects whose map bit disagrees with reality (diagnostic;
        the `rbd object-map check` role). Empty list = consistent."""
        bits = await self._load_map()
        actual = await self._stat_sweep()
        objsize = 1 << self.order
        n = (self.size + objsize - 1) // objsize
        return [
            i for i in range(n)
            if self._map_get(bits, i) != self._map_get(actual, i)
        ]

    # -- clones (librbd CloneRequest / CopyupRequest / flatten) ---------------

    async def _refresh(self) -> None:
        """Reload header state another handle may have changed (clone
        counts, protection) — the ImageCtx refresh librbd runs before
        maintenance operations."""
        fresh = await Image.open(self.ioctx, self.name)
        self.size = fresh.size
        self.snaps = fresh.snaps
        self.parent = fresh.parent
        self.protected = fresh.protected
        self.children = fresh.children
        self._apply_snapc()

    async def snap_protect(self, snap_name: str) -> None:
        await self._refresh()
        if snap_name not in self.snaps:
            raise RadosError(f"no snap {snap_name!r}")
        if snap_name not in self.protected:
            self.protected.append(snap_name)
            await self._save_header()

    async def snap_unprotect(self, snap_name: str) -> None:
        async with _header_lock(self.ioctx, self.name):
            await self._refresh()
            if self.children:
                raise RadosError(
                    f"snap {snap_name!r} has {self.children} clone(s)"
                )
            if snap_name in self.protected:
                self.protected.remove(snap_name)
                await self._save_header()

    @classmethod
    async def clone(
        cls, parent_ioctx: IoCtx, parent_name: str, snap_name: str,
        child_ioctx: IoCtx, child_name: str,
    ) -> "Image":
        """Snapshot-backed copy-on-write child (librbd::CloneRequest):
        the child starts with NO data objects; reads fall through to the
        parent's protected snap within the overlap, writes copy-up."""
        async with _header_lock(parent_ioctx, parent_name):
            parent = await cls.open(parent_ioctx, parent_name)
            meta = parent.snaps.get(snap_name)
            if meta is None:
                raise RadosError(f"no snap {snap_name!r}")
            if snap_name not in parent.protected:
                raise RadosError(f"snap {snap_name!r} is not protected")
            try:
                await child_ioctx.stat(cls._header_name(child_name))
                raise RadosError(f"image {child_name!r} exists")
            except ObjectNotFound:
                pass
            parent.children += 1
            await parent._save_header()
        child = cls(
            child_ioctx, child_name, meta["size"], parent.order,
            parent={"pool": parent_ioctx.pool_id,
                    "image": parent_name, "snap": snap_name,
                    "snapid": meta["id"], "overlap": meta["size"]},
        )
        await child._save_header()
        return child

    async def _open_parent(self) -> "Image":
        if self._parent_image is None:
            pioctx = IoCtx(self.ioctx.objecter, self.parent["pool"])
            self._parent_image = await Image.open(
                pioctx, self.parent["image"]
            )
        return self._parent_image

    async def _migration_object(self, objectno: int) -> bytes | None:
        """Read-through to a migration SOURCE's head (Migration.cc's
        deep-copy read path): same shape as the clone fall-through but
        at the live head, clipped to the source size."""
        if self.migration is None:
            return None
        if self._migration_src is None:
            sioctx = IoCtx(self.ioctx.objecter, self.migration["pool"])
            self._migration_src = await Image.open(
                sioctx, self.migration["image"]
            )
        src = self._migration_src
        objsize = 1 << self.order
        poff = objectno * objsize
        if poff >= src.size:
            return None
        length = min(objsize, src.size - poff)
        return await src.read(poff, length)

    async def _parent_object(self, objectno: int) -> bytes | None:
        """The child object's content as inherited from the parent snap
        (clipped to the overlap), or None when outside it — or from a
        migration source's head while a migration is in flight."""
        if self.parent is None:
            return await self._migration_object(objectno)
        objsize = 1 << self.order
        poff = objectno * objsize
        overlap = self.parent["overlap"]
        if poff >= overlap:
            return None
        length = min(objsize, overlap - poff)
        parent = await self._open_parent()
        return await parent.read(poff, length, self.parent["snap"])

    async def _copy_up(self, objectno: int) -> bytes:
        """CopyupRequest: materialize an absent child object from the
        parent before the first write touches it."""
        inherited = await self._parent_object(objectno)
        return inherited if inherited is not None else b""

    async def _detach_parent(self) -> None:
        pioctx = IoCtx(self.ioctx.objecter, self.parent["pool"])
        async with _header_lock(pioctx, self.parent["image"]):
            parent = await self._open_parent()
            await parent._refresh()
            parent.children = max(0, parent.children - 1)
            await parent._save_header()
        self.parent = None
        self._parent_image = None

    async def flatten(self) -> None:
        """Copy every still-inherited object up, then sever the parent
        link (librbd::Operations::flatten)."""
        if self.parent is None:
            return
        objsize = 1 << self.order
        overlap = min(self.parent["overlap"], self.size)
        bits = await self._load_map()
        for objectno in range((overlap + objsize - 1) // objsize):
            if self._map_get(bits, objectno):
                continue  # child already owns it
            data = await self._copy_up(objectno)
            await self.ioctx.write_full(
                self._data_name(objectno), data
            )
            self._set_bit(bits, objectno, True)
        await self._persist_map()
        await self._detach_parent()
        await self._save_header()

    # -- live migration (librbd/api/Migration.cc, mini) -----------------------

    @classmethod
    async def migration_prepare(
        cls, src_ioctx: IoCtx, src_name: str,
        dst_ioctx: IoCtx, dst_name: str,
    ) -> "Image":
        """Stage 1 (`rbd migration prepare`): create the TARGET image
        linked to the source; clients switch to the target immediately —
        holes read through to the source, writes copy up. The source is
        fenced for the whole migration by a cluster-side lock owned by
        the migration itself (the reference hides the source image)."""
        src = await cls.open(src_ioctx, src_name)
        if src.snaps:
            raise RadosError(
                "cannot migrate an image with snapshots (flatten its "
                "history first)"
            )
        if src.parent is not None:
            raise RadosError("flatten the clone before migrating")
        try:
            await dst_ioctx.stat(cls._header_name(dst_name))
            raise RadosError(f"image {dst_name!r} exists")
        except ObjectNotFound:
            pass
        fence = _ClsHeaderLock(src_ioctx, cls._header_name(src_name))
        fence.owner = f"migration/{dst_ioctx.pool_id}/{dst_name}"
        await fence.acquire()
        dst = cls(
            dst_ioctx, dst_name, src.size, src.order,
            migration={"pool": src_ioctx.pool_id, "image": src_name},
        )
        await dst._save_header()
        return dst

    def _migration_fence(self) -> _ClsHeaderLock:
        sioctx = IoCtx(self.ioctx.objecter, self.migration["pool"])
        fence = _ClsHeaderLock(
            sioctx, self._header_name(self.migration["image"])
        )
        fence.owner = (
            f"migration/{self.ioctx.pool_id}/{self.name}"
        )
        return fence

    async def migration_execute(self) -> int:
        """Stage 2: deep-copy every still-inherited object into the
        target (the image stays fully usable throughout). Returns the
        number of objects copied."""
        if self.migration is None:
            return 0
        objsize = 1 << self.order
        bits = await self._load_map()
        copied = 0
        for objectno in range((self.size + objsize - 1) // objsize):
            if self._map_get(bits, objectno):
                continue  # target already owns it
            data = await self._migration_object(objectno)
            if data is None:
                continue  # source hole stays a hole
            await self.ioctx.write_full(
                self._data_name(objectno), data
            )
            self._set_bit(bits, objectno, True)
            copied += 1
        await self._persist_map()
        return copied

    async def migration_commit(self) -> None:
        """Stage 3: finish any remaining copy, remove the SOURCE, and
        sever the link — the target is standalone from here."""
        if self.migration is None:
            return
        await self.migration_execute()
        fence = self._migration_fence()
        sioctx = IoCtx(self.ioctx.objecter, self.migration["pool"])
        src = await Image.open(sioctx, self.migration["image"])
        await fence.release()
        await src.remove()
        self.migration = None
        self._migration_src = None
        await self._save_header()

    async def migration_abort(self) -> None:
        """Back out: drop the target, unfence the source (clients
        switch back)."""
        if self.migration is None:
            return
        fence = self._migration_fence()
        self.migration = None
        await self.remove()
        await fence.release()

    # -- extent algebra (Striper::file_to_extents for the simple layout) ------

    def _extents(self, off: int, length: int):
        """Yield (objectno, obj_off, obj_len, buf_off) covering the span."""
        objsize = 1 << self.order
        buf_off = 0
        while length > 0:
            objectno = off >> self.order
            obj_off = off & (objsize - 1)
            obj_len = min(objsize - obj_off, length)
            yield objectno, obj_off, obj_len, buf_off
            off += obj_len
            buf_off += obj_len
            length -= obj_len

    # -- IO -------------------------------------------------------------------

    def _check_span(self, off: int, length: int) -> None:
        if off < 0 or length < 0 or off + length > self.size:
            raise RadosError(
                f"span [{off}, {off + length}) outside image of size "
                f"{self.size}"
            )

    async def read(
        self, off: int, length: int, snap_name: str | None = None
    ) -> bytes:
        snapid = None
        size = self.size
        if snap_name is not None:
            meta = self.snaps.get(snap_name)
            if meta is None:
                raise RadosError(f"no snap {snap_name!r}")
            snapid = meta["id"]
            size = meta["size"]
        if off < 0 or length < 0 or off + length > size:
            raise RadosError(
                f"span [{off}, {off + length}) outside image of size "
                f"{size}"
            )
        out = bytearray(length)
        objsize = 1 << self.order
        head_bits = (
            await self._load_map() if snapid is None else None
        )
        for objectno, obj_off, obj_len, buf_off in self._extents(
            off, length
        ):
            data = None
            if head_bits is not None and not self._map_get(
                head_bits, objectno
            ):
                # object-map fast path: no child object — inherit from
                # the parent snap (clone) or stay a hole
                data = await self._parent_object(objectno)
            else:
                try:
                    data = await self.ioctx.read(
                        self._data_name(objectno), snapid=snapid
                    )
                except ObjectNotFound:
                    data = await self._parent_object(objectno)
            if data is None:
                continue  # hole: stays zero
            if len(data) < objsize:
                data = data + b"\0" * (objsize - len(data))
            out[buf_off: buf_off + obj_len] = data[
                obj_off: obj_off + obj_len
            ]
        return bytes(out)

    # -- snapshots (librbd::Operations::snap_* family) ------------------------

    async def snap_create(self, snap_name: str) -> int:
        if snap_name in self.snaps:
            raise RadosError(f"snap {snap_name!r} exists")
        snapid = await self.ioctx.selfmanaged_snap_create()
        self.snaps[snap_name] = {"id": snapid, "size": self.size}
        self._apply_snapc()
        # freeze the object map alongside the data (per-snap maps);
        # everything existing right now is CLEAN relative to this snap
        bits = await self._load_map()
        self._clean_bits = bytearray(bits)
        await self._persist_clean()
        saved, self.ioctx.snapc = self.ioctx.snapc, None
        try:
            await self.ioctx.write_full(
                self._map_name(snapid), bytes(bits)
            )
        finally:
            self.ioctx.snapc = saved
        await self._save_header()
        return snapid

    async def snap_remove(self, snap_name: str) -> None:
        await self._refresh()
        if snap_name in self.protected:
            raise RadosError(f"snap {snap_name!r} is protected")
        meta = self.snaps.pop(snap_name, None)
        if meta is None:
            raise RadosError(f"no snap {snap_name!r}")
        self._apply_snapc()
        # clean bits were computed relative to the latest snap — if that
        # reference point goes away they would falsely exonerate changed
        # objects in diff(); void them (pessimistic, never wrong)
        self._clean_bits = bytearray()
        await self._persist_clean()
        await self._save_header()
        try:
            await self.ioctx.remove(self._map_name(meta["id"]))
        except ObjectNotFound:
            pass
        # pool-level removal queues the OSD-side clone trim
        await self.ioctx.selfmanaged_snap_remove(meta["id"])

    async def snap_rollback(self, snap_name: str) -> None:
        """Copy every object's at-snap state back over the head
        (Operations.cc snap_rollback); the rollback writes carry the
        current snap context so they are themselves snapshottable."""
        meta = self.snaps.get(snap_name)
        if meta is None:
            raise RadosError(f"no snap {snap_name!r}")
        snapid, snap_size = meta["id"], meta["size"]
        objsize = 1 << self.order
        cur_objects = (self.size + objsize - 1) // objsize
        snap_objects = (snap_size + objsize - 1) // objsize
        bits = await self._load_map()
        for objectno in range(max(cur_objects, snap_objects)):
            try:
                data = await self.ioctx.read(
                    self._data_name(objectno), snapid=snapid
                )
                await self.ioctx.write_full(
                    self._data_name(objectno), data
                )
                self._set_bit(bits, objectno, True)
            except ObjectNotFound:
                # hole (or did not exist) at snap time: drop the head
                try:
                    await self.ioctx.remove(self._data_name(objectno))
                except ObjectNotFound:
                    pass
                self._set_bit(bits, objectno, False)
        await self._persist_map()  # one batched map write for the sweep
        self._clean_bits = bytearray()  # rollback voids fast-diff state
        await self._persist_clean()
        self.size = snap_size
        await self._save_header()

    def snap_list(self) -> dict:
        return dict(self.snaps)

    async def write(self, off: int, data: bytes) -> None:
        self._check_span(off, len(data))
        objsize = 1 << self.order
        bits = await self._load_map()
        dirty = clean_dirty = False
        for objectno, obj_off, obj_len, buf_off in self._extents(
            off, len(data)
        ):
            piece = data[buf_off: buf_off + obj_len]
            exists = self._map_get(bits, objectno)
            if (
                obj_off == 0 and obj_len == objsize
                and (self.parent is None or exists)
            ):
                await self.ioctx.write_full(
                    self._data_name(objectno), piece
                )
            else:
                # partial object (or first clone write): read-modify-
                # write, seeding from the parent via copy-up when the
                # child object doesn't exist yet
                if exists:
                    try:
                        cur = await self.ioctx.read(
                            self._data_name(objectno)
                        )
                    except ObjectNotFound:
                        cur = await self._copy_up(objectno)
                else:
                    cur = await self._copy_up(objectno)
                buf = bytearray(max(len(cur), obj_off + obj_len))
                buf[: len(cur)] = cur
                buf[obj_off: obj_off + obj_len] = piece
                await self.ioctx.write_full(
                    self._data_name(objectno), bytes(buf)
                )
            if not exists:
                self._set_bit(bits, objectno, True)
                dirty = True
            clean = await self._load_clean()
            if self._map_get(clean, objectno):
                self._set_bit(clean, objectno, False)
                clean_dirty = True
        if dirty:
            await self._persist_map()  # one map write per span
        if clean_dirty:
            await self._persist_clean()

    async def resize(self, new_size: int) -> None:
        objsize = 1 << self.order
        old_objects = (self.size + objsize - 1) // objsize
        new_objects = (new_size + objsize - 1) // objsize
        bits = await self._load_map()
        trimmed = False
        for objectno in range(new_objects, old_objects):
            if self._map_get(bits, objectno):
                try:
                    await self.ioctx.remove(self._data_name(objectno))
                except ObjectNotFound:
                    pass
                self._set_bit(bits, objectno, False)
                trimmed = True
        if trimmed:
            await self._persist_map()
        if new_size < self.size and new_size & (objsize - 1):
            # shrink: truncate the partial boundary object too, or a later
            # grow would re-expose stale bytes where zeros are expected
            # (the reference truncates the boundary object on shrink)
            boundary = new_size >> self.order
            keep = new_size & (objsize - 1)
            try:
                cur = await self.ioctx.read(self._data_name(boundary))
                if len(cur) > keep:
                    await self.ioctx.write_full(
                        self._data_name(boundary), cur[:keep]
                    )
            except ObjectNotFound:
                pass
        if new_size < self.size and self.parent is not None:
            # shrinking below the parent overlap reduces what a clone
            # can ever inherit (librbd shrinks the overlap too)
            self.parent["overlap"] = min(
                self.parent["overlap"], new_size
            )
        self.size = new_size
        await self._save_header()
