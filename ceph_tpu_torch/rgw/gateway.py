"""ObjectGateway: buckets + keyed objects with a cls-maintained index.

Layout (mirroring RGW's bucket-index design, src/cls/rgw/cls_rgw.cc):

  ".bucket.index.<bucket>"   index object; entries are REAL omap rows
                             key -> json {size, etag} mutated ONLY by
                             rgw_index cls methods (cls_cxx_map_*), so
                             concurrent gateways update atomically and a
                             million-entry bucket never rewrites a blob
  "<bucket>/<key>"           the object data

List is served by the index class with (prefix, marker, max) pagination —
`list_objects` never enumerates the pool, exactly why RGW keeps an index.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.osd.cls import RD, WR, ClsError
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError


# -- the rgw_index object class (runs inside the primary OSD) -----------------

def _index_insert(ctx, inp):
    ctx.omap_set(
        {inp["key"].encode(): json.dumps(inp["meta"]).encode()}
    )
    return {}


def _index_remove(ctx, inp):
    if ctx.omap_get_val(inp["key"].encode()) is None:
        raise ClsError("ENOENT", f"no index entry {inp['key']!r}")
    ctx.omap_rm([inp["key"].encode()])
    return {}


def _index_list(ctx, inp):
    """(prefix, marker, max_entries) pagination (cls_rgw list_op) over
    the omap rows — ranged key iteration, not a blob scan."""
    prefix = inp.get("prefix", "").encode()
    marker = inp.get("marker", "").encode()
    max_entries = int(inp.get("max_entries", 1000))
    page = ctx.omap_get_vals(
        after=marker if marker else None,
        max_return=max_entries,
        prefix=prefix,
    )
    more = ctx.omap_get_vals(
        after=max(page) if page else (marker or None),
        max_return=1,
        prefix=prefix,
    )
    return {
        "entries": {
            k.decode(): json.loads(v) for k, v in page.items()
        },
        "truncated": bool(more),
        "next_marker": max(page).decode() if page else inp.get("marker", ""),
    }


def _index_stat(ctx, inp):
    return {"count": len(ctx.omap_get_vals())}


def _index_stack_push(ctx, inp):
    """Atomically push a version (or delete marker) onto a key's
    version stack and make it current — the cls-side mutation that
    keeps concurrent gateways from losing versions to read-modify-write
    races (cls_rgw's bucket-index transaction role). `version_id`
    "null" REPLACES an existing null entry (the S3 suspended-bucket
    rule) and reports the displaced object for reclamation."""
    key = inp["key"].encode()
    raw = ctx.omap_get_val(key)
    meta = json.loads(raw) if raw is not None else None
    ver = dict(inp["version"])
    versions = list(meta.get("versions", [])) if meta else []
    if meta is not None and not versions and not inp.get(
        "require_absent", False
    ):
        # adopt a pre-versioning head as version 'null'
        versions = [{
            "version_id": "null",
            "obj": inp["head_obj"],
            "size": meta.get("size", 0),
            "etag": meta.get("etag", ""),
            "delete_marker": False,
        }]
    displaced = None
    if ver["version_id"] == "null":
        for old in versions:
            if old["version_id"] == "null":
                displaced = old.get("obj")
        versions = [
            v for v in versions if v["version_id"] != "null"
        ]
    versions.append(ver)
    ctx.omap_set({key: json.dumps({
        "size": ver["size"], "etag": ver["etag"],
        "version_id": ver["version_id"],
        "delete_marker": ver["delete_marker"],
        "versions": versions,
    }).encode()})
    return {"displaced": displaced}


def _index_stack_pop(ctx, inp):
    """Atomically remove ONE version from a key's stack; the newest
    remaining version becomes current, and popping the last one drops
    the key. Returns the removed entry so the gateway can reclaim its
    data object."""
    key = inp["key"].encode()
    raw = ctx.omap_get_val(key)
    if raw is None:
        raise ClsError("ENOENT", f"no index entry {inp['key']!r}")
    meta = json.loads(raw)
    versions = list(meta.get("versions", []))
    if not versions and inp["version_id"] == "null":
        # never-versioned key addressed by its advertised null id
        ctx.omap_rm([key])
        return {"removed": {
            "version_id": "null", "obj": inp.get("head_obj"),
            "delete_marker": False,
        }}
    doomed = next(
        (v for v in versions
         if v["version_id"] == inp["version_id"]),
        None,
    )
    if doomed is None:
        raise ClsError(
            "ENOENT", f"no version {inp['version_id']!r}"
        )
    versions = [
        v for v in versions
        if v["version_id"] != inp["version_id"]
    ]
    if not versions:
        ctx.omap_rm([key])
        return {"removed": doomed}
    cur = versions[-1]
    ctx.omap_set({key: json.dumps({
        "size": cur["size"], "etag": cur["etag"],
        "version_id": cur["version_id"],
        "delete_marker": cur["delete_marker"],
        "versions": versions,
    }).encode()})
    return {"removed": doomed}


def register_rgw_classes(osd_service) -> None:
    """Install the rgw_index class on a daemon (its __cls_init analogue)."""
    h = osd_service.cls
    h.register("rgw_index", "insert", RD | WR, _index_insert)
    h.register("rgw_index", "remove", RD | WR, _index_remove)
    h.register("rgw_index", "list", RD, _index_list)
    h.register("rgw_index", "stat", RD, _index_stat)
    h.register("rgw_index", "stack_push", RD | WR, _index_stack_push)
    h.register("rgw_index", "stack_pop", RD | WR, _index_stack_pop)


# -- the gateway --------------------------------------------------------------

class GatewayError(RadosError):
    pass


class ObjectGateway:
    """`index_ioctx` defaults to the data pool but must point at a
    replicated pool when data lives on EC (bucket indexes are omap, and
    EC pools hold no omap — the reference's index_pool vs data_pool
    placement split for exactly this reason)."""

    def __init__(self, ioctx, index_ioctx=None):
        self.ioctx = ioctx
        self.index_ioctx = index_ioctx if index_ioctx is not None else ioctx

    @staticmethod
    def _index_obj(bucket: str) -> str:
        return f".bucket.index.{bucket}"

    @staticmethod
    def _data_obj(bucket: str, key: str) -> str:
        return f"{bucket}/{key}"

    _BUCKETS_OBJ = ".buckets.list"

    async def create_bucket(self, bucket: str) -> None:
        try:
            await self.index_ioctx.stat(self._index_obj(bucket))
            raise GatewayError(f"bucket {bucket!r} exists")
        except ObjectNotFound:
            pass
        await self.index_ioctx.write_full(self._index_obj(bucket), b"")
        # bucket registry (the rgw metadata-pool bucket list): what
        # list_buckets() and the lifecycle pass enumerate
        await self.index_ioctx.omap_set(
            self._BUCKETS_OBJ, {bucket.encode(): b"1"}
        )

    async def list_buckets(self) -> list[str]:
        try:
            rows = await self.index_ioctx.omap_get(self._BUCKETS_OBJ)
        except ObjectNotFound:
            return []
        return sorted(k.decode() for k in rows)

    async def bucket_exists(self, bucket: str) -> bool:
        try:
            await self.index_ioctx.stat(self._index_obj(bucket))
            return True
        except ObjectNotFound:
            return False

    # -- versioning (RGWBucketInfo flags + rgw_obj_key instances:
    # -- version objects are separate RADOS objects, the index entry's
    # -- meta carries the version stack with the newest as current) -----

    _VERSIONING_XATTR = "rgw.versioning"

    def _ver_obj(self, bucket: str, key: str, vid: str) -> str:
        return f"{bucket}/{key}.__v_{vid}"

    async def set_versioning(self, bucket: str, enabled: bool) -> None:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        await self.index_ioctx.setxattr(
            self._index_obj(bucket), self._VERSIONING_XATTR,
            b"Enabled" if enabled else b"Suspended",
        )

    async def get_versioning(self, bucket: str) -> bool:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        try:
            raw = await self.index_ioctx.getxattr(
                self._index_obj(bucket), self._VERSIONING_XATTR
            )
        except (ObjectNotFound, RadosError):
            return False
        return raw == b"Enabled"

    # -- canned ACLs (rgw_acl_s3.cc floor: private | public-read) -------

    _ACL_XATTR = "rgw.acl"

    async def set_bucket_acl(self, bucket: str, acl: str) -> None:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        await self.index_ioctx.setxattr(
            self._index_obj(bucket), self._ACL_XATTR, acl.encode()
        )

    async def get_bucket_acl(self, bucket: str) -> str:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        try:
            raw = await self.index_ioctx.getxattr(
                self._index_obj(bucket), self._ACL_XATTR
            )
        except (ObjectNotFound, RadosError):
            return "private"
        return raw.decode() or "private"

    # -- lifecycle (RGWLC, src/rgw/rgw_lc.cc at mini scale) -------------
    #
    # Rules are stored on the bucket like versioning/ACL state; a
    # lifecycle PASS walks registered buckets and applies Expiration
    # rules against each current object's mtime (prefix-filtered).
    # Deletes go through the normal versioning-aware path, so a
    # versioned bucket expires into delete markers, exactly S3's
    # behavior. Reclamation is synchronous everywhere in this gateway
    # (multipart parts via manifests, displaced versions at push), so
    # the separate deferred-GC queue (rgw_gc) has no role to play here.

    _LC_XATTR = "rgw.lifecycle"

    async def set_lifecycle(self, bucket: str, rules: list) -> None:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        for r in rules:
            if "days" not in r:
                raise GatewayError("lifecycle rule needs Days")
        await self.index_ioctx.setxattr(
            self._index_obj(bucket), self._LC_XATTR,
            json.dumps(rules, sort_keys=True).encode(),
        )

    async def get_lifecycle(self, bucket: str) -> list:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        try:
            raw = await self.index_ioctx.getxattr(
                self._index_obj(bucket), self._LC_XATTR
            )
        except (ObjectNotFound, RadosError):
            return []
        return json.loads(raw)

    async def delete_lifecycle(self, bucket: str) -> None:
        try:
            await self.index_ioctx.rmxattr(
                self._index_obj(bucket), self._LC_XATTR
            )
        except (ObjectNotFound, RadosError):
            pass

    async def lifecycle_pass(self, now: float | None = None) -> dict:
        """One LC work cycle over every bucket (RGWLC::process):
        returns {bucket: [expired keys]}."""
        now = time.time() if now is None else now
        expired: dict[str, list] = {}
        for bucket in await self.list_buckets():
            rules = [
                r for r in await self.get_lifecycle(bucket)
                if r.get("status", "Enabled") == "Enabled"
            ]
            if not rules:
                continue
            marker = ""
            while True:
                page = await self.list_objects(
                    bucket, marker=marker, max_entries=256
                )
                for key, meta in sorted(page["entries"].items()):
                    if meta.get("delete_marker"):
                        continue
                    mtime = meta.get("mtime")
                    if mtime is None and meta.get("versions"):
                        mtime = meta["versions"][-1].get("mtime")
                    if mtime is None:
                        continue
                    for r in rules:
                        if not key.startswith(r.get("prefix", "")):
                            continue
                        if now - mtime >= r["days"] * 86400.0:
                            await self.delete_object(bucket, key)
                            expired.setdefault(bucket, []).append(key)
                            break
                if not page.get("truncated"):
                    break
                marker = page["next_marker"]
        return expired

    async def set_object_acl(
        self, bucket: str, key: str, acl: str
    ) -> None:
        meta = await self.head_object(bucket, key)
        meta["acl"] = acl
        await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "insert",
            {"key": key, "meta": meta},
        )

    async def get_object_acl(self, bucket: str, key: str) -> str:
        meta = await self.head_object(bucket, key)
        acl = meta.get("acl")
        if acl is None and meta.get("versions"):
            acl = meta["versions"][-1].get("acl")
        return acl or "private"

    async def _has_stack(self, bucket: str, key: str) -> bool:
        try:
            meta = await self.head_object(bucket, key)
        except ObjectNotFound:
            return False
        return bool(meta.get("versions"))

    async def put_object(self, bucket: str, key: str, data: bytes) -> str:
        etag, _vid = await self.put_object2(bucket, key, data)
        return etag

    async def put_object2(
        self, bucket: str, key: str, data: bytes,
        acl: str | None = None,
    ) -> tuple[str, str | None]:
        """Store data, then index it atomically server-side; returns
        (etag, version_id). Versioning-enabled buckets stack a NEW
        version; a SUSPENDED bucket with an existing stack writes the
        'null' version, preserving every real version (the S3
        suspension rule). The stack mutation is one cls call at the
        index primary, so concurrent gateways never lose versions."""
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        etag = f"{ceph_crc32c(0xFFFFFFFF, data):08x}"
        enabled = await self.get_versioning(bucket)
        if enabled or await self._has_stack(bucket, key):
            if await self._multipart_meta(bucket, key):
                raise GatewayError(
                    "versioned overwrite of a multipart object is "
                    "not supported"
                )
            import uuid

            vid = uuid.uuid4().hex[:16] if enabled else "null"
            obj = self._ver_obj(bucket, key, vid)
            await self.ioctx.write_full(obj, data)
            rep = await self.index_ioctx.exec(
                self._index_obj(bucket), "rgw_index", "stack_push",
                {"key": key, "head_obj": self._data_obj(bucket, key),
                 "version": {
                     "version_id": vid, "obj": obj,
                     "size": len(data), "etag": etag,
                     "delete_marker": False,
                     "mtime": time.time(),
                     **({"acl": acl} if acl else {}),
                 }},
            )
            displaced = rep.get("displaced")
            if displaced and displaced != obj:
                try:
                    await self.ioctx.remove(displaced)
                except ObjectNotFound:
                    pass
            return etag, vid
        if await self._multipart_meta(bucket, key):
            # overwriting an assembled multipart object must reclaim its
            # parts, or every re-upload leaks them forever
            await self._reclaim_parts(bucket, key)
        await self.ioctx.write_full(self._data_obj(bucket, key), data)
        await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "insert",
            {"key": key,
             "meta": {"size": len(data), "etag": etag,
                      "mtime": time.time(),
                      **({"acl": acl} if acl else {})}},
        )
        return etag, None

    async def get_object_version(
        self, bucket: str, key: str, version_id: str
    ) -> bytes:
        meta = await self.head_object(bucket, key)
        versions = meta.get("versions", [])
        if not versions and version_id == "null":
            # never-versioned key addressed by its advertised null id
            return await self.ioctx.read(self._data_obj(bucket, key))
        for v in versions:
            if v["version_id"] == version_id:
                if v["delete_marker"]:
                    raise GatewayError(
                        f"{key!r}@{version_id} is a delete marker"
                    )
                return await self.ioctx.read(v["obj"])
        raise ObjectNotFound(f"{bucket}/{key}@{version_id}")

    async def list_versions(
        self, bucket: str, prefix: str = "", marker: str = "",
        max_keys: int = 1000,
    ) -> dict:
        """One PAGE of {key: [versions, newest last]}, riding the
        index's ranged pagination like list_objects does."""
        listing = await self.list_objects(
            bucket, prefix=prefix, marker=marker,
            max_entries=max_keys,
        )
        out = {}
        for key, meta in listing["entries"].items():
            if meta.get("versions"):
                out[key] = meta["versions"]
            else:
                out[key] = [{
                    "version_id": "null",
                    "obj": self._data_obj(bucket, key),
                    "size": meta.get("size", 0),
                    "etag": meta.get("etag", ""),
                    "delete_marker": False,
                }]
        return {
            "versions": out,
            "truncated": listing.get("truncated", False),
            "next_marker": listing.get("next_marker", ""),
        }

    async def delete_object_version(
        self, bucket: str, key: str, version_id: str
    ) -> None:
        """Permanent removal of ONE version (the S3 versioned delete):
        a single atomic cls stack_pop at the index primary promotes the
        newest remaining version; the gateway reclaims the popped data
        object afterwards."""
        try:
            rep = await self.index_ioctx.exec(
                self._index_obj(bucket), "rgw_index", "stack_pop",
                {"key": key, "version_id": version_id,
                 "head_obj": self._data_obj(bucket, key)},
            )
        except RadosError as e:
            if "ENOENT" in str(e) or isinstance(e, ObjectNotFound):
                raise ObjectNotFound(
                    f"{bucket}/{key}@{version_id}"
                ) from e
            raise
        removed = rep["removed"]
        if not removed.get("delete_marker") and removed.get("obj"):
            try:
                await self.ioctx.remove(removed["obj"])
            except ObjectNotFound:
                pass

    async def _multipart_meta(self, bucket: str, key: str):
        """The index entry IS the authority on whether a key is multipart
        (user data that happens to look like a manifest must never be
        interpreted as one)."""
        try:
            meta = await self.head_object(bucket, key)
        except ObjectNotFound:
            return None
        return meta if meta.get("multipart") else None

    async def get_object(self, bucket: str, key: str) -> bytes:
        meta = await self.head_object(bucket, key)
        if meta.get("versions"):
            cur = meta["versions"][-1]
            if cur["delete_marker"]:
                raise ObjectNotFound(
                    f"{bucket}/{key} (current is a delete marker)"
                )
            return await self.ioctx.read(cur["obj"])
        if meta.get("multipart"):
            m = json.loads(
                await self.ioctx.read(self._data_obj(bucket, key))
            )["__manifest__"]
            chunks = []
            for n in m["parts"]:
                chunks.append(await self.ioctx.read(
                    self._part_obj(bucket, key, m["multipart"], n)
                ))
            return b"".join(chunks)
        return await self.ioctx.read(self._data_obj(bucket, key))

    async def head_object(self, bucket: str, key: str) -> dict:
        listing = await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "list",
            {"prefix": key, "max_entries": 1},
        )
        meta = listing["entries"].get(key)
        if meta is None:
            raise ObjectNotFound(f"{bucket}/{key}")
        return meta

    async def _reclaim_parts(self, bucket: str, key: str) -> None:
        """Delete a multipart object's part objects via its manifest."""
        try:
            m = json.loads(
                await self.ioctx.read(self._data_obj(bucket, key))
            )["__manifest__"]
        except (ObjectNotFound, ValueError, KeyError):
            return
        for n in m.get("parts", []):
            try:
                await self.ioctx.remove(
                    self._part_obj(bucket, key, m["multipart"], n)
                )
            except ObjectNotFound:
                pass

    async def delete_object(
        self, bucket: str, key: str
    ) -> str | None:
        """Plain delete — except on a versioning-enabled bucket (or a
        suspended one whose key has a stack), where it stacks a DELETE
        MARKER as the new current version via one atomic cls call (data
        stays; returns the marker's version id). Per S3, a versioned
        delete of a NONEXISTENT key still succeeds with a marker."""
        enabled = await self.get_versioning(bucket)
        if enabled or await self._has_stack(bucket, key):
            import uuid

            vid = uuid.uuid4().hex[:16] if enabled else "null"
            rep = await self.index_ioctx.exec(
                self._index_obj(bucket), "rgw_index", "stack_push",
                {"key": key, "head_obj": self._data_obj(bucket, key),
                 "version": {
                     "version_id": vid, "obj": None, "size": 0,
                     "etag": "", "delete_marker": True,
                 }},
            )
            displaced = rep.get("displaced")
            if displaced:
                try:
                    await self.ioctx.remove(displaced)
                except ObjectNotFound:
                    pass
            return vid
        multipart = await self._multipart_meta(bucket, key)
        await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "remove", {"key": key}
        )
        if multipart:
            await self._reclaim_parts(bucket, key)
        await self.ioctx.remove(self._data_obj(bucket, key))
        return None

    async def list_objects(
        self,
        bucket: str,
        prefix: str = "",
        marker: str = "",
        max_entries: int = 1000,
    ) -> dict:
        return await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "list",
            {"prefix": prefix, "marker": marker,
             "max_entries": max_entries},
        )

    async def delete_bucket(self, bucket: str) -> None:
        stat = await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "stat", {}
        )
        if stat["count"]:
            raise GatewayError(f"bucket {bucket!r} not empty")
        await self.index_ioctx.remove(self._index_obj(bucket))
        try:
            await self.index_ioctx.omap_rm(
                self._BUCKETS_OBJ, [bucket.encode()]
            )
        except (ObjectNotFound, RadosError):
            pass

    # -- multipart upload (rgw_op.cc RGWInitMultipart / RGWPutObj part /
    # -- RGWCompleteMultipart): parts are separate RADOS objects; complete
    # -- writes a MANIFEST the read path follows — a large object is never
    # -- concatenated into one rados object, exactly like RGW's manifests.

    @staticmethod
    def _part_obj(bucket: str, key: str, upload_id: str, n: int) -> str:
        return f"{bucket}/{key}.__mp_{upload_id}.{n:05d}"

    @staticmethod
    def _uploads_obj(bucket: str) -> str:
        return f".bucket.uploads.{bucket}"

    @staticmethod
    def _upload_row(key: str, upload_id: str) -> str:
        return f"{key}\x00{upload_id}"

    async def initiate_multipart(self, bucket: str, key: str) -> str:
        if not await self.bucket_exists(bucket):
            raise GatewayError(f"no bucket {bucket!r}")
        if await self.get_versioning(bucket):
            raise GatewayError(
                "multipart upload to a versioning-enabled bucket is "
                "not supported (stated reduction)"
            )
        import uuid

        upload_id = uuid.uuid4().hex[:16]
        # in-progress uploads are REGISTERED (RGWListMultipart /
        # list_multipart_uploads need an index; part uploads are atomic
        # single-row cls inserts so concurrent frontends never race)
        await self.index_ioctx.exec(
            self._uploads_obj(bucket), "rgw_index", "insert",
            {"key": self._upload_row(key, upload_id),
             "meta": {"key": key, "upload_id": upload_id,
                      "initiated": time.time()}},
        )
        return upload_id

    async def list_multipart_uploads(
        self, bucket: str, prefix: str = ""
    ) -> list:
        """In-progress uploads (ListMultipartUploads)."""
        try:
            page = await self.index_ioctx.exec(
                self._uploads_obj(bucket), "rgw_index", "list",
                {"prefix": prefix, "max_entries": 1000},
            )
        except ObjectNotFound:
            return []
        return [
            meta for row, meta in sorted(page["entries"].items())
            if row.count("\x00") == 1  # part rows carry two
        ]

    async def list_parts(
        self, bucket: str, key: str, upload_id: str
    ) -> list:
        """Uploaded parts of one in-progress upload (ListParts)."""
        base = self._upload_row(key, upload_id) + "\x00"
        try:
            page = await self.index_ioctx.exec(
                self._uploads_obj(bucket), "rgw_index", "list",
                {"prefix": base, "max_entries": 10000},
            )
        except ObjectNotFound:
            return []
        return [
            meta for _row, meta in sorted(page["entries"].items())
        ]

    async def _drop_upload_rows(
        self, bucket: str, key: str, upload_id: str
    ) -> None:
        base = self._upload_row(key, upload_id)
        try:
            page = await self.index_ioctx.exec(
                self._uploads_obj(bucket), "rgw_index", "list",
                {"prefix": base, "max_entries": 10000},
            )
        except ObjectNotFound:
            return
        for row in page["entries"]:
            try:
                await self.index_ioctx.exec(
                    self._uploads_obj(bucket), "rgw_index", "remove",
                    {"key": row},
                )
            except RadosError:
                pass

    async def upload_part(
        self, bucket: str, key: str, upload_id: str, part_num: int,
        data: bytes,
    ) -> str:
        """Store one part; returns its etag (parts are 1-indexed)."""
        if part_num < 1:
            raise GatewayError("part numbers are 1-based")
        etag = f"{ceph_crc32c(0xFFFFFFFF, data):08x}"
        pname = self._part_obj(bucket, key, upload_id, part_num)
        await self.ioctx.write_full(pname, data)
        # etag rides the part as an xattr so complete() never re-reads
        # part payloads (the S3 contract passes etags back at complete)
        await self.ioctx.setxattr(pname, "rgw.etag", etag.encode())
        await self.index_ioctx.exec(
            self._uploads_obj(bucket), "rgw_index", "insert",
            {"key": (self._upload_row(key, upload_id)
                     + f"\x00{part_num:05d}"),
             "meta": {"part": part_num, "size": len(data),
                      "etag": etag, "mtime": time.time()}},
        )
        return etag

    async def complete_multipart(
        self, bucket: str, key: str, upload_id: str,
        parts: list[int],
    ) -> str:
        """Assemble the object from its parts: a manifest object lands
        under the key and the index entry records total size + the
        S3-style multipart etag ('<hash>-<nparts>')."""
        sizes = []
        etags = []
        for n in parts:
            pname = self._part_obj(bucket, key, upload_id, n)
            try:
                st = await self.ioctx.stat(pname)
                etags.append(
                    (await self.ioctx.getxattr(pname, "rgw.etag"))
                    .decode()
                )
            except ObjectNotFound:
                raise GatewayError(f"missing part {n}")
            sizes.append(st["size"])
        etag = (
            f"{ceph_crc32c(0xFFFFFFFF, ''.join(etags).encode()):08x}"
            f"-{len(parts)}"
        )
        manifest = {
            "multipart": upload_id,
            "parts": list(parts),
            "sizes": sizes,
        }
        await self.ioctx.write_full(
            self._data_obj(bucket, key),
            json.dumps({"__manifest__": manifest}).encode(),
        )
        await self.index_ioctx.exec(
            self._index_obj(bucket), "rgw_index", "insert",
            {"key": key,
             "meta": {"size": sum(sizes), "etag": etag,
                      "multipart": True}},
        )
        # unreferenced uploaded parts (client dropped them on retry) are
        # reclaimed now — after complete there is no abort to catch them
        await self._remove_stray_parts(
            bucket, key, upload_id, keep=set(parts)
        )
        await self._drop_upload_rows(bucket, key, upload_id)
        return etag

    async def _remove_stray_parts(
        self, bucket: str, key: str, upload_id: str, keep: set,
        miss_budget: int = 64,
    ) -> None:
        n, misses = 1, 0
        while misses < miss_budget:
            if n in keep:
                n += 1
                continue
            try:
                await self.ioctx.remove(
                    self._part_obj(bucket, key, upload_id, n)
                )
                misses = 0
            except ObjectNotFound:
                misses += 1
            n += 1

    async def abort_multipart(
        self, bucket: str, key: str, upload_id: str
    ) -> None:
        # sparse part numbers are legal: scan past gaps with a bounded
        # consecutive-miss budget instead of stopping at the first hole
        await self._remove_stray_parts(bucket, key, upload_id, keep=set())
        await self._drop_upload_rows(bucket, key, upload_id)
