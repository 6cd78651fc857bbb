"""CephFSClient: the mount-side of the MDS protocol (src/client role).

Metadata goes to the active MDS over a session (requests carry tids the
MDS dedups, so resends across failover are safe); file DATA never does —
`open` returns the ino plus a capability and the client reads/writes the
striped RADOS objects directly (the Client.cc / Objecter split). On a
connection error or a not-active bounce the client refetches the FSMap
from the mon, reconnects to the new active, and resends. A cap revoke
from the MDS drops the client's cached file data and acks immediately
(we write through, so there is nothing dirty to flush)."""

from __future__ import annotations

import asyncio
import itertools
import json

from ceph_tpu_torch.cephfs.fs import _file_soid
from ceph_tpu_torch.msg import Message, Policy
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError
from ceph_tpu_torch.rados.striper import RadosStriper


class CephFSError(RadosError):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class CephFSClient:
    def __init__(self, rados, pool_id: int):
        """`rados` is a connected Rados handle: its objecter's messenger
        carries the MDS session (ext_dispatch) and its IoCtx the data
        path."""
        self.rados = rados
        self.objecter = rados.objecter
        self.ioctx = rados.io_ctx(pool_id)
        self.striper = RadosStriper(self.ioctx)
        self.objecter.ext_dispatch = self._dispatch
        self._tids = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        self._mds_conn = None
        self._session_open = False
        #: ino -> cached file bytes, valid while we hold a cap
        self._cache: dict[int, bytes] = {}
        #: ino -> revoke count: IO that was in flight when a revoke
        #: landed must not repopulate the cache afterwards (the revoke
        #: already acked "nothing cached" to the MDS)
        self._revoked: dict[int, int] = {}
        self.revokes_seen = 0

    # -- session / transport ---------------------------------------------------

    async def _dispatch(self, conn, msg: Message) -> None:
        p = json.loads(msg.data) if msg.data else {}
        if msg.type in ("mds_reply", "mds_session_reply"):
            fut = self._waiters.get(p.get("tid"))
            if fut is not None and not fut.done():
                fut.set_result(p)
        elif msg.type == "mds_cap_revoke":
            # nothing dirty (write-through); drop the cache and ack
            self.revokes_seen += 1
            self._cache.pop(p["ino"], None)
            self._revoked[p["ino"]] = (
                self._revoked.get(p["ino"], 0) + 1
            )
            conn.send_message(Message(
                type="mds_cap_release",
                data=json.dumps({"ino": p["ino"]}).encode(),
            ))

    async def _connect_mds(self) -> None:
        # a (re)connect means our caps may be gone (failover wipes the
        # MDS cap table): cached data is no longer revoke-protected
        self._cache.clear()
        rep = await self.objecter.mon.command("fs map", timeout=10.0)
        fm = rep["fsmap"]
        actives = fm.get("actives")
        if actives is None:
            actives = [fm["active"]] if fm.get("active") else []
        if not actives:
            raise CephFSError("ENOENT", "no active MDS")
        # one session per RANK (the multi-active FSMap): requests route
        # by top-level directory hash, matching the MDS partition
        self._actives = actives
        self._mds_conns = {}
        for rank, m in enumerate(actives):
            conn = self.objecter.messenger.connect(
                tuple(m["addr"]), Policy.lossless_client()
            )
            tid = next(self._tids)
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = fut
            conn.send_message(Message(
                type="mds_session_open", tid=tid,
                data=json.dumps({"tid": tid}).encode(),
            ))
            try:
                await asyncio.wait_for(fut, 5.0)
            finally:
                self._waiters.pop(tid, None)
            self._mds_conns[rank] = conn
        self._mds_conn = self._mds_conns[0]
        self._session_open = True

    def _rank_of(self, payload: dict) -> int:
        """Mirror of the MDS partition: rank by rjenkins(top-level
        component); root/admin ops go to rank 0."""
        n = len(getattr(self, "_actives", []) or [1])
        if n <= 1:
            return 0
        path = payload.get("path") or payload.get("src")
        if path is None:
            return 0
        parts = [x for x in path.strip("/").split("/") if x]
        if not parts:
            return 0
        from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

        return ceph_str_hash_rjenkins(parts[0]) % n

    async def mount(self) -> None:
        await self._connect_mds()

    async def _request(self, payload: dict, timeout: float = 30.0) -> dict:
        """Send to the active MDS; on bounce/timeout refetch the map,
        re-open the session, resend the SAME tid (the MDS dedups)."""
        tid = next(self._tids)
        payload = {**payload, "tid": tid}
        deadline = asyncio.get_event_loop().time() + timeout
        while True:
            if not self._session_open or self._mds_conn is None:
                try:
                    await self._connect_mds()
                except (CephFSError, asyncio.TimeoutError, OSError):
                    await asyncio.sleep(0.3)
                    if asyncio.get_event_loop().time() > deadline:
                        raise CephFSError(
                            "ETIMEDOUT", "no reachable active MDS"
                        ) from None
                    continue
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = fut
            # the MDS may legitimately block an open for a full revoke
            # grace while it evicts an unresponsive cap holder — the
            # per-attempt timeout must outlast that, or every eviction
            # path churns the session
            attempt = (
                self.objecter.config.get("mds_beacon_grace") + 2.0
            )
            try:
                conn = getattr(self, "_mds_conns", {}).get(
                    self._rank_of(payload), self._mds_conn
                )
                conn.send_message(Message(
                    type="mds_request", tid=tid,
                    data=json.dumps(payload).encode(),
                ))
                rep = await asyncio.wait_for(fut, attempt)
            except (asyncio.TimeoutError, OSError, RuntimeError):
                self._session_open = False  # failover: re-resolve
                if asyncio.get_event_loop().time() > deadline:
                    raise CephFSError(
                        "ETIMEDOUT", f"mds request {payload['op']!r}"
                    ) from None
                continue
            finally:
                self._waiters.pop(tid, None)
            if (
                rep.get("not_active") or rep.get("no_session")
                or rep.get("wrong_rank")
            ):
                self._session_open = False
                await asyncio.sleep(0.2)
                if asyncio.get_event_loop().time() > deadline:
                    raise CephFSError(
                        "ETIMEDOUT", f"mds request {payload['op']!r}"
                    )
                continue
            if not rep.get("ok"):
                raise CephFSError(
                    rep.get("errno", "EIO"),
                    rep.get("error", "mds error"),
                )
            return rep

    # -- the filesystem surface ------------------------------------------------

    async def mkfs(self) -> None:
        await self._request({"op": "mkfs"})

    async def mkdir(self, path: str) -> int:
        return (await self._request({"op": "mkdir", "path": path}))[
            "ino"
        ]

    async def listdir(self, path: str = "/") -> dict:
        return (
            await self._request({"op": "readdir", "path": path})
        )["entries"]

    async def stat(self, path: str) -> dict:
        entry = (
            await self._request({"op": "stat", "path": path})
        )["entry"]
        if entry["type"] == "file":
            try:
                entry["size"] = await self.striper.size(
                    _file_soid(entry["ino"])
                )
            except ObjectNotFound:
                entry["size"] = 0
        return entry

    async def open(self, path: str, mode: str = "r") -> dict:
        """Returns {ino, cap}; data IO goes straight to RADOS."""
        return await self._request(
            {"op": "open", "path": path, "mode": mode}
        )

    async def write_file(self, path: str, data: bytes) -> int:
        got = await self.open(path, mode="w")
        ino = got["ino"]
        epoch = self._revoked.get(ino, 0)
        # the open reply carries the realm chain's snap context
        # (SnapRealm propagation with the cap): writes apply it so the
        # OSD clones objects on first-write-after-snap. A PRIVATE IoCtx
        # per call: save/restore on the shared handle corrupts the
        # context when calls interleave on the event loop
        from ceph_tpu_torch.rados.client import IoCtx

        wctx = IoCtx(self.objecter, self.ioctx.pool_id)
        wctx.snapc = got.get("snapc")
        await RadosStriper(wctx).write(_file_soid(ino), data)
        if self._revoked.get(ino, 0) == epoch:
            self._cache[ino] = data  # no revoke raced the write
        return ino

    async def read_file(self, path: str) -> bytes:
        got = await self.open(path, mode="r")
        ino = got["ino"]
        if got.get("snapid") is not None:
            # a .snap path: read the striped objects AT the snapid via a
            # private IoCtx (same interleaving hazard as writes); never
            # cached (past data has no cap protection to need)
            from ceph_tpu_torch.rados.client import IoCtx

            rctx = IoCtx(self.objecter, self.ioctx.pool_id)
            rctx.read_snap = got["snapid"]
            try:
                return await RadosStriper(rctx).read(_file_soid(ino))
            except ObjectNotFound:
                return b""
        cached = self._cache.get(ino)
        if cached is not None:
            return cached  # cap-protected cache: revoke drops it
        epoch = self._revoked.get(ino, 0)
        try:
            data = await self.striper.read(_file_soid(ino))
        except ObjectNotFound:
            data = b""
        if self._revoked.get(ino, 0) == epoch:
            self._cache[ino] = data  # no revoke raced the read
        return data

    async def mksnap(self, dirpath: str, name: str) -> int:
        """mkdir <dir>/.snap/<name> (the .snap pseudo-directory)."""
        base = dirpath.rstrip("/")
        return (await self._request(
            {"op": "mkdir", "path": f"{base}/.snap/{name}"}
        ))["snapid"]

    async def rmsnap(self, dirpath: str, name: str) -> None:
        base = dirpath.rstrip("/")
        await self._request(
            {"op": "rmdir", "path": f"{base}/.snap/{name}"}
        )

    async def unlink(self, path: str) -> None:
        await self._request({"op": "unlink", "path": path})

    async def rmdir(self, path: str) -> None:
        await self._request({"op": "rmdir", "path": path})

    async def rename(self, src: str, dst: str) -> None:
        await self._request({"op": "rename", "src": src, "dst": dst})
