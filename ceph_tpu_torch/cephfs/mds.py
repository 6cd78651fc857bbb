"""MDSService: the metadata daemon (the src/mds role, mini scale).

The reference's MDS (src/mds, ~84k LoC) owns the filesystem namespace:
clients open SESSIONS and send metadata requests; mutations are
JOURNALED before they apply (MDLog/Journaler: the journal IS the
authority across a crash); CAPABILITIES arbitrate which client may read
or write an inode's data (Capability.h; conflicting access triggers
revoke round-trips); standby daemons REPLAY the journal and take over
when the mon's beacon grace expires (MDSMonitor + FSMap).

This daemon reproduces those contracts at mini scale:

  * boot: beacon to the mon ("mds beacon"); the committed FSMap names
    one active + standbys, and the beacon reply tells us our role.
  * namespace: dentries/inodes live in RADOS dir objects (the same
    fs_dir/fs_ino object classes the client-side library uses — CDir
    omap storage), accessed through the daemon's own Objecter: the MDS
    is a RADOS client, exactly like the reference.
  * journaling: every mutation appends an idempotent event (ino
    pre-allocated into the event) to a Journaler object BEFORE applying
    it; the applied position is committed/trimmed lazily. A takeover
    REPLAYS the tail — events that already applied re-apply as no-ops
    (link replace semantics, unlink tolerates ENOENT).
  * capabilities: `open` grants "r" (shared) or "w" (exclusive) caps on
    a file ino; a conflicting open revokes holders first
    ("mds_cap_revoke" -> client flush/ack) and evicts sessions that
    don't answer within the grace.
  * sessions: per-client completed-tid table dedups resends across
    failover (the client retries against the new active).

Client data IO never touches the MDS: `open` returns the ino and the
client reads/writes the striped file objects directly — the metadata /
data path split that defines the architecture.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.cephfs.fs import ROOT_INO, _dir_obj, _file_soid
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.journal.journal import Journaler
from ceph_tpu_torch.msg import Message
from ceph_tpu_torch.rados.client import ObjectNotFound, Objecter, RadosError

JOURNAL_OBJ = "mds_journal"


class MDSError(RadosError):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


class _Session:
    def __init__(self, name: str, conn):
        self.name = name
        self.conn = conn
        #: tid -> reply payload (request dedup across resends/failover)
        self.completed: dict[int, dict] = {}


class MDSService:
    def __init__(
        self, name: str, monmap, pool_id: int,
        config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        device=None,
    ):
        self.name = name
        self.config = config if config is not None else Config()
        # the MDS is a RADOS client for its backing objects; its
        # messenger doubles as the serving endpoint for client sessions.
        # `device` goes to the Objecter (None = cuda, raising without a
        # card), as MgrService's does
        self.objecter = Objecter(
            name, monmap, config=self.config, keyring=keyring, device=device
        )
        self.device = self.objecter.device
        self.objecter.ext_dispatch = self._dispatch
        self.ioctx = None  # bound in start()
        self.pool_id = pool_id
        self.journaler: Journaler | None = None
        self.active = False
        #: this daemon's ACTIVE rank (None while standby): ranks
        #: partition the namespace by top-level directory hash (the
        #: subtree-partitioning role of MDBalancer, static at mini
        #: scale) and name the journal each rank owns
        self.rank: int | None = None
        self.n_actives = 1
        self.fsmap_epoch = 0
        self._sessions: dict[str, _Session] = {}
        #: ino -> {client_name: "r"|"w"} granted capabilities
        self.caps: dict[int, dict[str, str]] = {}
        self._cap_acks: dict[tuple[int, str], asyncio.Future] = {}
        #: per-ino grant serialization: concurrent conflicting opens
        #: must run their revoke round-trips one at a time or they
        #: clobber each other's ack futures and both "win" exclusivity
        self._cap_locks: dict[int, asyncio.Lock] = {}
        #: (client, tid) -> minimal ack, rebuilt from journal replay at
        #: takeover: a resend of an op the DEAD active completed must
        #: ack, not re-execute (the completed-tid contract survives
        #: failover because mutations journal their reqid)
        self._replayed: dict[tuple[str, int], dict] = {}
        self._applied_pos = 0
        #: (dir ino, dentry name) -> fragment size reported by the last
        #: link cls op (the split trigger's O(1) feed)
        self._frag_counts: dict[tuple, int] = {}
        self._stopped = False
        self._tasks: list[asyncio.Task] = []

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        await self.objecter.messenger.bind()
        await self.objecter.start()
        from ceph_tpu_torch.rados.client import IoCtx

        self.ioctx = IoCtx(self.objecter, self.pool_id)
        await self._beacon()  # learn the initial role
        self._tasks.append(asyncio.create_task(self._beacon_loop()))

    async def stop(self) -> None:
        self._stopped = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        await self.objecter.close()

    @property
    def addr(self):
        return tuple(self.objecter.messenger.my_addr)

    async def _beacon(self) -> None:
        rep = await self.objecter.mon.command(
            "mds beacon", {"name": self.name, "addr": list(self.addr)},
            timeout=5.0,
        )
        fm = rep["fsmap"]
        actives = fm.get("actives")
        if actives is None:
            actives = [fm["active"]] if fm.get("active") else []
        was_active = self.active
        old_rank = self.rank
        self.rank = next(
            (i for i, m in enumerate(actives)
             if m["name"] == self.name),
            None,
        )
        self.active = self.rank is not None
        self.n_actives = max(1, len(actives))
        self.fsmap_epoch = fm["epoch"]
        if self.active and (not was_active or old_rank != self.rank):
            # rank identity = journal identity: a takeover replays the
            # journal of the RANK we now hold, not a global one
            self.journaler = Journaler(
                self.ioctx, f"{JOURNAL_OBJ}.{self.rank}"
            )
            await self._takeover()

    async def _beacon_loop(self) -> None:
        interval = self.config.get("mds_beacon_interval")
        while not self._stopped:
            await asyncio.sleep(interval)
            try:
                await self._beacon()
            # cephlint: disable=error-taxonomy (mon churn: next beacon retries)
            except Exception:
                pass  # mon churn: next beacon retries

    # -- journal (MDLog role) --------------------------------------------------

    async def _takeover(self) -> None:
        """Standby -> active: replay the journal tail over the RADOS
        namespace state (MDSRank::boot_start REPLAY). Events are
        idempotent, so re-applying ones the dead active already flushed
        is harmless."""
        rep = await self.journaler.read(from_pos=0)
        pos = rep.get("commit", 0)
        for ev in rep["entries"]:
            pos = ev["pos"]
            event = ev["event"]
            try:
                await self._apply(event)
            # cephlint: disable=error-taxonomy (idempotent re-apply: conflicts mean already-done)
            except Exception:
                pass  # idempotent re-apply: conflicts mean "already done"
            if event.get("client") is not None:
                ack = {"tid": event["tid"], "ok": True,
                       "replayed": True}
                if "ino" in event:
                    ack["ino"] = event["ino"]
                self._replayed[(event["client"], event["tid"])] = ack
        self._applied_pos = pos
        if pos:
            await self.journaler.commit_and_trim(pos)

    async def _journal_and_apply(self, event: dict) -> None:
        """Journal first, then apply (the write-ahead contract that
        makes failover lossless): an MDS death between the two leaves
        the event for the successor's replay."""
        rec = await self.journaler.append(event)
        await self._apply(event)
        self._applied_pos = rec
        # lazy trim: every 32 applied events
        if self._applied_pos % 32 == 0:
            try:
                await self.journaler.commit_and_trim(self._applied_pos)
            # cephlint: disable=error-taxonomy (lazy trim is best-effort: the next 32-multiple retries)
            except Exception:
                pass

    async def _apply(self, ev: dict) -> None:
        op = ev["op"]
        if op == "mkfs":
            await self.ioctx.write_full(_dir_obj(ROOT_INO), b"")
            # NEVER rewind the inotable: a replayed mkfs must not hand
            # out inos that live allocations already took
            try:
                cur = int((await self.ioctx.read("fs.inotable")).decode())
            # cephlint: disable=error-taxonomy (missing/unreadable inotable: start numbering from 0)
            except Exception:
                cur = 0
            await self.ioctx.write_full(
                "fs.inotable",
                str(max(ROOT_INO, ev["ino"], cur)).encode(),
            )
        elif op == "mkdir":
            await self.ioctx.write_full(_dir_obj(ev["ino"]), b"")
            await self._dir_link(
                ev["parent"], ev["name"], ev["ino"], "dir"
            )
        elif op == "create":
            await self._dir_link(
                ev["parent"], ev["name"], ev["ino"], "file"
            )
        elif op == "unlink":
            try:
                await self._dir_unlink(ev["parent"], ev["name"])
            except RadosError:
                pass  # replay: already gone
            if ev.get("ino"):
                try:
                    from ceph_tpu_torch.rados.striper import RadosStriper

                    # deletes carry the realm's snap context so clones
                    # under live snapshots survive the head removal
                    saved = self.ioctx.snapc
                    self.ioctx.snapc = ev.get("snapc")
                    try:
                        await RadosStriper(self.ioctx).remove(
                            _file_soid(ev["ino"])
                        )
                    finally:
                        self.ioctx.snapc = saved
                except (ObjectNotFound, RadosError):
                    pass
        elif op == "mksnap":
            realm = await self._realm(ev["dir"])
            realm[ev["name"]] = {
                "snapid": ev["snapid"], "children": ev["children"],
            }
            await self.ioctx.setxattr(
                _dir_obj(ev["dir"]), "snaps",
                json.dumps(realm, sort_keys=True).encode(),
            )
        elif op == "fragment":
            # re-shard the directory's dentries across 2^bits fragment
            # objects (CDir::split). Idempotent: replay at the target
            # bit count is a no-op
            ino, bits = ev["ino"], ev["bits"]
            cur = await self._dir_bits(ino)
            if cur >= bits:
                return
            entries = await self._entries(ino)
            for name, entry in entries.items():
                await self.ioctx.exec(
                    self._frag_obj(
                        ino, self._frag_of(name, bits), bits
                    ),
                    "fs_dir", "link",
                    {"name": name, "ino": entry["ino"],
                     "type": entry["type"], "replace": True},
                )
            # drop the OLD layout's dentries, keep the base object (it
            # holds the frags/snaps xattrs)
            if cur == 0:
                try:
                    await self.ioctx.omap_clear(_dir_obj(ino))
                except RadosError:
                    pass
            else:
                for frag in range(1 << cur):
                    try:
                        await self.ioctx.remove(
                            self._frag_obj(ino, frag, cur)
                        )
                    except ObjectNotFound:
                        pass
            await self.ioctx.setxattr(
                _dir_obj(ino), "frags",
                json.dumps({"bits": bits}).encode(),
            )
        elif op == "rmsnap":
            realm = await self._realm(ev["dir"])
            if ev["name"] in realm:
                del realm[ev["name"]]
                await self.ioctx.setxattr(
                    _dir_obj(ev["dir"]), "snaps",
                    json.dumps(realm, sort_keys=True).encode(),
                )
            try:
                await self.ioctx.selfmanaged_snap_remove(ev["snapid"])
            except RadosError:
                pass  # replay: already removed from the pool
        elif op == "rmdir":
            try:
                await self._dir_unlink(ev["parent"], ev["name"])
            except RadosError:
                pass
            await self._remove_dir_objects(ev["ino"])
        elif op == "rename":
            await self._dir_link(
                ev["dparent"], ev["dname"], ev["ino"], ev["type"]
            )
            try:
                await self._dir_unlink(ev["sparent"], ev["sname"])
            except RadosError:
                pass
        else:
            raise MDSError("EINVAL", f"unknown journal op {op!r}")

    # -- snapshots (SnapRealm-lite, src/mds/SnapRealm.h:27) --------------------
    #
    # A directory is a realm root: `mkdir D/.snap/<name>` allocates a
    # pool snapid (the selfmanaged allocator), captures D's entries, and
    # journals the record into D's dir-object xattr — so realms live in
    # RADOS (surviving failover) and replay idempotently. File DATA
    # versioning rides the existing selfmanaged-snap machinery: `open`
    # replies carry the path's accumulated snap context, client writes
    # apply it, and the OSD clones objects on first-write-after-snap.
    # Reads at `D/.snap/<name>/file` resolve to (ino, snapid) and the
    # client reads the striped objects at that snapid. Mini reductions
    # (documented): captured listings are one level deep, and a write
    # whose open predates a concurrent mksnap carries the older context.

    async def _realm(self, ino: int) -> dict:
        """{snapname: {"snapid": N, "children": {...}}} for a dir."""
        try:
            raw = await self.ioctx.getxattr(_dir_obj(ino), "snaps")
        except (ObjectNotFound, RadosError):
            return {}
        return json.loads(raw)

    async def _path_snaps(self, parts: list[str]) -> tuple[int, list]:
        """Resolve a dir path accumulating every ancestor realm's
        snapids (the realm-chain walk clients get with their caps)."""
        ino = ROOT_INO
        snaps = [s["snapid"] for s in (await self._realm(ino)).values()]
        for name in parts:
            entry = (await self._entries(ino)).get(name)
            if entry is None or entry["type"] != "dir":
                raise MDSError("ENOENT", f"no directory {name!r}")
            ino = entry["ino"]
            snaps += [
                s["snapid"] for s in (await self._realm(ino)).values()
            ]
        return ino, sorted(snaps)

    @staticmethod
    def _snapc_of(snaps: list) -> dict | None:
        if not snaps:
            return None
        return {"seq": max(snaps), "snaps": sorted(snaps, reverse=True)}

    # -- directory fragments (CDir/frag_t, src/mds/CDir.h mini) ----------------
    #
    # An unfragmented directory keeps its dentries in the dir object's
    # omap (bits=0). Once a fragment crosses mds_bal_split_size the MDS
    # journals a "fragment" event doubling the fragment count: dentries
    # re-shard across 2^bits fragment OBJECTS routed by rjenkins(name),
    # so a huge directory's omap (and its update contention) spreads
    # over many RADOS objects/PGs — the reference's dirfrag scaling
    # axis. The split is journaled-then-applied and idempotent, like
    # every other namespace mutation.

    @staticmethod
    def _frag_obj(ino: int, frag: int, bits: int) -> str:
        # namespaced by the bit generation: a split from bits=1 to
        # bits=2 re-shards into FRESH objects (f2_0..f2_3) before the
        # old generation (f1_0..f1_1) is dropped — same-name reuse
        # would destroy re-sharded entries mid-split
        return f"{_dir_obj(ino)}.f{bits}_{frag:x}"

    async def _dir_bits(self, ino: int) -> int:
        try:
            raw = await self.ioctx.getxattr(_dir_obj(ino), "frags")
        except (ObjectNotFound, RadosError):
            return 0
        return json.loads(raw)["bits"]

    @staticmethod
    def _frag_of(name: str, bits: int) -> int:
        from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

        return ceph_str_hash_rjenkins(name) & ((1 << bits) - 1)

    async def _dentry_obj(self, ino: int, name: str) -> str:
        bits = await self._dir_bits(ino)
        if bits == 0:
            return _dir_obj(ino)
        return self._frag_obj(ino, self._frag_of(name, bits), bits)

    async def _dir_link(
        self, ino: int, name: str, child: int, type_: str
    ) -> int:
        rep = await self.ioctx.exec(
            await self._dentry_obj(ino, name), "fs_dir", "link",
            {"name": name, "ino": child, "type": type_,
             "replace": True},
        )
        count = int(rep.get("count", 0))
        # remember the fragment's size as reported by its own primary:
        # the O(1) feed for the split trigger
        self._frag_counts[(ino, name)] = count
        return count

    async def _dir_unlink(self, ino: int, name: str) -> None:
        await self.ioctx.exec(
            await self._dentry_obj(ino, name), "fs_dir", "unlink",
            {"name": name},
        )

    async def _remove_dir_objects(self, ino: int) -> None:
        bits = await self._dir_bits(ino)
        for frag in range(1 << bits if bits else 0):
            try:
                await self.ioctx.remove(
                    self._frag_obj(ino, frag, bits)
                )
            except ObjectNotFound:
                pass
        try:
            await self.ioctx.remove(_dir_obj(ino))
        except ObjectNotFound:
            pass

    async def _maybe_split(self, ino: int, name: str) -> None:
        """Post-link check: fragment the dir when the dentry's fragment
        crossed the split size (MDBalancer's split trigger, journaled
        like any namespace mutation — but as an INTERNAL event with no
        client reqid: it is idempotent and must not clobber the
        triggering op's replay ack). O(1): the link cls op already
        reported the fragment's post-insert count — listing the whole
        fragment per create would make population O(n^2)."""
        count = self._frag_counts.pop((ino, name), 0)
        if count <= self.config.get("mds_bal_split_size"):
            return
        bits = await self._dir_bits(ino)
        await self._journal_and_apply({
            "op": "fragment", "ino": ino, "bits": bits + 1,
        })

    # -- namespace helpers -----------------------------------------------------

    async def _entries(self, ino: int) -> dict:
        bits = await self._dir_bits(ino)
        if bits == 0:
            listing = await self.ioctx.exec(
                _dir_obj(ino), "fs_dir", "list", {}
            )
            return listing["entries"]
        merged: dict = {}
        for frag in range(1 << bits):
            try:
                listing = await self.ioctx.exec(
                    self._frag_obj(ino, frag, bits),
                    "fs_dir", "list", {},
                )
            except ObjectNotFound:
                continue
            merged.update(listing["entries"])
        return merged

    async def _resolve_dir(self, parts: list[str]) -> int:
        ino = ROOT_INO
        for name in parts:
            entry = (await self._entries(ino)).get(name)
            if entry is None or entry["type"] != "dir":
                raise MDSError("ENOENT", f"no directory {name!r}")
            ino = entry["ino"]
        return ino

    @staticmethod
    def _split(path: str) -> list[str]:
        parts = [p for p in path.strip("/").split("/") if p]
        if any(p in (".", "..") for p in parts):
            raise MDSError("EINVAL", "'.'/'..' not supported")
        return parts

    async def _parent_and_name(self, path: str) -> tuple[int, str]:
        parts = self._split(path)
        if not parts:
            raise MDSError("EINVAL", "path refers to the root")
        return await self._resolve_dir(parts[:-1]), parts[-1]

    async def _alloc_ino(self) -> int:
        r = await self.ioctx.exec("fs.inotable", "fs_ino", "alloc", {})
        return r["ino"]

    # -- capabilities (Capability.h role) --------------------------------------

    async def _grant_cap(
        self, session: _Session, ino: int, mode: str
    ) -> None:
        """Grant after revoking conflicting holders: 'w' conflicts with
        everything, 'r' conflicts with a held 'w'. Grants on one ino
        serialize: concurrent conflicting opens would otherwise clobber
        each other's ack futures and both claim exclusivity."""
        async with self._cap_locks.setdefault(ino, asyncio.Lock()):
            await self._grant_cap_locked(session, ino, mode)

    async def _grant_cap_locked(
        self, session: _Session, ino: int, mode: str
    ) -> None:
        holders = self.caps.setdefault(ino, {})
        conflicting = [
            (client, held) for client, held in holders.items()
            if client != session.name
            and (mode == "w" or held == "w")
        ]
        for client, _held in conflicting:
            other = self._sessions.get(client)
            if other is None or other.conn is None:
                holders.pop(client, None)
                continue
            fut = asyncio.get_event_loop().create_future()
            self._cap_acks[(ino, client)] = fut
            other.conn.send_message(Message(
                type="mds_cap_revoke",
                data=json.dumps({"ino": ino}).encode(),
            ))
            try:
                await asyncio.wait_for(
                    fut, self.config.get("mds_beacon_grace")
                )
            except asyncio.TimeoutError:
                # unresponsive client: evict its session (the
                # reference's session autoclose + cap revocation)
                await self._evict(client)
            finally:
                self._cap_acks.pop((ino, client), None)
            holders.pop(client, None)
        holders[session.name] = mode

    async def _evict(self, client: str) -> None:
        """Session eviction WITH fencing: before the conflicting cap can
        be re-granted, the evicted entity is blocklisted in the OSDMap
        (Server.cc:1099 kill_session -> mds_session_blacklist_on_evict,
        options.cc:7709) — file data IO bypasses the MDS by design, so
        dropping the session alone would leave the evicted client's
        in-flight direct-RADOS writes racing the new cap holder. The
        blocklist commit is awaited: eviction is not complete until every
        OSD refusing the entity is a map-epoch away, not a hope."""
        try:
            await self.objecter.mon.command(
                "osd blocklist",
                {"op": "add", "entity": client,
                 "expire": float(
                     self.config.get("mds_blocklist_expire")
                 )},
            )
        # cephlint: disable=error-taxonomy (mon unreachable: drop the session either way; next grant retries)
        except Exception:
            # mon unreachable: still drop the session (we cannot grant
            # safely either way; the next grant retries the blocklist)
            pass
        self._sessions.pop(client, None)
        for holders in self.caps.values():
            holders.pop(client, None)

    # -- the wire --------------------------------------------------------------

    async def _dispatch(self, conn, msg: Message) -> None:
        p = json.loads(msg.data) if msg.data else {}
        if msg.type == "mds_session_open":
            existing = self._sessions.get(conn.peer_name)
            session = _Session(conn.peer_name, conn)
            if existing is not None:
                # a session RE-open (reply lost, conn drop): the dedup
                # table must survive or the client's resends re-execute
                session.completed = existing.completed
            self._sessions[conn.peer_name] = session
            conn.send_message(Message(
                type="mds_session_reply", tid=p.get("tid", 0),
                data=json.dumps(
                    {"tid": p.get("tid", 0), "ok": True}
                ).encode(),
            ))
            return
        if msg.type == "mds_cap_release":
            fut = self._cap_acks.get((p["ino"], conn.peer_name))
            if fut is not None and not fut.done():
                fut.set_result(True)
            else:
                # voluntary release outside a revoke round-trip
                self.caps.get(p["ino"], {}).pop(conn.peer_name, None)
            return
        if msg.type != "mds_request":
            return
        reply = await self._handle_request(conn, p)
        conn.send_message(Message(
            type="mds_reply", tid=p.get("tid", 0),
            data=json.dumps(reply).encode(),
        ))

    def _owns(self, p: dict) -> bool:
        """Static subtree partition: ops on top-level entries route by
        rjenkins(first path component) % n_actives; root-level and
        admin ops (mkfs) belong to rank 0. Cross-subtree renames
        execute at the SOURCE owner (dir objects are cluster-side cls
        state, so any rank may link; cap state for the moved ino stays
        behind — stated mini reduction)."""
        if self.n_actives <= 1:
            return True
        path = p.get("path") or p.get("src")
        if path is None:
            return self.rank == 0
        parts = [x for x in path.strip("/").split("/") if x]
        if not parts:
            return self.rank == 0
        from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

        return (
            ceph_str_hash_rjenkins(parts[0]) % self.n_actives
            == self.rank
        )

    async def _handle_request(self, conn, p: dict) -> dict:
        tid = p.get("tid", 0)
        if not self.active:
            return {"tid": tid, "ok": False, "not_active": True}
        if not self._owns(p):
            # the client's map is stale or it mis-routed: bounce with
            # the authoritative hint (MDS_MAP epoch bump role)
            return {"tid": tid, "ok": False, "wrong_rank": True}
        session = self._sessions.get(conn.peer_name)
        if session is None:
            return {"tid": tid, "ok": False, "no_session": True}
        if tid in session.completed:
            return session.completed[tid]
        replayed = self._replayed.get((conn.peer_name, tid))
        if replayed is not None:
            return replayed  # the dead active completed this op
        try:
            result = await self._execute(session, p)
            reply = {"tid": tid, "ok": True, **result}
        except MDSError as e:
            reply = {"tid": tid, "ok": False, "errno": e.code,
                     "error": str(e)}
        except Exception as e:
            return {"tid": tid, "ok": False, "error": str(e)}
        session.completed[tid] = reply
        if len(session.completed) > 512:
            for old in sorted(session.completed)[:-256]:
                del session.completed[old]
        return reply

    @staticmethod
    def _reqid(session: _Session, p: dict) -> dict:
        return {"client": session.name, "tid": p.get("tid", 0)}

    async def _execute(self, session: _Session, p: dict) -> dict:
        op = p["op"]
        rid = self._reqid(session, p)
        if op == "mkfs":
            ino = ROOT_INO
            await self._journal_and_apply(
                {"op": "mkfs", "ino": ino, **rid}
            )
            return {}
        parts = self._split(p["path"]) if "path" in p else []
        if op == "mkdir" and len(parts) >= 2 and parts[-2] == ".snap":
            # mkdir D/.snap/<name> = snapshot creation (mksnap)
            dir_ino = await self._resolve_dir(parts[:-2])
            realm = await self._realm(dir_ino)
            if parts[-1] in realm:
                raise MDSError("EEXIST", f"snap {parts[-1]!r} exists")
            snapid = await self.ioctx.selfmanaged_snap_create()
            children = await self._entries(dir_ino)
            await self._journal_and_apply({
                "op": "mksnap", "dir": dir_ino, "name": parts[-1],
                "snapid": snapid, "children": children, **rid,
            })
            return {"snapid": snapid}
        if op == "rmdir" and len(parts) >= 2 and parts[-2] == ".snap":
            dir_ino = await self._resolve_dir(parts[:-2])
            realm = await self._realm(dir_ino)
            if parts[-1] not in realm:
                raise MDSError("ENOENT", f"no snap {parts[-1]!r}")
            await self._journal_and_apply({
                "op": "rmsnap", "dir": dir_ino, "name": parts[-1],
                "snapid": realm[parts[-1]]["snapid"], **rid,
            })
            return {}
        if op == "readdir" and parts and parts[-1] == ".snap":
            dir_ino = await self._resolve_dir(parts[:-1])
            realm = await self._realm(dir_ino)
            return {"entries": {
                name: {"type": "snap", "snapid": s["snapid"]}
                for name, s in realm.items()
            }}
        if op == "readdir" and len(parts) >= 2 and parts[-2] == ".snap":
            dir_ino = await self._resolve_dir(parts[:-2])
            realm = await self._realm(dir_ino)
            snap = realm.get(parts[-1])
            if snap is None:
                raise MDSError("ENOENT", f"no snap {parts[-1]!r}")
            return {"entries": snap["children"]}
        if op in ("open", "stat") and len(parts) >= 3 and (
            parts[-3] == ".snap"
        ):
            # D/.snap/<name>/file: read-only access to the past
            dir_ino = await self._resolve_dir(parts[:-3])
            realm = await self._realm(dir_ino)
            snap = realm.get(parts[-2])
            if snap is None:
                raise MDSError("ENOENT", f"no snap {parts[-2]!r}")
            entry = snap["children"].get(parts[-1])
            if entry is None or entry["type"] != "file":
                raise MDSError(
                    "ENOENT", f"no file {parts[-1]!r} in snap"
                )
            if op == "stat":
                return {"entry": {**entry, "snapid": snap["snapid"]}}
            if p.get("mode", "r") != "r":
                raise MDSError("EROFS", "snapshots are read-only")
            return {"ino": entry["ino"], "cap": "r",
                    "snapid": snap["snapid"]}
        if op == "mkdir":
            parent, name = await self._parent_and_name(p["path"])
            if name in await self._entries(parent):
                raise MDSError("EEXIST", f"{p['path']!r} exists")
            ino = await self._alloc_ino()
            await self._journal_and_apply({
                "op": "mkdir", "parent": parent, "name": name,
                "ino": ino, **rid,
            })
            await self._maybe_split(parent, name)
            return {"ino": ino}
        if op == "readdir":
            ino = await self._resolve_dir(self._split(p["path"]))
            return {"entries": await self._entries(ino)}
        if op == "stat":
            parent, name = await self._parent_and_name(p["path"])
            entry = (await self._entries(parent)).get(name)
            if entry is None:
                raise MDSError("ENOENT", f"no entry {p['path']!r}")
            return {"entry": entry}
        if op == "open":
            parent, name = await self._parent_and_name(p["path"])
            mode = p.get("mode", "r")
            entry = (await self._entries(parent)).get(name)
            if entry is None:
                if mode != "w":
                    raise MDSError("ENOENT", f"no file {p['path']!r}")
                ino = await self._alloc_ino()
                await self._journal_and_apply({
                    "op": "create", "parent": parent, "name": name,
                    "ino": ino, **rid,
                })
                await self._maybe_split(parent, name)
            elif entry["type"] != "file":
                raise MDSError("EISDIR", f"{p['path']!r} is a dir")
            else:
                ino = entry["ino"]
            await self._grant_cap(session, ino, mode)
            # the realm chain's snap context rides with the cap: the
            # client's direct-RADOS writes must carry it so the OSD
            # clones objects on first-write-after-snap
            _dino, snaps = await self._path_snaps(parts[:-1])
            return {"ino": ino, "cap": mode,
                    "snapc": self._snapc_of(snaps)}
        if op == "release":
            self.caps.get(p["ino"], {}).pop(session.name, None)
            return {}
        if op == "unlink":
            parent, name = await self._parent_and_name(p["path"])
            entry = (await self._entries(parent)).get(name)
            if entry is None or entry["type"] != "file":
                raise MDSError("ENOENT", f"no file {p['path']!r}")
            _dino, snaps = await self._path_snaps(parts[:-1])
            await self._journal_and_apply({
                "op": "unlink", "parent": parent, "name": name,
                "ino": entry["ino"],
                "snapc": self._snapc_of(snaps), **rid,
            })
            self.caps.pop(entry["ino"], None)
            return {}
        if op == "rmdir":
            parent, name = await self._parent_and_name(p["path"])
            entry = (await self._entries(parent)).get(name)
            if entry is None or entry["type"] != "dir":
                raise MDSError("ENOENT", f"no directory {p['path']!r}")
            if await self._entries(entry["ino"]):
                raise MDSError(
                    "ENOTEMPTY", f"directory {p['path']!r} not empty"
                )
            await self._journal_and_apply({
                "op": "rmdir", "parent": parent, "name": name,
                "ino": entry["ino"], **rid,
            })
            return {}
        if op == "rename":
            sparent, sname = await self._parent_and_name(p["src"])
            dparent, dname = await self._parent_and_name(p["dst"])
            entry = (await self._entries(sparent)).get(sname)
            if entry is None:
                raise MDSError("ENOENT", f"no entry {p['src']!r}")
            await self._journal_and_apply({
                "op": "rename", "sparent": sparent, "sname": sname,
                "dparent": dparent, "dname": dname,
                "ino": entry["ino"], "type": entry["type"], **rid,
            })
            return {}
        raise MDSError("EINVAL", f"unknown mds op {op!r}")
