"""coord.fleet: the multi-host training-fleet runtime.

One RADOS object per fleet — `fleet.<name>.roster` — carries all three
coordination roles, each on its own consistency primitive:

  * **registration**: the member set is a HEAD-CAS-published document
    (the `ckpt.cas_head` cls — same EC-safe xattr CAS the checkpoint
    commit point uses), so joins/evictions are atomic read-modify-write
    cycles with a monotonically versioned history;
  * **liveness**: each member holds the SHARED lease lock `members`
    (cookie = host id) and renews it from Lock's renew loop — a lapsed
    lease is the death signal, breakable by any survivor;
  * **leadership**: the EXCLUSIVE lease lock `leader`; election is just
    `acquire(block=False, break_dead=True)` — a dead leader's lease
    expires and the first survivor through breaks + takes it.

Barriers are per-epoch objects (`fleet.<name>.barrier.<epoch>`): each
host ARRIVES by taking a non-expiring shared lock (cookie = host id)
and the barrier completes when the arrival set covers the live member
set — which shrinks when the leader evicts lapsed members, so a host
dying mid-barrier releases the survivors instead of wedging them.
Waiters ride watch/notify; the poll interval is a lost-notify fallback.

Ranks are positions in the sorted live-member list: every host derives
the same (rank, num_hosts) from the same roster read, which is what the
data iterator's strided partition and the per-rank sharded restore key
off (coord.driver).
"""

from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch.coord.lock import Lock, make_coord_perf
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError


class FleetError(RadosError):
    pass


class Fleet:
    def __init__(self, ioctx, name: str, host_id: str, *,
                 config=None, perf=None, on_change=None):
        self.ioctx = ioctx
        self.name = name
        self.host_id = host_id
        self.config = (config if config is not None
                       else ioctx.objecter.config)
        self.perf = perf if perf is not None else make_coord_perf(name)
        self.lease = float(self.config.get("coord_lease"))
        self.roster_obj = f"fleet.{name}.roster"
        self.joined = False
        #: set when OUR member lease lapsed and was broken — we may have
        #: been evicted; stop acting on fleet state until re-join
        self.fenced = False
        self._callbacks = [] if on_change is None else [on_change]
        self._barrier_epoch = 0
        self._watching = False
        self._roster_wake = asyncio.Event()
        self._member_lock = Lock(
            ioctx, self.roster_obj, "members",
            owner=host_id, cookie=host_id, shared=True, lease=self.lease,
            description="fleet member heartbeat", perf=self.perf,
            on_lost=self._member_lease_lost,
        )
        self._leader_lock = Lock(
            ioctx, self.roster_obj, "leader",
            owner=host_id, cookie=host_id, lease=self.lease,
            description="fleet leader", perf=self.perf,
            on_lost=self._leadership_lost,
        )

    @property
    def tracer(self):
        return self.ioctx.objecter.tracer

    @property
    def is_leader(self) -> bool:
        return self._leader_lock.locked

    def on_change(self, cb) -> None:
        """`cb(event, host_id)` on join/leave/evict/leader/lease_lost."""
        self._callbacks.append(cb)

    # -- membership ------------------------------------------------------------

    async def join(self) -> tuple[int, int]:
        """Register: heartbeat lease first (so the roster never lists a
        member with no lease backing it), then CAS ourselves into the
        roster document. Returns (rank, num_hosts)."""
        await self._member_lock.acquire(block=False)
        self.fenced = False
        await self._roster_cas(add=self.host_id)
        if not self._watching:
            try:
                await self.ioctx.watch(
                    self.roster_obj, self._on_roster_notify,
                    cookie=f"fleet.{self.host_id}",
                )
                self._watching = True
            except RadosError:
                pass
        self.joined = True
        await self._notify_roster("join")
        return await self.rank()

    async def leave(self) -> None:
        """Orderly exit: drop leadership, deregister, stop the lease."""
        if self.is_leader:
            await self._leader_lock.release()
        try:
            await self._roster_cas(remove=self.host_id)
        except RadosError:
            pass
        await self._member_lock.release()
        self.joined = False
        await self._notify_roster("leave")
        await self._unwatch()

    async def close(self) -> None:
        """Drop in-process state without touching the roster (crash
        simulation / emergency teardown: the lease lapses on its own)."""
        self._member_lock._stop_renew()
        self._leader_lock._stop_renew()
        self._member_lock.locked = False
        self._leader_lock.locked = False
        await self._unwatch()

    async def members(self) -> dict:
        """Roster document joined with lease liveness: host_id ->
        {alive, lease_ttl, lease_age, joined}."""
        head = await self._read_roster()
        info = await self.ioctx.exec(
            self.roster_obj, "lock", "get_info", {"name": "members"}
        )
        now = info.get("now", 0.0)
        holders = {h["cookie"]: h for h in info["holders"]}
        out = {}
        for hid, meta in (head or {}).get("members", {}).items():
            h = holders.get(hid)
            out[hid] = dict(
                meta,
                alive=h is not None and not h.get("expired"),
                lease_ttl=None if h is None else h.get("ttl"),
                lease_age=(None if h is None
                           else max(0.0, now - h.get("since", now))),
            )
        return out

    async def live_members(self) -> list[str]:
        return sorted(h for h, m in (await self.members()).items()
                      if m["alive"])

    async def rank(self) -> tuple[int, int]:
        """(rank, num_hosts) from the sorted live-member list — the
        coordinates the data partition and sharded restore derive from."""
        live = await self.live_members()
        if self.host_id not in live:
            raise FleetError(
                f"ENOENT: {self.host_id!r} not a live member of "
                f"fleet {self.name!r}"
            )
        return live.index(self.host_id), len(live)

    # -- leadership ------------------------------------------------------------

    async def elect(self, *, block: bool = False,
                    timeout: float | None = None) -> bool:
        """Try to take (or keep) leadership; True when this host leads.
        A dead incumbent's expired lease is broken on the way in."""
        if self.is_leader:
            return True
        try:
            await self._leader_lock.acquire(
                block=block, timeout=timeout, break_dead=True
            )
        except (RadosError, TimeoutError) as e:
            if isinstance(e, RadosError) and "EBUSY" not in str(e):
                raise
            return False
        self.perf.inc("leader_changes")
        self._clog("INF", f"fleet {self.name}: leader changed to "
                          f"{self.host_id!r}")
        self._fire("leader", self.host_id)
        await self._notify_roster("leader")
        # a fresh leader reconciles the roster at once: the usual
        # reason the seat was vacant is that the incumbent died
        await self.sweep()
        return True

    async def leader(self) -> str | None:
        """The live leader's host id, or None when the seat is vacant
        (never held, released, or lease expired)."""
        info = await self.ioctx.exec(
            self.roster_obj, "lock", "get_info", {"name": "leader"}
        )
        for h in info["holders"]:
            if not h.get("expired"):
                return h["owner"]
        return None

    async def sweep(self) -> list[str]:
        """Leader-only: evict roster members whose lease lapsed (break
        the lease with the cls-side if_expired guard, then CAS them out
        of the roster). Returns the evicted host ids."""
        if not self.is_leader:
            return []
        head = await self._read_roster()
        info = await self.ioctx.exec(
            self.roster_obj, "lock", "get_info", {"name": "members"}
        )
        holders = {h["cookie"]: h for h in info["holders"]}
        evicted = []
        for hid in list((head or {}).get("members", {})):
            if hid == self.host_id:
                continue
            h = holders.get(hid)
            if h is not None and not h.get("expired"):
                continue
            if h is not None:
                try:
                    await self._member_lock.break_holder(
                        hid, hid, if_expired=True
                    )
                except ObjectNotFound:
                    pass  # already broken: still evict from the roster
                except RadosError:
                    continue  # renewed under us: still alive
            await self._roster_cas(remove=hid)
            self._clog("WRN", f"fleet {self.name}: host lease expired: "
                              f"{hid!r} evicted")
            self._fire("evict", hid)
            evicted.append(hid)
        if evicted:
            await self._notify_roster("evict")
        return evicted

    async def _maintain(self) -> None:
        """Self-heal from any wait point: fill a vacant leader seat,
        then (as leader) evict lapsed members. Every barrier waiter
        runs this, so a dead leader cannot wedge the fleet."""
        if not self.is_leader and await self.leader() is None:
            await self.elect()
        if self.is_leader:
            await self.sweep()

    # -- barriers --------------------------------------------------------------

    def _barrier_obj(self, epoch: int, tag: str | None = None) -> str:
        if tag is not None:
            return f"fleet.{self.name}.barrier.{tag}.{epoch}"
        return f"fleet.{self.name}.barrier.{epoch}"

    async def barrier(self, *, timeout: float | None = None,
                      epoch: int | None = None,
                      members: list[str] | None = None,
                      tag: str | None = None) -> int:
        """Arrive at the epoch barrier and wait until every LIVE member
        has arrived. Returns the epoch number passed.

        `members` restricts the barrier to an explicit SUB-GROUP: it
        completes when (members ∩ live) ⊆ arrived, so pipeline stages
        (or a parallel save's writer set) barrier independently of the
        full roster, and a sub-group member dying still releases the
        survivors via the usual eviction shrink. `tag` namespaces the
        barrier object (e.g. one per save_id) without consuming the
        fleet-wide epoch counter."""
        if epoch is None:
            epoch = 0 if tag is not None else self._barrier_epoch
        if tag is None:
            self._barrier_epoch = epoch + 1
        obj = self._barrier_obj(epoch, tag)
        span = self.tracer.start(
            "coord_barrier",
            tags={"fleet": self.name, "epoch": epoch,
                  "host": self.host_id,
                  **({"tag": tag} if tag is not None else {})},
            op_type="coord_barrier",
        )
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        arrive = Lock(
            self.ioctx, obj, "arrive",
            owner=self.host_id, cookie=self.host_id, shared=True,
            lease=0,  # arrivals persist until the object is groomed
        )
        wake = asyncio.Event()
        watch_cookie = f"bar.{self.host_id}"
        watching = False
        try:
            await arrive.acquire(block=False)
            try:
                await self.ioctx.watch(
                    obj, lambda n, p: wake.set(), cookie=watch_cookie
                )
                watching = True
            except RadosError:
                pass
            try:
                await self.ioctx.notify(
                    obj, json.dumps({"barrier": epoch,
                                     "host": self.host_id}),
                    timeout=1.0,
                )
            # cephlint: disable=error-taxonomy (barrier wakeups are best-effort; pollers converge anyway)
            except Exception:  # noqa: BLE001
                pass
            poll = float(self.config.get("coord_barrier_poll"))
            stragglers: set = set()
            while True:
                try:
                    info = await self.ioctx.exec(
                        obj, "lock", "get_info", {"name": "arrive"}
                    )
                    arrived = {h["cookie"] for h in info["holders"]}
                except RadosError:
                    arrived = set()
                if self.host_id not in arrived:
                    # our arrival persists (lease=0) until the object is
                    # groomed, and grooming happens strictly AFTER the
                    # barrier completed — racing in behind the groom IS
                    # completion, not a straggle
                    break
                live = await self.live_members()
                want = (set(live) if members is None
                        else set(members) & set(live))
                if want and want <= arrived:
                    break
                stragglers = want - arrived
                await self._maintain()  # evictions shrink `live`
                wake.clear()
                wait = poll
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"barrier {epoch} timed out waiting for "
                            f"{sorted(stragglers)}"
                        )
                    wait = min(poll, remaining)
                try:
                    await asyncio.wait_for(wake.wait(), timeout=wait)
                except asyncio.TimeoutError:
                    pass
            dt = time.monotonic() - t0
            self.perf.tinc("barrier_wait", dt)
            self.perf.hinc("barrier_wait_ms", int(dt * 1000))
            self.perf.inc("barriers")
            if span is not None:
                span.set_tag("wait_s", round(dt, 6))
            # leader hygiene at the epoch edge: evict members whose
            # lease lapsed while everyone was arriving (the live-set
            # shrink that completed the barrier can race ahead of any
            # waiter's _maintain), and groom the barrier object two
            # epochs back — out of every live host's reach
            if self.is_leader:
                await self.sweep()
                if tag is None and epoch >= 2:
                    try:
                        await self.ioctx.remove(
                            self._barrier_obj(epoch - 2)
                        )
                    except RadosError:
                        pass
            return epoch
        finally:
            if watching:
                try:
                    await self.ioctx.unwatch(obj, cookie=watch_cookie)
                except RadosError:
                    pass
            if span is not None:
                span.finish()

    # -- status (fleet_tool) ---------------------------------------------------

    async def status(self) -> dict:
        head = await self._read_roster()
        info = await self.ioctx.exec(
            self.roster_obj, "lock", "get_info", {"name": "leader"}
        )
        leader = next(
            (h for h in info["holders"] if not h.get("expired")), None
        )
        return {
            "fleet": self.name,
            "roster_version": None if head is None else head["save_id"],
            "members": await self.members(),
            "leader": None if leader is None else leader["owner"],
            "leader_ttl": None if leader is None else leader.get("ttl"),
        }

    # -- roster document (HEAD-CAS) --------------------------------------------

    async def _read_roster(self) -> dict | None:
        try:
            rep = await self.ioctx.exec(
                self.roster_obj, "ckpt", "read_head", {}
            )
        except ObjectNotFound:
            return None
        return rep["head"]

    async def _roster_cas(self, add: str | None = None,
                          remove: str | None = None) -> dict:
        """One atomic roster edit; retries the CAS on racing editors."""
        while True:
            head = await self._read_roster()
            members = dict((head or {}).get("members", {}))
            ver = 0 if head is None else int(head["save_id"][1:])
            if add is not None:
                members[add] = dict(
                    members.get(add) or {"joined": time.time()}
                )
            if remove is not None:
                members.pop(remove, None)
            new = {"save_id": f"r{ver + 1:08d}", "fleet": self.name,
                   "members": members}
            try:
                await self.ioctx.exec(
                    self.roster_obj, "ckpt", "cas_head",
                    {"expect": None if head is None else head["save_id"],
                     "head": new},
                )
                return new
            except RadosError as e:
                if "ECANCELED" not in str(e):
                    raise

    # -- events ----------------------------------------------------------------

    def _on_roster_notify(self, name: str, payload) -> None:
        self._roster_wake.set()
        try:
            msg = json.loads(payload) if payload else {}
        except (TypeError, ValueError):
            msg = {}
        event = msg.get("event")
        host = msg.get("host")
        if event and host != self.host_id:
            self._fire(event, host)

    async def _notify_roster(self, event: str) -> None:
        try:
            await self.ioctx.notify(
                self.roster_obj,
                json.dumps({"fleet": self.name, "event": event,
                            "host": self.host_id}),
                timeout=1.0,
            )
        # cephlint: disable=error-taxonomy (roster notify is best-effort; watchers also poll)
        except Exception:  # noqa: BLE001
            pass

    def _member_lease_lost(self, lock) -> None:
        # our heartbeat was broken: assume evicted until re-join
        self.fenced = True
        self._fire("lease_lost", self.host_id)

    def _leadership_lost(self, lock) -> None:
        self._fire("leader_lost", self.host_id)

    def _fire(self, event: str, host: str) -> None:
        for cb in self._callbacks:
            try:
                cb(event, host)
            except Exception as e:  # noqa: BLE001
                # a broken subscriber must not block the others, but its
                # failure should land in the cluster log, not vanish
                self._clog("ERR",
                           f"fleet {self.name}: callback failed for "
                           f"{event!r}: {e!r}")

    async def _unwatch(self) -> None:
        if not self._watching:
            return
        self._watching = False
        try:
            await self.ioctx.unwatch(
                self.roster_obj, cookie=f"fleet.{self.host_id}"
            )
        except RadosError:
            pass

    def _clog(self, level: str, message: str) -> None:
        try:
            self.ioctx.objecter.mon.cluster_log(level, message)
        # cephlint: disable=error-taxonomy (the log path itself must never throw)
        except Exception:  # noqa: BLE001
            pass
