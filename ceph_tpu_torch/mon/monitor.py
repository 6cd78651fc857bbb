"""Monitor: rank election + Paxos commits + the OSDMonitor service.

Shapes mirrored from the reference (src/mon):

  * Election by rank (Elector.cc): every mon proposes itself; a mon that
    hears a proposal from a LOWER rank defers and acks, a higher-ranked
    proposal makes it counter-propose; the proposer declares victory once a
    majority (counting itself) acks. The election epoch rises monotonically
    and fences stale traffic.
  * Paxos (Paxos.cc): the leader drives begin/accept/commit for one value
    at a time — versioned, strictly sequential (version = last_committed+1).
    Election acks double as the collect phase: they carry each peon's
    last_committed and any accepted-but-uncommitted value, so a new leader
    first syncs itself forward, re-proposes the highest-pn pending value,
    and brings lagging peons up with explicit catch-up entries. Proposal
    numbers are (election_epoch << 8 | rank) so every new reign outranks
    the last. Leases (px_lease) keep peons from calling elections while the
    leader is healthy; a missed lease window triggers one.
  * Services (PaxosService): every committed value is tagged with a service
    name; the only v1 service is "osdmap", whose values are OSDMap
    Incrementals (OSDMonitor.cc): pool/profile admin (EC profiles validated
    by instantiating the codec, OSDMonitor.cc:6814), osd boot registering
    the daemon's address, failure reports gated by
    mon_osd_min_down_reporters (prepare_failure, OSDMonitor.cc:2874), and
    pg-temp requests from peering primaries.
  * Subscriptions (Monitor::handle_subscribe): daemons/clients say "osdmap
    from epoch E" and receive the incrementals they miss (or a full map if
    too far behind), then every future commit as it happens.

All state that must survive a crash sits in a KeyValueDB under the "paxos"
and "osdmap" prefixes (MonitorDBStore role); a restarted mon rejoins with
its history intact.
"""

from __future__ import annotations

import asyncio
import json
import random
from dataclasses import dataclass

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.common.kv import KeyValueDB, KVTransaction, MemDB
from ceph_tpu_torch.common.tracer import Tracer
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.msg import Dispatcher, Message, Messenger, Policy
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap

_META = b"paxos_meta"
_VALS = b"paxos"


def _vkey(version: int) -> bytes:
    return b"%016x" % version


@dataclass
class MonMap:
    """rank -> address; names are mon.<rank> (the reference's MonMap)."""

    addrs: list[tuple[str, int]]
    #: optional rank -> uds:// endpoint for co-located peers (vstart
    #: fills this in); None entries / a missing list mean TCP only
    local_addrs: list | None = None

    @property
    def size(self) -> int:
        return len(self.addrs)

    @property
    def majority(self) -> int:
        return self.size // 2 + 1

    def name(self, rank: int) -> str:
        return f"mon.{rank}"


class Monitor(Dispatcher):
    def __init__(
        self,
        rank: int,
        monmap: MonMap,
        initial_osdmap: OSDMap,
        db: KeyValueDB | None = None,
        config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        device=None,
    ):
        self.rank = rank
        #: where profile validation instantiates codecs (None = cuda, which
        #: raises without a card); the monitor launches no kernel
        self.device = resolve_device(device)
        self.monmap = monmap
        self.config = config if config is not None else Config()
        self.db = db if db is not None else MemDB()
        self.name = monmap.name(rank)
        #: live keyring the messenger authenticates against; the auth
        #: service's committed entities are folded in (AuthMonitor's
        #: KeyServer feeding the transport), so adding a client via
        #: `auth get-or-create` immediately lets it connect
        self._keyring = keyring
        self.messenger = Messenger(
            self.name, config=self.config, keyring=keyring
        )
        self.messenger.dispatcher = self
        #: control-plane spans (mon command dispatch): `dump_tracing`
        #: trees grow mon hops when a traced client sends a command
        self.tracer = Tracer(self.name, config=self.config)
        self.messenger.tracer = self.tracer

        # election state
        self.state = "electing"
        self.election_epoch = self._load_u64(b"election_epoch", 0)
        self.leader_rank: int | None = None
        self.quorum: set[int] = set()
        self._acks: dict[int, dict] = {}
        self._election_task: asyncio.Task | None = None
        self._lease_task: asyncio.Task | None = None
        self._last_lease = 0.0
        #: leader-side: peon rank -> last px_lease_ack time
        self._lease_acks: dict[int, float] = {}

        # paxos state (persisted)
        self.last_committed = self._load_u64(b"last_committed", 0)
        self.promised_pn = self._load_u64(b"promised_pn", 0)
        self._pending = self._load_pending()
        self._propose_q: list[tuple[str, bytes, asyncio.Future]] = []
        self._in_flight: dict | None = None

        # osdmap service state
        self.osdmap = OSDMap.decode(initial_osdmap.encode())
        self._osdmap_base_epoch = self.osdmap.epoch
        #: the centralized config service's kv (ConfigMonitor's store):
        #: rebuilt deterministically from the committed paxos log
        self.config_kv: dict[str, str] = {}
        #: map epoch -> paxos version that produced it (services share
        #: one paxos log, so the 1:1 version<->epoch shortcut is gone)
        self._epoch_versions: dict[int, int] = {}
        #: (pool, ps) -> [(epoch, acting, primary)] acting-set intervals,
        #: rebuilt deterministically at replay — the past_intervals
        #: source peering consults so a stale quorum can never go active
        #: without contacting a possibly-newer interval's member
        self._acting_archive: dict[tuple, list] = {}
        #: osd -> sorted committed up_thru values (the osd_info_t
        #: up_thru history interval math consults): a past interval is
        #: maybe_went_rw only if its primary confirmed an up_thru
        #: WITHIN it — rebuilt deterministically at replay
        self._up_thru_archive: dict[int, list] = {}
        #: osd -> highest PRUNED up_thru value: intervals at or below it
        #: cannot be proven write-free and stay conservatively rw
        self._up_thru_floor: dict[int, int] = {}
        self._last_applied_service = ""
        #: leader-volatile PG stats reports: osd -> (mono time, stats)
        #: — the PGMap/MgrStatMonitor role feeding health checks; a new
        #: leader rebuilds it from the next report wave
        self._pg_stats: dict[int, tuple[float, dict]] = {}
        #: AuthMonitor state (paxos-replicated via the "auth" service):
        #: entity -> secret, and per-service rotating key windows
        #: (service -> epoch -> secret, the RotatingSecrets role)
        self.auth_db: dict[str, bytes] = {}
        self.rotating: dict[str, dict[int, bytes]] = {}
        #: FSMap-lite (the MDSMap role, src/mds/FSMap.h): one active
        #: metadata daemon + standbys, paxos-replicated via the "fsmap"
        #: service; beacons (leader-volatile) drive failover promotion
        self.fsmap: dict = {"epoch": 0, "active": None, "standbys": []}
        #: MgrMap (MgrMonitor role, src/mon/MgrMonitor.cc): one active
        #: manager + standbys, paxos-replicated via the "mgrmap" service;
        #: gives the module tier (balancer/autoscaler/prometheus) a
        #: daemon lifecycle instead of running as client library code
        self.mgrmap: dict = {
            "epoch": 0, "active": None, "standbys": [], "addrs": {},
        }
        self._mgr_beacons: dict[str, float] = {}
        #: mgr name -> report-endpoint addr from its beacon
        #: (leader-volatile; published through mgrmap proposes so OSDs
        #: learn where to push their perf reports)
        self._mgr_addrs: dict[str, list] = {}
        #: (stamp, checks) the ACTIVE mgr last fed us (MgrStatMonitor's
        #: health segment: SLO violations etc.); leader-volatile, merged
        #: into _health() while fresh
        self._mgr_health: tuple[float, dict] | None = None
        self._mds_beacons: dict[str, float] = {}
        self._replay_committed()
        #: peer_name -> (connection, from_epoch) map subscribers
        self._subs: dict[str, object] = {}
        #: failed osd -> set of reporter names (OSDMonitor failure_info)
        self._failure_reports: dict[int, set[str]] = {}
        #: reports received while leaderless, flushed post-election
        self._stashed_reports: list[tuple[str, dict]] = []
        #: cluster log (LogMonitor summary role): daemon warning events
        #: forwarded via MonClient.cluster_log, leader-local and bounded
        #: (non-durable — a leader change starts a fresh tail, like the
        #: reference's in-memory summary before the paxos write)
        self._cluster_log: list[dict] = []
        #: pool -> highest snap id handed out but possibly uncommitted
        self._pending_snap_seq: dict[int, int] = {}
        self._tasks: list[asyncio.Task] = []
        self._ephemeral: set[asyncio.Task] = set()
        self._stopped = False

    # -- persistence helpers --------------------------------------------------

    def _load_u64(self, key: bytes, default: int) -> int:
        raw = self.db.get(_META, key)
        return default if raw is None else Decoder(raw).u64()

    def _store_meta(self, txn: KVTransaction, key: bytes, v: int) -> None:
        txn.set(_META, key, Encoder().u64(v).bytes())

    def _load_pending(self):
        raw = self.db.get(_META, b"pending")
        if raw is None:
            return None
        d = Decoder(raw)
        return {"pn": d.u64(), "version": d.u64(), "value": d.blob()}

    def _store_pending(self, txn: KVTransaction, pending) -> None:
        if pending is None:
            txn.rm(_META, b"pending")
        else:
            txn.set(
                _META,
                b"pending",
                Encoder()
                .u64(pending["pn"])
                .u64(pending["version"])
                .blob(pending["value"])
                .bytes(),
            )

    def _replay_committed(self) -> None:
        """Rebuild the in-memory osdmap from the committed paxos log."""
        for v in range(1, self.last_committed + 1):
            raw = self.db.get(_VALS, _vkey(v))
            if raw is not None:
                self._apply_value(v, raw)

    # -- lifecycle ------------------------------------------------------------

    async def bind(self) -> None:
        """Bind the endpoint; port 0 back-fills the shared monmap with the
        kernel-assigned port (test clusters bind everyone before anyone
        campaigns, so peer addresses are always real)."""
        host, port = self.monmap.addrs[self.rank]
        local_path = None
        if self.monmap.local_addrs:
            ep = self.monmap.local_addrs[self.rank]
            if ep and ep.startswith("uds://"):
                # deterministic path so clients can dial it from the
                # shared monmap without a prior TCP round trip
                local_path = ep[len("uds://"):]
        await self.messenger.bind(host, port, local_path=local_path)
        self.monmap.addrs[self.rank] = tuple(self.messenger.my_addr)

    def go(self) -> None:
        self._tasks.append(asyncio.create_task(self._lease_watchdog()))
        self.start_election()

    async def start(self) -> None:
        await self.bind()
        self.go()

    async def stop(self) -> None:
        self._stopped = True
        for extra in (self._election_task, self._lease_task):
            if extra is not None:
                self._tasks.append(extra)
        self._election_task = self._lease_task = None
        for t in list(self._tasks) + list(self._ephemeral):
            t.cancel()
        for t in list(self._tasks) + list(self._ephemeral):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        await self.messenger.shutdown()
        self.tracer.close()

    @property
    def is_leader(self) -> bool:
        return self.state == "leader"

    def _peer_conn(self, rank: int):
        la = self.monmap.local_addrs
        return self.messenger.connect(
            tuple(self.monmap.addrs[rank]),
            Policy.lossless_client(),
            local_addr=la[rank] if la else None,
        )

    def _bcast(self, msg_type: str, payload: dict) -> None:
        data = json.dumps(payload).encode()
        for r in range(self.monmap.size):
            if r != self.rank:
                self._peer_conn(r).send_message(
                    Message(type=msg_type, data=data)
                )

    def _send(self, rank_or_conn, msg_type: str, payload: dict) -> None:
        data = json.dumps(payload).encode()
        conn = (
            self._peer_conn(rank_or_conn)
            if isinstance(rank_or_conn, int)
            else rank_or_conn
        )
        conn.send_message(Message(type=msg_type, data=data))

    # -- election -------------------------------------------------------------

    def _abort_proposals(self) -> None:
        """Fail the in-flight and queued proposals on leadership loss:
        their awaiting handlers reply an error and the reporter retries
        against the new reign (a hung future would wedge its connection's
        dispatch loop forever)."""
        err = RuntimeError("leadership lost mid-proposal")
        fl, self._in_flight = self._in_flight, None
        if fl is not None and fl["fut"] is not None and not fl["fut"].done():
            fl["fut"].set_exception(err)
        q, self._propose_q = self._propose_q, []
        for _service, _value, fut in q:
            if not fut.done():
                fut.set_exception(err)

    def start_election(self) -> None:
        if self._stopped:
            return
        if self.state == "leader":
            self._abort_proposals()
        self.state = "electing"
        self.leader_rank = None
        self.election_epoch += 1
        txn = KVTransaction()
        self._store_meta(txn, b"election_epoch", self.election_epoch)
        self.db.submit_transaction(txn)
        self._acks = {}
        self._bcast(
            "el_propose",
            {
                "epoch": self.election_epoch,
                "rank": self.rank,
                "last_committed": self.last_committed,
            },
        )
        if self._election_task is not None:
            self._election_task.cancel()
        self._election_task = asyncio.create_task(self._election_timer())
        # single-mon cluster: instant victory
        self._maybe_win()

    async def _election_timer(self) -> None:
        timeout = self.config.get("mon_election_timeout")
        await asyncio.sleep(timeout * (1 + random.random() * 0.2))
        if self.state == "electing" and not self._stopped:
            self.start_election()

    def _maybe_win(self) -> None:
        if self.state != "electing":
            return
        if len(self._acks) + 1 >= self.monmap.majority:
            self.state = "leader"
            self.leader_rank = self.rank
            self._promise_reign(self.election_epoch, self.rank)
            self.quorum = {self.rank} | set(self._acks)
            self._bcast(
                "el_victory",
                {
                    "epoch": self.election_epoch,
                    "leader": self.rank,
                    "quorum": sorted(self.quorum),
                },
            )
            if self._election_task is not None:
                self._election_task.cancel()
                self._election_task = None
            if self._lease_task is not None:
                self._lease_task.cancel()
            self._lease_task = asyncio.create_task(self._lease_loop())
            self._flush_stashed_reports()
            self._tasks.append(
                asyncio.create_task(self._post_election_sync())
            )

    async def _post_election_sync(self) -> None:
        """Collect phase: catch up from any peon ahead of us, then
        re-propose the highest-pn uncommitted value (Paxos.cc collect/
        handle_last semantics)."""
        ahead = [
            (info["last_committed"], r)
            for r, info in self._acks.items()
            if info["last_committed"] > self.last_committed
        ]
        if ahead:
            _, r = max(ahead)
            self._send(
                r, "px_fetch", {"from": self.last_committed + 1,
                                "to_rank": self.rank}
            )
            return  # sync continues when entries arrive
        self._finish_election_sync()

    def _finish_election_sync(self) -> None:
        pendings = [
            info["pending"]
            for info in self._acks.values()
            if info.get("pending") is not None
        ]
        if self._pending is not None:
            pendings.append(
                {
                    "pn": self._pending["pn"],
                    "version": self._pending["version"],
                    "value": self._pending["value"].hex(),
                }
            )
        live = [
            p for p in pendings if p["version"] == self.last_committed + 1
        ]
        if live:
            best = max(live, key=lambda p: p["pn"])
            self._drive_proposal(bytes.fromhex(best["value"]), None)
        self._kick_propose_queue()

    async def _lease_loop(self) -> None:
        interval = self.config.get("mon_lease")
        factor = self.config.get("mon_lease_ack_timeout_factor")
        loop = asyncio.get_event_loop()
        self._lease_acks = {r: loop.time() for r in range(self.monmap.size)}
        missed_rounds = 0
        while self.is_leader and not self._stopped:
            self._bcast(
                "px_lease",
                {"epoch": self.election_epoch,
                 "last_committed": self.last_committed},
            )
            await asyncio.sleep(interval)
            if not self.is_leader or self._stopped:
                return  # deposed mid-sleep: the new reign is not ours to judge
            # a leader partitioned from its quorum must step down rather
            # than keep proposing against a reign it no longer leads
            # (lease_ack_timeout in the reference forces a bootstrap).
            # Two consecutive failed rounds are required: a single stalled
            # event-loop step can delay every ack past the window without
            # any partition (all daemons share one loop in tests).
            fresh = sum(
                1 for r in range(self.monmap.size)
                if r != self.rank
                and loop.time() - self._lease_acks.get(r, 0)
                <= interval * factor
            )
            if self.monmap.size > 1 and fresh + 1 < self.monmap.majority:
                missed_rounds += 1
                if missed_rounds >= 2:
                    self.start_election()
                    return
            else:
                missed_rounds = 0

    async def _lease_watchdog(self) -> None:
        interval = self.config.get("mon_lease")
        factor = self.config.get("mon_lease_ack_timeout_factor")
        loop = asyncio.get_event_loop()
        self._last_lease = loop.time()
        while not self._stopped:
            await asyncio.sleep(interval)
            if self.state == "peon" and (
                loop.time() - self._last_lease > interval * factor
            ):
                self.start_election()

    # -- paxos ----------------------------------------------------------------

    def _pn(self) -> int:
        return (self.election_epoch << 8) | self.rank

    async def propose(self, service: str, payload: bytes) -> None:
        """Queue a value for commit; resolves when committed locally."""
        fut = asyncio.get_event_loop().create_future()
        value = Encoder().string(service).blob(payload).bytes()
        self._propose_q.append((service, value, fut))
        self._kick_propose_queue()
        await fut

    def _kick_propose_queue(self) -> None:
        if (
            self.is_leader
            and self._in_flight is None
            and self._propose_q
        ):
            _service, value, fut = self._propose_q.pop(0)
            self._drive_proposal(value, fut)

    def _drive_proposal(self, value: bytes, fut) -> None:
        """Synchronous on purpose: _in_flight must be claimed in the same
        event-loop step as the queue pop, or two queued proposals would
        both see it empty and race the same version."""
        version = self.last_committed + 1
        pn = self._pn()
        self._in_flight = {
            "pn": pn,
            "version": version,
            "value": value,
            "accepts": {self.rank},
            "fut": fut,
        }
        txn = KVTransaction()
        self._store_pending(
            txn, {"pn": pn, "version": version, "value": value}
        )
        self._store_meta(txn, b"promised_pn", pn)
        self.db.submit_transaction(txn)
        self.promised_pn = pn
        self._pending = {"pn": pn, "version": version, "value": value}
        self._bcast(
            "px_begin",
            {"epoch": self.election_epoch, "pn": pn, "version": version,
             "value": value.hex()},
        )
        self._check_accepts()

    def _check_accepts(self) -> None:
        fl = self._in_flight
        if fl is None:
            return
        if len(fl["accepts"]) >= self.monmap.majority:
            self._commit_value(fl["version"], fl["value"])
            self._bcast(
                "px_commit",
                {"epoch": self.election_epoch, "version": fl["version"],
                 "value": fl["value"].hex()},
            )
            if fl["fut"] is not None and not fl["fut"].done():
                fl["fut"].set_result(None)
            self._in_flight = None
            self._kick_propose_queue()

    def _commit_value(self, version: int, value: bytes) -> None:
        if version != self.last_committed + 1:
            return
        txn = KVTransaction()
        txn.set(_VALS, _vkey(version), value)
        self._store_meta(txn, b"last_committed", version)
        self._store_pending(txn, None)
        self.db.submit_transaction(txn)
        self.last_committed = version
        self._pending = None
        self._apply_value(version, value)
        if self._last_applied_service == "config":
            self._publish_config()
        else:
            self._publish_maps()

    def _apply_value(self, version: int, value: bytes) -> None:
        """Deterministic application: the effective map epoch of an inc
        is ALWAYS the current epoch + 1, regardless of the epoch the
        proposing handler guessed — two handlers racing to build incs
        would otherwise commit a value that every mon silently skips.
        Re-stamping is safe because every mon applies the same commit
        sequence and computes the same result."""
        d = Decoder(value)
        service = d.string()
        payload = d.blob()
        self._last_applied_service = service
        if service == "osdmap":
            inc = Incremental.decode(payload)
            inc.epoch = self.osdmap.epoch + 1
            self.osdmap.apply_incremental(inc)
            self._epoch_versions[inc.epoch] = version
            self._archive_actings(inc)
        elif service == "config":
            # {"set": {k: v}, "rm": [k]} — the ConfigMonitor delta
            delta = json.loads(payload)
            for k, v in delta.get("set", {}).items():
                self.config_kv[k] = v
            for k in delta.get("rm", []):
                self.config_kv.pop(k, None)
        elif service == "auth":
            # AuthMonitor delta: entity adds/removals + rotating-key
            # epochs; replayed deterministically like every service,
            # and folded into the live transport keyring so commits
            # take effect on the very next handshake
            delta = json.loads(payload)
            for entity, keyhex in delta.get("add", {}).items():
                self.auth_db[entity] = bytes.fromhex(keyhex)
                if self._keyring is not None:
                    self._keyring[entity] = bytes.fromhex(keyhex)
            for entity in delta.get("rm", []):
                self.auth_db.pop(entity, None)
                if self._keyring is not None:
                    self._keyring.pop(entity, None)
            for svc, epochs in delta.get("rotate", {}).items():
                window = self.rotating.setdefault(svc, {})
                for e, keyhex in epochs.items():
                    window[int(e)] = bytes.fromhex(keyhex)
                # keep a two-epoch window: current + previous (tickets
                # sealed under the old key stay valid through rotation)
                for old in sorted(window)[:-2]:
                    del window[old]
        elif service == "fsmap":
            # complete-state FSMap commits (MDSMonitor role): tiny map,
            # deltas would buy nothing
            new = json.loads(payload)
            new["epoch"] = self.fsmap["epoch"] + 1
            self.fsmap = new
        elif service == "mgrmap":
            new = json.loads(payload)
            new["epoch"] = self.mgrmap["epoch"] + 1
            self.mgrmap = new

    def _archive_actings(self, inc: Incremental) -> None:
        for osd, e in inc.new_up_thru.items():
            hist = self._up_thru_archive.setdefault(int(osd), [])
            if not hist or hist[-1] < int(e):
                hist.append(int(e))
                if len(hist) > 64:
                    # bounded like the acting archive — but pruning must
                    # stay SAFE: intervals older than the pruned horizon
                    # fall back to conservative rw=True via the floor
                    self._up_thru_floor[int(osd)] = hist[-65]
                    del hist[:-64]
        self._archive_actings_inner(inc)

    def _archive_actings_inner(self, inc: Incremental) -> None:
        """Append changed acting sets to the per-PG interval archive.
        Only PGs the inc can affect are recomputed: osd/crush/pool-level
        changes touch everything, pg_temp/upmap incs touch their named
        PGs, and snap/addr-only incs touch nothing."""
        osd_level = bool(
            inc.new_up or inc.new_down or inc.new_weight
            or inc.new_primary_affinity or inc.new_crush_text is not None
            or inc.new_max_osd is not None or inc.new_pools
            or inc.old_pools
        )
        if osd_level:
            targets = [
                (pid, ps)
                for pid, pool in self.osdmap.pools.items()
                for ps in range(pool.pg_num)
            ]
        else:
            named = (
                set(inc.new_pg_temp) | set(inc.new_primary_temp)
                | set(inc.new_pg_upmap) | set(inc.old_pg_upmap)
                | set(inc.new_pg_upmap_items)
                | set(inc.old_pg_upmap_items)
            )
            targets = [tuple(pg) for pg in named]
        for key in targets:
            pid, ps = key
            pool = self.osdmap.pools.get(pid)
            if pool is None or ps >= pool.pg_num:
                continue
            _up, _upp, acting, primary = (
                self.osdmap.pg_to_up_acting_osds(pid, ps)
            )
            arch = self._acting_archive.setdefault(key, [])
            if (
                not arch
                or arch[-1][1] != acting
                or arch[-1][2] != primary
            ):
                arch.append((self.osdmap.epoch, list(acting), primary))
                if len(arch) > 64:
                    # bounded: peers whose les predates the retained
                    # horizon are unbridgeable-stale anyway and take the
                    # backfill path on head comparison alone
                    del arch[: len(arch) - 64]

    # -- map subscription / publication ---------------------------------------

    def _inc_for_epoch(self, epoch: int) -> bytes | None:
        """Committed incremental bytes producing map `epoch`, if retained;
        served re-stamped with its effective epoch, matching what
        _apply_value applied (the stored bytes may carry a stale guess)."""
        v = self._epoch_versions.get(epoch)
        raw = self.db.get(_VALS, _vkey(v)) if v is not None else None
        if raw is None:
            return None
        d = Decoder(raw)
        if d.string() != "osdmap":
            return None
        inc = Incremental.decode(d.blob())
        inc.epoch = epoch
        return inc.encode()

    def _map_payload(self, from_epoch: int) -> dict:
        """Incrementals (from_epoch, current] or a full map."""
        incs = []
        e = from_epoch + 1
        while e <= self.osdmap.epoch:
            raw = self._inc_for_epoch(e)
            if raw is None:
                return {"full": self.osdmap.encode().hex(),
                        "epoch": self.osdmap.epoch}
            incs.append(raw.hex())
            e += 1
        return {"incs": incs, "epoch": self.osdmap.epoch}

    def _publish_config(self) -> None:
        """Push the committed config map to every subscriber (the
        ConfigMonitor's map distribution leg)."""
        for peer, (conn, _from_epoch) in list(self._subs.items()):
            if conn.is_connected:
                self._send(conn, "config_map", {"kv": self.config_kv})

    def _publish_maps(self) -> None:
        for peer, (conn, from_epoch) in list(self._subs.items()):
            if from_epoch >= self.osdmap.epoch:
                continue
            if not conn.is_connected:
                # dead accepted session: keep the entry (and its epoch
                # watermark) so the peer's reconnect re-attaches via
                # ms_handle_accept and receives the backlog
                continue
            self._send(conn, "osd_map", self._map_payload(from_epoch))
            self._subs[peer] = (conn, self.osdmap.epoch)

    # -- dispatch -------------------------------------------------------------

    #: handlers that may await a Paxos commit: they run as tasks, never
    #: inline — a proposal-awaiting handler inside dispatch stalls every
    #: later frame on that connection (command replies, subscriptions),
    #: and a pg_temp flood turns that into seconds of starvation
    _SLOW_HANDLERS = frozenset(
        {"osd_failure", "osd_boot", "pg_temp", "mon_command"}
    )

    async def ms_dispatch(self, conn, msg: Message) -> None:
        p = json.loads(msg.data) if msg.data else {}
        if msg.trace:
            p["_trace"] = msg.trace
        handler = getattr(self, f"_h_{msg.type}", None)
        if handler is None:
            return
        if msg.type in self._SLOW_HANDLERS:
            task = asyncio.create_task(self._run_shielded(handler, conn, p))
            self._ephemeral.add(task)
            task.add_done_callback(self._ephemeral.discard)
            return
        try:
            await handler(conn, p)
        except asyncio.CancelledError:
            raise
        # cephlint: disable=error-taxonomy (handler failures must not tear down the transport read loop)
        except Exception:
            # a handler failure (e.g. an aborted proposal) must not tear
            # down the transport read loop it runs in
            pass

    async def _run_shielded(self, handler, conn, p) -> None:
        try:
            await handler(conn, p)
        except asyncio.CancelledError:
            raise
        # cephlint: disable=error-taxonomy (reporters retry; commands replied their error already)
        except Exception:
            pass  # reporters retry; commands replied their error already

    async def ms_handle_accept(self, conn) -> None:
        # a reconnecting subscriber re-attaches at its old watermark and
        # immediately receives every epoch it missed while disconnected
        sub = self._subs.get(conn.peer_name)
        if sub is not None:
            _old_conn, from_epoch = sub
            self._subs[conn.peer_name] = (conn, from_epoch)
            if from_epoch < self.osdmap.epoch:
                self._send(conn, "osd_map", self._map_payload(from_epoch))
                self._subs[conn.peer_name] = (conn, self.osdmap.epoch)

    async def ms_handle_reset(self, conn) -> None:
        # losing the leader's session forces a new election
        if (
            self.state == "peon"
            and self.leader_rank is not None
            and conn.peer_name == self.monmap.name(self.leader_rank)
        ):
            self.start_election()

    # election messages

    def _promise_reign(self, epoch: int, rank: int) -> None:
        """Joining a reign IS a Paxos promise (Paxos::handle_collect bumps
        accepted_pn during collect for the same reason): once we ack an
        election proposal or accept a victory, any px_begin carrying a pn
        from an older reign must be rejected, or a deposed leader's
        in-flight begin could still reach majority and commit a different
        value at the same version the new leader is committing."""
        pn = (epoch << 8) | rank
        if pn > self.promised_pn:
            txn = KVTransaction()
            self._store_meta(txn, b"promised_pn", pn)
            self.db.submit_transaction(txn)
            self.promised_pn = pn

    async def _h_el_propose(self, conn, p) -> None:
        if p["epoch"] > self.election_epoch:
            self.election_epoch = p["epoch"]
            self.state = "electing"
        if p["rank"] < self.rank:
            self._promise_reign(p["epoch"], p["rank"])
            pending = None
            if self._pending is not None:
                pending = {
                    "pn": self._pending["pn"],
                    "version": self._pending["version"],
                    "value": self._pending["value"].hex(),
                }
            self._send(
                p["rank"],
                "el_ack",
                {
                    "epoch": p["epoch"],
                    "rank": self.rank,
                    "last_committed": self.last_committed,
                    "pending": pending,
                },
            )
            if self._election_task is not None:
                self._election_task.cancel()
            self._election_task = asyncio.create_task(
                self._election_timer()
            )
        elif self.state != "electing" or p["epoch"] >= self.election_epoch:
            # a higher rank is campaigning: counter-propose ourselves
            self.start_election()

    async def _h_el_ack(self, conn, p) -> None:
        if p["epoch"] != self.election_epoch:
            return
        if self.state == "leader":
            # a straggler acked after victory: fold it into the quorum and
            # re-announce so it becomes a peon of this reign
            if p["rank"] not in self.quorum:
                self._acks[p["rank"]] = p
                self.quorum.add(p["rank"])
                self._bcast(
                    "el_victory",
                    {"epoch": self.election_epoch, "leader": self.rank,
                     "quorum": sorted(self.quorum)},
                )
            return
        if self.state != "electing":
            return
        self._acks[p["rank"]] = p
        self._maybe_win()

    async def _h_el_victory(self, conn, p) -> None:
        if p["epoch"] < self.election_epoch:
            return
        if self.state == "leader":
            self._abort_proposals()
        self.election_epoch = p["epoch"]
        self._promise_reign(p["epoch"], p["leader"])
        self.state = "peon"
        self.leader_rank = p["leader"]
        self.quorum = set(p["quorum"])
        self._flush_stashed_reports()
        self._last_lease = asyncio.get_event_loop().time()
        if self._election_task is not None:
            self._election_task.cancel()
            self._election_task = None

    # paxos messages

    async def _h_px_begin(self, conn, p) -> None:
        if p["pn"] >= self.promised_pn and (
            p["version"] == self.last_committed + 1
        ):
            value = bytes.fromhex(p["value"])
            txn = KVTransaction()
            self._store_meta(txn, b"promised_pn", p["pn"])
            self._store_pending(
                txn,
                {"pn": p["pn"], "version": p["version"], "value": value},
            )
            self.db.submit_transaction(txn)
            self.promised_pn = p["pn"]
            self._pending = {
                "pn": p["pn"], "version": p["version"], "value": value
            }
            self._send(
                conn,
                "px_accept",
                {"pn": p["pn"], "version": p["version"],
                 "rank": self.rank},
            )
        else:
            self._send(
                conn,
                "px_nack",
                {"rank": self.rank,
                 "last_committed": self.last_committed,
                 "promised_pn": self.promised_pn},
            )

    async def _h_px_accept(self, conn, p) -> None:
        fl = self._in_flight
        if fl is not None and p["pn"] == fl["pn"] and (
            p["version"] == fl["version"]
        ):
            fl["accepts"].add(p["rank"])
            self._check_accepts()

    async def _h_px_nack(self, conn, p) -> None:
        # the peon is behind: ship it the committed entries it lacks
        if p["last_committed"] < self.last_committed:
            entries = {
                v: self.db.get(_VALS, _vkey(v)).hex()
                for v in range(p["last_committed"] + 1,
                               self.last_committed + 1)
            }
            self._send(
                p["rank"], "px_entries",
                {"entries": entries, "to_rank": p["rank"]},
            )
        elif self.is_leader and p.get("promised_pn", 0) > self._pn():
            # a peon promised a dead candidate of this very epoch a
            # higher pn than our reign's: our begins can never succeed
            # there. Re-electing bumps the epoch, and (epoch+1)<<8
            # outranks any promise from this epoch — classic Paxos
            # "retry with a higher proposal number", expressed through
            # the election that doubles as our collect phase.
            self.start_election()

    async def _h_px_commit(self, conn, p) -> None:
        value = bytes.fromhex(p["value"])
        if p["version"] == self.last_committed + 1:
            self._commit_value(p["version"], value)
        elif p["version"] > self.last_committed + 1 and (
            self.leader_rank is not None
        ):
            self._send(
                self.leader_rank, "px_fetch",
                {"from": self.last_committed + 1, "to_rank": self.rank},
            )

    async def _h_px_fetch(self, conn, p) -> None:
        entries = {}
        v = p["from"]
        while v <= self.last_committed:
            raw = self.db.get(_VALS, _vkey(v))
            if raw is not None:
                entries[v] = raw.hex()
            v += 1
        self._send(conn, "px_entries", {"entries": entries})

    async def _h_px_entries(self, conn, p) -> None:
        for v in sorted(int(k) for k in p["entries"]):
            if v == self.last_committed + 1:
                self._commit_value(v, bytes.fromhex(p["entries"][str(v)]))
        if self.is_leader:
            # a post-election sync may now be complete
            self._finish_election_sync()

    async def _h_px_lease(self, conn, p) -> None:
        if self.state == "peon":
            self._last_lease = asyncio.get_event_loop().time()
            self._send(
                conn, "px_lease_ack",
                {"epoch": p["epoch"], "rank": self.rank},
            )
            if p["last_committed"] > self.last_committed and (
                self.leader_rank is not None
            ):
                self._send(
                    self.leader_rank, "px_fetch",
                    {"from": self.last_committed + 1,
                     "to_rank": self.rank},
                )

    async def _h_px_lease_ack(self, conn, p) -> None:
        if self.is_leader and p["epoch"] == self.election_epoch:
            self._lease_acks[p["rank"]] = asyncio.get_event_loop().time()

    # subscriptions + client commands

    async def _h_sub(self, conn, p) -> None:
        self._subs[conn.peer_name] = (conn, p.get("from", 0))
        self._send(conn, "osd_map", self._map_payload(p.get("from", 0)))
        # always sent, even when empty: a resubscriber must LEARN that
        # central options were removed while it was away
        self._send(conn, "config_map", {"kv": self.config_kv})
        self._subs[conn.peer_name] = (conn, self.osdmap.epoch)

    async def _h_mon_command(self, conn, p) -> None:
        if not self.is_leader:
            self._send(
                conn, "mon_command_reply",
                {"tid": p.get("tid"), "redirect": self.leader_rank},
            )
            return
        # control-plane span: continue the client's trace when one rides
        # the message, else start a root sampled by
        # tracer_sample_rate_command
        span = self.tracer.join(
            p.get("_trace"), "mon_command", tags={"cmd": p.get("cmd")}
        ) or self.tracer.start(
            "mon_command", tags={"cmd": p.get("cmd")}, op_type="command"
        )
        token = self.tracer.use(span) if span is not None else None
        try:
            result = await self._run_command(p, conn)
            reply = {"tid": p.get("tid"), "ok": True, "result": result}
        except Exception as e:  # commands reply, never crash the mon
            reply = {"tid": p.get("tid"), "ok": False, "error": str(e)}
            if span is not None:
                span.set_tag("error", str(e) or type(e).__name__)
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()
        self._send(conn, "mon_command_reply", reply)

    def _forward_to_leader(self, msg_type: str, p: dict, conn) -> bool:
        """Peons forward one-way daemon reports to the leader (the
        reference's Monitor::forward_request_leader), tagging the original
        reporter so distinct-reporter counting survives the hop. Reports
        arriving while no leader is known are stashed and flushed when the
        election settles — dropping them would strand a booting OSD."""
        if self.is_leader:
            return False
        fwd = dict(p)
        fwd.setdefault("reporter", conn.peer_name if conn else self.name)
        if self.leader_rank is not None and self.leader_rank != self.rank:
            self._send(self.leader_rank, msg_type, fwd)
        else:
            self._stashed_reports.append((msg_type, fwd))
        return True

    def _flush_stashed_reports(self) -> None:
        stash, self._stashed_reports = self._stashed_reports, []

        async def run_shielded(handler, p):
            try:
                await handler(None, p)
            except asyncio.CancelledError:
                raise
            # cephlint: disable=error-taxonomy (proposal churn: the reporter re-reports)
            except Exception:
                pass  # proposal churn: the reporter re-reports

        for msg_type, p in stash:
            if self.is_leader:
                handler = getattr(self, f"_h_{msg_type}", None)
                if handler is not None:
                    self._tasks.append(
                        asyncio.create_task(run_shielded(handler, p))
                    )
            elif self.leader_rank is not None:
                self._send(self.leader_rank, msg_type, p)

    async def _h_osd_failure(self, conn, p) -> None:
        """OSDMonitor::prepare_failure: count distinct reporters."""
        if self._forward_to_leader("osd_failure", p, conn):
            return
        target = p["target"]
        if self.osdmap.is_down(target):
            return
        reporter = p.get("reporter") or (
            conn.peer_name if conn is not None else self.name
        )
        self._failure_reports.setdefault(target, set()).add(reporter)
        need = self.config.get("mon_osd_min_down_reporters")
        if len(self._failure_reports[target]) >= need:
            del self._failure_reports[target]
            await self._propose_osdmap(
                Incremental(epoch=self.osdmap.epoch + 1,
                            new_down=[target])
            )

    async def _h_log(self, conn, p) -> None:
        """LogMonitor-lite: daemons clog warning events (fence, read-EIO
        repair, slow request) here so self-heal activity is clusterwide
        visible via `log last <n>` instead of daemon-local dout lines."""
        if self._forward_to_leader("log", p, conn):
            return
        entry = {
            "stamp": p.get("stamp"),
            "who": p.get("reporter") or (
                conn.peer_name if conn is not None else self.name
            ),
            "level": p.get("level", "WRN"),
            "message": p.get("message", ""),
        }
        self._cluster_log.append(entry)
        limit = int(self.config.get("mon_cluster_log_entries"))
        if len(self._cluster_log) > limit:
            del self._cluster_log[: len(self._cluster_log) - limit]

    async def _h_osd_boot(self, conn, p) -> None:
        if self._forward_to_leader("osd_boot", p, conn):
            return
        osd = p["osd"]
        inc = Incremental(
            epoch=self.osdmap.epoch + 1,
            new_up=[osd],
            new_osd_addrs={osd: tuple(p["addr"])},
            # "" clears a previous instance's stale uds endpoint
            new_osd_local_addrs={osd: p.get("local_addr") or ""},
        )
        if osd >= self.osdmap.max_osd:
            inc.new_max_osd = osd + 1
        if p.get("location") and not self._in_crush(osd):
            # cluster expansion: a brand-new device announces its crush
            # location at boot and the mon places it in the hierarchy
            # (CrushLocation + `osd crush add` semantics) — without this
            # the new OSD would exist in the map but own no PGs
            text = self._crush_with_device(
                osd, p["location"], p.get("weight", 0x10000)
            )
            if text is not None:
                inc.new_crush_text = text
        self._failure_reports.pop(osd, None)
        await self._propose_osdmap(inc)

    def _in_crush(self, osd: int) -> bool:
        return any(
            osd in b.items for b in self.osdmap.crush.buckets.values()
        )

    def _crush_with_device(
        self, osd: int, location: dict, weight: int
    ) -> str | None:
        """Decompiled crush text with `osd` inserted under its location's
        host bucket (created under the root if new)."""
        from ceph_tpu_torch.crush import builder as cb
        from ceph_tpu_torch.crush.compiler import (
            compile_crushmap,
            decompile_crushmap,
        )
        from ceph_tpu_torch.crush.types import BucketAlg

        scratch = compile_crushmap(decompile_crushmap(self.osdmap.crush))
        host_name = location.get("host")
        if not host_name:
            return None
        by_name = {v: k for k, v in scratch.item_names.items()}
        host_id = by_name.get(host_name)
        if host_id is None:
            # new failure domain: create the host bucket under the root
            root_name = location.get("root")
            if root_name is not None:
                root_id = by_name.get(root_name)
            else:
                children = {
                    i for b in scratch.buckets.values()
                    for i in b.items if i < 0
                }
                root_id = min(
                    (bid for bid in scratch.buckets
                     if bid not in children),
                    default=None,
                )
            if root_id is None:
                return None
            # same bucket type as existing device-holding buckets (host)
            host_type = next(
                (b.type for b in scratch.buckets.values()
                 if any(i >= 0 for i in b.items)),
                1,
            )
            host_id = min(scratch.buckets) - 1
            host = cb.make_bucket(
                scratch, host_id, BucketAlg.STRAW2, host_type, [], [],
            )
            scratch.item_names[host_id] = host_name
            cb.bucket_add_item(scratch, root_id, host.id, 0)
        cb.bucket_add_item(scratch, host_id, osd, weight)
        return decompile_crushmap(scratch)

    async def _h_pg_temp(self, conn, p) -> None:
        """Peering primaries request temp mappings (MOSDPGTemp)."""
        if self._forward_to_leader("pg_temp", p, conn):
            return
        pg = tuple(p["pgid"])
        acting = list(p["acting"])
        if self.osdmap.pg_temp.get(pg, []) == acting:
            return
        await self._propose_osdmap(
            Incremental(epoch=self.osdmap.epoch + 1,
                        new_pg_temp={pg: acting})
        )

    # -- the OSDMonitor command surface ---------------------------------------

    async def _propose_osdmap(self, inc: Incremental) -> None:
        await self.propose("osdmap", inc.encode())

    async def _run_command(self, p: dict, conn=None) -> dict:
        cmd = p["cmd"]
        args = p.get("args", {})
        if cmd.startswith("auth "):
            return await self._cmd_auth(cmd, args, conn)
        if cmd == "osd pool create":
            return await self._cmd_pool_create(args)
        if cmd.startswith("osd tier "):
            # OSDMonitor's tier command family (`osd tier add|cache-mode|
            # set-overlay|remove-overlay|remove`): wires a CACHE pool in
            # front of a BASE pool (PrimaryLogPG.cc promote/flush paths
            # consume these pg_pool_t fields)
            import copy as _copy

            sub = cmd[len("osd tier "):]
            pools = self.osdmap.pools
            new_pools: dict = {}

            def edited(pid):
                if pid not in new_pools:
                    if pid not in pools:
                        raise ValueError(f"no pool {pid}")
                    new_pools[pid] = _copy.deepcopy(pools[pid])
                return new_pools[pid]

            if sub == "add":
                base, cache = int(args["base"]), int(args["cache"])
                if edited(cache).is_erasure():
                    raise ValueError("cache pool must be replicated")
                edited(cache).tier_of = base
            elif sub == "cache-mode":
                mode = args["mode"]
                if mode not in ("", "none", "writeback"):
                    raise ValueError(f"unsupported cache mode {mode!r}")
                pool = edited(int(args["pool"]))
                if pool.tier_of < 0:
                    raise ValueError("pool is not a tier")
                pool.cache_mode = "" if mode == "none" else mode
            elif sub == "set-overlay":
                base, cache = int(args["base"]), int(args["cache"])
                if edited(cache).tier_of != base:
                    raise ValueError("cache is not a tier of base")
                edited(base).read_tier = cache
                edited(base).write_tier = cache
            elif sub == "remove-overlay":
                base = int(args["base"])
                edited(base).read_tier = -1
                edited(base).write_tier = -1
            elif sub == "remove":
                base, cache = int(args["base"]), int(args["cache"])
                if (pools[base].read_tier == cache
                        or pools[base].write_tier == cache):
                    raise ValueError("remove the overlay first")
                edited(cache).tier_of = -1
                edited(cache).cache_mode = ""
            else:
                raise ValueError(f"unknown tier command {sub!r}")
            await self._propose_osdmap(
                Incremental(
                    epoch=self.osdmap.epoch + 1, new_pools=new_pools
                )
            )
            return {}
        if cmd == "osd blocklist":
            # OSDMonitor's `osd blocklist add|rm|ls` (the fencing lever:
            # src/osd/OSDMap.h:579 blacklist + options.cc
            # mon_osd_blacklist_default_expire). Entities are
            # "client.name" (all instances) or "client.name/nonce".
            import time as _time

            op = args.get("op", "add")
            if op == "ls":
                now = _time.time()
                return {"blocklist": {
                    k: v for k, v in self.osdmap.blocklist.items()
                    if v > now
                }}
            entity = args["entity"]
            if op == "add":
                expire = float(args.get("expire", 3600.0))
                await self._propose_osdmap(
                    Incremental(
                        epoch=self.osdmap.epoch + 1,
                        new_blocklist={
                            entity: _time.time() + expire
                        },
                    )
                )
            elif op == "rm":
                if entity in self.osdmap.blocklist:
                    await self._propose_osdmap(
                        Incremental(
                            epoch=self.osdmap.epoch + 1,
                            old_blocklist=[entity],
                        )
                    )
            else:
                raise ValueError(f"osd blocklist: unknown op {op!r}")
            return {}
        if cmd == "osd erasure-code-profile set":
            profile = dict(args["profile"])
            # validate by instantiating the codec (OSDMonitor.cc:6814)
            from ceph_tpu_torch.ec.registry import factory

            plugin = profile.get("plugin", "tpu")
            # the allowlist gates what PROFILES may name, not what the
            # registry holds: in-process callers can still factory() any
            # registered codec (OSDMonitor's osd_erasure_code_plugins check)
            allowed = self.config.get("osd_erasure_code_plugins").split()
            if plugin not in allowed:
                raise ValueError(
                    f"erasure-code plugin {plugin!r} not allowed by"
                    f" osd_erasure_code_plugins ({' '.join(allowed)})"
                )
            factory(plugin, {k: v for k, v in profile.items()
                             if k != "plugin"}, device=self.device)
            await self._propose_osdmap(
                Incremental(
                    epoch=self.osdmap.epoch + 1,
                    new_erasure_code_profiles={args["name"]: profile},
                )
            )
            return {}
        if cmd == "osd pool set":
            # pg_num growth (the autoscaler's lever): commits the new
            # pool geometry; OSDs split PGs on the map change
            pool = self.osdmap.pools.get(args["pool_id"])
            if pool is None:
                raise ValueError(f"no pool {args['pool_id']}")
            if args["name"] != "pg_num":
                raise ValueError(f"unsupported pool option {args['name']}")
            new_num = int(args["value"])
            if new_num < pool.pg_num:
                raise ValueError("pg_num can only grow")
            import copy

            newpool = copy.deepcopy(pool)
            newpool.pg_num = new_num
            newpool.pgp_num = new_num
            await self._propose_osdmap(
                Incremental(
                    epoch=self.osdmap.epoch + 1,
                    new_pools={args["pool_id"]: newpool},
                )
            )
            return {"pg_num": new_num}
        if cmd == "osd down":
            await self._propose_osdmap(
                Incremental(epoch=self.osdmap.epoch + 1,
                            new_down=[args["osd"]])
            )
            return {}
        if cmd == "osd out":
            await self._propose_osdmap(
                Incremental(epoch=self.osdmap.epoch + 1,
                            new_weight={args["osd"]: 0})
            )
            return {}
        if cmd == "osd in":
            await self._propose_osdmap(
                Incremental(epoch=self.osdmap.epoch + 1,
                            new_weight={args["osd"]: 0x10000})
            )
            return {}
        if cmd == "osd crush set":
            await self._propose_osdmap(
                Incremental(epoch=self.osdmap.epoch + 1,
                            new_crush_text=args["crush_text"])
            )
            return {}
        if cmd == "osd pg-upmap-items":
            # balancer-committed placement overrides (OSDMonitor's
            # osd pg-upmap-items command); mappings: {"pool.ps": [[f,t],..]}
            new_items = {}
            old_items = []
            for pgid, pairs in args["mappings"].items():
                pool_s, ps_s = pgid.split(".")
                pg = (int(pool_s), int(ps_s))
                if pairs:
                    new_items[pg] = [tuple(p) for p in pairs]
                else:
                    old_items.append(pg)
            await self._propose_osdmap(
                Incremental(
                    epoch=self.osdmap.epoch + 1,
                    new_pg_upmap_items=new_items,
                    old_pg_upmap_items=old_items,
                )
            )
            return {"applied": len(new_items), "removed": len(old_items)}
        if cmd == "osd up-thru":
            # OSDMonitor::prepare_alive: a primary confirms it is alive
            # in its current interval BEFORE serving writes; the commit
            # is what makes the interval maybe_went_rw for future
            # peering
            osd, e = int(args["osd"]), int(args["epoch"])
            if (
                0 <= osd < self.osdmap.max_osd
                and int(self.osdmap.osd_up_thru[osd]) < e
            ):
                await self._propose_osdmap(
                    Incremental(
                        epoch=self.osdmap.epoch + 1,
                        new_up_thru={osd: e},
                    )
                )
            return {"up_thru": (
                int(self.osdmap.osd_up_thru[osd])
                if 0 <= osd < self.osdmap.max_osd else 0
            )}
        if cmd == "pg history":
            # acting-set intervals since `from` (+ the one spanning it):
            # the past_intervals feed for peering's stale-quorum gate.
            # Bulk: {"queries": {"pool.ps": from}} answers every PG a
            # daemon hosts in ONE round trip — per-PG commands from every
            # daemon on every epoch would swamp the mon.
            def intervals_for(key, frm):
                arch = self._acting_archive.get(key, [])
                out = []
                for i, (epoch, acting, primary) in enumerate(arch):
                    is_last = i + 1 >= len(arch)
                    end = (
                        arch[i + 1][0] - 1 if not is_last
                        else self.osdmap.epoch
                    )
                    if end < frm:
                        continue
                    # maybe_went_rw (osd_types.h:3030 PastIntervals +
                    # check_new_interval's up_thru reasoning): a CLOSED
                    # interval whose primary never committed an up_thru
                    # inside it cannot have acked writes — peering may
                    # skip its members. The open interval is always
                    # conservatively rw.
                    rw = True
                    if not is_last and primary not in (-1, None):
                        rw = (
                            epoch <= self._up_thru_floor.get(
                                primary, -1
                            )
                            or any(
                                epoch <= v <= end
                                for v in self._up_thru_archive.get(
                                    primary, []
                                )
                            )
                        )
                    out.append([epoch, acting, primary, rw])
                return out

            if "queries" in args:
                return {
                    "histories": {
                        pgid: intervals_for(
                            tuple(int(x) for x in pgid.split(".")), frm
                        )
                        for pgid, frm in args["queries"].items()
                    }
                }
            key = (args["pgid"][0], args["pgid"][1])
            return {
                "intervals": intervals_for(key, args.get("from", 0))
            }
        if cmd == "config set":
            # validate against the typed schema before committing (the
            # ConfigMonitor rejects unknown/ill-typed options the same way)
            from ceph_tpu_torch.common.config import SCHEMA

            opt = SCHEMA.get(args["name"])
            if opt is None:
                raise ValueError(f"unknown option {args['name']!r}")
            opt.parse(args["value"])
            await self.propose(
                "config",
                json.dumps(
                    {"set": {args["name"]: str(args["value"])}}
                ).encode(),
            )
            return {}
        if cmd == "config rm":
            await self.propose(
                "config", json.dumps({"rm": [args["name"]]}).encode()
            )
            return {}
        if cmd == "config get":
            if args["name"] not in self.config_kv:
                raise ValueError(f"{args['name']!r} not set centrally")
            return {"value": self.config_kv[args["name"]]}
        if cmd == "config dump":
            return {"kv": dict(self.config_kv)}
        if cmd == "osd pool selfmanaged-snap create":
            # allocate the next snap id for the pool (the OSDMonitor leg
            # of rados_ioctx_selfmanaged_snap_create): committed through
            # Paxos so every client/OSD sees a consistent snap_seq.
            # Concurrent creates must not read the same committed seq —
            # a leader-local pending high-water covers ids whose commit
            # is still in flight (stale pendings after churn only skip
            # ids, never reuse them).
            pool = self.osdmap.pools.get(args["pool_id"])
            if pool is None:
                raise ValueError(f"no pool {args['pool_id']}")
            pid = args["pool_id"]
            snapid = max(
                pool.snap_seq, self._pending_snap_seq.get(pid, 0)
            ) + 1
            self._pending_snap_seq[pid] = snapid
            await self._propose_osdmap(
                Incremental(
                    epoch=self.osdmap.epoch + 1,
                    new_pool_snap_seq={args["pool_id"]: snapid},
                )
            )
            return {"snapid": snapid}
        if cmd == "osd pool selfmanaged-snap rm":
            pool = self.osdmap.pools.get(args["pool_id"])
            if pool is None:
                raise ValueError(f"no pool {args['pool_id']}")
            await self._propose_osdmap(
                Incremental(
                    epoch=self.osdmap.epoch + 1,
                    new_removed_snaps={
                        args["pool_id"]: [args["snapid"]]
                    },
                )
            )
            return {}
        if cmd == "status":
            fm = self._fsmap_out()
            return {
                "epoch": self.osdmap.epoch,
                "leader": self.leader_rank,
                "quorum": sorted(self.quorum),
                "election_epoch": self.election_epoch,
                "num_osds": self.osdmap.max_osd,
                "num_up": int(self.osdmap.osd_up.sum()),
                "pools": sorted(self.osdmap.pools),
                "health": self._health(),
                # the `ceph -s` service lines: mds and mgr states
                "fsmap": {
                    "actives": [
                        m["name"] for m in fm["actives"]
                    ],
                    "standbys": [
                        s["name"] for s in fm["standbys"]
                    ],
                },
                "mgrmap": {
                    "active": self.mgrmap.get("active"),
                    "standbys": list(
                        self.mgrmap.get("standbys", [])
                    ),
                },
            }
        if cmd == "df":
            # `ceph df` (the PGMap usage report): cluster totals +
            # per-osd utilization from the statfs riding pg stats
            now_df = asyncio.get_event_loop().time()
            per_osd = {}
            total = used = 0
            compressed = comp_original = 0
            for osd, (t, stats) in sorted(self._pg_stats.items()):
                st = stats.get("statfs")
                if not st or now_df - t > 30 or self.osdmap.is_down(
                    osd
                ):
                    continue
                per_osd[str(osd)] = st
                total += st["total"]
                used += st["used"]
                compressed += st.get("data_compressed", 0)
                comp_original += st.get("data_compressed_original", 0)
            out = {
                "total_bytes": total,
                "used_bytes": used,
                "avail_bytes": max(0, total - used),
                "osds": per_osd,
            }
            if comp_original:
                # the bluestore compression stat pair + derived ratio
                out["data_compressed"] = compressed
                out["data_compressed_original"] = comp_original
                out["compress_ratio"] = round(
                    compressed / comp_original, 4
                )
            return out
        if cmd == "log last":
            # `ceph log last <n>`: the tail of the cluster log
            n = int(args.get("n", 20) or 20)
            return {"lines": self._cluster_log[-n:]}
        if cmd == "pg stats report":
            # primaries report PG state sums (num/degraded/undersized/
            # backfilling/peering/inconsistent) — the PGStats flow that
            # feeds the reference's health checks via the mgr's PGMap
            self._pg_stats[int(args["osd"])] = (
                asyncio.get_event_loop().time(), dict(args["stats"])
            )
            return {}
        if cmd == "health":
            return self._health()
        if cmd == "mgr health report":
            # the ACTIVE mgr feeds module-computed checks (SLO
            # violations) into _health(); an empty checks dict clears.
            # Leader-volatile like _pg_stats: a new leader gets the
            # next tick's report
            if args.get("name") == self.mgrmap.get("active"):
                self._mgr_health = (
                    asyncio.get_event_loop().time(),
                    dict(args.get("checks") or {}),
                )
            return {}
        if cmd == "dump_tracing":
            # mon-side completed spans (command dispatch hops), the same
            # drain surface the OSD admin socket exposes
            return self.tracer.dump_tracing(
                drain=bool(args.get("drain", True))
            )
        if cmd == "mds beacon":
            return await self._cmd_mds_beacon(args)
        if cmd == "mgr beacon":
            return await self._cmd_mgr_beacon(args)
        if cmd == "mgr map":
            return {"mgrmap": self.mgrmap}
        if cmd == "fs map":
            return {"fsmap": self._fsmap_out()}
        raise ValueError(f"unknown command {cmd!r}")

    async def _cmd_mgr_beacon(self, args: dict) -> dict:
        """MgrMonitor::prepare_beacon-lite: same admit/promote shape as
        the MDS beacon flow — first beacon becomes active, later ones
        stand by, a standby's beacon promotes it once the active's
        silence exceeds mgr_beacon_grace."""
        name = args["name"]
        addr = args.get("addr")
        now = asyncio.get_event_loop().time()
        self._mgr_beacons[name] = now
        if addr is not None:
            self._mgr_addrs[name] = list(addr)
        mm = self.mgrmap
        if mm["active"] is not None:
            self._mgr_beacons.setdefault(mm["active"], now)
        known = ({mm["active"]} if mm["active"] else set()) | set(
            mm["standbys"]
        )
        grace = self.config.get("mgr_beacon_grace")
        propose = None
        if name not in known:
            if mm["active"] is None:
                propose = {"active": name, "standbys": mm["standbys"]}
            else:
                propose = {"active": mm["active"],
                           "standbys": mm["standbys"] + [name]}
        elif (
            mm["active"] is not None
            and mm["active"] != name
            and now - self._mgr_beacons.get(mm["active"], 0.0) > grace
            and name in mm["standbys"]
        ):
            propose = {
                "active": name,
                "standbys": [s for s in mm["standbys"] if s != name],
            }
        elif (
            addr is not None
            and (mm.get("addrs") or {}).get(name) != list(addr)
        ):
            # known mgr rebound its report endpoint (restart under the
            # same name): republish the map so daemons re-target
            propose = {"active": mm["active"],
                       "standbys": list(mm["standbys"])}
        if propose is not None:
            # _apply_value replaces the map wholesale, so every propose
            # must carry the addrs of all members it names forward
            members = set(propose["standbys"])
            if propose["active"] is not None:
                members.add(propose["active"])
            published = mm.get("addrs") or {}
            propose["addrs"] = {
                n: self._mgr_addrs.get(n, published.get(n))
                for n in members
                if self._mgr_addrs.get(n, published.get(n)) is not None
            }
            await self.propose("mgrmap", json.dumps(propose).encode())
        return {"mgrmap": self.mgrmap}

    async def _cmd_mds_beacon(self, args: dict) -> dict:
        """MDSMonitor::preprocess_beacon: record liveness, admit new
        daemons (first becomes active, later ones stand by), and promote
        a standby when the active's beacon has gone stale past
        mds_beacon_grace — the failover decision rides the next standby
        beacon, so no extra mon timer exists."""
        name, addr = args["name"], list(args["addr"])
        now = asyncio.get_event_loop().time()
        self._mds_beacons[name] = now
        fm = self._fsmap_out()
        actives = list(fm["actives"])
        standbys = list(fm["standbys"])
        max_mds = int(self.config.get("mds_max_active"))
        # beacons are leader-volatile: after a mon restart or leader
        # change the actives have no record yet — stamp them as seen NOW
        # so a standby's first beacon can't trigger a spurious failover
        for m in actives:
            self._mds_beacons.setdefault(m["name"], now)
        known = {m["name"] for m in actives} | {
            s["name"] for s in standbys
        }
        grace = self.config.get("mds_beacon_grace")
        propose = None
        me = {"name": name, "addr": addr}
        if name not in known:
            # admission: fill active RANKS up to max_mds (the FSMap's
            # multi-active ladder), then stand by
            if len(actives) < max_mds:
                propose = {"actives": actives + [me],
                           "standbys": standbys}
            else:
                propose = {"actives": actives,
                           "standbys": standbys + [me]}
        elif any(s["name"] == name for s in standbys):
            # a standby's beacon drives failover: take over a stale
            # active's RANK in place (rank identity = journal identity,
            # so the successor replays the right journal), or fill a
            # below-max rank ladder
            stale = next(
                (
                    i for i, m in enumerate(actives)
                    if now - self._mds_beacons.get(m["name"], 0.0)
                    > grace
                ),
                None,
            )
            rest = [s for s in standbys if s["name"] != name]
            if stale is not None:
                new_actives = list(actives)
                new_actives[stale] = me
                propose = {"actives": new_actives, "standbys": rest}
            elif len(actives) < max_mds:
                propose = {"actives": actives + [me],
                           "standbys": rest}
        if propose is not None:
            propose["max_mds"] = max_mds
            await self.propose("fsmap", json.dumps(propose).encode())
        return {"fsmap": self._fsmap_out()}

    def _fsmap_out(self) -> dict:
        """FSMap in the rank-based shape, with the single-active alias
        ('active' = rank 0) kept for older consumers."""
        fm = dict(self.fsmap)
        actives = fm.get("actives")
        if actives is None:
            actives = [fm["active"]] if fm.get("active") else []
        fm["actives"] = actives
        fm["active"] = actives[0] if actives else None
        fm.setdefault("standbys", [])
        return fm

    def _health(self) -> dict:
        """Real health checks (the role of Monitor.cc's get_health /
        HealthMonitor + the mgr PGMap's check generation): map-derived
        OSD_DOWN plus PG checks aggregated from primaries' stats
        reports. Stale reports (>30s) and reports from down OSDs are
        ignored — their PGs re-report from their new primaries."""
        checks: dict[str, dict] = {}
        # MON_DOWN (Monitor.cc get_health's quorum check): a functioning
        # 2/3 quorum must still WARN about the missing member. Election
        # quorum alone goes stale when a PEON dies (the leader only
        # re-elects on losing its majority), so the leader also counts a
        # member down once its lease acks go silent.
        if self.quorum and self.state in ("leader", "peon"):
            missing = [
                r for r in range(self.monmap.size)
                if r not in self.quorum
            ]
            if self.is_leader:
                lease = self.config.get("mon_lease")
                factor = self.config.get(
                    "mon_lease_ack_timeout_factor"
                )
                now_m = asyncio.get_event_loop().time()
                for r in range(self.monmap.size):
                    if r == self.rank or r in missing:
                        continue
                    age = now_m - self._lease_acks.get(r, now_m)
                    if age > lease * factor * 3:
                        missing.append(r)
            if missing:
                checks["MON_DOWN"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (
                        f"{len(missing)}/{self.monmap.size} mons down, "
                        f"quorum {sorted(self.quorum)}"
                    ),
                    "count": len(missing),
                    "detail": [
                        f"mon.{r} (rank {r}) is down" for r in missing
                    ],
                }
        down = [
            o for o in range(self.osdmap.max_osd)
            if self.osdmap.is_down(o)
        ]
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
                "count": len(down),
                "detail": [f"osd.{o} is down" for o in down],
            }
        now = asyncio.get_event_loop().time()
        agg = {"degraded": 0, "undersized": 0, "backfilling": 0,
               "peering": 0, "inconsistent": 0, "degraded_objects": 0}
        nearfull, backfillfull, full = [], [], []
        near_r = self.config.get("mon_osd_nearfull_ratio")
        bf_r = self.config.get("mon_osd_backfillfull_ratio")
        full_r = self.config.get("mon_osd_full_ratio")
        for osd, (t, stats) in list(self._pg_stats.items()):
            if now - t > 30 or self.osdmap.is_down(osd):
                continue
            for key in agg:
                agg[key] += int(stats.get(key, 0))
            st = stats.get("statfs")
            if st and st.get("total"):
                ratio = st["used"] / st["total"]
                if ratio >= full_r:
                    full.append(osd)
                elif ratio >= bf_r:
                    backfillfull.append(osd)
                elif ratio >= near_r:
                    nearfull.append(osd)
        # capacity checks (OSDMonitor.cc:365 full_ratio family): the
        # reference's OSD_FULL is HEALTH_ERR — writes are being refused
        if full:
            checks["OSD_FULL"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{len(full)} full osd(s)",
                "count": len(full),
                "detail": [f"osd.{o} is full" for o in sorted(full)],
            }
        if backfillfull:
            checks["OSD_BACKFILLFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(backfillfull)} backfillfull osd(s)",
                "count": len(backfillfull),
            }
        if nearfull:
            checks["OSD_NEARFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(nearfull)} nearfull osd(s)",
                "count": len(nearfull),
                "detail": [
                    f"osd.{o} is near full" for o in sorted(nearfull)
                ],
            }
        for key, name, sev, noun in (
            ("degraded", "PG_DEGRADED", "HEALTH_WARN",
             "pgs degraded"),
            ("undersized", "PG_UNDERSIZED", "HEALTH_WARN",
             "pgs undersized"),
            ("backfilling", "PG_BACKFILLING", "HEALTH_WARN",
             "pgs backfilling"),
            ("peering", "PG_AVAILABILITY", "HEALTH_WARN",
             "pgs not active"),
            ("inconsistent", "PG_DAMAGED", "HEALTH_ERR",
             "scrub errors"),
        ):
            if agg[key]:
                checks[name] = {
                    "severity": sev,
                    "summary": f"{agg[key]} {noun}",
                    "count": agg[key],
                }
        if "PG_DEGRADED" in checks and agg["degraded_objects"]:
            # object-granular debt from the primaries' pg stats; the
            # active mgr's richer check (with the healing rate) wins
            # via the merge below while it is fresh
            checks["PG_DEGRADED"]["summary"] += (
                f" ({agg['degraded_objects']} object copies degraded)"
            )
        # mgr-fed checks (MGR_SLO_VIOLATION etc.): merged while fresh —
        # the active mgr re-reports every mgr_report_interval, so a
        # stale entry means the mgr died and its verdicts with it
        if self._mgr_health is not None:
            t, mgr_checks = self._mgr_health
            if now - t <= 30 and self.mgrmap.get("active") is not None:
                checks.update(mgr_checks)
        if any(
            c["severity"] == "HEALTH_ERR" for c in checks.values()
        ):
            status = "HEALTH_ERR"
        elif checks:
            status = "HEALTH_WARN"
        else:
            status = "HEALTH_OK"
        return {"status": status, "checks": checks}

    async def _cmd_auth(self, cmd: str, args: dict, conn) -> dict:
        """AuthMonitor (src/mon/AuthMonitor.cc + CephxProtocol.h roles):
        the entity-key database, rotating service keys, and ticket
        grants. Secrets never travel in the clear on authenticated
        deployments: rotating keys are sealed under the requesting
        daemon's entity key, ticket session keys under the client's."""
        import os as _os
        import time as _time

        from ceph_tpu_torch.auth.cephx import make_ticket, seal

        requester = conn.peer_name if conn is not None else self.name
        # key administration is capability-gated (the reference's mon
        # caps): only the admin entity and mons may mint, read, or
        # revoke other entities' keys — any authenticated client being
        # able to fetch client.admin's secret would void the whole model
        admin = requester == "client.admin" or requester.startswith(
            "mon."
        )
        if cmd in ("auth get-or-create", "auth rm", "auth rotate"):
            if not admin:
                raise ValueError(
                    f"{requester!r} lacks auth admin capability"
                )
        if cmd == "auth get-or-create":
            entity = args["entity"]
            existing = self.auth_db.get(entity)
            if existing is not None:
                return {"entity": entity, "key": existing.hex()}
            key = args.get("key") or _os.urandom(16).hex()
            await self.propose(
                "auth", json.dumps({"add": {entity: key}}).encode()
            )
            return {"entity": entity, "key": key}
        if cmd == "auth rm":
            await self.propose(
                "auth", json.dumps({"rm": [args["entity"]]}).encode()
            )
            return {}
        if cmd == "auth rotate":
            svc = args["service"]
            epoch = max(self.rotating.get(svc, {0: b""}), default=0) + 1
            await self.propose(
                "auth",
                json.dumps({
                    "rotate": {svc: {str(epoch): _os.urandom(16).hex()}}
                }).encode(),
            )
            return {"epoch": epoch}
        if cmd == "auth rotating":
            svc = args["service"]
            if not self.rotating.get(svc):
                # internal bootstrap rotation: mon-initiated, not gated
                await self._cmd_auth(
                    "auth rotate", {"service": svc}, None
                )
            window = {
                str(e): k.hex()
                for e, k in self.rotating[svc].items()
            }
            payload = json.dumps(window).encode()
            if self._keyring is None:
                return {"keys": window}  # auth disabled: plain
            dkey = self._keyring.get(requester)
            if dkey is None or not requester.split(".")[0] in (
                "mon", "osd", "mgr", "mds"
            ):
                raise ValueError(
                    f"{requester!r} may not fetch rotating keys"
                )
            return {"sealed": seal(dkey, payload).hex()}
        if cmd == "auth get-ticket":
            svc = args["service"]
            ekey = self.auth_db.get(requester) or (
                (self._keyring or {}).get(requester)
            )
            if ekey is None:
                raise ValueError(f"unknown entity {requester!r}")
            if not self.rotating.get(svc):
                await self._cmd_auth(
                    "auth rotate", {"service": svc}, None
                )
            epoch = max(self.rotating[svc])
            session_key = _os.urandom(32)
            ttl = self.config.get("auth_service_ticket_ttl")
            ticket = make_ticket(
                self.rotating[svc][epoch], epoch, requester,
                session_key, _time.time() + ttl,
            )
            return {
                "ticket": ticket.hex(),
                "session_key": seal(ekey, session_key).hex(),
                "ttl": ttl,
            }
        raise ValueError(f"unknown command {cmd!r}")

    async def _cmd_pool_create(self, args: dict) -> dict:
        from ceph_tpu_torch.osd.types import (
            TYPE_ERASURE,
            TYPE_REPLICATED,
            PgPool,
        )

        pool_id = args["pool_id"]
        existing = self.osdmap.pools.get(pool_id)
        if existing is not None:
            # idempotent for client retries: a create whose reply was
            # lost re-arrives after the commit — the SAME geometry is a
            # success, anything else is EEXIST (mon commands carry no
            # reqids, so geometry equality is the dedup test)
            want_type = (
                TYPE_ERASURE
                if args.get("erasure_code_profile") else TYPE_REPLICATED
            )
            want_pg_num = args.get(
                "pg_num", self.config.get("osd_pool_default_pg_num")
            )
            same = (
                existing.type == want_type
                and existing.pg_num == want_pg_num
            )
            if want_type == TYPE_ERASURE:
                same = same and (
                    existing.erasure_code_profile
                    == args.get("erasure_code_profile", "")
                )
            else:
                same = same and existing.size == args.get(
                    "size", self.config.get("osd_pool_default_size")
                )
            if same:
                return {"pool_id": pool_id, "existed": True}
            raise ValueError(f"pool {pool_id} exists")
        profile_name = args.get("erasure_code_profile", "")
        new_profiles: dict | None = None
        if profile_name:
            profile = self.osdmap.erasure_code_profiles.get(profile_name)
            if profile is None and profile_name == "default":
                # the reference materializes the "default" profile on
                # first use from osd_pool_default_erasure_code_profile
                # (OSDMonitor::parse_erasure_code_profile); it is stored
                # in the same incremental that creates the pool
                profile = dict(
                    kv.split("=", 1)
                    for kv in self.config.get(
                        "osd_pool_default_erasure_code_profile"
                    ).split()
                    if "=" in kv
                )
                new_profiles = {profile_name: profile}
            if profile is None:
                raise ValueError(
                    f"no erasure-code profile {profile_name!r}"
                )
            # size/min_size come from the CODEC, not k+m: LRC's locality
            # chunks and CLAY's geometry make get_chunk_count() the real
            # width (OSDMonitor::prepare_pool_size instantiates the
            # erasure code the same way, OSDMonitor.cc:6407)
            from ceph_tpu_torch.ec.registry import factory

            ec = factory(
                profile.get("plugin", "tpu"),
                {kk: v for kk, v in profile.items() if kk != "plugin"},
                device=self.device,
            )
            size = ec.get_chunk_count()
            data = ec.get_data_chunk_count()
            pool = PgPool(
                pg_num=args.get("pg_num",
                                self.config.get("osd_pool_default_pg_num")),
                size=size,
                # data+1, the reference's EC default: a write acked at
                # exactly k live shards has zero redundancy the moment
                # one of them is lost (OSDMonitor's
                # osd_pool_default_min_size rule for EC pools)
                min_size=data + 1 if size > data + 1 else data,
                type=TYPE_ERASURE,
                crush_rule=args["crush_rule"],
                erasure_code_profile=profile_name,
            )
        else:
            size = args.get("size",
                            self.config.get("osd_pool_default_size"))
            pool = PgPool(
                pg_num=args.get("pg_num",
                                self.config.get("osd_pool_default_pg_num")),
                size=size,
                min_size=max(1, size - 1),
                type=TYPE_REPLICATED,
                crush_rule=args["crush_rule"],
            )
        await self._propose_osdmap(
            Incremental(epoch=self.osdmap.epoch + 1,
                        new_pools={pool_id: pool},
                        new_erasure_code_profiles=new_profiles or {})
        )
        return {"pool_id": pool_id}
