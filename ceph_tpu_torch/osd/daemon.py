"""OSDService: the storage daemon (L6).

One process-per-OSD data plane speaking the messenger, mirroring the
reference's structure (src/osd/OSD.cc boot at ceph_osd.cc:106, fast
dispatch at OSD.cc:6877) at mini scale:

  boot      bind messenger -> MonClient subscribe -> send osd_boot with our
            address -> serve once the committed map shows us up
  ops       clients send "osd_op" to the acting primary; the primary drives
            the backend (PrimaryLogPG::do_op -> PGBackend analogues):
              * replicated: apply locally + fan "rep_write" sub-ops to the
                other acting members, ack to the client when all commit
                (ReplicatedBackend sub-write fan-out)
              * EC: encode on the pool's codec, "ec_sub_write" one shard to
                each acting position, ack when all commit
                (ECBackend::start_rmw -> ECSubWrite, ECBackend.cc:1830);
                reads gather minimum_to_decode shards via "ec_sub_read"
                and decode only when degraded (objects_read_async, 2154)
  fencing   an op whose placement disagrees with our map is bounced with
            the current epoch ("wrong_primary"); the Objecter refreshes its
            map and resends — the reference drops stale-epoch ops the same
            way and relies on client resend (epoch-tagged resend contract)
  peering   on every map epoch whose acting set changed, the primary runs
            GetInfo -> GetLog -> GetMissing -> recover (PeeringState.h
            statechart collapsed to one async pass): collect pg_info from
            acting members, adopt the most advanced log (pull objects it
            names that we lack), then push log + objects/shards every
            laggard is missing; EC shards a member lacks are rebuilt by
            decoding from surviving shards. Every sub-write carries its log
            entry, so replicas' logs advance with their data, exactly like
            ECSubWrite carrying log_entries in the reference
  logs      per-PG log in the pg-meta object's omap ("log/<version>" ->
            entry, PGLog.cc role): the authoritative object inventory that
            peering compares and recovery replays
  failure   periodic pings to peers holding PGs with us; a peer silent past
            osd_heartbeat_grace is reported to the mon (OSD.cc:4547
            handle_osd_ping / heartbeat_check), which commits the down mark

Object naming: a replicated object is stored under its name in collection
"pg_<pool>_<ps>"; EC shard i of an object is "<name>.s<i>" in the same
collection — shard identity in the key, as ECBackend's shard_id_t does.
"""

from __future__ import annotations

import asyncio
import json
import time
import zlib

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.common.kv import KeyValueDB
from ceph_tpu_torch.common.op_queue import QOS_RECOVERY
from ceph_tpu_torch.common.watchdog import SharedWatchdog
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.msg import (
    Dispatcher,
    Message,
    Messenger,
    Policy,
    payload_of,
    redirect_reply,
)
from ceph_tpu_torch.msg.frames import FEATURE_SUBOP_BATCH
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.osd.cls import ClsError, MethodContext, default_handler
from ceph_tpu_torch.osd.ecutil import SEED, HashInfo
from ceph_tpu_torch.osd.extent_cache import (
    ExtentCache,
    patch_window,
    write_column_intervals,
)
from ceph_tpu_torch.osd.objectstore import (
    StoreError,
    StoreFatalError,
    Transaction,
    create_store,
)
from ceph_tpu_torch.osd.ops import (
    ObjectState,
    OpError,
    execute_ops,
    is_mutating,
)
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE

_NONE = CRUSH_ITEM_NONE

#: mutations still allowed on a FULL osd: space-freeing ops only
#: (the reference lets deletes through so the operator can recover)
_FULL_OK_OPS = {
    "delete", "rmxattr", "omap_rm", "omap_clear", "unwatch",
}

#: the active trace id for the op currently executing in this task
#: (zipkin_trace.h role): set when a traced client op starts, read by
#: _peer_call so every downstream sub-op hop carries the id — async
#: context propagates through awaits AND create_task, so the EC write
#: pipeline's spawned tasks inherit it without plumbing
import contextvars as _contextvars

_trace_ctx: "_contextvars.ContextVar[str | None]" = (
    _contextvars.ContextVar("ceph_trace_id", default=None)
)


class _StalePartial(Exception):
    """A prepared sub-stripe RMW found its base superseded by a
    whole-object mutation at commit time; the caller re-prepares."""


class _PartialUnfit(Exception):
    """Sub-stripe RMW preconditions failed mid-prepare (degraded shard,
    stale version, codec geometry); fall back to whole-object RMW."""


class _SubOpCollector:
    """Stand-in connection for one op inside a subop_batch frame: the
    inner handler's sub_reply lands in a future instead of going
    straight to the wire, so the batch handler can re-coalesce the
    per-op acks into one reply frame."""

    def __init__(self, conn, fut: asyncio.Future):
        self.fut = fut
        self.peer_name = getattr(conn, "peer_name", None)
        self.peer_nonce = getattr(conn, "peer_nonce", 0)

    def send_message(self, msg) -> None:
        if not self.fut.done():
            self.fut.set_result(msg)


def pg_coll(pool: int, ps: int) -> str:
    return f"pg_{pool}_{ps}"


def shard_name(name: str, shard: int | None) -> str:
    return name if shard is None else f"{name}.s{shard}"


#: reserved xattr carrying the head's SnapSet (osd_types.h SnapSet:
#: seq + clone list + clone sizes); reserved names are invisible to
#: client getxattrs and travel with the object through every write,
#: push, and scrub path because they live in the ordinary xattr blob
SNAPSET_XATTR = "\x01ss"


def snap_store_name(name: str, snapid: int) -> str:
    """Storage name of a clone object (hobject_t's snap field folded into
    the key, like shard ids are)."""
    return f"{name}\x1f{snapid:016x}"


def snapdir_name(name: str) -> str:
    """When the head is deleted but clones survive, the SnapSet parks on
    this object (the reference's CEPH_SNAPDIR virtual object)."""
    return f"{name}\x1fsnapdir"


def load_snapset(xattrs: dict) -> dict:
    raw = xattrs.get(SNAPSET_XATTR)
    if not raw:
        return {"seq": 0, "clones": [], "sizes": {}}
    return json.loads(raw)


class PG:
    """Per-PG volatile state; durable state lives in the store.

    Persistent layout in the pg-meta object's omap:
      log/<v>    retained log entries (trimmed to osd_min_pg_log_entries,
                 PGLog::trim)
      obj/<name> the object inventory: name -> latest entry, INDEPENDENT
                 of log retention — trimming the log never forgets what
                 objects exist (the missing-set/backfill source of truth)
      info       {last_update, log_tail, head:[epoch,version]}
    """

    META = ".pgmeta"

    def __init__(self, service: "OSDService", pool: int, ps: int):
        self.service = service
        self.pool = pool
        self.ps = ps
        self.coll = pg_coll(pool, ps)
        self.lock = asyncio.Lock()  # serializes writes + peering
        store = service.store
        if not store.collection_exists(self.coll):
            store.queue_transaction(
                Transaction().create_collection(self.coll).touch(
                    self.coll, self.META
                )
            )
        self._last_update = 0
        #: versions <= log_tail have been trimmed from the log
        self._log_tail = 0
        #: last epoch this PG went active under us as primary
        #: (last_epoch_started): the horizon past-interval checks reach
        #: back to
        self.les = 0
        #: eversion of the newest entry: (epoch it was written in,
        #: version) — the reference's eversion_t, what makes two reigns'
        #: same-numbered entries distinguishable for divergence handling
        self._head: tuple[int, int] = (0, 0)
        self._inventory: dict[str, dict] = {}
        #: reqid -> version: client-op dup detection across primary
        #: failover (the reference scans the pg log for the reqid,
        #: PrimaryLogPG::check_in_progress_op); entries replicate so a new
        #: primary inherits the set
        self._reqids: dict[str, int] = {}
        #: reqids whose fan-out fully completed THIS primary's tenure: a
        #: dup whose reqid is logged but not here means the original op
        #: aborted mid-fan-out — it must be completed forward (full-state
        #: re-push) before acking, or the ack would cover a write that
        #: exists on too few members to survive the next failure
        self._reqids_done: set[str] = set()
        omap = store.omap_get(self.coll, self.META)
        raw_info = omap.get(b"info")
        if raw_info:
            info = json.loads(raw_info)
            self._last_update = info.get("last_update", 0)
            self._log_tail = info.get("log_tail", 0)
            self._head = tuple(info.get("head", (0, 0)))
            self.les = info.get("les", 0)
        #: retained log mirror (bounded by osd_min_pg_log_entries):
        #: version -> entry, so entry_at/log_entries never rescan the
        #: whole pg-meta omap (which also holds the full inventory)
        self._log: dict[int, dict] = {}
        for k, v in sorted(omap.items()):
            if k.startswith(b"obj/"):
                e = json.loads(v)
                self._inventory[e["name"]] = e
            elif k.startswith(b"log/"):
                e = json.loads(v)
                self._log[e["version"]] = e
                self._last_update = max(self._last_update, e["version"])
                if e.get("reqid"):
                    self._reqids[e["reqid"]] = e["version"]
                if (e.get("epoch", 0), e["version"]) > self._head:
                    self._head = (e.get("epoch", 0), e["version"])
        #: a primary serves client IO only once peering for the current
        #: interval finished (PeeringState: Peering -> Active); until then
        #: ops bounce with a retryable error, so a revived primary can
        #: never serve ENOENT for an object it simply hasn't learned yet
        self.active = False
        self.last_acting: list[int] | None = None
        #: lock-taking sub-ops run through this per-PG queue instead of
        #: the connection's dispatch loop — a handler awaiting pg.lock
        #: inside dispatch would stall every later frame on that
        #: connection, and lock-holders calling peers whose dispatch is
        #: likewise stalled deadlock ACROSS daemons (the reference keeps
        #: its messenger fast-dispatch non-blocking for the same reason)
        self.subop_q: asyncio.Queue = asyncio.Queue()
        self.subop_task: asyncio.Task | None = None
        #: in-flight sub-stripe overwrite coordination (ExtentCache.h
        #: role): overlapping column windows serialize, disjoint ones
        #: run their read+encode legs outside the PG lock concurrently
        self.extents = ExtentCache()
        #: name -> obj_ver of the last WHOLE-object mutation this tenure
        #: (full write / delete / truncate path); the fence a prepared
        #: sub-stripe RMW validates against at commit — disjoint partial
        #: writes may interleave freely, a full rewrite forces re-prepare
        self._full_mut: dict[str, int] = {}
        #: acting members whose logs could not be bridged (blank revival,
        #: divergence): the PG activates WITHOUT them — they take no
        #: write sub-ops and satisfy neither min_size nor reads until the
        #: background drain backfills them (the reference's async
        #: backfill with backfill_targets, PeeringState::Active +
        #: recover_backfill; PastIntervals is what keeps their stale
        #: stores from masquerading as current)
        self.backfill_targets: set[int] = set()
        self.backfill_task: asyncio.Task | None = None
        #: the primary itself revived amnesiac: it adopted the
        #: authority's log/inventory and serves (reads decode around the
        #: missing local data) while a background sweep pulls its own
        #: copies/shards back
        self.self_backfill = False
        self.self_backfill_task: asyncio.Task | None = None
        #: balanced-read activation marker on a NON-primary member: the
        #: primary's pg_activate broadcast {les, acting, backfill} —
        #: replica-side proof that peering for that interval finished and
        #: our copy set was current when it did. None means never heard
        #: (or invalidated by a map change): balanced reads redirect,
        #: because a replica has no interval knowledge of its own
        self.replica_marker: dict | None = None

    # -- the persisted log ----------------------------------------------------

    @property
    def last_update(self) -> int:
        return self._last_update

    @property
    def log_tail(self) -> int:
        return self._log_tail

    @property
    def head(self) -> tuple[int, int]:
        return self._head

    def log_entries(self, from_version: int = 0) -> list[dict]:
        return [
            self._log[v] for v in sorted(self._log)
            if v > from_version
        ]

    def entry_at(self, version: int) -> dict | None:
        return self._log.get(version)

    def _info_blob(self) -> bytes:
        return json.dumps(
            {"last_update": self._last_update,
             "log_tail": self._log_tail,
             "head": list(self._head),
             "les": self.les}
        ).encode()

    def set_les(self, epoch: int) -> None:
        self.les = max(self.les, epoch)
        self.service.store.queue_transaction(
            Transaction().omap_setkeys(
                self.coll, self.META, {b"info": self._info_blob()}
            )
        )

    def append_log(self, txn: Transaction, entry: dict) -> None:
        """Record `entry` in the transaction AND the in-memory mirror; the
        caller must queue_transaction(txn) before yielding control (all
        call sites do, under the PG lock). Trims the log to the configured
        horizon (PGLog::trim) — the obj/ inventory keeps full knowledge."""
        self._last_update = max(self._last_update, entry["version"])
        ev = (entry.get("epoch", 0), entry["version"])
        if ev > self._head:
            self._head = ev
        self._log[entry["version"]] = entry
        rows = {
            b"log/%016x" % entry["version"]: json.dumps(entry).encode(),
            b"obj/" + entry["name"].encode(): (
                json.dumps(entry).encode()
            ),
        }
        max_entries = self.service.config.get("osd_min_pg_log_entries")
        if self._last_update - self._log_tail > max_entries:
            new_tail = self._last_update - max_entries
            txn.omap_rmkeys(
                self.coll, self.META,
                [b"log/%016x" % v
                 for v in range(self._log_tail + 1, new_tail + 1)],
            )
            for v in range(self._log_tail + 1, new_tail + 1):
                self._log.pop(v, None)
            self._log_tail = new_tail
            # the dup-detection horizon tracks the trimmed log: reqids
            # below the tail are forgotten in memory exactly as a
            # restart reloading from the log would forget them
            stale = [
                r for r, v in self._reqids.items() if v <= new_tail
            ]
            for r in stale:
                del self._reqids[r]
                self._reqids_done.discard(r)
        rows[b"info"] = self._info_blob()
        txn.omap_setkeys(self.coll, self.META, rows)
        cur = self._inventory.get(entry["name"])
        if cur is None or entry["version"] > cur["version"]:
            self._inventory[entry["name"]] = entry
        if entry.get("reqid"):
            self._reqids[entry["reqid"]] = entry["version"]

    def reset_log(
        self, txn: Transaction, inventory: dict[str, dict],
        head: tuple[int, int], tail: int,
    ) -> None:
        """Backfill epilogue: adopt the authority's object inventory and
        restart the log fresh at its head (divergent local entries are
        gone — their client ops were never fully acked and will re-execute
        under new reqids on retry)."""
        omap = self.service.store.omap_get(self.coll, self.META)
        txn.omap_rmkeys(
            self.coll, self.META,
            [k for k in omap if k.startswith((b"log/", b"obj/"))],
        )
        self._inventory = {}
        self._reqids = {}
        self._log = {}
        rows = {}
        for name, e in inventory.items():
            rows[b"obj/" + name.encode()] = json.dumps(e).encode()
            self._inventory[name] = e
            if e.get("reqid"):
                self._reqids[e["reqid"]] = e["version"]
        self._last_update = head[1]
        self._log_tail = tail
        self._head = tuple(head)
        rows[b"info"] = self._info_blob()
        txn.omap_setkeys(self.coll, self.META, rows)

    def latest_objects(self) -> dict[str, dict]:
        """name -> newest entry (the recovery/backfill inventory)."""
        return self._inventory


class OSDService(Dispatcher):
    def __init__(
        self,
        osd_id: int,
        monmap,
        db: KeyValueDB | None = None,
        config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        crush_location: dict | None = None,
        device=None,
    ):
        self.id = osd_id
        #: where the pools' codecs and the EncodeService launch (None =
        #: cuda, which raises without a card); placement stays scalar
        self.device = resolve_device(device)
        #: e.g. {"host": "host9"} — announced at boot so the mon can place
        #: a brand-new device in the crush hierarchy (cluster expansion)
        self.crush_location = crush_location
        self.name = f"osd.{osd_id}"
        self.config = config if config is not None else Config()
        # kstore over the given KV db by default; `osd_objectstore =
        # blockstore` opts into the allocator/at-rest-checksum store
        # (its block file lands beside a FileDB's WAL)
        self.store = create_store(db, self.config)
        # distributed tracer (common/tracer): spans at every layer of
        # the op path; disabled cost is one cached-flag check per site
        from ceph_tpu_torch.common.tracer import Tracer

        self.tracer = Tracer(self.name, config=self.config)
        self.store.tracer = self.tracer
        self.messenger = Messenger(
            self.name, config=self.config, keyring=keyring
        )
        self.messenger.tracer = self.tracer
        self.messenger.dispatcher = self
        # MonClient chains itself in front of us on the shared messenger
        self.mon = MonClient(
            self.name, monmap, config=self.config,
            messenger=self.messenger,
        )
        self.pgs: dict[tuple[int, int], PG] = {}
        self.cls = default_handler()  # in-OSD object classes (src/cls)
        # coalesces concurrent EC encodes/decodes into planar device
        # launches (the batch window is the write-path latency bound)
        from ceph_tpu_torch.osd.encode_service import EncodeService

        self.encode_service = EncodeService(
            window=self.config.get("osd_ec_batch_window"),
            tracer=self.tracer,
            device=self.device,
        )
        # per-daemon perf counters, dumped via the admin surface the way
        # `ceph daemon osd.N perf dump` reads the admin socket
        from ceph_tpu_torch.common.perf_counters import PerfCountersCollection

        self.perf_collection = PerfCountersCollection()
        self.perf = self.perf_collection.create(self.name)
        # a BlockStore keeps its own counter block (cache hits, deferred
        # queue depth/age, flush latency); adopt it so `perf dump` shows
        # the store alongside the op-path counters
        store_perf = getattr(self.store, "perf", None)
        if store_perf is not None:
            self.perf_collection.add(store_perf)
        # span latency histograms land beside the op counters, so the
        # Prometheus exporter scrapes trace timings as metrics
        self.perf_collection.add(self.tracer.perf)
        # wire-path counters (frames out, corked runs, envelope format)
        # surface through the same dump/Prometheus path
        self.perf_collection.add(self.messenger.perf)
        for key, desc in (
            ("subop_batch_tx", "coalesced multi-op frames sent to peers"),
            ("subop_batch_tx_ops", "sub-ops that rode a coalesced frame"),
            ("subop_batch_rx", "coalesced multi-op frames received"),
            ("subop_direct", "sub-ops sent as their own frame"),
        ):
            self.perf.add_u64_counter(key, desc)
        for key, desc in (
            ("op_w", "client writes served as primary"),
            ("op_w_partial", "EC writes served via sub-stripe RMW"),
            ("op_r", "client reads served as primary"),
            ("op_rw", "client cls calls served as primary"),
            ("subop_w", "replica/shard sub-writes applied"),
            ("recovery_pushes", "objects/shards pushed during recovery"),
            ("recovery_pulls", "objects/shards pulled during peering"),
            ("recovery_sub_bytes",
             "helper bytes read via fractional sub-chunk repair"),
            ("read_error_repaired",
             "primary read EIOs healed from replicas/EC survivors "
             "before the client saw them (rep_repair_primary_object)"),
            ("read_balanced",
             "client reads this OSD served as a NON-primary acting "
             "member (rados_read_policy balance/localize)"),
            ("read_redirected",
             "balanced/direct-shard reads bounced back to the primary "
             "(peering, backfill, stale marker, or local error — never "
             "served from an unproven copy)"),
            ("read_shard_direct",
             "EC data-shard ranges served straight to clients with no "
             "primary gather/decode"),
            ("scrub_errors", "inconsistencies found by scrub"),
            ("heartbeat_failures", "peer failures reported to the mon"),
            ("tier_hit", "cache-pool ops served from the cache"),
            ("tier_promote", "objects promoted from the base pool"),
            ("tier_miss", "cache misses with no base object either"),
            ("tier_flush", "dirty objects flushed to the base pool"),
            ("tier_evict", "clean objects evicted from the cache"),
            ("op_in_bytes", "client payload bytes written as primary"),
            ("op_out_bytes", "client payload bytes read as primary"),
        ):
            self.perf.add_u64_counter(key, desc)
        # sampled by the mgr report tick (and perf dump): ops queued on
        # the shards + pipelined in-flight tasks — the overload signal
        # mgr SLO rules like `osd_queue_depth.avg < N` watch
        self.perf.add_u64(
            "osd_queue_depth",
            "client ops queued on the op shards or executing",
        )
        # write-path leg timings (the l_* time_avg family the reference
        # keeps in l_osd_op_w_process_lat etc.): where a client op's
        # wall time goes, for `perf dump` + the latency investigations
        # multi-process deployment makes meaningful
        for key, desc in (
            ("l_op_total", "whole primary-side client op"),
            ("l_load_state", "EC RMW read leg (_load_state_ec)"),
            ("l_encode", "batch-encode service wait"),
            ("l_fan", "sub-write fan-out gather (RTT + shard apply)"),
            ("l_subop_apply", "shard-side sub-write apply"),
            ("l_txn", "store.queue_transaction on the shard"),
            ("l_subop_transit", "sub-write wire transit (send->dispatch)"),
            ("l_subop_queue", "sub-write shard queue wait (dispatch->pick)"),
            ("l_loop_lag", "event-loop scheduling overshoot (watchdog)"),
        ):
            self.perf.add_time_avg(key, desc)
        self._codecs: dict[int, object] = {}
        self._tids = iter(range(1, 1 << 62))
        self._waiters: dict[int, asyncio.Future] = {}
        #: one deadline sweep for the whole sub-op fan-out instead of a
        #: TimerHandle armed+cancelled per _peer_call (Objecter::tick)
        self._watchdog = SharedWatchdog()
        #: peer osd -> sub-ops queued this event-loop tick, flushed as
        #: one subop_batch frame by a call_soon (sub-op coalescing)
        self._subop_pending: dict[int, list] = {}
        self._subop_batch = bool(self.config.get("ms_subop_batch"))
        self.config.observe(
            "ms_subop_batch",
            lambda _n, v: setattr(self, "_subop_batch", bool(v)),
        )
        self._hb_last: dict[int, float] = {}
        #: heartbeat_inject_failure window end (None = disarmed)
        self._hb_inject_until: float | None = None
        #: highest up_thru epoch already requested from the mon (the
        #: OSD::up_thru_wanted role; avoids a request per peering pass)
        self._up_thru_requested = 0
        #: peer -> last failure-report time; reports repeat every grace
        #: interval while the peer stays silent and up-in-map (a one-shot
        #: report can be lost to mon leadership churn, and the mon counts
        #: distinct reporters, not report instances, so repeats are safe)
        self._reported: dict[int, float] = {}
        #: (pool, ps, name) -> [(conn, watcher, cookie)] watch sessions
        self._watchers: dict[tuple, list] = {}
        self._notify_waiters: dict[tuple, asyncio.Future] = {}
        # per-op event timeline ("slow request" reporting, TrackedOp.h)
        from ceph_tpu_torch.common.admin import OpTracker

        self.op_tracker = OpTracker(
            slow_op_seconds=self.config.get("slow_op_seconds")
        )
        #: (pool, ps) -> error count from the last deep scrub of that PG
        #: (primary-side); feeds the PG_DAMAGED health check and clears
        #: when a rescrub comes back clean
        self._scrub_incons: dict[tuple, int] = {}
        #: trace id -> [(unix ts, "osd.N", event)] span events
        #: (ZTracer::Trace spans at mini scale)
        self.traces: dict[str, list] = {}
        # dout-style subsystem logging with the always-on recent ring
        # (src/log/Log.cc); dumped via the `log dump` admin command
        from ceph_tpu_torch.common.log import LogRegistry

        self.logs = LogRegistry(self.config)
        self.dlog = self.logs.get_logger("osd")
        # sharded op queue (ShardedOpWQ): workers start in start(); the
        # scheduler inside each shard is selected by osd_op_queue
        # (wpq | mclock), the reference's op-queue switch
        from ceph_tpu_torch.common.op_queue import (
            QOS_DATA_PREFETCH,
            QOS_RECOVERY,
            MClockOpQueue,
            WeightedPriorityQueue,
            data_prefetch_profile,
            recovery_profile,
        )

        queue_kind = self.config.get("osd_op_queue")
        try:
            data_weight = float(self.config.get("osd_mclock_data_weight"))
            rec_weight = float(
                self.config.get("osd_mclock_recovery_weight")
            )
            rec_res = float(
                self.config.get("osd_mclock_recovery_reservation")
            )
        # cephlint: disable=error-taxonomy (config races boot: fall back to the shipped default weight)
        except Exception:
            data_weight = 0.25
            rec_weight, rec_res = 0.25, 10.0

        def _make_queue():
            if queue_kind != "mclock":
                return WeightedPriorityQueue()
            q = MClockOpQueue()
            # bulk dataset prefetch rides a background weight profile so
            # it can't starve foreground (weight-1) client classes
            q.set_profile(
                QOS_DATA_PREFETCH, data_prefetch_profile(data_weight)
            )
            # recovery sub-ops (pulls, rebuild reads, batched pushes):
            # fractional weight caps the storm, the reservation floor
            # keeps healing from stalling to zero under client load
            q.set_profile(
                QOS_RECOVERY, recovery_profile(rec_weight, rec_res)
            )
            return q

        class _OpShard:
            def __init__(self):
                self.queue = _make_queue()
                self.kick = asyncio.Event()
                #: object name -> in-flight PIPELINED op tasks; inline
                #: ops on the same object drain these first so
                #: per-object client ordering survives pipelining
                self.inflight: dict[str, set] = {}

        self._op_shards = [_OpShard() for _ in range(4)]
        #: pool id -> client ops served as primary (cumulative); rides
        #: the mgr report's status section for `ceph top` per-pool rows
        self._pool_ops: dict[int, int] = {}
        #: object copies missing from our primary PGs (recomputed by
        #: _pg_stats_loop); rides both the mon pg-stats report and the
        #: mgr status block, feeding PG_DEGRADED / RECOVERY_SLOW
        self._degraded_objects = 0
        self._tasks: list[asyncio.Task] = []
        self._ephemeral: set[asyncio.Task] = set()
        self._next_reboot = 0.0
        self._acting_cache: dict[tuple[int, int], tuple] = {}
        self._acting_cache_epoch = -1
        self._hist_cache: dict[tuple[int, int], list] = {}
        self._hist_cache_epoch = -1
        #: bounds concurrent backfills we source (osd_max_backfills /
        #: the reservation sched_scrub-style throttle)
        self._backfill_sem = asyncio.Semaphore(
            self.config.get("osd_max_backfills")
        )
        self._stopped = False
        #: fail-stop in progress (a fatal store error fenced us); set
        #: once so repeated store failures schedule one shutdown
        self._fencing = False
        self._loop: asyncio.AbstractEventLoop | None = None
        # fail-stop contract: a write/fsync device error fences the
        # store (no further acks can lie about durability) and the
        # daemon reports itself to the mon + shuts down cleanly — the
        # callback may fire on the store's flusher thread, so it only
        # schedules onto our event loop
        self.store.on_fatal = self._note_store_fatal
        self.mon.on_map_change(self._note_map)
        self._map_dirty = asyncio.Event()

    # -- lifecycle ------------------------------------------------------------

    @property
    def osdmap(self):
        return self.mon.osdmap

    async def start(self) -> None:
        self._loop = asyncio.get_event_loop()
        await self.messenger.bind()
        self.mon.subscribe()
        await self.mon.wait_for_map()
        # serve once the quorum-committed map says we're up at our address;
        # the boot report is re-sent until then (it can race an election
        # or ride a session that dies — one-way messages need the retry)
        loop = asyncio.get_event_loop()
        end = loop.time() + 30
        next_boot = 0.0
        while loop.time() < end:
            m = self.osdmap
            if (
                self.id < m.max_osd
                and m.osd_up[self.id]
                and m.osd_addrs.get(self.id)
                == tuple(self.messenger.my_addr)
            ):
                break
            if loop.time() >= next_boot:
                self.mon.send_boot(
                    self.id, tuple(self.messenger.my_addr),
                    location=self.crush_location,
                    local_addr=self.messenger.my_local_addr,
                )
                next_boot = loop.time() + 1.0
            await asyncio.sleep(0.02)
        if (d := self.dlog.dout(1)) is not None:
            d(f"osd.{self.id} booted at {self.messenger.my_addr}, "
              f"epoch {self.osdmap.epoch}")
        self._tasks.append(asyncio.create_task(self._loop_lag_watchdog()))
        self._tasks.append(asyncio.create_task(self._slow_op_loop()))
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        self._tasks.append(asyncio.create_task(self._peering_loop()))
        self._tasks.append(asyncio.create_task(self._resub_loop()))
        self._tasks.append(asyncio.create_task(self._pg_stats_loop()))
        self._tasks.append(asyncio.create_task(self._mgr_report_loop()))
        if self.messenger.keyring is not None:
            # cephx: fetch the rotating service-key window so client
            # tickets verify locally, and keep it fresh through
            # rotations (the KeyServer-to-daemon distribution) — plus
            # reactively when a ticket shows up under a newer epoch
            await self._fetch_rotating_keys()
            self.messenger.on_service_keys_stale = (
                self._fetch_rotating_keys
            )
            self._tasks.append(
                asyncio.create_task(self._rotating_keys_loop())
            )
        for shard in self._op_shards:
            self._tasks.append(
                asyncio.create_task(self._op_shard_worker(shard))
            )
        self._note_map(self.osdmap)

    # -- cross-daemon tracing (src/common/zipkin_trace.h role) ----------------

    def _trace(self, trace_id: str | None, event: str) -> None:
        """Record one span event under a trace id. Each daemon keeps its
        own span store; `dump_trace` on the admin surface hands the
        events out and the client stitches the full multi-daemon
        timeline (wall clock: every daemon shares the host's)."""
        if not trace_id:
            return
        import time as _time

        store = self.traces.setdefault(trace_id, [])
        store.append((_time.time(), f"osd.{self.id}", event))
        if len(self.traces) > 256:  # bound the span store
            self.traces.pop(next(iter(self.traces)))

    def statfs(self) -> dict:
        """Store utilization (ObjectStore::statfs): advertised capacity
        comes from config (the disk-size role), used bytes from the live
        KV footprint. Cached briefly — the scan is O(rows)."""
        loop = asyncio.get_event_loop()
        cached = getattr(self, "_statfs_cache", None)
        ttl = float(self.config.get("osd_statfs_cache_sec"))
        if cached is not None and loop.time() - cached[0] < ttl:
            return cached[1]
        total = self.config.get("osd_statfs_total_bytes")
        used = self.store.used_bytes()
        st = {
            "total": int(total),
            "used": int(used),
            "available": max(0, int(total) - int(used)),
        }
        comp = getattr(self.store, "compression_stats", None)
        if comp is not None:
            st.update(comp())
        self._statfs_cache = (loop.time(), st)
        return st

    def _is_full(self) -> bool:
        st = self.statfs()
        return st["used"] >= st["total"] * self.config.get(
            "mon_osd_full_ratio"
        )

    async def _slow_op_loop(self) -> None:
        """Warn the MOMENT an op crosses slow_op_seconds (the reference's
        op_tracker check_ops_in_flight -> cluster-log "slow request"
        lines, OSD.cc tick path) — slow ops must not stay invisible
        until someone polls dump_ops_in_flight. One line per op."""
        interval = min(
            1.0, max(0.05, self.op_tracker.slow_op_seconds / 4)
        )
        while not self._stopped:
            await asyncio.sleep(interval)
            for op_id, dump in self.op_tracker.check_slow():
                last = (
                    dump["events"][-1]["event"]
                    if dump["events"] else "none"
                )
                tr = dump.get("trace_id")
                line = (
                    f"slow request: op {op_id} "
                    f"({dump['description']}) blocked for "
                    f"{dump['age']:.3f}s, last event: {last}"
                    + (f" trace={tr}" if tr else "")
                )
                if (d := self.dlog.dout(0)) is not None:
                    d(line)
                self._cluster_log("WRN", line)

    async def _loop_lag_watchdog(self) -> None:
        """Samples how late a 10ms sleep fires: the single cheapest
        signal for 'something blocked the event loop' (a first kernel
        build, a long callback) — the latency killer multi-process deployment
        surfaces as mysterious wire-transit time."""
        loop = asyncio.get_event_loop()
        while not self._stopped:
            t0 = loop.time()
            await asyncio.sleep(0.01)
            self.perf.tinc("l_loop_lag", max(0.0, loop.time() - t0 - 0.01))

    def _spawn(self, coro) -> None:
        """Short-lived task that prunes itself on completion (notifies,
        peering nudges): `_tasks` must not grow with daemon lifetime."""
        task = asyncio.create_task(coro)
        self._ephemeral.add(task)
        task.add_done_callback(self._ephemeral.discard)

    async def stop(self) -> None:
        self._stopped = True
        self._watchdog.stop()
        self._subop_pending.clear()
        # never cancel the task running stop() itself (the fail-stop
        # path shuts the daemon down from inside an ephemeral task)
        cur = asyncio.current_task()
        tasks = [
            t for t in list(self._tasks) + list(self._ephemeral)
            if t is not cur
        ]
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        await self.messenger.shutdown()
        # a BlockStore owns a background deferred-write flusher: umount
        # joins it before the device closes and drains the backlog
        umount = getattr(self.store, "umount", None)
        if umount is not None:
            try:
                umount()
            except Exception:  # noqa: BLE001 - shutdown must not throw
                if (d := self.dlog.dout(1)) is not None:
                    d(f"osd.{self.id}: store umount failed at stop")
        self.tracer.close()

    def _cluster_log(self, level: str, message: str) -> None:
        """Best-effort clog to the mon (LogClient role): warning events
        must never take the data path down with them."""
        try:
            self.mon.cluster_log(level, message)
        # cephlint: disable=error-taxonomy (the dout line already landed; cluster log is best-effort)
        except Exception:  # noqa: BLE001 - the dout line already landed
            pass

    # -- fail-stop fencing (the Rebello et al. fsync-error contract) ----------

    def _note_store_fatal(self, reason: str) -> None:
        """The store fenced itself after a write/fsync device error.
        May be called from the store's flusher thread mid-lock: only
        schedule the fail-stop onto the event loop here."""
        if self._fencing or self._stopped:
            return
        self._fencing = True
        loop = self._loop
        if loop is None:
            return  # never started; nothing to tear down
        loop.call_soon_threadsafe(
            lambda: self._spawn(self._fail_stop(reason))
        )

    async def _fail_stop(self, reason: str) -> None:
        """Fail-stop: the store can no longer promise acks imply
        durability, so the daemon must go down rather than keep serving
        (RADOS assumes fail-stop OSDs). Report ourselves to the mon via
        the existing failure path — heartbeat peers confirm as our pings
        go silent — then shut down cleanly; the mon marks us down,
        peering re-targets, and data stays available on the survivors."""
        if (d := self.dlog.dout(0)) is not None:
            d(f"osd.{self.id}: store fenced ({reason}); fail-stop: "
              f"reporting ourselves to the mon and shutting down")
        self._cluster_log(
            "ERR",
            f"osd.{self.id}: store fenced ({reason}); fail-stop",
        )
        box = self._write_black_box(reason)
        if box is not None:
            # the pointer rides the cluster log so an operator reading
            # `ceph log last` knows exactly where the causal history is
            self._cluster_log(
                "ERR", f"osd.{self.id}: black box: {box}"
            )
        try:
            self.mon.report_failure(self.id)
        # cephlint: disable=error-taxonomy (one-way death report: peers will report us anyway)
        except Exception:  # noqa: BLE001 - peers will report us anyway
            pass
        # give the one-way report a beat on the wire before the
        # messenger dies with the rest of the daemon
        await asyncio.sleep(0.05)
        await self.stop()

    def _write_black_box(self, reason: str) -> str | None:
        """Crash black-box: on a fatal store error, persist the flight
        ring (recent span history regardless of sampling), the op
        tracker state, and the recent in-memory log lines to a file so
        the causal history of the crash survives the daemon. Best
        effort by design — the daemon is dying and must not hang on a
        diagnostic write."""
        dump_dir = self.config.get("tracer_crash_dump_dir")
        if not dump_dir:
            return None
        try:
            import os

            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(dump_dir, f"osd.{self.id}.blackbox.json")
            box = {
                "daemon": f"osd.{self.id}",
                "reason": reason,
                "time": time.time(),
                "flight_spans": self.tracer.flight_snapshot(),
                "ops_in_flight": self.op_tracker.dump_ops_in_flight(),
                "historic_ops": self.op_tracker.dump_historic_ops(),
                "recent_log": self.logs.dump_recent(),
            }
            with open(path, "w") as fh:
                json.dump(box, fh, indent=1)
            return path
        # cephlint: disable=error-taxonomy (diagnostic write on the death path)
        except Exception:  # noqa: BLE001 - never let diagnostics block death
            return None

    # -- placement helpers ----------------------------------------------------

    def codec(self, pool_id: int):
        if pool_id not in self._codecs:
            pool = self.osdmap.pools[pool_id]
            if not pool.is_erasure():
                self._codecs[pool_id] = None
            else:
                from ceph_tpu_torch.ec.registry import factory

                profile = dict(
                    self.osdmap.erasure_code_profiles[
                        pool.erasure_code_profile
                    ]
                )
                plugin = profile.pop("plugin", "tpu")
                self._codecs[pool_id] = factory(
                    plugin, profile, device=self.device
                )
        return self._codecs[pool_id]

    def acting_of(self, pool_id: int, ps: int) -> tuple[list[int], int]:
        """Per-epoch memoized placement: heartbeats and per-op targeting
        would otherwise re-run the scalar CRUSH mapper thousands of times
        per second for identical answers (the OSDMapMapping cache role)."""
        m = self.osdmap
        if self._acting_cache_epoch != m.epoch:
            self._acting_cache_epoch = m.epoch
            self._acting_cache = {}
        hit = self._acting_cache.get((pool_id, ps))
        if hit is None:
            _up, _upp, acting, primary = m.pg_to_up_acting_osds(
                pool_id, ps
            )
            hit = (acting, primary)
            self._acting_cache[(pool_id, ps)] = hit
        return hit

    def object_pg(self, pool_id: int, name: str) -> int:
        from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

        pool = self.osdmap.pools[pool_id]
        return pool.raw_pg_to_pg(ceph_str_hash_rjenkins(name))

    def _osd_conn(self, osd: int):
        addr = self.osdmap.osd_addrs.get(osd)
        if addr is None:
            raise RuntimeError(f"no address for osd.{osd}")
        return self.messenger.connect(
            tuple(addr), Policy.lossless_client(),
            local_addr=self.osdmap.osd_local_addrs.get(osd),
        )

    async def _peer_call(
        self, osd: int, msg_type: str, payload: dict,
        timeout: float = 10.0, raw: bytes = b"",
        batchable: bool = False,
    ) -> dict:
        """Request/response to a peer OSD (sub-op + ack). Bulk bytes ride
        the raw frame segment, never hex-in-JSON (frames_v2 multi-segment
        shape); the reply's raw segment surfaces as reply["_raw"].

        `batchable` sub-ops to the same peer within one event-loop tick
        coalesce into a single subop_batch frame (a k+m stripe touching
        4 peers costs 4 frames, not k+m). Only sub-ops whose senders
        tolerate per-op timeout+retry (idempotent via the replica's
        version gate) may opt in."""
        tid = next(self._tids)
        payload = dict(payload)
        payload["tid"] = tid
        payload["reply_to"] = self.id
        payload["_sent_at"] = time.time()
        trace_id = _trace_ctx.get()
        if trace_id is not None:
            payload["trace_id"] = trace_id
            self._trace(trace_id, f"{msg_type} -> osd.{osd}")
        # fork a child span per sub-op (the per-replica/EC-shard leg):
        # covers send -> peer apply -> ack, and its context rides the
        # Message so the peer's spans hang off it
        sp = self.tracer.child(
            f"subop_{msg_type}", tags={"to": f"osd.{osd}"}
        )
        wire = "" if sp is None else sp.context().encode()
        fut = asyncio.get_event_loop().create_future()
        self._waiters[tid] = fut
        try:
            conn = self._osd_conn(osd)
            if (
                batchable
                and self._subop_batch
                and conn.is_connected
                and conn.has_feature(FEATURE_SUBOP_BATCH)
            ):
                self._queue_subop(osd, msg_type, payload, raw, wire)
            else:
                # ordering: entries already queued for this peer were
                # logically sent first — they must hit the wire first,
                # or the replica's version gate drops the later one
                self._flush_subops(osd)
                self.perf.inc("subop_direct")
                conn.send_message(
                    Message(type=msg_type, tid=tid,
                            epoch=self.osdmap.epoch,
                            payload=payload, raw=raw, trace=wire)
                )
            return await self._watchdog.wait(fut, timeout)
        finally:
            self._waiters.pop(tid, None)
            if sp is not None:
                sp.finish()

    #: bound one coalesced frame (keeps head-of-line blocking and the
    #: receiver's slice bookkeeping sane under deep fan-out backlogs)
    SUBOP_BATCH_MAX = 32

    def _queue_subop(
        self, osd: int, msg_type: str, payload: dict, raw, wire: str
    ) -> None:
        raw = raw if isinstance(raw, (bytes, bytearray, memoryview)) \
            else bytes(raw)
        pend = self._subop_pending.setdefault(osd, [])
        pend.append((msg_type, payload, raw, wire))
        if len(pend) >= self.SUBOP_BATCH_MAX:
            self._flush_subops(osd)
        elif len(pend) == 1:
            # flush a few ticks out, not one: sub-ops submitted by ops
            # that the CURRENT tick's callbacks wake (an EC encode
            # completing, a batch of client writes resuming) still join
            # this frame — the extra ticks are microseconds against a
            # ms-scale sub-op round trip, and ordering is safe because
            # every direct send flushes this peer's queue first
            loop = asyncio.get_event_loop()
            loop.call_soon(
                loop.call_soon, loop.call_soon, self._flush_subops, osd
            )

    def _flush_subops(self, osd: int) -> None:
        """Put this peer's pending sub-ops on the wire: one subop_batch
        frame when several coalesced, the plain per-op message when one.
        A send failure here is absorbed — every queued op has a waiter
        with a deadline, and _sub_op_persist retries on timeout."""
        pend = self._subop_pending.pop(osd, None)
        if not pend:
            return
        try:
            conn = self._osd_conn(osd)
            if len(pend) == 1:
                mtype, payload, raw, wire = pend[0]
                self.perf.inc("subop_direct")
                conn.send_message(
                    Message(type=mtype, tid=payload["tid"],
                            epoch=self.osdmap.epoch,
                            payload=payload, raw=raw, trace=wire)
                )
                return
            ops = [
                {"type": mtype, "payload": payload,
                 "raw_len": len(raw), "trace": wire}
                for mtype, payload, raw, wire in pend
            ]
            btid = next(self._tids)
            conn.send_message(
                Message(type="subop_batch", tid=btid,
                        epoch=self.osdmap.epoch,
                        payload={"tid": btid, "ops": ops},
                        raw=b"".join(raw for _, _, raw, _ in pend))
            )
            self.perf.inc("subop_batch_tx")
            self.perf.inc("subop_batch_tx_ops", len(pend))
        # cephlint: disable=error-taxonomy (waiters time out; _sub_op_persist re-targets/retries)
        except Exception:
            pass  # waiters time out; _sub_op_persist re-targets/retries

    def _reply_peer(
        self, conn, tid: int, payload: dict, raw: bytes = b""
    ) -> None:
        payload = dict(payload)
        payload["tid"] = tid
        conn.send_message(
            Message(type="sub_reply", tid=tid,
                    epoch=self.osdmap.epoch,
                    payload=payload, raw=raw)
        )

    # -- dispatch -------------------------------------------------------------

    async def ms_dispatch(self, conn, msg: Message) -> None:
        p = payload_of(msg)
        p["_raw"] = msg.raw  # the bulk data segment, bytes verbatim
        if msg.trace:
            p["_trace"] = msg.trace  # span context rides to the handler
        if msg.type == "sub_reply":
            replies = p.get("replies")
            if replies is not None:
                # coalesced ack for a subop_batch: fan the per-op
                # replies back out to their waiters
                raw, off = p["_raw"], 0
                for r in replies:
                    n = int(r.pop("_raw_len", 0))
                    r["_raw"] = raw[off:off + n]
                    off += n
                    fut = self._waiters.get(r.get("tid"))
                    if fut is not None and not fut.done():
                        fut.set_result(r)
                return
            fut = self._waiters.get(p.get("tid"))
            if fut is not None and not fut.done():
                fut.set_result(p)
            return
        handler = getattr(self, f"_h_{msg.type}", None)
        if handler is not None:
            await handler(conn, p)

    async def _h_subop_batch(self, conn, p) -> None:
        """Coalesced same-peer sub-ops (one frame, many ops): run each
        inner op through its normal handler IN ORDER — the ordered
        handlers enqueue synchronously, so the per-PG FIFO sees sender
        order and the _sub_op_persist invariant holds. The ack gather
        runs as its own task: dispatch stays on the read loop's fast
        path and a stalled inner op never blocks this connection."""
        self.perf.inc("subop_batch_rx")
        loop = asyncio.get_event_loop()
        raw, off = p["_raw"], 0
        futs = []
        for op in p.get("ops") or []:
            ip = dict(op["payload"])
            n = int(op.get("raw_len") or 0)
            ip["_raw"] = raw[off:off + n]
            off += n
            if op.get("trace"):
                ip["_trace"] = op["trace"]
            handler = getattr(self, f"_h_{op['type']}", None)
            if handler is None:
                continue  # sender's per-op timeout retries it
            fut = loop.create_future()
            await handler(_SubOpCollector(conn, fut), ip)
            futs.append(fut)
        if futs:
            self._spawn(
                self._subop_batch_ack(conn, p.get("tid", 0), futs)
            )

    async def _subop_batch_ack(self, conn, btid: int, futs) -> None:
        """One coalesced sub_reply for every inner op that acked within
        the window; each op acks/fails INDEPENDENTLY — a straggler is
        acked on its own when it completes (or the sender's per-op
        deadline retries it) rather than holding the batch hostage.
        The window is shorter than _sub_op_persist's 2.0s per-op
        timeout so on-time acks always beat the sender's retry."""
        done, pending = await asyncio.wait(futs, timeout=1.5)
        for fut in pending:
            fut.add_done_callback(
                lambda f, c=conn: self._subop_late_ack(c, f)
            )
        replies, raws = [], []
        for fut in futs:
            if fut not in done or fut.cancelled() or fut.exception():
                continue
            m = fut.result()
            rp = dict(
                m.payload if m.payload is not None
                else json.loads(m.data) if m.data else {}
            )
            rp["_raw_len"] = len(m.raw)
            replies.append(rp)
            raws.append(m.raw)
        if replies:
            conn.send_message(
                Message(type="sub_reply", tid=btid,
                        epoch=self.osdmap.epoch,
                        payload={"tid": btid, "replies": replies},
                        raw=b"".join(raws))
            )

    def _subop_late_ack(self, conn, fut) -> None:
        if fut.cancelled() or fut.exception() is not None:
            return
        try:
            conn.send_message(fut.result())
        # cephlint: disable=error-taxonomy (the sender's retry loop owns recovery)
        except Exception:
            pass  # the sender's retry loop owns recovery

    # -- heartbeats + failure detection ---------------------------------------

    def _hb_peers(self) -> set[int]:
        """OSDs sharing at least one PG with us (the heartbeat peer set)."""
        peers: set[int] = set()
        for (pool, ps) in self.pgs:
            acting, _ = self.acting_of(pool, ps)
            peers.update(o for o in acting if o != _NONE and o != self.id)
        return peers

    async def _resub_loop(self) -> None:
        """Periodic subscription refresh: a monitor that restarted loses
        its subscriber table, and our lossless connection reconnects
        SILENTLY — without this the daemon's map stream freezes forever
        (MonClient::tick's renew_subs role). Idempotent and cheap: the
        mon replies only the incrementals we lack."""
        interval = max(1.0, self.config.get("mon_lease") * 2)
        while not self._stopped:
            await asyncio.sleep(interval)
            try:
                self.mon.subscribe(
                    from_epoch=self.osdmap.epoch if self.osdmap else 0
                )
            except Exception:
                if (d := self.dlog.dout(20)) is not None:
                    d("renew_subs failed; next tick retries")

    async def _heartbeat_loop(self) -> None:
        """Periodic concurrent pings + a separate deadline scan (the
        reference's tick-driven MOSDPing send vs heartbeat_check split,
        OSD.cc:4547/4746): a ping RPC gets the full grace to come home, so
        a momentarily busy event loop never fakes peer silence, and one
        dead peer never stalls pings to the others."""
        interval = self.config.get("osd_heartbeat_interval")
        grace = self.config.get("osd_heartbeat_grace")
        loop = asyncio.get_event_loop()

        async def ping(peer: int) -> None:
            try:
                await self._peer_call(peer, "osd_ping", {}, timeout=grace)
                self._hb_last[peer] = loop.time()
                self._reported.pop(peer, None)
            except (asyncio.TimeoutError, RuntimeError):
                pass  # the deadline scan decides what silence means

        prev_iter = loop.time()
        while not self._stopped:
            if loop.time() - prev_iter > interval * 3:
                # OUR loop stalled (jit compile, GC, CPU burst): peers'
                # apparent silence is our own fault — forgive it rather
                # than report healthy daemons (HeartbeatMap's is_healthy
                # self-check role)
                for peer in list(self._hb_last):
                    self._hb_last[peer] = max(
                        self._hb_last[peer], loop.time() - interval
                    )
            prev_iter = loop.time()
            peers = self._hb_peers()
            for peer in peers:
                if self.osdmap.is_down(peer):
                    self._hb_last.pop(peer, None)
                    self._reported.pop(peer, None)
                    continue
                self._hb_last.setdefault(peer, loop.time())
                self._spawn(ping(peer))
            for peer in list(self._hb_last):
                if peer not in peers or self.osdmap.is_down(peer):
                    continue
                silent = loop.time() - self._hb_last[peer]
                last_report = self._reported.get(peer)
                if silent > grace and (
                    last_report is None
                    or loop.time() - last_report > grace
                ):
                    if (d := self.dlog.dout(1)) is not None:
                        d(f"peer osd.{peer} silent {silent:.1f}s: "
                          f"reporting failure")
                    self.mon.report_failure(peer)
                    self._reported[peer] = loop.time()
                    self.perf.inc("heartbeat_failures")
            await asyncio.sleep(interval)

    async def _h_osd_ping(self, conn, p) -> None:
        inject = int(self.config.get("heartbeat_inject_failure"))
        if inject:
            # heartbeat_inject_failure=N: drop incoming pings for N
            # seconds (options.cc:822) — peers see silence and report us
            loop = asyncio.get_event_loop()
            if self._hb_inject_until is None:
                self._hb_inject_until = loop.time() + inject
            if loop.time() < self._hb_inject_until:
                return
        else:
            self._hb_inject_until = None  # re-armable once cleared
        self._reply_peer(conn, p["tid"], {"ok": True})

    # -- map handling + peering -----------------------------------------------

    def _note_map(self, osdmap) -> None:
        osdmap.device = self.device
        self._map_dirty.set()

    async def _peering_loop(self) -> None:
        """Re-evaluate PG responsibility on every map change."""
        while not self._stopped:
            await self._map_dirty.wait()
            self._map_dirty.clear()
            try:
                await self._handle_map_change()
            except asyncio.CancelledError:
                raise
            # cephlint: disable=error-taxonomy (next epoch retries)
            except Exception:
                pass  # next epoch retries

    async def _handle_map_change(self) -> None:
        m = self.osdmap
        # alive but marked down (a false failure report, or mon churn ate
        # our boot): re-boot, the reference's OSD::start_boot-on-mark-down
        # behavior — without this a spurious down mark is permanent
        loop = asyncio.get_event_loop()
        if (
            self.id >= m.max_osd
            or not m.osd_up[self.id]
            or m.osd_addrs.get(self.id) != tuple(self.messenger.my_addr)
        ):
            if loop.time() >= self._next_reboot:
                self._next_reboot = loop.time() + 1.0
                self.mon.send_boot(
                    self.id, tuple(self.messenger.my_addr),
                    location=self.crush_location,
                    local_addr=self.messenger.my_local_addr,
                )

            async def renudge():
                # the boot can be lost to mon churn; keep retrying until
                # a committed map shows us up again
                await asyncio.sleep(1.1)
                self._map_dirty.set()

            self._spawn(renudge())
            return
        self._maybe_split_pools()
        mine: set[tuple[int, int]] = set()
        for pool_id, pool in m.pools.items():
            for ps in range(pool.pg_num):
                acting, primary = self.acting_of(pool_id, ps)
                if self.id in [o for o in acting if o != _NONE]:
                    mine.add((pool_id, ps))
        for key in mine:
            if key not in self.pgs:
                self.pgs[key] = PG(self, *key)
        # primaries drive recovery for their PGs; the interval's acting set
        # is the peering trigger (PastIntervals role): unchanged acting on
        # an already-active PG needs no new pass
        retry_needed = False
        for (pool_id, ps) in sorted(mine):
            acting, primary = self.acting_of(pool_id, ps)
            pg = self.pgs[(pool_id, ps)]
            if primary != self.id:
                pg.active = False
                pg.last_acting = None
                mk = pg.replica_marker
                if mk is not None and list(acting) != list(mk["acting"]):
                    # acting moved past the marker's interval: stop
                    # serving balanced reads now instead of waiting for
                    # the history check to notice at read time
                    pg.replica_marker = None
                continue
            if pg.active and pg.last_acting == acting:
                # same acting as when we activated — but an interval may
                # have come and GONE in between (member died and revived
                # while our peering pass was busy elsewhere): if the
                # interval archive shows nothing since activation, skip;
                # otherwise re-peer, or a flapped member would silently
                # keep missing every write from the gap interval
                ivs = await self._pg_history(pg)
                if ivs is None or all(iv[0] <= pg.les for iv in ivs):
                    continue
            pg.active = False
            try:
                async with pg.lock:
                    complete = await self._peer_and_recover(pg, acting)
                # serviceability: activation with backfill targets still
                # needs enough COMPLETE members to reconstruct every
                # object (k shards for EC, one copy replicated) — else
                # keep peering and let revivals/drains change the math
                ec = self.codec(pool_id)
                need = 1 if ec is None else ec.get_data_chunk_count()
                ready = sum(
                    1 for o in acting
                    if o != _NONE and not m.is_down(o)
                    and o not in pg.backfill_targets
                )
                if complete and ready >= need:
                    if not await self._ensure_up_thru(
                        getattr(pg, "up_thru_need", m.epoch)
                    ):
                        # alive-confirmation not committed yet: serving
                        # writes before up_thru would let this interval
                        # hold acked data that future peering (which
                        # skips !maybe_went_rw intervals) could miss
                        retry_needed = True
                        continue
                    pg.active = True
                    pg.last_acting = list(acting)
                    pg.set_les(m.epoch)
                    if (d := self.dlog.dout(5)) is not None:
                        d(f"pg {pool_id}.{ps} active, acting {acting}, "
                          f"backfilling {sorted(pg.backfill_targets)}")
                    # tell the replicas peering finished so they may
                    # serve balanced reads for this interval
                    self._spawn(
                        self._broadcast_activate(pg, list(acting))
                    )
                    if pg.backfill_targets and (
                        pg.backfill_task is None
                        or pg.backfill_task.done()
                    ):
                        pg.backfill_task = asyncio.create_task(
                            self._drain_backfill(pg)
                        )
                        self._ephemeral.add(pg.backfill_task)
                        pg.backfill_task.add_done_callback(
                            self._ephemeral.discard
                        )
                    if pg.self_backfill and (
                        pg.self_backfill_task is None
                        or pg.self_backfill_task.done()
                    ):
                        pg.self_backfill_task = asyncio.create_task(
                            self._drain_self_backfill(pg)
                        )
                        self._ephemeral.add(pg.self_backfill_task)
                        pg.self_backfill_task.add_done_callback(
                            self._ephemeral.discard
                        )
                else:
                    retry_needed = True  # partial recovery: stay peering
            except asyncio.CancelledError:
                raise
            # cephlint: disable=error-taxonomy (transient peer trouble: retry_needed re-queries)
            except Exception:
                retry_needed = True  # transient peer trouble: try again
        if retry_needed and not self._stopped:
            async def nudge():
                await asyncio.sleep(0.3)
                self._map_dirty.set()

            self._spawn(nudge())
        self._spawn(self._trim_removed_snaps())

    async def _fetch_rotating_keys(self) -> None:
        from ceph_tpu_torch.auth.cephx import unseal

        rep = await self.mon.command(
            "auth rotating", {"service": "osd"}, timeout=10.0
        )
        if "sealed" in rep:
            payload = unseal(
                self.messenger.keyring[self.name],
                bytes.fromhex(rep["sealed"]),
            )
            if payload is None:
                raise RuntimeError("rotating keys unopenable")
            window = json.loads(payload)
        else:
            window = rep["keys"]
        self.messenger.service_keys = {
            int(e): bytes.fromhex(k) for e, k in window.items()
        }

    async def _rotating_keys_loop(self) -> None:
        interval = max(
            1.0, self.config.get("auth_service_ticket_ttl") / 4
        )
        delay = interval
        while not self._stopped:
            await asyncio.sleep(delay)
            try:
                await self._fetch_rotating_keys()
                delay = interval
            # cephlint: disable=error-taxonomy (mon churn: keep retrying fast)
            except Exception:
                delay = 1.0  # mon churn: keep retrying fast

    async def _pg_stats_loop(self) -> None:
        """Primaries report PG state sums to the mon on the
        osd_mon_report_interval cadence (OSD::ms_handle osd_stat /
        MPGStats flow): the feed for the mon's health checks."""
        while not self._stopped:
            await asyncio.sleep(
                self.config.get("osd_mon_report_interval")
            )
            stats = {"num_pgs": 0, "degraded": 0, "undersized": 0,
                     "backfilling": 0, "peering": 0, "inconsistent": 0,
                     "degraded_objects": 0, "statfs": self.statfs()}
            for (pool_id, ps), pg in list(self.pgs.items()):
                pool = self.osdmap.pools.get(pool_id)
                if pool is None:
                    continue
                acting, primary = self.acting_of(pool_id, ps)
                if primary != self.id:
                    continue
                stats["num_pgs"] += 1
                if not pg.active:
                    stats["peering"] += 1
                    continue
                live = [
                    o for o in acting
                    if o != _NONE and not self.osdmap.is_down(o)
                ]
                complete = [
                    o for o in live if o not in pg.backfill_targets
                ]
                if len(live) < pool.size:
                    stats["undersized"] += 1
                if len(complete) < pool.size or pg.self_backfill:
                    stats["degraded"] += 1
                if pg.backfill_targets or pg.self_backfill:
                    stats["backfilling"] += 1
                # object-granular durability debt: one unit per live
                # object copy/shard a degraded member is missing — the
                # reference's "N/M objects degraded" numerator
                short = (pool.size - len(complete)) + (
                    1 if pg.self_backfill else 0
                )
                if short > 0:
                    nlive = sum(
                        1 for e in pg.latest_objects().values()
                        if e["kind"] != "delete"
                    )
                    stats["degraded_objects"] += nlive * short
                stats["inconsistent"] += self._scrub_incons.get(
                    (pool_id, ps), 0
                )
            self._degraded_objects = stats["degraded_objects"]
            try:
                await self.mon.command(
                    "pg stats report",
                    {"osd": self.id, "stats": stats}, timeout=5.0,
                )
            # cephlint: disable=error-taxonomy (mon churn: next interval re-reports)
            except Exception:
                pass  # mon churn: next interval re-reports

    def _update_queue_depth(self) -> int:
        """Refresh the osd_queue_depth gauge: ops waiting on the shard
        queues plus pipelined tasks already executing."""
        depth = 0
        for shard in self._op_shards:
            depth += len(shard.queue)
            depth += sum(len(s) for s in shard.inflight.values())
        self.perf.set("osd_queue_depth", depth)
        return depth

    async def _mgr_report_loop(self) -> None:
        """Push perf-counter reports to the ACTIVE mgr every
        mgr_report_interval (MgrClient::_send_report): the mgr never
        pulls `perf dump`s on its scrape path. Reports are
        delta-compacted — only counters that changed since the last
        send ride the wire — but values stay CUMULATIVE, so a dropped
        report just widens the next sample's span instead of corrupting
        rates. The active mgr's address rides the MgrMap the mon builds
        from mgr beacons; on failover we re-prime with a full report so
        the new mgr's empty store gets complete baselines."""
        last_sent: dict[tuple[str, str], object] = {}
        target: tuple[str, tuple] | None = None
        refreshed = float("-inf")
        seq = 0
        while not self._stopped:
            interval = self.config.get("mgr_report_interval")
            await asyncio.sleep(interval)
            loop = asyncio.get_event_loop()
            # refresh the MgrMap on the stale horizon ONLY — a cluster
            # with no mgr at all must not pay a mon round-trip per tick
            if loop.time() - refreshed > max(4 * interval, 2.0):
                try:
                    rep = await self.mon.command("mgr map", timeout=5.0)
                # cephlint: disable=error-taxonomy (mon churn: next tick retries)
                except Exception:
                    continue
                refreshed = loop.time()
                mm = rep.get("mgrmap") or {}
                active = mm.get("active")
                addr = (mm.get("addrs") or {}).get(active)
                if not active or not addr:
                    target = None
                else:
                    fresh = (active, tuple(addr))
                    if target != fresh:
                        target = fresh
                        last_sent = {}
            if target is None:
                continue
            queue_depth = self._update_queue_depth()
            full = not last_sent
            counters: dict[str, dict] = {}
            for block, kv in self.perf_collection.dump().items():
                for key, val in kv.items():
                    if full or last_sent.get((block, key)) != val:
                        counters.setdefault(block, {})[key] = val
                        last_sent[(block, key)] = val
            seq += 1
            report = {
                "daemon": self.name,
                "seq": seq,
                "full": full,
                "counters": counters,
                "status": {
                    "queue_depth": queue_depth,
                    "inflight_ops": self.op_tracker.num_in_flight,
                    "degraded_objects": self._degraded_objects,
                    "pool_ops": {
                        str(pid): n for pid, n in self._pool_ops.items()
                    },
                },
                # tail-sampling surface: promoted traces for the mgr
                # collector, their exemplars for the Prometheus
                # histograms, and the capture-predicate version we hold
                # (a stale version makes the mgr push fresh predicates
                # back down this same connection)
                "capture_ver": self.tracer.capture_version,
            }
            promoted = self.tracer.drain_promoted()
            if promoted:
                report["traces"] = promoted
            exemplars = self.tracer.exemplars()
            if exemplars:
                report["exemplars"] = exemplars
            try:
                conn = self.messenger.connect(
                    target[1], Policy.lossy_client()
                )
                conn.send_message(
                    Message(type="mgr_report", payload=report)
                )
            # cephlint: disable=error-taxonomy (mgr down/failover: rediscover next tick)
            except Exception:
                target = None  # force a mgr map refresh next tick

    async def _trim_removed_snaps(self) -> None:
        """SnapTrimmer: drop clones whose snap was deleted from the pool
        (PrimaryLogPG's SnapTrimmer machinery; removed_snaps is the
        OSDMap-carried work queue). Primaries trim their own PGs; the
        deletes replicate like any delete."""
        for (pool_id, ps), pg in list(self.pgs.items()):
            pool = self.osdmap.pools.get(pool_id)
            if pool is None or not pool.removed_snaps or not pg.active:
                continue
            acting, primary = self.acting_of(pool_id, ps)
            if primary != self.id:
                continue
            removed = set(pool.removed_snaps)
            for sname, entry in list(pg.latest_objects().items()):
                if entry["kind"] != "modify":
                    continue
                if "\x1f" in sname and not sname.endswith("snapdir"):
                    continue  # clones are trimmed via their snapset owner
                name = (
                    sname[: -len("\x1fsnapdir")]
                    if sname.endswith("\x1fsnapdir") else sname
                )
                is_snapdir = sname != name
                ss = load_snapset(self._head_xattrs(pg, acting, sname))
                doomed = [c for c in ss["clones"] if c in removed]
                if not doomed:
                    continue
                try:
                    async with pg.lock:
                        for c in doomed:
                            await self._primary_delete(
                                pg, acting, snap_store_name(name, c)
                            )
                        ss["clones"] = [
                            c for c in ss["clones"] if c not in removed
                        ]
                        for c in doomed:
                            ss["sizes"].pop(str(c), None)
                        if is_snapdir and not ss["clones"]:
                            # last clone gone: the snapdir evaporates
                            await self._primary_delete(pg, acting, sname)
                        else:
                            await self._primary_ops(
                                pg, acting, sname,
                                [{"op": "setxattr",
                                  "name": SNAPSET_XATTR,
                                  "value": json.dumps(
                                      ss
                                  ).encode().hex()}],
                                [], None,
                            )
                except (asyncio.CancelledError,):
                    raise
                # cephlint: disable=error-taxonomy (next map change retries)
                except Exception:
                    continue  # next map change retries

    # -- PG splitting (pool pg_num growth; PG::split_into) --------------------

    _OSD_META = "osd_meta"

    def _seen_pg_num(self, pool_id: int) -> int | None:
        raw = self.store.omap_get(self._OSD_META, ".meta").get(
            b"pgnum/%d" % pool_id
        )
        return int(raw) if raw else None

    def _maybe_split_pools(self) -> None:
        """Deterministic local split on pg_num growth: every member moves
        the objects whose stable-mod home changed into the child PG's
        collection with fresh child log entries; peering then reconciles
        the child's acting set (which may differ from the parent's). The
        watermark persists so a member that was down during the commit
        still splits on revival."""
        if not self.store.collection_exists(self._OSD_META):
            self.store.queue_transaction(
                Transaction().create_collection(self._OSD_META).touch(
                    self._OSD_META, ".meta"
                )
            )
        for pool_id, pool in self.osdmap.pools.items():
            seen = self._seen_pg_num(pool_id)
            if seen == pool.pg_num:
                continue  # the common no-change case: no store traffic
            if seen is not None and pool.pg_num > seen:
                self._split_pool(pool_id, seen, pool.pg_num)
            self.store.queue_transaction(
                Transaction().omap_setkeys(
                    self._OSD_META, ".meta",
                    {b"pgnum/%d" % pool_id: str(pool.pg_num).encode()},
                )
            )

    def _split_pool(self, pool_id: int, old_n: int, new_n: int) -> None:
        from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

        pool = self.osdmap.pools[pool_id]
        for ps in range(old_n):
            coll = pg_coll(pool_id, ps)
            if not self.store.collection_exists(coll):
                continue
            parent = self._pg_of((pool_id, ps))
            moves: dict[int, list[dict]] = {}
            for name, entry in sorted(parent.latest_objects().items()):
                newps = pool.raw_pg_to_pg(ceph_str_hash_rjenkins(name))
                if newps != ps:
                    moves.setdefault(newps, []).append(entry)
            if not moves:
                continue
            # store names per logical name (plain, .sN shards)
            by_logical: dict[str, list[str]] = {}
            for sname in self.store.list_objects(coll):
                if sname == parent.META:
                    continue
                logical = sname
                base, sep, tail = sname.rpartition(".s")
                if sep and tail.isdigit():
                    logical = base
                by_logical.setdefault(logical, []).append(sname)
            moved_names = set()
            for newps, entries in sorted(moves.items()):
                child = self._pg_of((pool_id, newps))
                txn = Transaction()
                for e in sorted(entries, key=lambda x: x["name"]):
                    moved_names.add(e["name"])
                    for sname in by_logical.get(e["name"], []):
                        try:
                            data = self.store.read(coll, sname)
                            attrs = self.store.getattrs(coll, sname)
                        except StoreError:
                            continue
                        txn.write(child.coll, sname, data, attrs=attrs)
                        omap = self.store.omap_get(coll, sname)
                        if omap:
                            txn.omap_setkeys(child.coll, sname, omap)
                        txn.remove(coll, sname)
                    child.append_log(
                        txn,
                        {**e, "version": child.last_update + 1,
                         "epoch": self.osdmap.epoch},
                    )
                self.store.queue_transaction(txn)
            # drop the moved names from the parent's inventory AND its
            # retained log, or recovery would try to resurrect them
            txn = Transaction()
            rm_keys = [
                b"obj/" + n.encode() for n in moved_names
            ]
            for le in parent.log_entries(0):
                if le["name"] in moved_names:
                    rm_keys.append(b"log/%016x" % le["version"])
                    parent._log.pop(le["version"], None)
            txn.omap_rmkeys(coll, parent.META, rm_keys)
            for n in moved_names:
                parent._inventory.pop(n, None)
            self.store.queue_transaction(txn)
            if (d := self.dlog.dout(1)) is not None:
                d(f"split pg {pool_id}.{ps}: moved "
                  f"{len(moved_names)} objects across {len(moves)} "
                  f"children (pg_num {old_n} -> {new_n})")

    async def _peer_and_recover(self, pg: PG, acting: list[int]) -> bool:
        """GetInfo -> GetLog -> GetMissing -> push/backfill, one pass.
        True only when the PG is known complete (safe to go active).

        Info is collected from acting members AND every other up OSD: a
        remap (cluster expansion, failed host) can hand the whole acting
        set to newcomers, leaving the authoritative log only on strays.

        Authority is the max HEAD EVERSION (epoch, version) — the
        reference's eversion ordering, which makes a new reign's entries
        outrank a dead primary's divergent same-numbered tail. A member
        whose log cannot be bridged (behind the tail, or divergent) gets
        a full backfill instead of log recovery."""
        members = [o for o in acting if o != _NONE and o != self.id]
        infos: dict[int, dict] = {
            self.id: {"last_update": pg.last_update,
                      "head": list(pg.head), "tail": pg.log_tail}
        }
        for osd in set(members) | set(self._up_peers()):
            try:
                rep = await self._peer_call(
                    osd, "pg_info", {"pgid": [pg.pool, pg.ps]},
                    timeout=2.0,
                )
                infos[osd] = rep
            except (asyncio.TimeoutError, RuntimeError):
                continue
        # past-intervals gate (PeeringState::build_prior): any interval
        # since our last activation that could have served writes must
        # have at least one member among the peers we actually reached —
        # else an unreached member may hold acked writes we cannot see,
        # and going active would serve (and later un-serve) stale state
        intervals = await self._pg_history(pg)
        if intervals is None:
            return False  # no map history without a mon quorum: wait
        # the CURRENT interval's start epoch (same_interval_since): the
        # up_thru value activation must confirm. Taken from the mon's
        # interval archive, NOT from when this daemon first noticed the
        # interval — a first-seen epoch would ratchet with every
        # up_thru commit and a mass PG split would cascade epochs
        pg.up_thru_need = intervals[-1][0] if intervals else (
            self.osdmap.epoch
        )
        pool = self.osdmap.pools[pg.pool]
        contacted = set(infos)
        for interval in intervals:
            _epoch, acting_h, primary_h = interval[:3]
            # interval-accurate prior set (PastIntervals maybe_went_rw,
            # osd_types.h:3030): a closed interval whose primary never
            # committed up_thru inside it cannot hold acked writes —
            # skip it instead of blocking on its unreachable members
            rw = interval[3] if len(interval) > 3 else True
            if not rw:
                continue
            live = [o for o in acting_h if o != _NONE]
            if primary_h in (-1, _NONE) or len(live) < pool.min_size:
                continue  # could not have gone active
            if not (set(live) & contacted):
                return False
        best_osd = max(
            infos,
            key=lambda o: (tuple(infos[o]["head"]), o == self.id),
        )
        ok = True
        if tuple(infos[best_osd]["head"]) > pg.head:
            ok = await self._pull_from_authority(
                pg, best_osd, infos[best_osd], acting
            )
        member_infos = {
            o: v for o, v in infos.items() if o in members or o == self.id
        }
        pushed = await self._push_missing(pg, acting, member_infos)
        return ok and pushed

    async def _ensure_up_thru(self, need: int) -> bool:
        """Alive-confirmation gate (OSD::send_alive -> OSDMonitor::
        prepare_alive): True once the committed map's up_thru for this
        daemon reaches `need` (the first epoch we saw the activating
        interval). Serving writes before the commit would create an
        interval that future peering — which skips !maybe_went_rw
        intervals — could not know to consult."""
        m = self.osdmap
        if self.id < m.max_osd and int(m.osd_up_thru[self.id]) >= need:
            return True
        if self._up_thru_requested >= need:
            # commit in flight; the committed inc will dirty the map and
            # re-run this pass
            return False
        self._up_thru_requested = need
        try:
            rep = await self.mon.command(
                "osd up-thru", {"osd": self.id, "epoch": need},
                timeout=5.0,
            )
            return int(rep.get("up_thru", 0)) >= need
        # cephlint: disable=error-taxonomy (mon churn: clear the request so the next pass re-asks)
        except Exception:
            self._up_thru_requested = 0  # mon churn: re-request
            return False

    async def _pg_history(self, pg: PG):
        """Past intervals for `pg`, fetched in ONE bulk mon command per
        map epoch for every local PG and memoized (per-PG commands from
        the whole fleet each epoch would swamp the mon and the loop)."""
        epoch = self.osdmap.epoch
        key = (pg.pool, pg.ps)
        if self._hist_cache_epoch != epoch or key not in self._hist_cache:
            queries = {
                f"{p}.{s}": self.pgs[(p, s)].les
                for (p, s) in self.pgs
            }
            queries[f"{pg.pool}.{pg.ps}"] = pg.les
            try:
                rep = await self.mon.command(
                    "pg history", {"queries": queries}, timeout=8.0
                )
            # cephlint: disable=error-taxonomy (mon churn: peering retries without the history cache)
            except Exception:
                return None
            self._hist_cache = {
                tuple(int(x) for x in pgid.split(".")): iv
                for pgid, iv in rep["histories"].items()
            }
            self._hist_cache_epoch = epoch
        return self._hist_cache.get(key, [])

    def _needs_backfill(self, pg: PG, info: dict) -> bool:
        """Log recovery can bridge a peer only when its head is an
        ancestor of ours: same entry at its head version, and within our
        retained log (PGLog::merge_log's fallback-to-backfill rule)."""
        head = tuple(info["head"])
        if head == tuple(pg.head):
            return False
        if head == (0, 0):
            # empty peer: log-bridgeable only if our log reaches back to 0
            return pg.log_tail > 0
        if head[1] > pg.last_update or head[1] <= pg.log_tail:
            return True
        mine = pg.entry_at(head[1])
        return mine is None or (
            mine.get("epoch", 0), mine["version"]
        ) != head

    async def _pull_from_authority(
        self, pg: PG, source: int, source_info: dict, acting: list[int]
    ) -> bool:
        """Catch ourselves up from the authoritative holder: log pull when
        bridgeable, else backfill ourselves from its inventory."""
        rep = await self._peer_call(
            source, "pg_log",
            {"pgid": [pg.pool, pg.ps], "from": pg.last_update,
             "head": list(pg.head)},
        )
        if rep.get("bridgeable"):
            return await self._apply_log_entries(
                pg, rep["entries"], acting
            )
        return await self._backfill_self(pg, source, acting)

    async def _apply_log_entries(
        self, pg: PG, entries: list[dict], acting: list[int]
    ) -> bool:
        """Adopt a more advanced holder's log tail (GetLog + pull). Aborts
        at the first entry whose data is unreachable: appending later
        entries past a gap would advance last_update and silently orphan
        the skipped one forever.

        The pulls run as ONE bounded-concurrency batch up front (the
        batched recovery engine): the sub-op reads coalesce into
        subop_batch frames and concurrent EC rebuilds share decode
        launches, then the log entries apply strictly in order against
        the pulled results — the gap-abort contract is unchanged."""
        my_shard = self._my_shard(pg, acting)
        newest: dict[str, dict] = {}
        for e in entries:
            newest[e["name"]] = e
        need = [
            e for e in entries
            if e["kind"] != "delete"
            and newest[e["name"]]["version"] == e["version"]
        ]
        results = await self._recovery_gather(
            self._pull_object(pg, e["name"], my_shard, acting, e)
            for e in need
        )
        pulled = {
            (e["name"], e["version"]): got
            for e, got in zip(need, results)
        }
        for e in entries:
            txn = Transaction()
            if e["kind"] == "delete":
                txn.remove(pg.coll, shard_name(e["name"], my_shard))
            elif newest[e["name"]]["version"] != e["version"]:
                pass  # superseded within this pull: newest entry has it
            else:
                got = pulled.get((e["name"], e["version"]))
                if got is None:
                    return False  # retry the whole tail next pass
                data, attrs = got
                self._write_fetched(
                    txn, pg.coll, shard_name(e["name"], my_shard),
                    data, attrs,
                )
            pg.append_log(txn, e)
            self.store.queue_transaction(txn)
            self.perf.inc("recovery_pulls")
        return True

    async def _recovery_gather(self, coros) -> list:
        """Run recovery fetches concurrently, bounded by
        `osd_recovery_batch_max` (the reference's osd_recovery_max_active
        window): results come back in submission order, a failed fetch
        becomes None (recovery call sites already treat None as
        retry-next-pass). Concurrency is what lets the per-peer sub-op
        coalescer fold the reads into batch frames and the EncodeService
        fold the EC rebuilds into shared decode launches."""
        limit = max(1, int(self.config.get("osd_recovery_batch_max")))
        sem = asyncio.Semaphore(limit)

        async def run(c):
            async with sem:
                try:
                    return await c
                except (asyncio.TimeoutError, RuntimeError):
                    return None

        return await asyncio.gather(*(run(c) for c in coros))

    def _local_logical_names(self, pg: PG) -> dict[str, str]:
        """logical object name -> store name for our copies/shards."""
        out = {}
        for sname in self.store.list_objects(pg.coll):
            if sname == pg.META:
                continue
            logical = sname
            # strip a shard suffix (EC layout folds shard id in the key)
            base, sep, tail = sname.rpartition(".s")
            if sep and tail.isdigit():
                logical = base
            out[logical] = sname
        return out

    async def _backfill_self(
        self, pg: PG, source: int, acting: list[int]
    ) -> bool:
        """Resync FROM the authority (recover_backfill pulling): adopt
        its inventory + log head NOW — dropping local strays — and let
        the PG activate immediately; the object DATA heals in the
        background (_drain_self_backfill). An amnesiac primary can serve
        the moment it knows WHAT exists: EC reads decode around the
        missing local shard, replicated reads fall back to peer copies,
        and new writes land fresh locally. Blocking the whole PG behind
        a full self-pull was the availability hole the thrasher kept
        finding (the reference's answer is PastIntervals + pg_temp: a
        complete member serves while the newcomer backfills)."""
        try:
            rep = await self._peer_call(
                source, "pg_inventory", {"pgid": [pg.pool, pg.ps]},
                timeout=10.0,
            )
        except (asyncio.TimeoutError, RuntimeError):
            return False
        inventory = rep["inventory"]
        txn = Transaction()
        for logical, sname in self._local_logical_names(pg).items():
            e = inventory.get(logical)
            if e is None or e["kind"] == "delete":
                txn.remove(pg.coll, sname)
        pg.reset_log(
            txn, inventory, tuple(rep["head"]), rep["tail"]
        )
        self.store.queue_transaction(txn)
        pg.self_backfill = True
        return True

    async def _drain_self_backfill(self, pg: PG) -> None:
        """Pull our own missing/stale copies/shards back while serving
        (the puller half of async backfill). Each landed object is
        version-gated against concurrent client writes: a pull result
        older than what a write just stored locally is dropped — the
        next sweep sees the newer inventory entry already satisfied."""
        while pg.self_backfill and not self._stopped:
            acting, primary = self.acting_of(pg.pool, pg.ps)
            if primary != self.id or not pg.active:
                return
            my = self._my_shard(pg, acting)
            missing = 0
            work: list[tuple[str, str, dict]] = []
            for name, e in sorted(pg.latest_objects().items()):
                if e["kind"] == "delete":
                    continue
                sname = shard_name(name, my)
                try:
                    if (
                        self.store.getattrs(pg.coll, sname).get("ver")
                        == e["obj_ver"]
                    ):
                        continue
                except StoreError:
                    pass
                work.append((name, sname, e))
            # one bounded-concurrency batch per sweep: the pulls
            # coalesce into subop_batch frames / shared decode launches
            results = await self._recovery_gather(
                self._pull_object(pg, name, my, acting, e)
                for name, _sname, e in work
            )
            for (name, sname, e), got in zip(work, results):
                cur = pg.latest_objects().get(name)
                if got is None or cur is None:
                    missing += 1
                    continue
                if cur["obj_ver"] != e["obj_ver"]:
                    missing += 1  # advanced mid-pull: next sweep
                    continue
                try:
                    local_ver = self.store.getattrs(
                        pg.coll, sname
                    ).get("ver") or 0
                except StoreError:
                    local_ver = 0
                if local_ver == cur["obj_ver"]:
                    continue  # a concurrent write healed it for us
                # any other local version — including a HIGHER one from
                # a divergent past reign — is stale; overwrite it
                txn = Transaction()
                self._write_fetched(txn, pg.coll, sname, got[0], got[1])
                self.store.queue_transaction(txn)
                self.perf.inc("recovery_pulls")
            if missing == 0:
                # one re-check pass: anything written mid-sweep has a
                # fresh local copy already (writes apply locally too)
                pg.self_backfill = False
                if (d := self.dlog.dout(5)) is not None:
                    d(f"pg {pg.pool}.{pg.ps} self-backfill complete")
                return
            await asyncio.sleep(0.2)

    def _write_fetched(
        self, txn: Transaction, coll: str, sname: str, data: bytes,
        attrs: dict,
    ) -> None:
        """Store a recovered copy/shard, applying the _omap rider as real
        omap rows (replacing any stale local ones). The hinfo digest for
        THIS position is recomputed from the bytes being stored: attrs
        travel from whichever shard sourced the recovery, and after
        sub-stripe overwrites each shard's hinfo is only authoritative
        for its own position."""
        attrs = dict(attrs)
        omap_hex = attrs.pop("_omap", None)
        hinfo = attrs.get("hinfo")
        if hinfo is not None:
            base, sep, tail = sname.rpartition(".s")
            if sep and tail.isdigit():
                pos = int(tail)
                hashes = list(hinfo.cumulative_shard_hashes)
                if pos < len(hashes):
                    hashes[pos] = ceph_crc32c(SEED, data)
                attrs["hinfo"] = HashInfo(len(data), hashes)
        txn.write(coll, sname, data, attrs=attrs)
        if omap_hex:
            existing = self.store.omap_get(coll, sname)
            if existing:
                txn.omap_rmkeys(coll, sname, list(existing))
            txn.omap_setkeys(
                coll, sname,
                {bytes.fromhex(k): bytes.fromhex(v)
                 for k, v in omap_hex.items()},
            )

    def _my_shard(self, pg: PG, acting: list[int]) -> int | None:
        if self.codec(pg.pool) is None:
            return None
        try:
            return acting.index(self.id)
        except ValueError:
            return None

    def _up_peers(self) -> list[int]:
        m = self.osdmap
        return [
            o for o in sorted(m.osd_addrs)
            if o != self.id and o < m.max_osd and not m.is_down(o)
        ]

    def _holders_for(self, acting: list[int], pos: int | None) -> list[int]:
        """Candidate holders of a copy/shard: the acting home first, then
        every other up OSD — after a remap the surviving data lives on
        previous-interval STRAYS, which is exactly what the reference's
        MissingLoc tracks (src/osd/MissingLoc.cc). Includes self (local
        store) since we may hold stray shards of other positions."""
        out = []
        if pos is not None and pos < len(acting):
            home = acting[pos]
            if home != _NONE and not self.osdmap.is_down(home):
                out.append(home)
        if self.id not in out:
            out.append(self.id)
        acting_set = set(acting)
        out.extend(
            o for o in self._up_peers()
            if o not in acting_set and o not in out
        )
        # remaining acting members too (replicated: any member has a copy)
        out.extend(
            o for o in acting
            if o not in (_NONE, *out) and not self.osdmap.is_down(o)
        )
        return out

    async def _fetch_copy(self, pg: PG, sname: str, ver: int, candidates):
        """First current-version (data, attrs) among candidates, or None.
        attrs may carry an "_omap" rider: the object's user omap travels
        with its data during recovery (hex kv; applied, never stored as an
        attr)."""
        for osd in candidates:
            if osd == self.id:
                try:
                    data = self.store.read(pg.coll, sname)
                    attrs = self.store.getattrs(pg.coll, sname)
                except StoreError:
                    continue
                if attrs.get("ver") == ver:
                    omap = self.store.omap_get(pg.coll, sname)
                    if omap:
                        attrs = dict(attrs)
                        attrs["_omap"] = {
                            k.hex(): v.hex() for k, v in omap.items()
                        }
                    return data, attrs
                continue
            try:
                # recovery-tagged + batchable: concurrent pulls to the
                # same peer fold into one subop_batch frame, and the
                # receiver admits the read under the mclock recovery
                # class instead of the client default
                rep = await self._peer_call(
                    osd, "obj_read",
                    {"coll": pg.coll, "name": sname, "ver": ver,
                     "qos": QOS_RECOVERY},
                    timeout=2.0, batchable=True,
                )
            except (asyncio.TimeoutError, RuntimeError):
                continue
            if rep.get("ok"):
                return rep["_raw"], _attrs_from(rep)
        return None

    async def _rebuild_shard_subchunks(
        self, pg: PG, name: str, shard: int, acting: list[int], ver: int,
        exclude: int | None,
    ):
        """Fractional repair over the wire (the CLAY contract): fetch
        ONLY the repair sub-chunk runs minimum_to_decode names from the
        d helper shards at their acting homes — d*(1/q) of the data a
        whole-shard rebuild would move (ErasureCodeClay::minimum_to_decode,
        src/erasure-code/clay/ErasureCodeClay.cc:304+, read via the
        ECSubRead sub-extent shape, src/osd/ECBackend.cc:1605). Returns
        (bytes, attrs) or None to fall back to the whole-shard path
        (helpers missing at acting homes, or no fractional saving)."""
        ec = self.codec(pg.pool)
        sub = ec.get_sub_chunk_count()
        avail = set()
        for pos, osd in enumerate(acting):
            if (
                pos == shard or osd in (_NONE, exclude)
                or self.osdmap.is_down(osd)
                or osd in pg.backfill_targets
            ):
                continue
            avail.add(pos)
        try:
            minimum = ec.minimum_to_decode({shard}, avail)
        # cephlint: disable=error-taxonomy (unrecoverable with current shards: caller takes full recovery)
        except Exception:
            return None
        if all(
            list(runs) == [(0, sub)] for runs in minimum.values()
        ):
            return None  # whole-shard reads anyway: use the plain path
        chunks: dict[int, bytes] = {}
        attrs = cs = None
        for pos, runs in sorted(minimum.items()):
            osd = acting[pos]
            sname = shard_name(name, pos)
            if osd == self.id:
                try:
                    a = self.store.getattrs(pg.coll, sname)
                    data = self.store.read(pg.coll, sname)
                except StoreError:
                    return None
                if a.get("ver") != ver:
                    return None
                cs = len(data)
                unit = cs // sub
                raw = b"".join(
                    data[o * unit: (o + c) * unit] for o, c in runs
                )
            else:
                if cs is None:
                    # one attrs-only probe tells us the object size and
                    # therefore the shard/sub-chunk geometry
                    try:
                        probe = await self._peer_call(
                            osd, "obj_read",
                            {"coll": pg.coll, "name": sname,
                             "ver": ver, "runs": [],
                             "qos": QOS_RECOVERY},
                            timeout=2.0, batchable=True,
                        )
                    except (asyncio.TimeoutError, RuntimeError):
                        return None
                    size = (
                        _attrs_from(probe).get("size")
                        if probe.get("ok") else None
                    )
                    if not size:
                        return None
                    cs = ec.get_chunk_size(size)
                unit = cs // sub
                try:
                    rep = await self._peer_call(
                        osd, "obj_read",
                        {"coll": pg.coll, "name": sname, "ver": ver,
                         "runs": [[o * unit, c * unit]
                                  for o, c in runs],
                         "qos": QOS_RECOVERY},
                        timeout=2.0, batchable=True,
                    )
                except (asyncio.TimeoutError, RuntimeError):
                    return None
                if not rep.get("ok"):
                    return None
                raw = rep["_raw"]
                a = _attrs_from(rep)
            chunks[pos] = raw
            attrs = attrs or a
            self.perf.inc("recovery_sub_bytes", len(raw))
        try:
            rebuilt = ec.decode({shard}, chunks, chunk_size=cs)[shard]
        # cephlint: disable=error-taxonomy (decode failed: caller falls back to full-object recovery)
        except Exception:
            return None
        return rebuilt, attrs

    async def _rebuild_shard(
        self, pg: PG, name: str, shard: int, acting: list[int], ver: int,
        exclude: int | None = None,
    ):
        """Decode shard `shard` from current-version source shards found at
        acting homes or strays (RecoveryOp READING with MissingLoc)."""
        ec = self.codec(pg.pool)
        if ec.get_sub_chunk_count() > 1:
            got = await self._rebuild_shard_subchunks(
                pg, name, shard, acting, ver, exclude
            )
            if got is not None:
                return got
        chunks: dict[int, bytes] = {}
        attrs = None
        k = ec.get_data_chunk_count()

        async def fetch(pos: int):
            cands = [
                o for o in self._holders_for(acting, pos) if o != exclude
            ]
            return await self._fetch_copy(
                pg, shard_name(name, pos), ver, cands
            )

        # fetch the first k source positions concurrently (every rebuild
        # of this stripe geometry picks the SAME lowest positions, so
        # concurrent rebuilds share a (present, targets) signature and
        # coalesce below), topping up serially only past failures
        positions = [p for p in range(len(acting)) if p != shard]
        first = positions[:k]
        for pos, got in zip(first, await asyncio.gather(
            *(fetch(p) for p in first)
        )):
            if got is not None:
                chunks[pos] = got[0]
                attrs = attrs or got[1]
        for pos in positions[k:]:
            if len(chunks) >= k:
                break
            got = await fetch(pos)
            if got is not None:
                chunks[pos] = got[0]
                attrs = attrs or got[1]
        if len(chunks) < k:
            return None
        # decode through the batch service: concurrent rebuilds (a
        # batched recovery pass pulls many objects at once) sharing a
        # source signature fuse into ONE decode launch across objects
        try:
            out = await self.encode_service.decode(ec, {shard}, chunks)
        # cephlint: disable=error-taxonomy (decode failed: caller treats the object as unrecoverable this pass)
        except Exception:
            return None
        return out[shard], attrs

    async def _pull_object(
        self, pg: PG, name: str, shard: int | None, acting: list[int], entry
    ):
        """Fetch our copy/shard: direct from any holder (acting or stray),
        else (EC) rebuild by decoding (RecoveryOp READING)."""
        cands = [
            o for o in self._holders_for(acting, shard) if o != self.id
        ]
        got = await self._fetch_copy(
            pg, shard_name(name, shard), entry["obj_ver"], cands
        )
        if got is not None:
            return got
        ec = self.codec(pg.pool)
        if ec is None or shard is None:
            return None
        return await self._rebuild_shard(
            pg, name, shard, acting, entry["obj_ver"]
        )

    async def _push_missing(
        self, pg: PG, acting: list[int], infos: dict[int, dict]
    ) -> bool:
        """Push log entries + object data to every laggard member; a
        member whose log can't be bridged becomes a BACKFILL TARGET
        instead of blocking here — the PG activates without it and the
        background drain resyncs it (async backfill: the reference goes
        Active with backfill_targets excluded from acting-set service
        rather than wedging client IO behind a full resync). True when
        every non-target member is known complete."""
        inventory = pg.latest_objects()
        ec = self.codec(pg.pool)
        complete = True
        targets: set[int] = set()
        for pos, osd in enumerate(acting):
            if osd in (self.id, _NONE) or self.osdmap.is_down(osd):
                continue
            info = infos.get(osd)
            if info is None:
                complete = False  # unreachable member: state unknown
                continue
            if tuple(info["head"]) > tuple(pg.head):
                # the member OUTRANKS us (we failed to pull from the
                # authority this pass): never push — a backfill here
                # would wipe the only copy of acked writes. Stay
                # incomplete; the next pass pulls first.
                complete = False
                continue
            shard = pos if ec is not None else None
            if self._needs_backfill(pg, info):
                targets.add(osd)
                continue
            since = info["last_update"]
            if since >= pg.last_update:
                continue

            async def resolve(e, _shard=shard):
                latest = inventory.get(e["name"])
                if (
                    latest is None
                    or latest["version"] != e["version"]
                    or e["kind"] == "delete"
                ):
                    # superseded entry: the newest one carries the data
                    return {"entry": e, "has_data": False}, b""
                got = await self._object_for_push(
                    pg, e, _shard, acting
                )
                if got is None:
                    return None  # sources unavailable right now
                raw, attrs = got
                return {
                    "entry": e,
                    "has_data": True,
                    "attrs": _attrs_to(attrs),
                }, raw

            _acked, ok = await self._push_batches(
                pg, osd, shard, list(pg.log_entries(since)), resolve
            )
            if not ok:
                complete = False  # next pass retries this member
        pg.backfill_targets = targets
        return complete

    async def _push_batches(
        self, pg: PG, osd: int, shard: int | None, entries: list,
        resolve, skip_unresolved: bool = True,
    ) -> tuple[list, bool]:
        """Ship recovery pushes to `osd` as ordered obj_push_batch
        frames of up to `osd_recovery_batch_max` items: payloads resolve
        concurrently (fetches/rebuilds coalesce), then one frame and one
        ack move the whole batch instead of a round trip per object.
        Returns (entries acked, everything resolved AND acked). An
        unresolvable payload is skipped (`skip_unresolved`) or aborts
        the remaining batches — either way the result reads incomplete.
        Batches to a member go strictly one at a time: the receiver's
        admission queue must never reorder two in-flight batches, or
        log versions would land out of order and leave holes."""
        limit = max(1, int(self.config.get("osd_recovery_batch_max")))
        acked: list = []
        ok = True
        for i in range(0, len(entries), limit):
            group = entries[i:i + limit]
            payloads = await self._recovery_gather(
                resolve(e) for e in group
            )
            items: list[dict] = []
            raws: list[bytes] = []
            for got in payloads:
                if got is None:
                    ok = False
                    if not skip_unresolved:
                        return acked, False
                    continue
                payload, raw = got
                payload = dict(payload)
                payload["raw_len"] = len(raw)
                items.append(payload)
                raws.append(raw)
            if not items:
                continue
            try:
                rep = await self._peer_call(
                    osd, "obj_push_batch",
                    {"pgid": [pg.pool, pg.ps], "shard": shard,
                     "items": items, "qos": QOS_RECOVERY},
                    timeout=10.0, raw=b"".join(raws),
                )
            except (asyncio.TimeoutError, RuntimeError):
                return acked, False
            if not rep.get("ok"):
                return acked, False
            acked.extend(it["entry"] for it in items)
            self.perf.inc("recovery_pushes", len(items))
        return acked, ok

    async def _drain_backfill(self, pg: PG) -> None:
        """Background backfill of this PG's targets — concurrently,
        bounded by the osd_max_backfills semaphore — while the PG
        serves client IO (recover_backfill running under the Active
        state). Ends when no targets remain or primaryship moves (the
        next peering pass re-evaluates)."""
        while pg.backfill_targets and not self._stopped:
            acting, primary = self.acting_of(pg.pool, pg.ps)
            if primary != self.id or not pg.active:
                return
            ec = self.codec(pg.pool)
            progressed = False
            live: list[int] = []
            for osd in sorted(pg.backfill_targets):
                if osd not in acting or self.osdmap.is_down(osd):
                    pg.backfill_targets.discard(osd)
                    progressed = True
                    continue
                live.append(osd)

            async def drain_one(osd: int) -> bool:
                shard = acting.index(osd) if ec is not None else None
                return await self._backfill_member(
                    pg, acting, osd, shard
                )

            done = await asyncio.gather(*(drain_one(o) for o in live))
            for osd, finished in zip(live, done):
                if finished:
                    pg.backfill_targets.discard(osd)
                    progressed = True
                    if (d := self.dlog.dout(5)) is not None:
                        d(f"pg {pg.pool}.{pg.ps} backfill of osd.{osd} "
                          "complete")
            if progressed:
                # the backfill set shrank: refresh the replicas' marker
                # so the drained member becomes a balanced-read target
                self._spawn(self._broadcast_activate(pg, acting))
            else:
                await asyncio.sleep(0.2)

    async def _backfill_member(
        self, pg: PG, acting: list[int], osd: int, shard: int | None
    ) -> bool:
        """Full resync TO a member whose log we can't bridge: push every
        live object at its current version, then hand it our inventory +
        head so it drops strays and restarts its log (recover_backfill +
        the reservation throttle, PeeringState WaitRemoteBackfillReserved:
        osd_max_backfills bounds concurrent backfills we source).

        Runs while the PG serves writes (the target takes no write
        sub-ops meanwhile): unlocked convergence passes push the moving
        inventory until a pass finds nothing new, then one final pass
        under the PG lock quiesces writes for the (tiny) residue and the
        inventory/head handoff — the backfill-finish-under-lock step."""
        async with self._backfill_sem:
            pushed: dict[str, int] = {}

            async def resolve(e):
                if e["kind"] == "delete":
                    return {"entry": e, "has_data": False}, b""
                got = await self._object_for_push(pg, e, shard, acting)
                if got is None:
                    return None
                raw, attrs = got
                return {"entry": e, "has_data": True, "force": True,
                        "attrs": _attrs_to(attrs)}, raw

            async def push_diff() -> int | None:
                work = [
                    e for name, e in sorted(pg.latest_objects().items())
                    if pushed.get(name) != e["version"]
                ]
                acked, ok = await self._push_batches(
                    pg, osd, shard, work, resolve,
                    skip_unresolved=False,
                )
                for e in acked:
                    pushed[e["name"]] = e["version"]
                if not ok:
                    return None
                return len(work)

            for _pass in range(5):
                n = await push_diff()
                if n is None:
                    return False
                if n == 0:
                    break  # converged against the live inventory
            # under SUSTAINED writes unlocked passes may never find an
            # empty diff — after the pass cap, quiesce and finish: the
            # locked pass is correct for any residue, just holds the
            # lock proportionally longer
            async with pg.lock:
                if await push_diff() is None:
                    return False
                try:
                    await self._peer_call(
                        osd, "pg_backfill_done",
                        {"pgid": [pg.pool, pg.ps],
                         "inventory": pg.latest_objects(),
                         "head": list(pg.head), "tail": pg.log_tail},
                        timeout=10.0,
                    )
                except (asyncio.TimeoutError, RuntimeError):
                    return False
            return True

    async def _object_for_push(
        self, pg: PG, entry: dict, shard: int | None, acting: list[int]
    ):
        """Data for the target's copy/shard: our own copy when we hold it
        at the right version, else fetched/rebuilt from acting + stray
        holders."""
        ver = entry["obj_ver"]
        my = self._my_shard(pg, acting)
        ec = self.codec(pg.pool)
        if ec is None or shard == my:
            sname = shard_name(entry["name"], my if ec is not None else None)
            got = await self._fetch_copy(
                pg, sname, ver, self._holders_for(acting, my)
            )
            return got
        return await self._rebuild_shard(
            pg, entry["name"], shard, acting, ver
        )

    # -- peer sub-op servers --------------------------------------------------

    async def _h_pg_info(self, conn, p) -> None:
        pg = self._pg_of(p["pgid"])
        self._reply_peer(
            conn, p["tid"],
            {"last_update": pg.last_update, "head": list(pg.head),
             "tail": pg.log_tail},
        )

    async def _h_pg_log(self, conn, p) -> None:
        """Log tail for a puller; `bridgeable` is false when the puller's
        head is not an ancestor of ours (divergent or behind our tail) —
        it must backfill instead (merge_log's divergence rule)."""
        pg = self._pg_of(p["pgid"])
        frm = p.get("from", 0)
        bridgeable = frm >= pg.log_tail
        if bridgeable and p.get("head") is not None:
            head = tuple(p["head"])
            if head != (0, 0) and head != tuple(pg.head):
                mine = pg.entry_at(head[1])
                if mine is None or (
                    mine.get("epoch", 0), mine["version"]
                ) != head:
                    bridgeable = False
        self._reply_peer(
            conn, p["tid"],
            {"entries": pg.log_entries(frm) if bridgeable else [],
             "bridgeable": bridgeable, "tail": pg.log_tail},
        )

    async def _h_pg_inventory(self, conn, p) -> None:
        pg = self._pg_of(p["pgid"])
        self._reply_peer(
            conn, p["tid"],
            {"inventory": pg.latest_objects(), "head": list(pg.head),
             "tail": pg.log_tail},
        )

    async def _h_pg_backfill_done(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_pg_backfill_done, conn)

    async def _do_pg_backfill_done(self, conn, p) -> None:
        """Backfill epilogue at the target: adopt the authority's
        inventory/head, drop strays (objects it no longer has)."""
        pg = self._pg_of(p["pgid"])
        async with pg.lock:
            if tuple(p["head"]) < pg.head:
                # a stale reign's backfill must never wipe newer state
                self._reply_peer(
                    conn, p["tid"], {"ok": False, "stale": True}
                )
                return
            inventory = p["inventory"]
            txn = Transaction()
            for logical, sname in self._local_logical_names(pg).items():
                e = inventory.get(logical)
                if e is None or e["kind"] == "delete":
                    txn.remove(pg.coll, sname)
            pg.reset_log(
                txn, inventory, tuple(p["head"]), p["tail"]
            )
            self.store.queue_transaction(txn)
        self._reply_peer(conn, p["tid"], {"ok": True})

    def _admit_recovery(self, conn, p, fn) -> bool:
        """Recovery-class admission: a sub-op tagged `qos: recovery`
        takes a detour through the sharded op queue under the mclock
        recovery profile before its handler runs — client ops keep
        their weight share against a recovery storm, and the recovery
        reservation keeps healing off zero under client storms. Returns
        True when the op was queued (caller returns; the shard worker
        re-enters `fn` with the admission marker set). Gating here in
        the handler (not ms_dispatch) covers batch-inner sub-ops too —
        _h_subop_batch calls handlers directly."""
        if p.get("qos") != QOS_RECOVERY or p.pop("_admitted", False):
            return False
        p["_admitted"] = True
        p["_rfn"] = fn
        key = str(p.get("name") or p.get("pgid"))
        shard = self._op_shards[
            zlib.crc32(key.encode()) % len(self._op_shards)
        ]
        shard.queue.enqueue(
            63,
            max(1, len(p.get("_raw") or b"") // 4096),
            (conn, p),
            klass=QOS_RECOVERY,
        )
        shard.kick.set()
        return True

    async def _h_obj_read(self, conn, p) -> None:
        """handle_sub_read: local read (+ version check when asked).
        `runs` = [[off,len],...] requests sub-extent ranges only — the
        ECSubRead (offset,count) shape (src/osd/ECMsgTypes.h to_read)
        that sub-stripe RMW reads and CLAY fractional repairs ride."""
        if self._admit_recovery(conn, p, self._h_obj_read):
            return
        reader = self.store.read
        if p.get("verify"):
            # deep-scrub fetch: read device truth, not the buffer cache
            reader = getattr(self.store, "read_verify", reader)
        try:
            data = reader(p["coll"], p["name"])
            attrs = self.store.getattrs(p["coll"], p["name"])
        except StoreError as e:
            # carry the errno so the scrubbing primary can tell at-rest
            # corruption (EIO -> read_error) from an absent copy
            self._reply_peer(
                conn, p["tid"], {"ok": False, "error": e.code}
            )
            return
        if p.get("ver") is not None and attrs.get("ver") != p["ver"]:
            self._reply_peer(conn, p["tid"], {"ok": False, "stale": True})
            return
        if p.get("runs") is not None:
            data = b"".join(
                data[off: off + ln] for off, ln in p["runs"]
            )
        attrs_out = _attrs_to(attrs)
        omap = self.store.omap_get(p["coll"], p["name"])
        if omap:
            attrs_out["_omap"] = {
                k.hex(): v.hex() for k, v in omap.items()
            }
        self._reply_peer(
            conn, p["tid"],
            {"ok": True, "attrs": attrs_out}, raw=data,
        )

    async def _h_obj_push(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_obj_push, conn)

    async def _do_obj_push(self, conn, p) -> None:
        """Recovery push: store the object/shard + its log entry. The
        data write is version-gated: a backfill/recovery push must never
        regress a copy that a concurrent client write already advanced
        past the pushed version."""
        pg = self._pg_of(p["pgid"])
        e = p["entry"]
        sname = shard_name(e["name"], p.get("shard"))
        txn = Transaction()
        if e["version"] > pg.last_update:
            pg.append_log(txn, e)
        if p.get("has_data"):
            # backfill pushes are authoritative (full resync from the
            # primary: "force") — obj_vers from a divergent reign are
            # not comparable and must be overwritten. Non-forced pushes
            # (repair, forward-completion) share our log lineage, so
            # the gate keeps them from regressing a newer local write.
            pushed_ver = _attrs_from(p).get("ver") or 0
            try:
                local_ver = self.store.getattrs(
                    pg.coll, sname
                ).get("ver") or 0
            except StoreError:
                local_ver = 0
            if p.get("force") or local_ver <= pushed_ver:
                self._write_fetched(
                    txn, pg.coll, sname, p["_raw"], _attrs_from(p)
                )
        elif e["kind"] == "delete":
            txn.remove(pg.coll, sname)
        self.store.queue_transaction(txn)
        self._reply_peer(conn, p["tid"], {"ok": True})

    async def _h_obj_push_batch(self, conn, p) -> None:
        if self._admit_recovery(conn, p, self._h_obj_push_batch):
            return
        self._enqueue_subop(p, self._do_obj_push_batch, conn)

    async def _do_obj_push_batch(self, conn, p) -> None:
        """Many recovery pushes, one frame, one commit, one ack (the
        batched recovery engine's push leg). Items apply strictly IN
        ORDER — log versions must land monotonically or the
        `version > last_update` gate would punch holes — under the same
        per-item version/force gates as _do_obj_push, and the whole
        batch lands in one store transaction."""
        pg = self._pg_of(p["pgid"])
        raw = p.get("_raw") or b""
        off = 0
        txn = Transaction()
        for item in p["items"]:
            e = item["entry"]
            n = int(item.get("raw_len") or 0)
            data = raw[off:off + n]
            off += n
            sname = shard_name(e["name"], p.get("shard"))
            if e["version"] > pg.last_update:
                pg.append_log(txn, e)
            if item.get("has_data"):
                pushed_ver = _attrs_from(item).get("ver") or 0
                try:
                    local_ver = self.store.getattrs(
                        pg.coll, sname
                    ).get("ver") or 0
                except StoreError:
                    local_ver = 0
                if item.get("force") or local_ver <= pushed_ver:
                    self._write_fetched(
                        txn, pg.coll, sname, data, _attrs_from(item)
                    )
            elif e["kind"] == "delete":
                txn.remove(pg.coll, sname)
        self.store.queue_transaction(txn)
        self._reply_peer(
            conn, p["tid"], {"ok": True, "applied": len(p["items"])}
        )

    async def _h_rep_write(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_rep_write, conn)

    async def _do_rep_write(self, conn, p) -> None:
        """ReplicatedBackend sub-write: apply locally, ack; idempotent on
        resend (the entry version gate)."""
        pg = self._pg_of(p["pgid"])
        e = p["entry"]
        async with pg.lock:
            if e["version"] > pg.last_update:
                txn = Transaction()
                if e["kind"] == "delete":
                    txn.remove(pg.coll, e["name"])
                elif e["kind"] == "clone":
                    self._local_clone(txn, pg, e["src"], e["name"])
                else:
                    txn.write(
                        pg.coll, e["name"], p["_raw"],
                        attrs=_attrs_from(p),
                    )
                    if p.get("omap_delta"):
                        self._omap_delta_txn(
                            txn, pg.coll, e["name"], p["omap_delta"]
                        )
                pg.append_log(txn, e)
                self.store.queue_transaction(txn)
                self.perf.inc("subop_w")
        self._reply_peer(conn, p["tid"], {"ok": True})

    async def _h_ec_sub_write(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_ec_sub_write, conn)

    async def _do_ec_sub_write(self, conn, p) -> None:
        self._trace(
            p.get("trace_id"),
            f"ec_sub_write apply shard={p.get('shard')}",
        )
        with self.perf.time("l_subop_apply"):
            await self._do_ec_sub_write_inner(conn, p)
        self._trace(p.get("trace_id"), "ec_sub_write acked")

    async def _do_ec_sub_write_inner(self, conn, p) -> None:
        """ECBackend::handle_sub_write for our shard."""
        pg = self._pg_of(p["pgid"])
        e = p["entry"]
        async with pg.lock:
            if e["version"] > pg.last_update:
                txn = Transaction()
                if e["kind"] == "delete":
                    txn.remove(
                        pg.coll, shard_name(e["name"], p["shard"])
                    )
                elif e["kind"] == "clone":
                    self._local_clone(
                        txn, pg,
                        shard_name(e["src"], p["shard"]),
                        shard_name(e["name"], p["shard"]),
                    )
                elif p.get("partial"):
                    extents, cur = [], 0
                    for off, ln in p.get("extents") or []:
                        extents.append(
                            (off, p["_raw"][cur: cur + ln])
                        )
                        cur += ln
                    self._partial_shard_txn(
                        txn, pg, shard_name(e["name"], p["shard"]),
                        p["shard"], extents, e["obj_ver"],
                    )
                else:
                    txn.write(
                        pg.coll,
                        shard_name(e["name"], p["shard"]),
                        p["_raw"],
                        attrs=_attrs_from(p),
                    )
                pg.append_log(txn, e)
                with self.perf.time("l_txn"):
                    self.store.queue_transaction(txn)
                self.perf.inc("subop_w")
        self._reply_peer(conn, p["tid"], {"ok": True})

    # -- cache tiering (PrimaryLogPG promote/flush/proxy, .cc:2341/2305) ------

    TIER_DIRTY_XATTR = "_cache_dirty"

    async def _h_obj_copy_get(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_obj_copy_get, conn)

    async def _do_obj_copy_get(self, conn, p) -> None:
        """Full object state for copy-from/promote/flush (the
        object_copy_data_t GET side, PrimaryLogPG::do_copy_get)."""
        pg = self._pg_of(p["pgid"])
        name = p["name"]
        ec = self.codec(pg.pool)
        async with pg.lock:
            acting, _primary = self.acting_of(pg.pool, pg.ps)
            if ec is None:
                state = self._load_state_local(pg, name)
            else:
                state = await self._load_state_ec(
                    pg, acting, name, need_data=True
                )
            if not state.exists:
                self._reply_peer(
                    conn, p["tid"], {"ok": False, "errno": "ENOENT"}
                )
                return
            omap = {}
            if ec is None:
                try:
                    omap = self.store.omap_get(pg.coll, name)
                except StoreError:
                    omap = {}
            self._reply_peer(
                conn, p["tid"],
                {"ok": True,
                 "xattrs": {k: v.hex()
                            for k, v in state.xattrs.items()},
                 "omap": {k.hex(): v.hex()
                          for k, v in (omap or {}).items()}},
                raw=bytes(state.data),
            )

    async def _h_tier_put(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_tier_put, conn)

    async def _do_tier_put(self, conn, p) -> None:
        """Apply a full-object state at this (base-pool) primary — the
        flush/copy-from WRITE side. Runs the normal primary mutation so
        it replicates/EC-encodes like any client write."""
        pg = self._pg_of(p["pgid"])
        try:
            if self.codec(pg.pool) is not None and p.get("omap"):
                p = dict(p)
                p.pop("omap")  # EC base: omap cannot land, drop it
            async with pg.lock:
                acting, _primary = self.acting_of(pg.pool, pg.ps)
                await self._primary_ops(
                    pg, acting, p["name"],
                    self._state_put_ops(p), [p["_raw"]], None,
                )
            self._reply_peer(conn, p["tid"], {"ok": True})
        except Exception as e:
            self._reply_peer(
                conn, p["tid"], {"ok": False, "error": str(e)}
            )

    async def _h_tier_delete(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_tier_delete, conn)

    async def _do_tier_delete(self, conn, p) -> None:
        pg = self._pg_of(p["pgid"])
        try:
            async with pg.lock:
                acting, _primary = self.acting_of(pg.pool, pg.ps)
                await self._primary_ops(
                    pg, acting, p["name"], [{"op": "delete"}], [], None,
                )
            self._reply_peer(conn, p["tid"], {"ok": True})
        except OpError as e:
            ok = e.code == "ENOENT"  # deleting the never-flushed is fine
            self._reply_peer(
                conn, p["tid"], {"ok": ok, "errno": e.code}
            )
        except Exception as e:
            self._reply_peer(
                conn, p["tid"], {"ok": False, "error": str(e)}
            )

    @staticmethod
    def _state_put_ops(p) -> list[dict]:
        """write_full + xattr/omap restore vector from a copy payload;
        the cache's own dirty flag never travels to the base."""
        ops = [{"op": "write_full"}]
        for k, vhex in (p.get("xattrs") or {}).items():
            if k == OSDService.TIER_DIRTY_XATTR:
                continue
            ops.append({"op": "setxattr", "name": k, "value": vhex})
        if p.get("omap"):
            ops.append({"op": "omap_set", "kv": dict(p["omap"])})
        return ops

    async def _expand_copy_from(
        self, pool_id: int, ops: list[dict], datas: list[bytes]
    ) -> tuple[list[dict], list[bytes]]:
        out_ops, out_datas, di = [], [], 0
        consuming = {"write", "write_full", "append"}
        for op in ops:
            if op["op"] != "copy_from":
                out_ops.append(op)
                if op["op"] in consuming:
                    out_datas.append(datas[di])
                    di += 1
                continue
            src = await self._tier_get(
                int(op.get("src_pool", pool_id)), op["src_name"]
            )
            if src is None:
                raise OpError(
                    "ENOENT", f"copy_from: no object {op['src_name']!r}"
                )
            if self.codec(pool_id) is not None:
                # EC destinations have no omap (ECBackend's EOPNOTSUPP);
                # data + xattrs travel, omap is dropped like the
                # reference's copy-get omap gate
                src = dict(src)
                src.pop("omap", None)
            out_ops.extend(self._state_put_ops(src))
            out_datas.append(src["_raw"])
        return out_ops, out_datas

    def _tier_primary_of(self, pool_id: int, name: str) -> int:
        ps = self.object_pg(pool_id, name)
        _acting, primary = self.acting_of(pool_id, ps)
        return primary

    async def _tier_call(
        self, pool_id: int, name: str, mtype: str, payload: dict,
        raw: bytes = b"",
    ) -> dict:
        """Internal op against another pool's primary (which may be this
        very daemon — then the handler runs locally via a loopback
        conn-less path to keep one code path)."""
        primary = self._tier_primary_of(pool_id, name)
        ps = self.object_pg(pool_id, name)
        payload = dict(payload)
        payload["pgid"] = [pool_id, ps]
        payload["name"] = name
        return await self._peer_call(
            primary, mtype, payload, timeout=10.0, raw=raw
        )

    async def _tier_get(self, pool_id: int, name: str) -> dict | None:
        rep = await self._tier_call(pool_id, name, "obj_copy_get", {})
        if not rep.get("ok"):
            if rep.get("errno") == "ENOENT":
                return None
            raise RuntimeError(rep.get("error", "copy-get failed"))
        return rep

    def _tier_dirty_set(self, pg: PG) -> dict:
        if not hasattr(pg, "tier_dirty"):
            pg.tier_dirty = {}  # name -> True, insertion-ordered
        return pg.tier_dirty

    def _tier_exists_here(self, pg: PG, name: str) -> bool:
        e = pg.latest_objects().get(name)
        return e is not None and e["kind"] != "delete"

    async def _tier_promote(
        self, pool, pg: PG, acting, name: str
    ) -> bool:
        """Copy the base pool's object into the cache PG (clean).
        Returns False when the base has no such object either."""
        src = await self._tier_get(pool.tier_of, name)
        if src is None:
            self.perf.inc("tier_miss")
            return False
        async with pg.lock:
            if not self._tier_exists_here(pg, name):  # re-check: raced
                await self._primary_ops(
                    pg, acting, name,
                    self._state_put_ops(src), [src["_raw"]], None,
                )
        self.perf.inc("tier_promote")
        return True

    async def _tier_flush(
        self, pool, pg: PG, acting, name: str, evict: bool = False
    ) -> None:
        """Write the cached object back to the base pool, clear its
        dirty mark (and optionally evict the now-clean copy)."""
        async with pg.lock:
            state = self._load_state_local(pg, name)
            if not state.exists:
                self._tier_dirty_set(pg).pop(name, None)
                return
            payload = {
                "xattrs": {k: v.hex() for k, v in state.xattrs.items()},
            }
            try:
                omap = self.store.omap_get(pg.coll, name)
            except StoreError:
                omap = {}
            if omap:
                payload["omap"] = {
                    k.hex(): v.hex() for k, v in omap.items()
                }
            data = bytes(state.data)
        dirty = self.TIER_DIRTY_XATTR in payload["xattrs"]
        if dirty:
            rep = await self._tier_call(
                pool.tier_of, name, "tier_put", payload, raw=data
            )
            if not rep.get("ok"):
                raise RuntimeError(rep.get("error", "tier flush failed"))
            async with pg.lock:
                await self._primary_ops(
                    pg, acting, name,
                    [{"op": "rmxattr",
                      "name": self.TIER_DIRTY_XATTR}], [], None,
                )
            self.perf.inc("tier_flush")
        self._tier_dirty_set(pg).pop(name, None)
        if evict:
            async with pg.lock:
                await self._primary_ops(
                    pg, acting, name, [{"op": "delete"}], [], None,
                )
            self.perf.inc("tier_evict")

    async def _tier_agent(self, pool, pg: PG, acting) -> None:
        """Flush oldest dirty objects once the PG exceeds the pool's
        dirty budget (the tier agent's dirty_ratio trigger). One agent
        per PG: a concurrent pair would pick the same oldest name and
        flush it twice."""
        if getattr(pg, "tier_agent_busy", False):
            return
        pg.tier_agent_busy = True
        try:
            dirty = self._tier_dirty_set(pg)
            while len(dirty) > pool.cache_target_dirty_max:
                name = next(iter(dirty))
                try:
                    await self._tier_flush(pool, pg, acting, name)
                # cephlint: disable=error-taxonomy (flush failure keeps the object TRACKED for the next pass)
                except Exception:
                    # keep it TRACKED (dropping it would orphan the
                    # only durable copy in the cache): rotate to the
                    # back and stop this pass; the next trigger retries
                    dirty.pop(name, None)
                    dirty[name] = True
                    break
        finally:
            pg.tier_agent_busy = False

    async def _tier_before_op(
        self, conn, p, pool, pg: PG, acting, name: str
    ) -> bool:
        """Writeback-cache behavior in front of the normal op dispatch.
        Returns True when the op was fully handled (replied) here."""
        op = p.get("op")
        if op in ("cache_flush", "cache_evict"):
            # explicit per-object flush/evict (the rados cache-flush /
            # cache-evict commands; the test's determinism lever)
            try:
                await self._tier_flush(
                    pool, pg, acting, name, evict=(op == "cache_evict")
                )
                reply = {"tid": p["tid"], "ok": True}
            except Exception as e:
                reply = {"tid": p["tid"], "ok": False,
                         "error": str(e)}
            conn.send_message(
                Message(type="osd_op_reply", tid=p["tid"],
                        epoch=self.osdmap.epoch, payload=reply)
            )
            return True
        if op == "delete":
            # deletes write through: cache copy AND base object go
            # (mini semantics — the reference caches a whiteout). A
            # failed base delete must NOT be swallowed: the local copy
            # going while the base copy survives would resurrect the
            # object on the next promote
            rep = await self._tier_call(
                pool.tier_of, name, "tier_delete", {}
            )
            base_had = rep.get("ok") and rep.get("errno") != "ENOENT"
            if not rep.get("ok"):
                raise RuntimeError(
                    rep.get("error", "tier base delete failed")
                )  # retryable: the client resends
            self._tier_dirty_set(pg).pop(name, None)
            if not self._tier_exists_here(pg, name):
                # base-only object (flushed + evicted): the base delete
                # IS the whole operation — answer here, or the normal
                # path would ENOENT an object we just deleted
                reply = {"tid": p["tid"], "ok": True}
                if not base_had:
                    reply = {"tid": p["tid"], "ok": False,
                             "errno": "ENOENT",
                             "error": f"no such object {name!r}"}
                conn.send_message(
                    Message(type="osd_op_reply", tid=p["tid"],
                            epoch=self.osdmap.epoch, payload=reply)
                )
                return True
            return False
        if not self._tier_exists_here(pg, name):
            await self._tier_promote(pool, pg, acting, name)
        else:
            self.perf.inc("tier_hit")
        # mutating vectors mark the cached object dirty atomically
        if op == "write":
            p["op"] = "ops"
            p["ops"] = [
                {"op": "write_full"},
                {"op": "setxattr", "name": self.TIER_DIRTY_XATTR,
                 "value": b"1".hex()},
            ]
            p["data_lens"] = [len(p["_raw"])]
        elif op == "ops" and is_mutating(p.get("ops") or []):
            p["ops"] = list(p["ops"]) + [
                {"op": "setxattr", "name": self.TIER_DIRTY_XATTR,
                 "value": b"1".hex()},
            ]
        else:
            return False
        dirty = self._tier_dirty_set(pg)
        dirty.pop(name, None)
        dirty[name] = True
        self._spawn(self._tier_agent(pool, pg, acting))
        return False

    def _pg_of(self, pgid) -> PG:
        key = (pgid[0], pgid[1])
        if key not in self.pgs:
            self.pgs[key] = PG(self, *key)
        return self.pgs[key]

    def _enqueue_subop(self, p, fn, conn) -> None:
        """Queue a lock-taking sub-op for ordered per-PG execution off
        the dispatch path (per-connection arrival order is preserved by
        the FIFO, which is the ordering _sub_op_persist relies on)."""
        pg = self._pg_of(p["pgid"])
        if pg.subop_task is None or pg.subop_task.done():
            pg.subop_task = asyncio.create_task(self._subop_worker(pg))
            self._tasks.append(pg.subop_task)
        if "_sent_at" in p:
            self.perf.tinc("l_subop_transit", time.time() - p["_sent_at"])
        p["_queued_at"] = time.time()
        qs = self.tracer.join(p.get("_trace"), "op_queue")
        if qs is not None:
            p["_qspan"] = qs
        pg.subop_q.put_nowait((fn, conn, p))

    async def _subop_worker(self, pg: PG) -> None:
        while not self._stopped:
            fn, conn, p = await pg.subop_q.get()
            if "_queued_at" in p:
                self.perf.tinc(
                    "l_subop_queue", time.time() - p["_queued_at"]
                )
            qs = p.pop("_qspan", None)
            if qs is not None:
                qs.finish()
            # sub-op handlers run under the SENDER's fork span, so the
            # shard-side journal/store spans attach to the right branch
            stoken = self.tracer.use_wire(p.get("_trace"))
            try:
                await fn(conn, p)
            except asyncio.CancelledError:
                raise
            # cephlint: disable=error-taxonomy (the sender retries; never kill the worker)
            except Exception:
                pass  # the sender retries; never kill the worker
            finally:
                self.tracer.release(stoken)

    # -- client ops (the primary path) ----------------------------------------

    async def _h_osd_op(self, conn, p) -> None:
        """Client ops ride the sharded weighted op queue (ShardedOpWQ,
        OSD.cc:9490 enqueue_op -> dequeue_op): the shard is picked by
        object name so same-object ops keep their arrival order, and
        within a shard the WPQ's deficit round-robin over client klasses
        fair-shares service by op cost."""
        if self.osdmap.is_blocklisted(conn.peer_name, conn.peer_nonce):
            # fencing (OSD::ms_verify_authorizer + op blacklist check):
            # an evicted/blocklisted entity's ops — including writes that
            # were in flight when the blocklist committed — are refused
            # with a terminal errno at EVERY osd, so it can never race
            # the client that took over its caps/locks
            conn.send_message(
                Message(
                    type="osd_op_reply", tid=p["tid"],
                    epoch=self.osdmap.epoch,
                    payload={"tid": p["tid"], "ok": False,
                             "errno": "EBLOCKLISTED",
                             "error": f"{conn.peer_name} is blocklisted"},
                )
            )
            return
        self._trace(p.get("trace_id"), "op_dispatch")
        shard = self._op_shards[
            zlib.crc32(p["name"].encode()) % len(self._op_shards)
        ]
        # queue-wait span: enqueue here, finished when the shard worker
        # picks the op — the ShardedOpWQ wait is a first-class trace leg
        # the queue class: a client-declared QoS class (ioctx.qos_class,
        # e.g. background data prefetch) wins over the per-client default
        klass = p.get("qos") or conn.peer_name
        qs = self.tracer.join(
            p.get("_trace"), "op_queue",
            tags={"klass": klass},
        )
        if qs is not None:
            p["_qspan"] = qs
        shard.queue.enqueue(
            63,  # osd_client_op_priority
            max(1, len(p["_raw"]) // 4096),
            (conn, p),
            klass=klass,
        )
        shard.kick.set()

    async def _op_shard_worker(self, shard) -> None:
        while not self._stopped:
            item = shard.queue.dequeue()
            if item is None:
                if len(shard.queue):
                    # mclock limit throttling: ops exist but none are
                    # eligible until the clock advances — poll, don't
                    # sleep on the kick (no new op may ever arrive)
                    await asyncio.sleep(0.005)
                    continue
                shard.kick.clear()
                await shard.kick.wait()
                continue
            conn, p = item
            rfn = p.pop("_rfn", None)
            if rfn is not None:
                # admitted recovery sub-op: re-enter its handler as an
                # ephemeral task (the handler replies to the peer; an
                # obj_push_batch re-queues itself on the PG FIFO) so a
                # slow store op can't block the shard's client ops
                task = asyncio.create_task(rfn(conn, p))
                self._ephemeral.add(task)
                task.add_done_callback(self._ephemeral.discard)
                continue
            name = p.get("name")
            inflight = shard.inflight.get(name)
            if self._op_pipelines(p):
                # EC all-write vectors run as their own tasks so the
                # sub-stripe RMW read+encode legs of in-flight writes
                # overlap (ECBackend pipelines rmw ops the same way,
                # ECBackend.cc:1830); the ExtentCache serializes
                # conflicting column windows in SPAWN order (reserve is
                # reached before the task's first yield point), the
                # _full_mut fence catches full-rewrite races, and
                # version assignment + fan-out still serialize under
                # the PG lock.
                task = asyncio.create_task(
                    self._run_client_op(conn, p)
                )
                self._ephemeral.add(task)
                bucket = shard.inflight.setdefault(name, set())
                bucket.add(task)

                def _done(t, name=name, bucket=bucket):
                    self._ephemeral.discard(t)
                    bucket.discard(t)
                    if not bucket and shard.inflight.get(
                        name
                    ) is bucket:
                        del shard.inflight[name]

                task.add_done_callback(_done)
            else:
                # strict per-object order for everything else: an
                # inline op (read, mixed vector, full rewrite) must
                # observe every previously-queued pipelined write on
                # its object — same-client read-your-writes
                if inflight:
                    await asyncio.gather(
                        *list(inflight), return_exceptions=True
                    )
                await self._run_client_op(conn, p)

    def _op_pipelines(self, p) -> bool:
        if p.get("op") != "ops":
            return False
        try:
            if self.codec(p["pool"]) is None:
                return False
        # cephlint: disable=error-taxonomy (not an EC pool or codec unavailable: not a planar candidate)
        except Exception:
            return False
        ops = p.get("ops") or []
        return bool(ops) and all(o.get("op") == "write" for o in ops)

    async def _run_client_op(self, conn, p) -> None:
        pool_id = p["pool"]
        name = p["name"]
        token = _trace_ctx.set(p.get("trace_id"))
        qs = p.pop("_qspan", None)
        if qs is not None:
            qs.finish()
        # execution span: child of the client's op_submit root; made the
        # task-local current context so every downstream site — sub-op
        # forks, encode batches, journal commits, store reads — parents
        # to it without plumbing
        # tail=True: the execution span runs its own keep/drop decision
        # at completion — a server-slow op promotes its trace even when
        # the client never relays (e.g. the client died mid-op)
        span = self.tracer.join(
            p.get("_trace"), "osd_op",
            tags={"op": p.get("op"), "object": f"{pool_id}/{name}"},
            tail=True,
        )
        stoken = None if span is None else self.tracer.use(span)
        self._trace(
            p.get("trace_id"),
            f"op_execute {p.get('op')} {pool_id}/{name}",
        )
        try:
            with self.op_tracker.track(
                f"osd_op({p.get('op')} {pool_id}/{name} "
                f"from {conn.peer_name})", span=span
            ) as tracked, self.perf.time("l_op_total"):
                await self._do_osd_op(conn, p, pool_id, name, tracked)
            self._trace(p.get("trace_id"), "op_replied")
        finally:
            if span is not None:
                span.finish()
                self.tracer.release(stoken)
            _trace_ctx.reset(token)

    async def _do_osd_op(self, conn, p, pool_id, name, tracked) -> None:
        try:
            if pool_id not in self.osdmap.pools:
                raise RuntimeError(f"no pool {pool_id}")
            ps = self.object_pg(pool_id, name)
            acting, primary = self.acting_of(pool_id, ps)
            tracked.mark_event("placed")
            if p["op"] == "shard_read":
                # EC direct-shard read: served by whichever acting
                # member homes the requested data shard (possibly the
                # primary itself); does its own state checks + redirect
                await self._serve_shard_read(
                    conn, p, pool_id, name, ps, acting, primary
                )
                return
            if primary != self.id:
                if p.get("balanced"):
                    if await self._serve_balanced_read(
                        conn, p, pool_id, name, ps, acting, primary
                    ):
                        return
                    # cannot prove our copy current: bounce to the
                    # primary, never serve unproven data — and when our
                    # marker names the PG's backfill targets (we may be
                    # one), ship them so the client's round robin stops
                    # landing reads here while the backfill drains
                    self.perf.inc("read_redirected")
                    mk = self._pg_of((pool_id, ps)).replica_marker
                    conn.send_message(
                        Message(
                            type="osd_op_reply", tid=p["tid"],
                            epoch=self.osdmap.epoch,
                            payload=redirect_reply(
                                p["tid"], primary, self.osdmap.epoch,
                                "replica cannot prove its copy current",
                                backfill=(mk or {}).get("backfill"),
                            ),
                        )
                    )
                    return
                conn.send_message(
                    Message(
                        type="osd_op_reply", tid=p["tid"],
                        epoch=self.osdmap.epoch,
                        payload={"tid": p["tid"], "ok": False,
                                 "wrong_primary": True,
                                 "epoch": self.osdmap.epoch},
                    )
                )
                return
            pg = self._pg_of((pool_id, ps))
            if not pg.active:
                raise RuntimeError(
                    f"pg {pool_id}.{ps} is peering"
                )  # retryable: no errno, the client resends
            pool = self.osdmap.pools.get(pool_id)
            if (
                pool is not None
                and pool.tier_of >= 0
                and pool.cache_mode == "writeback"
            ):
                handled = await self._tier_before_op(
                    conn, p, pool, pg, acting, name
                )
                if handled:
                    return
            reply_raw = b""
            if p["op"] in ("ops", "write", "delete"):
                if p["op"] == "ops":
                    ops, datas, off = p["ops"], [], 0
                    for ln in p.get("data_lens", []):
                        datas.append(p["_raw"][off: off + ln])
                        off += ln
                elif p["op"] == "write":
                    ops, datas = [{"op": "write_full"}], [p["_raw"]]
                else:
                    ops, datas = [{"op": "delete"}], []
                if any(o["op"] == "copy_from" for o in ops):
                    # CEPH_OSD_OP_COPY_FROM (PrimaryLogPG.cc:5622): the
                    # DEST primary fetches the source object server-side
                    # (any pool, its own included) and applies it as a
                    # normal mutation vector — so it replicates/encodes
                    # exactly like a client write
                    ops, datas = await self._expand_copy_from(
                        pool_id, ops, datas
                    )
                # instance nonce distinguishes a restarted client whose
                # fresh tid counter would otherwise collide with its old
                # reqids (osd_reqid_t carries the client instance too)
                reqid = (
                    f"{conn.peer_name}.{conn.peer_nonce}:{p['tid']}"
                )
                if (
                    is_mutating(ops)
                    and not all(
                        o["op"] in _FULL_OK_OPS for o in ops
                    )
                    and self._is_full()
                ):
                    # full handling (OSD::check_full_status / the
                    # FAILSAFE path of PrimaryLogPG): space-consuming
                    # writes are refused with ENOSPC once usage crosses
                    # mon_osd_full_ratio; deletes still run so the
                    # operator can dig the cluster out
                    raise OpError(
                        "ENOSPC",
                        f"osd.{self.id} is full "
                        f"({self.statfs()['used']} of "
                        f"{self.statfs()['total']} bytes)",
                    )
                if is_mutating(ops):
                    # EC writes do their heavy lifting BEFORE the PG
                    # lock: full-object writes pre-encode (concurrent
                    # writes coalesce into one planar launch); partial
                    # overwrites run the whole sub-stripe read+encode
                    # leg outside too, coordinated by the ExtentCache —
                    # version assignment + fan-out stay serialized
                    pre_encoded = None
                    partial = None
                    ec = self.codec(pool_id)
                    if (
                        ec is not None
                        and ops[0]["op"] == "write_full"
                        and len(ops) == 1
                    ):
                        pre_encoded = await self.encode_service.encode(
                            ec, datas[0]
                        )
                    elif ec is not None:
                        partial = await self._prepare_partial_ec(
                            pg, acting, name, ops, datas,
                            p.get("snapc"),
                        )
                    try:
                        for _attempt in range(3):
                            try:
                                async with pg.lock:
                                    op_results, reply_raw = (
                                        await self._primary_ops(
                                            pg, acting, name, ops,
                                            datas, reqid,
                                            snapc=p.get("snapc"),
                                            pre_encoded=pre_encoded,
                                            partial=partial,
                                        )
                                    )
                                break
                            except _StalePartial:
                                # a whole-object write superseded our
                                # base between prepare and commit:
                                # re-prepare against the new state
                                pg.extents.release(partial["token"])
                                partial = None
                                partial = (
                                    await self._prepare_partial_ec(
                                        pg, acting, name, ops, datas,
                                        p.get("snapc"),
                                    )
                                )
                        else:
                            raise RuntimeError(
                                f"partial write to {name!r} kept "
                                "racing full rewrites"
                            )  # retryable: client resends
                    finally:
                        if partial is not None:
                            pg.extents.release(partial["token"])
                    self.perf.inc("op_w")
                    self.perf.inc("op_in_bytes", sum(
                        len(d_) for d_ in datas if d_
                    ))
                else:
                    op_results, reply_raw = await self._primary_ops(
                        pg, acting, name, ops, datas, None,
                        snapid=p.get("snapid"),
                    )
                    self.perf.inc("op_r")
                    self.perf.inc(
                        "op_out_bytes", len(reply_raw) if reply_raw else 0
                    )
                result = {"results": op_results}
            elif p["op"] == "read":
                rname = name
                if p.get("snapid") is not None:
                    rname = self._resolve_snap(
                        pg, acting, name, p["snapid"]
                    )
                reply_raw = await self._primary_read(pg, acting, rname)
                result = {}
                self.perf.inc("op_r")
                self.perf.inc(
                    "op_out_bytes", len(reply_raw) if reply_raw else 0
                )
            elif p["op"] == "stat":
                result = self._primary_stat(pg, name)
            elif p["op"] == "call":
                async with pg.lock:
                    result = await self._primary_call(pg, acting, name, p)
                self.perf.inc("op_rw")
            elif p["op"] == "watch":
                result = await self._h_op_watch(pg, conn, p)
            elif p["op"] == "unwatch":
                result = await self._h_op_unwatch(pg, conn, p)
            elif p["op"] == "notify":
                # replied by a task: waiting for acks inline would wedge
                # this conn's dispatch loop, and the notifier may well be
                # one of the watchers being notified on this very conn
                self._spawn(self._notify_and_reply(pg, conn, p))
                return
            else:
                raise RuntimeError(f"unknown op {p['op']!r}")
            reply = {"tid": p["tid"], "ok": True, **result}
            self._pool_ops[pool_id] = self._pool_ops.get(pool_id, 0) + 1
        except (StoreError, ClsError, OpError) as e:
            if isinstance(e, StoreFatalError) or e.code == "EROFS":
                # fail-stop: our store just fenced (we are about to go
                # down) — never surface a terminal errno for an op we
                # could not durably apply; the client retries against
                # the re-targeted acting set once the mon marks us down
                reply = {"tid": p["tid"], "ok": False, "error": str(e)}
            else:
                # permanent, client-visible errno (ENOENT/EBUSY/...):
                # the client surfaces these instead of retrying
                reply = {"tid": p["tid"], "ok": False, "error": str(e),
                         "errno": e.code}
            reply_raw = b""
        except Exception as e:
            reply = {"tid": p["tid"], "ok": False, "error": str(e)}
            reply_raw = b""
        conn.send_message(
            Message(type="osd_op_reply", tid=p["tid"],
                    epoch=self.osdmap.epoch,
                    payload=reply, raw=reply_raw)
        )

    def _obj_version(self, pg: PG, name: str) -> int:
        e = pg.latest_objects().get(name)
        return 0 if e is None else e["obj_ver"]

    def _check_min_size(self, pg: PG, acting: list[int]) -> None:
        """The reference blocks IO below pool min_size: acking a write
        that landed on fewer than min_size members risks silently losing
        it if the lone holder then fails and stale replicas re-peer. The
        error is retryable (no errno) so the client resends once the
        cluster heals."""
        pool = self.osdmap.pools[pg.pool]
        # backfill targets don't count: an amnesiac-revived store takes
        # no writes and holds nothing yet, so letting it satisfy
        # min_size would ack writes that live on too few REAL copies to
        # survive the next failure (the hole PastIntervals closes in the
        # reference, osd_types.h:3030)
        alive = sum(
            1 for o in acting
            if o != _NONE and not self.osdmap.is_down(o)
            and o not in pg.backfill_targets
        )
        if alive < pool.min_size:
            raise RuntimeError(
                f"pg {pg.pool}.{pg.ps} has {alive} complete acting "
                f"members, below min_size {pool.min_size}"
            )

    async def _sub_op_persist(
        self, pg: PG, osd: int, mtype: str, payload: dict, raw: bytes = b""
    ) -> None:
        """Send a sub-op and retry until it acks, the target leaves the
        map, or the interval changes under us. Within one interval every
        acting member therefore applies every entry IN ORDER — the
        invariant that lets op-vector sub-ops mutate replica state
        incrementally (a skipped entry would diverge a replica silently).
        The reference gets the same guarantee from ordered lossless
        sessions plus peering on connection loss."""
        start_acting, start_primary = self.acting_of(pg.pool, pg.ps)
        while True:
            if self.osdmap.is_down(osd):
                return  # peering will resync it when it returns
            acting, primary = self.acting_of(pg.pool, pg.ps)
            if primary != self.id or osd not in acting:
                raise RuntimeError(
                    f"pg {pg.pool}.{pg.ps} interval changed mid-write"
                )
            try:
                rep = await self._peer_call(
                    osd, mtype, payload, timeout=2.0, raw=raw,
                    batchable=True,
                )
            except (asyncio.TimeoutError, RuntimeError):
                await asyncio.sleep(0.05)
                continue  # down-mark or ack resolves the wait
            if rep.get("ok"):
                return
            await asyncio.sleep(0.05)

    # -- the object context (do_osd_ops execution) ----------------------------

    def _load_state_local(self, pg: PG, name: str) -> ObjectState:
        """ObjectState from the local store (replicated pools; also used
        by replicas applying op vectors)."""
        entry = pg.latest_objects().get(name)
        exists = entry is not None and entry["kind"] != "delete"
        state = ObjectState(exists=exists)
        if exists:
            try:
                state.data = bytearray(self.store.read(pg.coll, name))
            except StoreError:
                state.data = bytearray()
            attrs = self.store.getattrs(pg.coll, name)
            blob = attrs.get("xattr")
            if blob:
                state.xattrs = {
                    k: bytes.fromhex(v)
                    for k, v in json.loads(blob).items()
                }
            state.omap = self.store.omap_get(pg.coll, name) or None
        return state

    def _persist_state_txn(
        self, pg: PG, name: str, state: ObjectState, obj_ver: int,
        keep_user: bytes | None = None,
    ) -> Transaction:
        """Compile the mutated state into a store transaction (replicated
        object layout: data row + ver/xattr attrs + omap delta)."""
        txn = Transaction()
        if state.deleted:
            txn.remove(pg.coll, name)
            return txn
        attrs: dict = {"ver": obj_ver}
        if state.xattrs:
            attrs["xattr"] = json.dumps(
                {k: v.hex() for k, v in state.xattrs.items()},
                sort_keys=True,
            ).encode()
        if keep_user is not None:
            attrs["user"] = keep_user
        txn.write(pg.coll, name, bytes(state.data), attrs=attrs)
        if state.omap_cleared:
            existing = self.store.omap_get(pg.coll, name)
            if existing:
                txn.omap_rmkeys(pg.coll, name, list(existing))
        if state.omap_rms:
            txn.omap_rmkeys(pg.coll, name, state.omap_rms)
        if state.omap_sets:
            txn.omap_setkeys(pg.coll, name, state.omap_sets)
        return txn

    async def _primary_ops(
        self, pg: PG, acting: list[int], name: str, ops: list[dict],
        datas: list[bytes], reqid: str | None,
        snapc: dict | None = None, snapid: int | None = None,
        pre_encoded: dict[int, bytes] | None = None,
        partial: dict | None = None,
    ) -> tuple[list[dict], bytes]:
        """Execute a client op vector (execute_ctx -> do_osd_ops ->
        issue_repop): run against the object context, and when it mutated,
        log one entry and replicate — replicated pools ship the op vector
        for deterministic re-execution, EC pools re-encode the final
        object and ship whole shards (full-stripe RMW overwrite).

        `snapc` (writes) triggers clone-on-first-write-after-snap
        (make_writeable); `snapid` (reads) redirects the context to the
        clone covering that snap."""
        if reqid is not None and reqid in pg._reqids:
            # duplicate of an already-logged op (client resend after a
            # lost reply / primary failover): never re-execute the
            # mutation — but if the original aborted mid-fan-out, finish
            # distributing its result first, or this ack would cover a
            # write that lives on too few members
            if reqid not in pg._reqids_done:
                if not await self._complete_entry_forward(
                    pg, acting, name
                ):
                    # some live member still lacks the entry: do NOT ack
                    # (the write would exist on too few members); the
                    # client's next resend tries again
                    raise RuntimeError(
                        f"op {reqid} logged but not fully replicated yet"
                    )
                pg._reqids_done.add(reqid)
            return [], b""
        ec = self.codec(pg.pool)
        mutating = is_mutating(ops)
        if mutating and snapid is not None:
            raise OpError("EINVAL", "cannot write at a snapshot")
        if mutating:
            self._check_min_size(pg, acting)
        if snapid is not None:
            name = self._resolve_snap(pg, acting, name, snapid)
        if partial is not None:
            # commit leg of a prepared sub-stripe RMW: valid only while
            # no whole-object mutation superseded the base it read from
            # (disjoint partial writes in between are fine — column
            # independence + the ExtentCache reservation)
            cur = self._obj_version(pg, name)
            if (
                pg._full_mut.get(name, 0) > partial["base_obj_ver"]
                or cur < partial["base_obj_ver"]
            ):
                raise _StalePartial
            entry = {
                "version": pg.last_update + 1,
                "name": name,
                "obj_ver": cur + 1,
                "kind": "modify",
                "epoch": self.osdmap.epoch,
            }
            if reqid is not None:
                entry["reqid"] = reqid
            await self._fan_ec_partial(pg, acting, name, entry, partial)
            if reqid is not None:
                pg._reqids_done.add(reqid)
            return [{} for _ in ops], b""
        if ec is None:
            state = self._load_state_local(pg, name)
        else:
            # EC persistence rewrites whole shards from state.data, so
            # ANY mutation needs the prior data decoded (the RMW read
            # leg) — unless the vector's first op replaces or removes the
            # object outright (ECBackend skips reads for aligned
            # full-stripe writes for the same reason)
            if mutating:
                need_data = ops[0]["op"] not in ("write_full", "delete")
            else:
                need_data = any(
                    op["op"] in ("read", "stat") for op in ops
                )
            with self.perf.time("l_load_state"):
                state = await self._load_state_ec(
                    pg, acting, name, need_data=need_data
                )
        pre_snapset = load_snapset(state.xattrs)
        if mutating and snapc:
            if not state.exists:
                # recreate after delete: adopt the snapdir's SnapSet so
                # older clones stay linked to the new head
                sd = load_snapset(
                    self._head_xattrs(pg, acting, snapdir_name(name))
                )
                if sd["clones"]:
                    state.xattrs[SNAPSET_XATTR] = json.dumps(sd).encode()
            new_ss = await self._make_writeable(
                pg, acting, name, state, snapc
            )
            if new_ss is not None:
                # the SnapSet update replicates as a real op in the
                # vector, so every replica's head carries it too
                ops = [
                    {"op": "setxattr", "name": SNAPSET_XATTR,
                     "value": json.dumps(new_ss).encode().hex()}
                ] + list(ops)
                pre_snapset = new_ss
        results, reads = execute_ops(state, ops, datas)
        if not mutating:
            return results, b"".join(reads)
        entry = {
            "version": pg.last_update + 1,
            "name": name,
            "obj_ver": self._obj_version(pg, name) + 1,
            "kind": "delete" if state.deleted else "modify",
            "epoch": self.osdmap.epoch,
        }
        if reqid is not None:
            entry["reqid"] = reqid
        if state.deleted and pre_snapset["clones"]:
            # the head is going away but clones remain: park the SnapSet
            # on the snapdir object (find_object_context's CEPH_SNAPDIR)
            await self._primary_ops(
                pg, acting, snapdir_name(name),
                [{"op": "setxattr", "name": SNAPSET_XATTR,
                  "value": json.dumps(pre_snapset).encode().hex()}],
                [], None,
            )
            entry["version"] = pg.last_update + 1
        if ec is None:
            user = None
            try:
                user = self.store.getattrs(pg.coll, name).get("user")
            except StoreError:
                pass
            txn = self._persist_state_txn(
                pg, name, state, entry["obj_ver"], keep_user=user
            )
            pg.append_log(txn, entry)
            self.store.queue_transaction(txn)
            waits = [
                self._sub_op_persist(
                    pg, osd, "rep_ops",
                    {"pgid": [pg.pool, pg.ps], "entry": entry,
                     "ops": ops,
                     "data_lens": [len(d) for d in datas]},
                    raw=b"".join(datas),
                )
                for osd in acting
                if osd not in (self.id, _NONE)
                and not self.osdmap.is_down(osd)
                and osd not in pg.backfill_targets
            ]
            if waits:
                with self.perf.time("l_fan"):
                    await asyncio.gather(*waits)
        elif state.deleted:
            await self._fan_ec_delete(pg, acting, entry)
        else:
            # preserve the cls "user" attr across data writes, like the
            # replicated branch's keep_user (a client append must not
            # erase a held cls lock)
            local = shard_name(name, self._my_shard(pg, acting))
            try:
                user = self.store.getattrs(pg.coll, local).get("user")
            except StoreError:
                user = None
            await self._fan_ec_write(
                pg, acting, name, bytes(state.data), entry,
                xattrs=state.xattrs, user_blob=user,
                pre_encoded=pre_encoded,
            )
        if reqid is not None:
            pg._reqids_done.add(reqid)
        return results, b"".join(reads)

    def _head_xattrs(self, pg: PG, acting: list[int], name: str) -> dict:
        """The head object's xattr blob (local copy or our shard)."""
        ec = self.codec(pg.pool)
        sname = shard_name(
            name, self._my_shard(pg, acting) if ec is not None else None
        )
        try:
            blob = self.store.getattrs(pg.coll, sname).get("xattr")
        except StoreError:
            blob = None
        if not blob:
            return {}
        return {
            k: bytes.fromhex(v) for k, v in json.loads(blob).items()
        }

    def _resolve_snap(
        self, pg: PG, acting: list[int], name: str, snapid: int
    ) -> str:
        """Which object serves a read at `snapid`: the oldest clone whose
        id >= snapid, else the head (SnapSet resolution,
        PrimaryLogPG::find_object_context's snapdir walk)."""
        ss = load_snapset(self._head_xattrs(pg, acting, name))
        if not ss["clones"]:
            sd = load_snapset(
                self._head_xattrs(pg, acting, snapdir_name(name))
            )
            if sd["clones"]:
                ss = sd  # deleted head: the SnapSet parked on snapdir
        covering = [c for c in sorted(ss["clones"]) if c >= snapid]
        if not covering:
            if ss["seq"] >= snapid:
                # the head was first written AFTER this snap (else that
                # write would have cloned): the object did not exist at
                # snap time
                raise StoreError(
                    "ENOENT", f"{name!r} did not exist at snap {snapid}"
                )
            return name  # head unchanged since the snap: it IS the state
        return snap_store_name(name, covering[0])

    async def _make_writeable(
        self, pg: PG, acting: list[int], name: str, state: ObjectState,
        snapc: dict,
    ) -> None:
        """Clone-on-first-write-after-snap (PrimaryLogPG::make_writeable,
        src/osd/PrimaryLogPG.cc:6500+): when the write's snap context is
        newer than the head's SnapSet, every acting member copies its
        LOCAL head (whole object, or its own EC shard — no re-encode) to
        the clone object before the mutation lands."""
        ss = load_snapset(state.xattrs)
        seq = int(snapc.get("seq", 0))
        if seq <= ss["seq"]:
            return None
        if state.exists:
            cloneid = seq
            entry = {
                "version": pg.last_update + 1,
                "name": snap_store_name(name, cloneid),
                "obj_ver": self._obj_version(pg, name),
                "kind": "clone",
                "src": name,
                "epoch": self.osdmap.epoch,
            }
            ec = self.codec(pg.pool)
            waits = []
            for pos, osd in enumerate(acting):
                if (osd == _NONE or self.osdmap.is_down(osd)
                        or osd in pg.backfill_targets):
                    continue
                shard = pos if ec is not None else None
                if osd == self.id:
                    txn = Transaction()
                    self._local_clone(
                        txn, pg,
                        shard_name(name, shard),
                        shard_name(entry["name"], shard),
                    )
                    pg.append_log(txn, entry)
                    self.store.queue_transaction(txn)
                    continue
                mtype = "ec_sub_write" if ec is not None else "rep_write"
                waits.append(
                    self._sub_op_persist(
                        pg, osd, mtype,
                        {"pgid": [pg.pool, pg.ps], "shard": shard,
                         "entry": entry},
                    )
                )
            if waits:
                await asyncio.gather(*waits)
            ss["clones"].append(cloneid)
            ss["sizes"][str(cloneid)] = len(state.data)
        ss["seq"] = seq
        return ss

    def _local_clone(
        self, txn: Transaction, pg: PG, src: str, dst: str
    ) -> None:
        """Copy our local copy/shard (data + attrs + omap) to the clone's
        storage name — clone creation never crosses the wire."""
        try:
            data = self.store.read(pg.coll, src)
            attrs = self.store.getattrs(pg.coll, src)
        except StoreError:
            return  # nothing local to clone (recovery will fill it)
        txn.write(pg.coll, dst, data, attrs=attrs)
        omap = self.store.omap_get(pg.coll, src)
        if omap:
            txn.omap_setkeys(pg.coll, dst, omap)

    async def _complete_entry_forward(
        self, pg: PG, acting: list[int], name: str
    ) -> bool:
        """Finish a partially-fanned entry by pushing the object's current
        full state (idempotent: version-gated at receivers) to every live
        acting member — the forward-completion half of the reference's
        in-progress-op handling. True only when EVERY live member took
        the push: acking on anything less would cover a write that still
        lives on too few members to survive the next failure."""
        entry = pg.latest_objects().get(name)
        if entry is None:
            return True
        ec = self.codec(pg.pool)
        ok = True
        for pos, osd in enumerate(acting):
            if (osd in (self.id, _NONE) or self.osdmap.is_down(osd)
                    or osd in pg.backfill_targets):
                continue
            shard = pos if ec is not None else None
            if entry["kind"] == "delete":
                payload = {"entry": entry, "has_data": False}
                raw = b""
            else:
                got = await self._object_for_push(
                    pg, entry, shard, acting
                )
                if got is None:
                    ok = False  # sources unavailable right now
                    continue
                raw, attrs = got
                payload = {"entry": entry, "has_data": True,
                           "attrs": _attrs_to(attrs)}
            try:
                await self._peer_call(
                    osd, "obj_push",
                    {"pgid": [pg.pool, pg.ps], "shard": shard,
                     **payload},
                    timeout=5.0, raw=raw,
                )
            except (asyncio.TimeoutError, RuntimeError):
                ok = False
        return ok

    async def _load_state_ec(
        self, pg: PG, acting: list[int], name: str, need_data: bool = True
    ) -> ObjectState:
        """EC object context: decode the current object (the RMW read leg,
        ECBackend::start_rmw's reads), xattrs off our shard's attrs."""
        entry = pg.latest_objects().get(name)
        exists = entry is not None and entry["kind"] != "delete"
        state = ObjectState(exists=exists, omap_supported=False)
        if exists:
            if need_data:
                state.data = bytearray(
                    await self._primary_read(pg, acting, name)
                )
            state.xattrs = self._head_xattrs(pg, acting, name)
        return state

    async def _fan_ec_write(
        self, pg: PG, acting: list[int], name: str, data: bytes,
        entry: dict, xattrs: dict[str, bytes] | None = None,
        user_blob: bytes | None = None,
        pre_encoded: dict[int, bytes] | None = None,
    ) -> None:
        """Encode and ship whole shards to every acting position
        (ECBackend sub-write fan-out). `pre_encoded` carries shards
        already produced by the batch service outside the PG lock."""
        ec = self.codec(pg.pool)
        if pre_encoded is not None:
            encoded = pre_encoded
        else:
            with self.perf.time("l_encode"):
                encoded = await self.encode_service.encode(ec, data)
        hinfo = HashInfo.from_shards(encoded, ec.get_chunk_count())
        attrs = {"ver": entry["obj_ver"], "hinfo": hinfo,
                 "size": len(data)}
        if xattrs:
            attrs["xattr"] = json.dumps(
                {k: v.hex() for k, v in xattrs.items()}, sort_keys=True
            ).encode()
        if user_blob is not None:
            attrs["user"] = user_blob
        pg._full_mut[name] = entry["obj_ver"]
        waits = []
        for pos, osd in enumerate(acting):
            if (osd == _NONE or self.osdmap.is_down(osd)
                    or osd in pg.backfill_targets):
                continue  # degraded write: that shard stays missing
            if osd == self.id:
                txn = Transaction().write(
                    pg.coll, shard_name(name, pos), encoded[pos],
                    attrs=attrs,
                )
                pg.append_log(txn, entry)
                self.store.queue_transaction(txn)
                continue
            waits.append(
                self._sub_op_persist(
                    pg, osd, "ec_sub_write",
                    {"pgid": [pg.pool, pg.ps], "shard": pos,
                     "entry": entry, "attrs": _attrs_to(attrs)},
                    raw=encoded[pos],
                )
            )
        if waits:
            with self.perf.time("l_fan"):
                await asyncio.gather(*waits)

    # -- sub-stripe EC overwrite (start_rmw / ExtentCache analogue) -----------

    async def _prepare_partial_ec(
        self, pg: PG, acting: list[int], name: str, ops: list[dict],
        datas: list[bytes], snapc: dict | None,
    ) -> dict | None:
        """The read+encode leg of a sub-stripe RMW, run OUTSIDE the PG
        lock (ECBackend::start_rmw's reads + ECTransaction's re-encode,
        src/osd/ECBackend.cc:1830, ECTransaction.cc:101): map the write
        ops to intra-chunk column windows, read exactly those columns of
        the k data shards, patch the client bytes in, and re-encode the
        windows through the batch service. Returns the per-shard
        sub-extents for _primary_ops to commit, or None when the vector
        doesn't qualify (growth, degraded data shard, clone-on-write
        pending, non-column-independent codec) — the caller then takes
        the whole-object path. The returned ctx holds an ExtentCache
        reservation the caller MUST release."""
        ec = self.codec(pg.pool)
        if ec is None or not getattr(ec, "column_independent", False):
            return None
        if not ops or any(op["op"] != "write" for op in ops):
            return None
        if len(datas) != len(ops):
            return None
        entry = pg.latest_objects().get(name)
        if entry is None or entry["kind"] == "delete":
            return None
        base_ver = entry["obj_ver"]
        my = self._my_shard(pg, acting)
        if my is None:
            return None
        try:
            attrs = self.store.getattrs(pg.coll, shard_name(name, my))
        except StoreError:
            return None
        size = attrs.get("size")
        if attrs.get("ver") != base_ver or not size:
            return None
        writes: list[tuple[int, int, bytes]] = []
        for op, data in zip(ops, datas):
            off = int(op.get("off", 0))
            if not data or off + len(data) > size:
                return None  # growth or no-op: whole-object path
            writes.append((off, len(data), data))
        if snapc:
            ss = load_snapset(self._head_xattrs(pg, acting, name))
            if int(snapc.get("seq", 0)) > ss["seq"]:
                return None  # make_writeable must clone first
        k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
        bs = ec.get_chunk_size(size)
        unit = ec.get_chunk_size(1)
        intervals = write_column_intervals(
            [(o, ln) for o, ln, _ in writes], bs, unit
        )
        if sum(hi - lo for lo, hi in intervals) >= bs:
            return None  # windows span the whole stripe: nothing saved
        token = await pg.extents.reserve(name, intervals)
        try:
            sub: dict[int, list[tuple[int, bytes]]] = {}
            for lo, hi in intervals:
                w = hi - lo
                if ec.get_chunk_size(k * w) != w:
                    raise _PartialUnfit
                window = bytearray(k * w)
                pieces = await asyncio.gather(*(
                    self._read_shard_columns(
                        pg, acting, name, ec.chunk_index(logical),
                        lo, w, base_ver,
                    )
                    for logical in range(k)
                ))
                for logical, piece in enumerate(pieces):
                    window[logical * w: (logical + 1) * w] = piece
                before = bytes(window)
                patch_window(window, (lo, hi), k, writes, bs)
                encoded = await self.encode_service.encode(
                    ec, bytes(window)
                )
                for logical in range(k):
                    phys = ec.chunk_index(logical)
                    seg = bytes(window[logical * w: (logical + 1) * w])
                    if seg != before[logical * w: (logical + 1) * w]:
                        sub.setdefault(phys, []).append((lo, seg))
                for logical in range(k, n):
                    phys = ec.chunk_index(logical)
                    sub.setdefault(phys, []).append((lo, encoded[phys]))
            return {
                "token": token, "base_obj_ver": base_ver,
                "size": size, "sub": sub, "intervals": intervals,
            }
        except _PartialUnfit:
            pg.extents.release(token)
            return None
        except Exception:
            pg.extents.release(token)
            raise

    async def _read_shard_columns(
        self, pg: PG, acting: list[int], name: str, phys: int,
        lo: int, w: int, base_ver: int,
    ) -> bytes:
        """Columns [lo, lo+w) of one data shard at version >= base_ver.
        `>=` not `==`: a concurrent DISJOINT sub-stripe write bumps the
        shard version without touching our columns (reservation excludes
        overlapping ones), and an intervening whole-object write is
        fenced at commit via _full_mut — so newer is safe here."""
        osd = acting[phys] if phys < len(acting) else _NONE
        if (osd == _NONE or self.osdmap.is_down(osd)
                or osd in pg.backfill_targets):
            raise _PartialUnfit
        sname = shard_name(name, phys)
        if osd == self.id:
            try:
                attrs = self.store.getattrs(pg.coll, sname)
                data = self.store.read(pg.coll, sname)
            except StoreError:
                raise _PartialUnfit
            if (attrs.get("ver") or 0) < base_ver:
                raise _PartialUnfit
            piece = data[lo: lo + w]
        else:
            try:
                rep = await self._peer_call(
                    osd, "obj_read",
                    {"coll": pg.coll, "name": sname,
                     "runs": [[lo, w]]},
                    timeout=2.0,
                )
            except (asyncio.TimeoutError, RuntimeError):
                raise _PartialUnfit
            if not rep.get("ok"):
                raise _PartialUnfit
            if (_attrs_from(rep).get("ver") or 0) < base_ver:
                raise _PartialUnfit
            piece = rep["_raw"]
        if len(piece) != w:
            raise _PartialUnfit
        return piece

    def _partial_shard_txn(
        self, txn: Transaction, pg: PG, sname: str, pos: int,
        extents: list[tuple[int, bytes]], new_ver: int,
    ) -> None:
        """One shard's share of a sub-stripe write: patch the extents via
        write_at (store traffic = bytes touched), bump the version, and
        refresh this position's crc in the hinfo attr — each shard keeps
        its OWN position's digest exact, which is all deep scrub ever
        checks against it. A shard that is absent or not at new_ver-1
        takes the log entry only and stays stale for recovery to repair
        (the reference records it missing the same way)."""
        try:
            old = self.store.read(pg.coll, sname)
            attrs = self.store.getattrs(pg.coll, sname)
        except StoreError:
            return
        if attrs.get("ver") != new_ver - 1:
            return
        new_attrs: dict = {"ver": new_ver}
        if extents:
            patched = bytearray(old)
            for off, data in extents:
                patched[off: off + len(data)] = data
                txn.write_at(pg.coll, sname, off, data)
            hinfo = attrs.get("hinfo")
            if hinfo is not None:
                hashes = list(hinfo.cumulative_shard_hashes)
                if pos < len(hashes):
                    hashes[pos] = ceph_crc32c(SEED, bytes(patched))
                new_attrs["hinfo"] = HashInfo(len(patched), hashes)
        txn.setattrs(pg.coll, sname, new_attrs)

    async def _fan_ec_partial(
        self, pg: PG, acting: list[int], name: str, entry: dict,
        partial: dict,
    ) -> None:
        """Commit leg of the sub-stripe RMW: per-shard sub-extents to
        touched data + parity positions, a metadata-only version bump to
        untouched data shards (their bytes didn't change but the object
        version did), the log entry to everyone. Wire cost scales with
        the column windows, never the object size."""
        self.perf.inc("op_w_partial")
        sub = partial["sub"]
        waits = []
        for pos, osd in enumerate(acting):
            if (osd == _NONE or self.osdmap.is_down(osd)
                    or osd in pg.backfill_targets):
                continue
            extents = sub.get(pos, [])
            if osd == self.id:
                txn = Transaction()
                self._partial_shard_txn(
                    txn, pg, shard_name(name, pos), pos, extents,
                    entry["obj_ver"],
                )
                pg.append_log(txn, entry)
                self.store.queue_transaction(txn)
                continue
            payload = {
                "pgid": [pg.pool, pg.ps], "shard": pos,
                "entry": entry, "partial": True,
                "extents": [[off, len(d)] for off, d in extents],
            }
            waits.append(
                self._sub_op_persist(
                    pg, osd, "ec_sub_write", payload,
                    raw=b"".join(d for _off, d in extents),
                )
            )
        if waits:
            await asyncio.gather(*waits)

    async def _fan_ec_delete(
        self, pg: PG, acting: list[int], entry: dict
    ) -> None:
        pg._full_mut[entry["name"]] = entry["obj_ver"]
        waits = []
        for pos, osd in enumerate(acting):
            if (osd == _NONE or self.osdmap.is_down(osd)
                    or osd in pg.backfill_targets):
                continue
            if osd == self.id:
                txn = Transaction().remove(
                    pg.coll, shard_name(entry["name"], pos)
                )
                pg.append_log(txn, entry)
                self.store.queue_transaction(txn)
                continue
            waits.append(
                self._sub_op_persist(
                    pg, osd, "ec_sub_write",
                    {"pgid": [pg.pool, pg.ps], "shard": pos,
                     "entry": entry},
                )
            )
        if waits:
            await asyncio.gather(*waits)

    async def _h_rep_ops(self, conn, p) -> None:
        self._enqueue_subop(p, self._do_rep_ops, conn)

    async def _do_rep_ops(self, conn, p) -> None:
        """Replica-side op-vector application (the sub-op carries the ops,
        the reference carries the compiled transaction — both re-apply
        deterministically; _sub_op_persist guarantees in-order arrival)."""
        self._trace(p.get("trace_id"), "rep_ops apply")
        pg = self._pg_of(p["pgid"])
        e = p["entry"]
        async with pg.lock:
            if e["version"] > pg.last_update:
                datas, off = [], 0
                for ln in p.get("data_lens", []):
                    datas.append(p["_raw"][off: off + ln])
                    off += ln
                state = self._load_state_local(pg, e["name"])
                try:
                    execute_ops(state, p["ops"], datas)
                except OpError:
                    pass  # primary already validated; state is what counts
                user = None
                try:
                    user = self.store.getattrs(
                        pg.coll, e["name"]
                    ).get("user")
                except StoreError:
                    pass
                txn = self._persist_state_txn(
                    pg, e["name"], state, e["obj_ver"], keep_user=user
                )
                pg.append_log(txn, e)
                self.store.queue_transaction(txn)
                self.perf.inc("subop_w")
        self._reply_peer(conn, p["tid"], {"ok": True})

    def _omap_delta_txn(
        self, txn: Transaction, coll: str, name: str, delta: dict
    ) -> None:
        if delta.get("clear"):
            existing = self.store.omap_get(coll, name)
            if existing:
                txn.omap_rmkeys(coll, name, list(existing))
        if delta.get("rms"):
            txn.omap_rmkeys(
                coll, name, [bytes.fromhex(k) for k in delta["rms"]]
            )
        if delta.get("sets"):
            txn.omap_setkeys(
                coll, name,
                {bytes.fromhex(k): bytes.fromhex(v)
                 for k, v in delta["sets"].items()},
            )

    async def _primary_write(
        self, pg: PG, acting: list[int], name: str, data: bytes,
        user_attrs: dict | None = None, omap_delta: dict | None = None,
    ) -> None:
        """Full-object write fan-out. `user_attrs` (cls xattrs) ride along
        as a json blob on every replica/shard; a plain client write_full
        resets them, matching its replace-the-object semantics.
        `omap_delta` (cls omap mutations) replicates exactly."""
        entry = {
            "version": pg.last_update + 1,
            "name": name,
            "obj_ver": self._obj_version(pg, name) + 1,
            "kind": "modify",
            "epoch": self.osdmap.epoch,
        }
        user_blob = (
            json.dumps(user_attrs, sort_keys=True).encode()
            if user_attrs else None
        )
        self._check_min_size(pg, acting)
        ec = self.codec(pg.pool)
        if ec is None:
            attrs = {"ver": entry["obj_ver"]}
            if user_blob is not None:
                attrs["user"] = user_blob
            else:
                # a plain write_full replaces the object, but cls writes
                # and client data writes must not clobber each other's
                # orthogonal attrs
                try:
                    old = self.store.getattrs(pg.coll, name)
                    if old.get("xattr"):
                        attrs["xattr"] = old["xattr"]
                except StoreError:
                    pass
            txn = Transaction().write(pg.coll, name, data, attrs=attrs)
            if omap_delta:
                self._omap_delta_txn(txn, pg.coll, name, omap_delta)
            pg.append_log(txn, entry)
            self.store.queue_transaction(txn)
            payload = {"pgid": [pg.pool, pg.ps], "entry": entry,
                       "attrs": _attrs_to(attrs)}
            if omap_delta:
                payload["omap_delta"] = omap_delta
            waits = [
                self._sub_op_persist(pg, osd, "rep_write", payload,
                                     raw=data)
                for osd in acting
                if osd not in (self.id, _NONE)
                and not self.osdmap.is_down(osd)
                and osd not in pg.backfill_targets
            ]
            if waits:
                with self.perf.time("l_fan"):
                    await asyncio.gather(*waits)
            return
        await self._fan_ec_write(
            pg, acting, name, data, entry, user_blob=user_blob
        )

    async def _primary_delete(
        self, pg: PG, acting: list[int], name: str
    ) -> None:
        entry = {
            "version": pg.last_update + 1,
            "name": name,
            "obj_ver": self._obj_version(pg, name) + 1,
            "kind": "delete",
            "epoch": self.osdmap.epoch,
        }
        self._check_min_size(pg, acting)
        ec = self.codec(pg.pool)
        if ec is not None:
            await self._fan_ec_delete(pg, acting, entry)
            return
        txn = Transaction().remove(pg.coll, name)
        pg.append_log(txn, entry)
        self.store.queue_transaction(txn)
        waits = [
            self._sub_op_persist(
                pg, osd, "rep_write",
                {"pgid": [pg.pool, pg.ps], "entry": entry},
            )
            for osd in acting
            if osd not in (self.id, _NONE)
            and not self.osdmap.is_down(osd)
            and osd not in pg.backfill_targets
        ]
        if waits:
            await asyncio.gather(*waits)

    async def _recover_read_error(
        self, pg: PG, acting: list[int], name: str, shard: int | None,
        entry: dict,
    ):
        """Self-healing read (PrimaryLogPG::rep_repair_primary_object):
        our local copy/shard raised EIO — pull the object from a peer
        replica (replicated) or reconstruct the lost shard by decoding
        the survivors (EC), write-back-repair the local copy, and hand
        the recovered (data, attrs) to the caller so the client op
        succeeds without ever seeing the error. None when no verified
        source is reachable (the caller falls back / retries)."""
        ver = entry["obj_ver"]
        sname = shard_name(name, shard)
        # recovery reads are traced at their own rate
        # (tracer_sample_rate_recovery): a child span when the op is
        # already sampled, else a fresh root so operators can run
        # recovery at 100% while steady-state IO stays sampled
        sp = self.tracer.child("recovery_read")
        if sp is None:
            sp = self.tracer.start("recovery_read", op_type="recovery")
        if sp is not None:
            sp.set_tag("recovery_read", 1)
            sp.set_tag("object", f"{pg.pool}/{sname}")
        try:
            if shard is None:
                got = await self._fetch_copy(
                    pg, sname, ver,
                    [o for o in self._holders_for(acting, None)
                     if o != self.id and o not in pg.backfill_targets],
                )
            else:
                got = await self._rebuild_shard(
                    pg, name, shard, acting, ver, exclude=self.id
                )
            if got is None:
                if sp is not None:
                    sp.set_tag("error", "no verified source reachable")
                return None
            data, attrs = got
            try:
                txn = Transaction()
                self._write_fetched(txn, pg.coll, sname, data, attrs)
                self.store.queue_transaction(txn)
            except StoreError:
                # a store that cannot take the write-back (fenced, full)
                # still serves the client from the recovered bytes
                pass
            self.perf.inc("read_error_repaired")
            if (d := self.dlog.dout(0)) is not None:
                d(f"osd.{self.id}: read error on {pg.coll}/{sname} "
                  f"healed from peers (recovery read, ver {ver})")
            self._cluster_log(
                "WRN",
                f"osd.{self.id}: read error on {pg.coll}/{sname} "
                f"healed from peers",
            )
            return data, attrs
        finally:
            if sp is not None:
                sp.finish()

    async def _primary_read(
        self, pg: PG, acting: list[int], name: str
    ) -> bytes:
        entry = pg.latest_objects().get(name)
        if entry is None or entry["kind"] == "delete":
            raise StoreError("ENOENT", f"no such object {name!r}")
        ec = self.codec(pg.pool)
        if ec is None:
            try:
                data = self.store.read(pg.coll, name)
                attrs = self.store.getattrs(pg.coll, name)
                if attrs.get("ver") == entry["obj_ver"]:
                    return data
            except StoreError as e:
                if e.code == "EIO":
                    # at-rest corruption / device read error: heal from
                    # a replica before the client ever sees it
                    got = await self._recover_read_error(
                        pg, acting, name, None, entry
                    )
                    if got is not None:
                        return got[0]
            # local copy missing/stale (self-backfilling primary):
            # serve from any current-version holder instead of wedging
            got = await self._fetch_copy(
                pg, name, entry["obj_ver"],
                [o for o in self._holders_for(acting, None)
                 if o != self.id and o not in pg.backfill_targets],
            )
            if got is None:
                raise RuntimeError(
                    f"no current copy of {name!r} reachable"
                )  # retryable
            return got[0]

        # EC: probe current-version shard availability at acting homes
        available: dict[int, int] = {}
        chunks: dict[int, bytes] = {}
        size = None
        for pos, osd in enumerate(acting):
            if (osd == _NONE or self.osdmap.is_down(osd)
                    or osd in pg.backfill_targets):
                continue
            if osd == self.id:
                try:
                    data = self.store.read(pg.coll, shard_name(name, pos))
                    attrs = self.store.getattrs(
                        pg.coll, shard_name(name, pos)
                    )
                except StoreError as e:
                    if e.code == "EIO":
                        # our shard is rotten: reconstruct it from the
                        # survivors, rewrite it, and serve the read
                        got = await self._recover_read_error(
                            pg, acting, name, pos, entry
                        )
                        if (
                            got is not None
                            and got[1].get("ver") == entry["obj_ver"]
                        ):
                            available[pos] = osd
                            chunks[pos] = got[0]
                            size = got[1].get("size", size)
                    continue
                if attrs.get("ver") == entry["obj_ver"]:
                    available[pos] = osd
                    chunks[pos] = data
                    size = attrs.get("size", size)
            else:
                available[pos] = osd
        want = {ec.chunk_index(i)
                for i in range(ec.get_data_chunk_count())}
        async def _fetch_shard(s: int) -> tuple[int, dict]:
            try:
                return s, await self._peer_call(
                    available[s], "obj_read",
                    {"coll": pg.coll, "name": shard_name(name, s),
                     "ver": entry["obj_ver"]},
                    timeout=2.0, batchable=True,
                )
            except (asyncio.TimeoutError, RuntimeError):
                return s, {"ok": False}

        while True:
            minimum = ec.minimum_to_decode(want, set(available))
            fetch = [s for s in minimum if s not in chunks]
            failed = None
            # all missing shards in flight at once: one gather instead of
            # k serial round trips, and same-tick fetches to one peer ride
            # a single batched sub-op frame
            results = await asyncio.gather(
                *(_fetch_shard(s) for s in fetch)
            )
            for s, rep in results:
                if not rep.get("ok"):
                    if failed is not None:
                        continue  # one miss already drives the retry
                    # acting home lacks the shard (mid-recovery interval):
                    # previous-interval strays may still hold it
                    stray = await self._fetch_copy(
                        pg, shard_name(name, s), entry["obj_ver"],
                        [o for o in self._up_peers()
                         if o not in set(acting)],
                    )
                    if stray is not None:
                        chunks[s] = stray[0]
                        if size is None:
                            size = stray[1].get("size")
                        continue
                    failed = s
                    continue
                chunks[s] = rep["_raw"]
                if size is None:
                    size = _attrs_from(rep).get("size")
            if failed is None:
                break
            del available[failed]
            chunks.pop(failed, None)
        decoded = await self.encode_service.decode(
            ec, want, {s: chunks[s] for s in minimum}
        )
        out = b"".join(
            decoded[ec.chunk_index(i)]
            for i in range(ec.get_data_chunk_count())
        )
        return out[:size] if size is not None else out

    def _primary_stat(self, pg: PG, name: str) -> dict:
        entry = pg.latest_objects().get(name)
        if entry is None or entry["kind"] == "delete":
            raise StoreError("ENOENT", f"no such object {name!r}")
        out = {"obj_ver": entry["obj_ver"],
               "pg_version": entry["version"]}
        # size without shipping data: local length (replicated) or the
        # size attr stamped on our shard (EC) — never a decode read
        ec = self.codec(pg.pool)
        acting, _ = self.acting_of(pg.pool, pg.ps)
        sname = shard_name(
            name, self._my_shard(pg, acting) if ec is not None else None
        )
        try:
            if ec is None:
                out["size"] = len(self.store.read(pg.coll, sname))
            else:
                size = self.store.getattrs(pg.coll, sname).get("size")
                if size is not None:
                    out["size"] = size
        except StoreError:
            pass  # mid-recovery: the client's operate fallback covers it
        return out

    # -- balanced replica reads & EC direct-shard reads ------------------------
    # (the reference's Octopus balanced reads: osd_read_from_replica /
    # CEPH_OSD_FLAG_BALANCE_READS lets a clean replica serve reads; here
    # the license is an explicit activation marker from the primary,
    # cross-checked against the mon's interval archive, and every state
    # the marker cannot vouch for bounces back with a redirect reply)

    async def _broadcast_activate(
        self, pg: PG, acting: list[int]
    ) -> None:
        """Hand every clean acting member the activation marker that
        licenses it to serve balanced reads this interval. Best-effort:
        write correctness never depends on the marker, so a lost
        broadcast only costs that member its share of read traffic."""
        marker = {
            "pgid": [pg.pool, pg.ps],
            "les": pg.les,
            "acting": list(acting),
            "backfill": sorted(pg.backfill_targets),
        }
        for osd in acting:
            if osd in (self.id, _NONE) or self.osdmap.is_down(osd):
                continue
            try:
                await self._peer_call(
                    osd, "pg_activate", dict(marker), timeout=2.0
                )
            except (asyncio.TimeoutError, RuntimeError):
                pass  # member serves primary-only until the next pass

    async def _h_pg_activate(self, conn, p) -> None:
        """The primary finished peering (or drained a backfill target)
        and vouches for this acting set: keep the newest marker. No
        locks taken — validity is re-derived per read from the marker
        plus the mon's interval archive, so racing markers from an old
        reign lose to the history check even if they land last."""
        pg = self._pg_of(p["pgid"])
        mk = pg.replica_marker
        if mk is None or p["les"] >= mk["les"]:
            pg.replica_marker = {
                "les": p["les"],
                "acting": list(p["acting"]),
                "backfill": list(p.get("backfill") or ()),
            }
        self._reply_peer(conn, p["tid"], {"ok": True})

    async def _replica_read_ok(
        self, pg: PG, acting: list[int], primary: int
    ) -> bool:
        """May this acting member serve a read it is not primary for?
        Proof of currency = the primary's activation marker for exactly
        this acting set, with us not a backfill target, cross-checked
        against the mon's interval archive: an interval that STARTED
        after the marker's activation epoch means membership flapped
        since the primary vouched for us (even if the flap's epochs
        never reached us — replicas coalesce map updates), so redirect.
        The archive fetch is one bulk mon query memoized per map epoch
        (_pg_history); steady-state balanced reads stay local."""
        if primary == self.id:
            return pg.active and not pg.self_backfill
        mk = pg.replica_marker
        if (
            mk is None
            or pg.self_backfill
            or self.id in mk["backfill"]
            or list(acting) != list(mk["acting"])
        ):
            return False
        ivs = await self._pg_history(pg)
        if ivs is None:
            return False  # mon unreachable: cannot prove, do not serve
        return not ivs or ivs[-1][0] <= mk["les"]

    async def _serve_balanced_read(
        self, conn, p, pool_id, name, ps, acting, primary
    ) -> bool:
        """Serve a read-only client op as a NON-primary acting member.
        True = a reply went out (data or the same terminal errno the
        primary would give); False sends the caller to the redirect
        path. Served object data is version-checked against our own
        inventory, which sub-op transactions advance atomically with
        the data — with a valid marker every acked write is present, so
        a balanced read can never return bytes a primary read wouldn't."""
        pg = self._pg_of((pool_id, ps))
        if self.codec(pool_id) is not None:
            return False  # EC logical reads decode at the primary
        pool = self.osdmap.pools.get(pool_id)
        if pool is not None and pool.tier_of >= 0:
            return False  # cache-tier promotion is primary-side logic
        if p.get("snapid") is not None or p.get("snapc") is not None:
            return False  # snap resolution walks primary-side state
        if not await self._replica_read_ok(pg, acting, primary):
            return False
        sp = self.tracer.child(
            "balanced_read", tags={"object": f"{pool_id}/{name}"}
        )
        reply_raw = b""
        try:
            if p["op"] == "read":
                entry = pg.latest_objects().get(name)
                if entry is None or entry["kind"] == "delete":
                    raise StoreError(
                        "ENOENT", f"no such object {name!r}"
                    )
                try:
                    data = self.store.read(pg.coll, name)
                    attrs = self.store.getattrs(pg.coll, name)
                except StoreError as e:
                    if e.code == "EIO":
                        self._report_read_error(pg, name, None)
                    return False
                if attrs.get("ver") != entry["obj_ver"]:
                    return False  # copy lags: let the primary serve
                reply_raw = data
                result = {}
            elif p["op"] == "stat":
                result = self._primary_stat(pg, name)
            elif p["op"] == "ops" and not is_mutating(p.get("ops") or ()):
                ops, datas, off = p["ops"], [], 0
                for ln in p.get("data_lens", []):
                    datas.append(p["_raw"][off: off + ln])
                    off += ln
                op_results, reply_raw = await self._primary_ops(
                    pg, acting, name, ops, datas, None
                )
                result = {"results": op_results}
            else:
                return False  # mutations/exotica belong to the primary
            reply = {"tid": p["tid"], "ok": True, **result}
        except (StoreError, ClsError, OpError) as e:
            if isinstance(e, StoreFatalError) or e.code == "EROFS":
                return False  # store fenced: we are about to go down
            # marker-valid state means this terminal errno IS the
            # cluster's answer (every acked create/delete reached us)
            reply = {"tid": p["tid"], "ok": False, "error": str(e),
                     "errno": e.code}
            reply_raw = b""
        except asyncio.CancelledError:
            raise
        # cephlint: disable=error-taxonomy (anything unexpected redirects to the primary)
        except Exception:
            return False
        finally:
            if sp is not None:
                sp.finish()
        self.perf.inc("read_balanced")
        conn.send_message(
            Message(type="osd_op_reply", tid=p["tid"],
                    epoch=self.osdmap.epoch,
                    payload=reply, raw=reply_raw)
        )
        return True

    async def _serve_shard_read(
        self, conn, p, pool_id, name, ps, acting, primary
    ) -> None:
        """EC direct-shard read: return the clipped bytes of OUR data
        shard with the object version, so the client can check that all
        k shards agree and assemble the stripe without a primary gather
        or decode. Every failure mode — wrong home, unproven interval,
        stale or rotten shard — redirects, and the client falls back to
        the primary decode path."""
        pg = self._pg_of((pool_id, ps))

        def _send(payload: dict, raw: bytes = b"") -> None:
            conn.send_message(
                Message(type="osd_op_reply", tid=p["tid"],
                        epoch=self.osdmap.epoch,
                        payload=payload, raw=raw)
            )

        def _redirect(why: str) -> None:
            self.perf.inc("read_redirected")
            mk = pg.replica_marker
            _send(redirect_reply(
                p["tid"], primary, self.osdmap.epoch, why,
                backfill=(mk or {}).get("backfill"),
            ))

        pos = p.get("shard")
        ec = self.codec(pool_id)
        pool = self.osdmap.pools.get(pool_id)
        if (
            ec is None
            or not isinstance(pos, int)
            or (pool is not None and pool.tier_of >= 0)
            or pos >= len(acting)
            or acting[pos] != self.id
        ):
            return _redirect("not this shard's clean home")
        if not await self._replica_read_ok(pg, acting, primary):
            return _redirect("unproven interval")
        entry = pg.latest_objects().get(name)
        if entry is None or entry["kind"] == "delete":
            # the primary serves the authoritative ENOENT on fallback
            return _redirect("no such object")
        sname = shard_name(name, pos)
        try:
            data = self.store.read(pg.coll, sname)
            attrs = self.store.getattrs(pg.coll, sname)
        except StoreError as e:
            if e.code == "EIO":
                self._report_read_error(pg, name, pos)
            return _redirect("shard unreadable")
        if attrs.get("ver") != entry["obj_ver"]:
            return _redirect("shard stale")
        size = attrs.get("size")
        if size is None:
            return _redirect("shard missing size attr")
        # this shard holds data chunk `dpos`: its logical bytes span
        # [dpos*cs, dpos*cs+cs) pre-truncation, clamped by the object
        # size attr (padding never leaves the OSD), then clipped to the
        # client's requested run
        cs = len(data)
        dpos = int(p.get("dpos", 0))
        lo, hi = dpos * cs, min((dpos + 1) * cs, int(size))
        run = p.get("run")
        if run is not None:
            lo = max(lo, int(run[0]))
            hi = min(hi, int(run[0]) + int(run[1]))
        piece = data[lo - dpos * cs: hi - dpos * cs] if hi > lo else b""
        sp = self.tracer.child(
            "shard_read",
            tags={"object": f"{pool_id}/{sname}", "dpos": dpos},
        )
        if sp is not None:
            sp.finish()
        self.perf.inc("read_shard_direct")
        _send({"tid": p["tid"], "ok": True, "ver": entry["obj_ver"],
               "cs": cs, "size": int(size), "lo": lo}, piece)

    def _report_read_error(
        self, pg: PG, name: str, shard: int | None
    ) -> None:
        """A balanced/shard read hit at-rest EIO on our copy: tell the
        primary so it runs the write-back repair now instead of waiting
        for the next scrub (the replica-reported leg of
        rep_repair_primary_object), while we redirect the client."""
        acting, primary = self.acting_of(pg.pool, pg.ps)
        if (
            primary in (-1, _NONE, self.id)
            or self.osdmap.is_down(primary)
        ):
            return

        async def report() -> None:
            try:
                await self._peer_call(
                    primary, "read_error_report",
                    {"pgid": [pg.pool, pg.ps], "name": name,
                     "shard": shard, "reporter": self.id},
                    timeout=5.0,
                )
            except (asyncio.TimeoutError, RuntimeError):
                pass  # scrub remains the backstop

        self._spawn(report())

    async def _h_read_error_report(self, conn, p) -> None:
        # repair takes the fetch/rebuild/push path: run it off the
        # dispatch loop through the per-PG sub-op queue
        self._enqueue_subop(p, self._do_read_error_report, conn)

    async def _do_read_error_report(self, conn, p) -> None:
        """Primary side of a replica-reported read error: rebuild the
        reporter's copy/shard from the survivors and push it back — the
        same write-back _recover_read_error runs for our own EIOs,
        driven by a replica's instead."""
        pg = self._pg_of(p["pgid"])
        name, reporter = p["name"], p["reporter"]
        shard = p.get("shard")
        acting, primary = self.acting_of(pg.pool, pg.ps)
        if (
            primary != self.id
            or not pg.active
            or reporter not in acting
            or (shard is not None
                and (shard >= len(acting) or acting[shard] != reporter))
        ):
            self._reply_peer(conn, p["tid"], {"ok": False})
            return
        entry = pg.latest_objects().get(name)
        if entry is None or entry["kind"] == "delete":
            # deleted since the report: nothing left to heal
            self._reply_peer(conn, p["tid"], {"ok": True})
            return
        got = await self._object_for_push(pg, entry, shard, acting)
        if got is None:
            self._reply_peer(conn, p["tid"], {"ok": False})
            return
        data, attrs = got
        try:
            # force: the reporter's copy is rotten AT the current
            # version, so the push must overwrite an equal-version row
            await self._peer_call(
                reporter, "obj_push",
                {"pgid": [pg.pool, pg.ps], "shard": shard,
                 "entry": entry, "has_data": True, "force": True,
                 "attrs": _attrs_to(attrs)},
                timeout=5.0, raw=data,
            )
        except (asyncio.TimeoutError, RuntimeError):
            self._reply_peer(conn, p["tid"], {"ok": False})
            return
        self.perf.inc("read_error_repaired")
        if (d := self.dlog.dout(0)) is not None:
            d(f"osd.{self.id}: osd.{reporter} reported a read error on "
              f"{pg.coll}/{shard_name(name, shard)}; pushed a rebuilt "
              f"copy (ver {entry['obj_ver']})")
        self._cluster_log(
            "WRN",
            f"osd.{self.id}: read error on "
            f"{pg.coll}/{shard_name(name, shard)} reported by "
            f"osd.{reporter} healed by primary push",
        )
        self._reply_peer(conn, p["tid"], {"ok": True})

    async def _primary_call(
        self, pg: PG, acting: list[int], name: str, p: dict
    ) -> dict:
        """Execute an object-class method server-side (rados exec; the
        PrimaryLogPG CEPH_OSD_OP_CALL path): build the context from the
        object's current content + user xattrs, run the method, and write
        dirty results back through the normal backend fan-out so the
        mutation replicates / EC-encodes like any client write."""
        entry = pg.latest_objects().get(name)
        exists = entry is not None and entry["kind"] != "delete"
        data = None
        user_attrs: dict = {}
        if exists:
            data = await self._primary_read(pg, acting, name)
            local = shard_name(
                name, self._my_shard(pg, acting)
            )
            try:
                blob = self.store.getattrs(pg.coll, local).get("user")
            except StoreError:
                blob = None
            if blob:
                user_attrs = json.loads(blob)
        ec = self.codec(pg.pool)
        ctx = MethodContext(
            data=data,
            user_attrs=user_attrs,
            version=entry["obj_ver"] if exists else 0,
            omap=(
                self.store.omap_get(pg.coll, name) if ec is None else None
            ),
            omap_supported=ec is None,
            # lease arithmetic runs on the primary's clock; the offset
            # knob lets tests advance cls time without sleeping
            now=time.time() + float(self.config.get("cls_clock_offset")),
        )
        result = self.cls.call(p["cls"], p["method"], ctx, p.get("input"))
        if ctx.dirty:
            await self._primary_write(
                pg, acting, name,
                ctx.data if ctx.data is not None else b"",
                user_attrs=ctx.user_attrs,
                omap_delta=ctx.omap_delta(),
            )
        return {"result": result}


    # -- watch / notify (PrimaryLogPG watch/notify, src/osd/Watch.cc) ---------
    #
    # Watchers register on an object at its acting primary; a notify fans
    # the payload to every watcher and completes when all have acked (or
    # the per-notify timeout lapses), returning who acked — the librados
    # coordination primitive rbd's exclusive lock rides. Watches are
    # sessions on THIS primary: a new primary (or a restarted one) starts
    # with no watchers and clients must re-watch, matching the reference's
    # watch timeout + reconnect contract.

    WATCHERS_XATTR = "\x01w"

    async def _persist_watchers(
        self, pg, name: str, remove: tuple | None = None
    ) -> None:
        """Mirror the watcher set into a reserved object xattr
        (obc->watchers persisted in object_info): after a primary change
        the NEW primary knows who SHOULD be watching, so notifies report
        them as missed until they re-watch, instead of silently
        succeeding against an empty table. The persisted set MERGES with
        what a previous primary recorded (minus an explicit unwatch) —
        overwriting with only our live sessions would silently drop
        watchers that have not re-watched here yet."""
        key = (pg.pool, pg.ps, name)
        acting, primary = self.acting_of(pg.pool, pg.ps)
        if primary != self.id:
            return
        live = {
            (w, c) for _conn, w, c in self._watchers.get(key, [])
        }
        merged = live | set(
            self._persisted_watchers(pg, acting, name)
        )
        if remove is not None:
            merged.discard(remove)
        persisted = sorted(f"{w}|{c}" for w, c in merged)
        try:
            async with pg.lock:
                # re-check under the lock: a delete may have committed
                # while we awaited it — the setxattr must not resurrect
                # the object as a ghost
                entry = pg.latest_objects().get(name)
                if entry is None or entry["kind"] == "delete":
                    return
                await self._primary_ops(
                    pg, acting, name,
                    [{"op": "setxattr", "name": self.WATCHERS_XATTR,
                      "value": json.dumps(persisted).encode().hex()}],
                    [], None,
                )
        # cephlint: disable=error-taxonomy (best effort: live sessions still work this interval)
        except Exception:
            pass  # best effort: live sessions still work this interval

    def _persisted_watchers(self, pg, acting, name: str) -> list[tuple]:
        raw = self._head_xattrs(pg, acting, name).get(
            self.WATCHERS_XATTR
        )
        if not raw:
            return []
        return [tuple(s.split("|", 1)) for s in json.loads(raw)]

    async def _h_op_watch(self, pg, conn, p) -> dict:
        key = (pg.pool, pg.ps, p["name"])
        entry = (conn, p.get("watcher", conn.peer_name), p.get("cookie", ""))
        watchers = self._watchers.setdefault(key, [])
        if not any(
            w[1] == entry[1] and w[2] == entry[2] for w in watchers
        ):
            watchers.append(entry)
            await self._persist_watchers(pg, p["name"])
        return {}

    async def _h_op_unwatch(self, pg, conn, p) -> dict:
        key = (pg.pool, pg.ps, p["name"])
        me = (p.get("watcher", conn.peer_name), p.get("cookie", ""))
        self._watchers[key] = [
            w for w in self._watchers.get(key, [])
            if (w[1], w[2]) != me
        ]
        await self._persist_watchers(pg, p["name"], remove=me)
        return {}

    async def _h_op_notify(self, pg, conn, p) -> dict:
        key = (pg.pool, pg.ps, p["name"])
        notify_id = next(self._tids)
        waits = {}
        for wconn, wname, cookie in list(self._watchers.get(key, [])):
            if not wconn.is_connected:
                continue
            fut = asyncio.get_event_loop().create_future()
            self._notify_waiters[(notify_id, wname, cookie)] = fut
            waits[(wname, cookie)] = fut
            wconn.send_message(
                Message(
                    type="watch_notify",
                    payload={"pool": pg.pool, "name": p["name"],
                             "notify_id": notify_id,
                             "cookie": cookie,
                             "payload": p.get("payload", "")},
                )
            )
        timeout = p.get("timeout", 5.0)
        acked, missed = [], []
        if waits:
            # one deadline for the whole fan-out: N silent watchers cost
            # one timeout, not N stacked ones
            await asyncio.wait(waits.values(), timeout=timeout)
        for (wname, cookie), fut in waits.items():
            if fut.done():
                acked.append({"watcher": wname, "cookie": cookie})
            else:
                fut.cancel()
                missed.append({"watcher": wname, "cookie": cookie})
            self._notify_waiters.pop((notify_id, wname, cookie), None)
        # watchers persisted by a previous primary that have not
        # re-established a session here are MISSED, not invisible
        # (handle_watch_timeout semantics after failover)
        acting, _primary = self.acting_of(pg.pool, pg.ps)
        seen = {(a["watcher"], a["cookie"]) for a in acked} | {
            (m["watcher"], m["cookie"]) for m in missed
        }
        for wname, cookie in self._persisted_watchers(
            pg, acting, p["name"]
        ):
            if (wname, cookie) not in seen:
                missed.append({"watcher": wname, "cookie": cookie})
        return {"acked": acked, "missed": missed}

    async def _notify_and_reply(self, pg, conn, p) -> None:
        try:
            result = await self._h_op_notify(pg, conn, p)
            reply = {"tid": p["tid"], "ok": True, **result}
        except Exception as e:
            reply = {"tid": p["tid"], "ok": False, "error": str(e)}
        conn.send_message(
            Message(type="osd_op_reply", tid=p["tid"],
                    epoch=self.osdmap.epoch, payload=reply)
        )

    async def _h_notify_ack(self, conn, p) -> None:
        fut = self._notify_waiters.get(
            (p["notify_id"], p.get("watcher", conn.peer_name),
             p.get("cookie", ""))
        )
        if fut is not None and not fut.done():
            fut.set_result(None)

    # -- admin surface + scrub (admin_socket / `ceph daemon` analogue) --------

    async def _h_osd_admin(self, conn, p) -> None:
        """Daemon admin commands over the wire — the role the per-daemon
        unix admin socket plays for `ceph daemon osd.N <cmd>`."""
        try:
            cmd = p["cmd"]
            if cmd == "perf dump":
                result = self.perf_collection.dump()
            elif cmd == "status":
                result = {
                    "osd": self.id,
                    "epoch": self.osdmap.epoch if self.osdmap else 0,
                    "num_pgs": len(self.pgs),
                    "active_pgs": sum(
                        1 for pg in self.pgs.values() if pg.active
                    ),
                    "collections": len(self.store.list_collections()),
                    "ec_launches": self.encode_service.launches,
                    "ec_objects": self.encode_service.objects,
                }
            elif cmd == "pool_stats":
                # per-pool objects/bytes for PGs this OSD is primary of
                # (the pg_stat_t aggregation the mgr's autoscaler reads)
                stats: dict[int, dict] = {}
                for (pool_id, ps), pg in self.pgs.items():
                    acting, primary = self.acting_of(pool_id, ps)
                    if primary != self.id:
                        continue
                    st = stats.setdefault(
                        pool_id, {"objects": 0, "bytes": 0, "pgs": 0}
                    )
                    st["pgs"] += 1
                    for name, entry in pg.latest_objects().items():
                        if entry["kind"] == "delete":
                            continue
                        st["objects"] += 1
                        try:
                            sname = shard_name(
                                name,
                                self._my_shard(pg, acting),
                            ) if self.codec(pool_id) is not None else name
                            attrs = self.store.getattrs(pg.coll, sname)
                            size = attrs.get("size")
                            if size is None:
                                size = len(self.store.read(pg.coll, sname))
                            st["bytes"] += size
                        except StoreError:
                            pass
                result = {str(k): v for k, v in stats.items()}
                comp = getattr(self.store, "compression_stats", None)
                if comp is not None:
                    # store-wide compressed-length bookkeeping (blob
                    # attribution to pools stays in the store's keyspace)
                    result["compression"] = comp()
            elif cmd == "pg ls":
                # PGLS (the rados `ls` primitive): head objects of this
                # pool's PGs we lead (clones/snapdirs stay internal)
                objects = []
                for (pid, ps), pg in self.pgs.items():
                    if pid != p["pool"]:
                        continue
                    if self.acting_of(pid, ps)[1] != self.id:
                        continue
                    for name, e in pg.latest_objects().items():
                        if e["kind"] != "delete" and "\x1f" not in name:
                            objects.append(name)
                result = {"objects": sorted(objects)}
            elif cmd == "log dump":
                result = {"entries": self.logs.dump_recent()}
            elif cmd == "dump_trace":
                result = {
                    "events": list(
                        self.traces.get(p.get("trace_id", ""), [])
                    )
                }
            elif cmd == "dump_tracing":
                # drain the completed-span ring (client spans reported
                # via trace_report included, so one call returns whole
                # client->messenger->osd->store trees)
                result = self.tracer.dump_tracing(
                    drain=not p.get("keep")
                )
            elif cmd == "dump_ops_in_flight":
                result = self.op_tracker.dump_ops_in_flight()
            elif cmd == "dump_historic_ops":
                result = self.op_tracker.dump_historic_ops()
                # cross-link: a historic op's full span timeline is still
                # retrievable while the flight ring holds the trace
                for o in result.get("slowest", []):
                    tid = o.get("trace_id")
                    if tid:
                        o["in_flight_ring"] = self.tracer.flight_has(tid)
            elif cmd == "injectargs":
                # runtime config overrides (`ceph tell osd.N injectargs`):
                # flips the fault knobs, tracer rates, etc. live — the
                # config observers refresh every cached flag, so no
                # restart is needed to arm/disarm faults mid-run
                applied = {}
                for k, v in (p.get("args") or {}).items():
                    self.config.set(k, v)
                    applied[k] = self.config.get(k)
                result = {"applied": applied}
            elif cmd == "injectdataerr":
                # deterministic per-object read EIO on OUR copy/shard
                # (the reference's `injectdataerr` admin command); heals
                # when the object is rewritten, e.g. by a recovery read
                pool_id = p["pool"]
                ps = self.object_pg(pool_id, p["name"])
                pg = self._pg_of((pool_id, ps))
                acting, _primary = self.acting_of(pool_id, ps)
                shard = self._my_shard(pg, acting)
                sname = shard_name(p["name"], shard)
                inject = getattr(self.store, "inject_data_error", None)
                if inject is None:
                    raise RuntimeError(
                        f"{self.store.KIND} has no device-fault surface "
                        "(osd_objectstore=blockstore required)"
                    )
                inject(pg.coll, sname)
                result = {"injected": sname, "coll": pg.coll}
            elif cmd == "scrub":
                result = await self._scrub(
                    p["pool"], deep=p.get("deep", False)
                )
            elif cmd == "repair":
                result = await self._repair(p["pool"])
            else:
                raise RuntimeError(f"unknown admin command {cmd!r}")
            reply = {"tid": p["tid"], "ok": True, "result": result}
        except Exception as e:
            reply = {"tid": p["tid"], "ok": False, "error": str(e)}
        conn.send_message(
            Message(type="osd_admin_reply", tid=p["tid"],
                    payload=reply)
        )

    async def _h_trace_report(self, conn, p) -> None:
        """Adopt a client's finished spans (the Jaeger agent->collector
        hop): one-way, no reply — tracing must never add an RTT.

        A `promote` section is the tail-sampling relay: the client kept
        its completed trace (slow/errored at any sample rate) — adopt
        its spans into the FLIGHT ring (not the sampled ring: an
        unsampled trace must stay invisible to dump_tracing) and
        promote the same trace locally so our own flight spans ride the
        next mgr report alongside the client's."""
        promote = p.get("promote")
        if promote:
            self.tracer.adopt_flight(p.get("spans") or [])
            self.tracer.promote(
                promote.get("trace_id"),
                reason=promote.get("reason", "relay"),
                root=promote.get("root"),
            )
            return
        self.tracer.adopt(p.get("spans") or [])

    async def _h_mgr_capture(self, conn, p) -> None:
        """The mgr pushed fresh SLO capture predicates down the report
        channel (the metrics->traces loop): while a rule is violated,
        matching ops promote their traces at completion."""
        self.tracer.set_capture_predicates(
            p.get("predicates") or [], p.get("ver") or 0
        )

    async def _scrub_fetch(self, pg, sname: str, osd: int,
                           verify: bool = False):
        """One copy's (data, attrs) or an error string. `verify` reads
        device truth through BlockStore.read_verify so the buffer cache
        can never mask at-rest corruption from a deep scrub."""
        if osd == self.id:
            reader = self.store.read
            if verify:
                reader = getattr(self.store, "read_verify", reader)
            try:
                return (
                    reader(pg.coll, sname),
                    self.store.getattrs(pg.coll, sname),
                )
            except StoreError as e:
                # EIO = at-rest corruption a checksumming store caught
                # (BlockStore); distinct from a copy that is simply gone
                return "read_error" if e.code == "EIO" else "missing"
        try:
            rep = await self._peer_call(
                osd, "obj_read",
                {"coll": pg.coll, "name": sname, "verify": verify},
                timeout=2.0,
            )
        except (asyncio.TimeoutError, RuntimeError):
            return "unreachable"
        if not rep.get("ok"):
            return "read_error" if rep.get("error") == "EIO" else "missing"
        return rep["_raw"], _attrs_from(rep)

    #: deep-scrub findings the primary repairs in place when
    #: osd_scrub_auto_repair is set; "inconsistent" (no safe authority)
    #: and "stale"/"missing" (recovery's job) never auto-repair
    _AUTO_REPAIRABLE = frozenset(
        {"digest_mismatch", "read_error", "hinfo_missing"}
    )

    async def _scrub(
        self, pool_id: int, deep: bool, auto_repair_ok: bool = True
    ) -> dict:
        """Primary-driven consistency check over this OSD's primary PGs in
        `pool_id` (PGBackend::be_scan_list shallow; deep re-reads every
        copy/shard: EC shards verify crc32c against the stored HashInfo
        (ECBackend::be_deep_scrub, ECBackend.cc:2461), replicated copies
        compare data digests and flag the minority, like
        be_select_auth_object's majority rule). With
        `osd_scrub_auto_repair` set, a deep scrub that finds repairable
        damage runs the primary-driven repair in place and reports the
        count as "auto_repaired"."""
        from ceph_tpu_torch.common.crc import ceph_crc32c

        errors: list[dict] = []
        ec = self.codec(pool_id)
        for (pid, ps), pg in sorted(self.pgs.items()):
            if pid != pool_id or not pg.active:
                continue
            acting, primary = self.acting_of(pid, ps)
            if primary != self.id:
                continue
            for name, entry in sorted(pg.latest_objects().items()):
                if entry["kind"] == "delete":
                    continue
                copies: dict[int, tuple] = {}  # pos -> (data, attrs)
                for pos, osd in enumerate(acting):
                    if (osd == _NONE or self.osdmap.is_down(osd)
                            or osd in pg.backfill_targets):
                        continue
                    shard = pos if ec is not None else None
                    got = await self._scrub_fetch(
                        pg, shard_name(name, shard), osd, verify=deep
                    )
                    if isinstance(got, str):
                        errors.append(
                            {"pg": [pid, ps], "name": name,
                             "shard": shard, "osd": osd, "error": got}
                        )
                        continue
                    data, attrs = got
                    if attrs.get("ver") != entry["obj_ver"]:
                        errors.append(
                            {"pg": [pid, ps], "name": name,
                             "shard": shard, "osd": osd,
                             "error": "stale"}
                        )
                        continue
                    copies[pos] = (data, attrs)
                if not deep:
                    continue
                if ec is not None:
                    for pos, (data, attrs) in sorted(copies.items()):
                        hinfo = attrs.get("hinfo")
                        err = None
                        if hinfo is None:
                            err = "hinfo_missing"
                        elif ceph_crc32c(
                            0xFFFFFFFF, data
                        ) != hinfo.get_chunk_hash(pos):
                            err = "digest_mismatch"
                        if err:
                            errors.append(
                                {"pg": [pid, ps], "name": name,
                                 "shard": pos, "osd": acting[pos],
                                 "error": err}
                            )
                elif len(copies) > 1:
                    digests = {
                        pos: ceph_crc32c(0xFFFFFFFF, d)
                        for pos, (d, _a) in copies.items()
                    }
                    counts: dict[int, int] = {}
                    for dg in digests.values():
                        counts[dg] = counts.get(dg, 0) + 1
                    best = max(counts.values())
                    if best * 2 > len(digests):
                        # flag minority copies ONLY under a strict digest
                        # majority; a tie (e.g. 1:1 with a replica down)
                        # has no safe authority — auto-picking one could
                        # make repair overwrite the only good copy, so
                        # ties report "inconsistent" and repair skips them
                        auth = next(
                            dg for dg, c in counts.items() if c == best
                        )
                        for pos, dg in sorted(digests.items()):
                            if dg != auth:
                                errors.append(
                                    {"pg": [pid, ps], "name": name,
                                     "shard": None, "osd": acting[pos],
                                     "error": "digest_mismatch"}
                                )
                    else:
                        for pos in sorted(digests):
                            errors.append(
                                {"pg": [pid, ps], "name": name,
                                 "shard": None, "osd": acting[pos],
                                 "error": "inconsistent"}
                            )
        self.perf.inc("scrub_errors", len(errors))
        if deep:
            # refresh the health feed for every PG this pass scanned
            # (zero clears a previously-flagged PG that came back clean)
            scanned = [
                (pid, ps) for (pid, ps), pg in sorted(self.pgs.items())
                if pid == pool_id and pg.active
                and self.acting_of(pid, ps)[1] == self.id
            ]
            for key in scanned:
                self._scrub_incons[key] = 0
            for err in errors:
                key = tuple(err["pg"])
                if key in self._scrub_incons:
                    self._scrub_incons[key] += 1
        result = {"errors": errors}
        if (
            auto_repair_ok
            and deep
            and self.config.get("osd_scrub_auto_repair")
            and any(e["error"] in self._AUTO_REPAIRABLE for e in errors)
        ):
            n = await self._repair_from_report(pool_id, errors)
            result["auto_repaired"] = n
            if (d := self.dlog.dout(0)) is not None:
                d(f"pool {pool_id}: deep scrub auto-repaired {n} of "
                  f"{len(errors)} inconsistencies")
            self._cluster_log(
                "WRN",
                f"osd.{self.id}: pool {pool_id} deep scrub "
                f"auto-repaired {n} of {len(errors)} inconsistencies",
            )
        return result

    async def _repair(self, pool_id: int) -> dict:
        """Deep-scrub, then overwrite every inconsistent copy with content
        rebuilt from VERIFIED sources only (the `ceph pg repair` flow): EC
        shards decode from hinfo-checked survivors, replicated copies pull
        from a digest-majority member — never from the copy being
        repaired."""
        report = await self._scrub(
            pool_id, deep=True, auto_repair_ok=False
        )
        repaired = await self._repair_from_report(
            pool_id, report["errors"]
        )
        return {"repaired": repaired, "errors": report["errors"]}

    async def _repair_from_report(
        self, pool_id: int, errors: list[dict]
    ) -> int:
        from ceph_tpu_torch.common.crc import ceph_crc32c

        ec = self.codec(pool_id)
        repaired = 0
        for err in errors:
            if err["error"] == "inconsistent":
                continue  # no safe authority: surfaced, never auto-fixed
            pid, ps = err["pg"]
            pg = self.pgs[(pid, ps)]
            acting, _ = self.acting_of(pid, ps)
            entry = pg.latest_objects().get(err["name"])
            if entry is None:
                continue
            shard = err["shard"]
            bad_osd = err["osd"]
            # gather verified sources, excluding the copy under repair
            chunks: dict[int, bytes] = {}
            attrs = None
            data = None
            for pos, osd in enumerate(acting):
                if osd in (_NONE, bad_osd) or self.osdmap.is_down(osd):
                    continue
                spos = pos if ec is not None else None
                # repair sources are verified reads: never rebuild a
                # copy from a peer's (possibly rot-masking) cache
                got = await self._scrub_fetch(
                    pg, shard_name(err["name"], spos), osd, verify=True
                )
                if isinstance(got, str):
                    continue
                d, a = got
                if a.get("ver") != entry["obj_ver"]:
                    continue
                if ec is not None:
                    hinfo = a.get("hinfo")
                    if hinfo is None or ceph_crc32c(
                        0xFFFFFFFF, d
                    ) != hinfo.get_chunk_hash(pos):
                        continue  # never decode from an unverified shard
                    chunks[pos] = d
                    attrs = attrs or a
                    if len(chunks) >= ec.get_data_chunk_count():
                        break
                else:
                    chunks[pos] = d
                    attrs = attrs or a
            if ec is not None:
                if len(chunks) < ec.get_data_chunk_count():
                    continue
                # serial repair loop: direct decode (see _rebuild_shard)
                data = ec.decode({shard}, chunks)[shard]
            elif chunks:
                # replicated: the digest-majority copy wins (ties -> the
                # lowest acting position, like be_select_auth_object)
                counts: dict[bytes, int] = {}
                for d in chunks.values():
                    counts[d] = counts.get(d, 0) + 1
                best = max(counts.values())
                data = next(
                    d for _pos, d in sorted(chunks.items())
                    if counts[d] == best
                )
            if data is None or attrs is None:
                continue
            try:
                if bad_osd == self.id:
                    txn = Transaction()
                    self._write_fetched(
                        txn, pg.coll, shard_name(err["name"], shard),
                        data, attrs,
                    )
                    self.store.queue_transaction(txn)
                else:
                    await self._peer_call(
                        bad_osd, "obj_push",
                        {"pgid": [pid, ps], "shard": shard,
                         "entry": entry, "has_data": True,
                         "attrs": _attrs_to(attrs)},
                        timeout=5.0, raw=data,
                    )
                repaired += 1
            except (asyncio.TimeoutError, RuntimeError):
                continue
        return repaired


def _attrs_to(attrs: dict | None) -> dict:
    if attrs is None:
        return {}
    out = {}
    for k, v in attrs.items():
        if isinstance(v, HashInfo):
            out[k] = {"__hinfo__": [v.total_chunk_size,
                                    v.cumulative_shard_hashes]}
        elif isinstance(v, bytes):
            out[k] = {"__bytes__": v.hex()}
        else:
            out[k] = v
    return out


def _attrs_from(p: dict) -> dict:
    raw = p.get("attrs") or {}
    out = {}
    for k, v in raw.items():
        if isinstance(v, dict) and "__hinfo__" in v:
            out[k] = HashInfo(v["__hinfo__"][0], list(v["__hinfo__"][1]))
        elif isinstance(v, dict) and "__bytes__" in v:
            out[k] = bytes.fromhex(v["__bytes__"])
        else:
            out[k] = v
    return out
