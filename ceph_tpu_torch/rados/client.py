"""Objecter + Rados: the client op engine over the live cluster.

The reference's Objecter (src/osdc/Objecter.cc) computes each op's target
from its cached OSDMap (`_calc_target`, 2786: pool -> ps -> CRUSH -> primary),
sends to the primary, and recomputes + resends whenever the map epoch moves
or the target bounces it — ops survive OSD failures by re-targeting, never
by give-up. Same loop here: a "wrong_primary" reply or a timeout refreshes
the map from the mon and resends (epoch-tagged resend contract, SURVEY
§2.4). `Rados`/`IoCtx` mirror the librados surface at mini scale
(src/librados): connect once, then per-pool handles with
write/read/delete/stat.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins
from ceph_tpu_torch.common.watchdog import SharedWatchdog
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.msg import Dispatcher, Message, Messenger, Policy, payload_of
from ceph_tpu_torch.mon.client import MonClient
from ceph_tpu_torch.osd.ops import is_mutating
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE


class RadosError(Exception):
    pass


class ObjectNotFound(RadosError):
    """ENOENT from the primary — permanent, never retried."""


class Objecter(Dispatcher):
    def __init__(
        self,
        name: str,
        monmap,
        config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        device=None,
    ):
        self.name = name
        #: where the client's layout codecs live (None = cuda, which raises
        #: without a card); they do stripe math only and launch nothing
        self.device = resolve_device(device)
        self.config = config if config is not None else Config()
        self.messenger = Messenger(
            name, config=self.config, keyring=keyring
        )
        self.messenger.dispatcher = self
        self.mon = MonClient(
            name, monmap, config=self.config, messenger=self.messenger
        )
        self._tids = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        #: (pool, name, cookie) -> callback(name, payload)
        self._watches: dict[tuple, object] = {}
        #: watch key -> primary we registered at; watches are LINGER ops
        #: (Objecter::linger_ops): a primary change re-registers them
        self._watch_primary: dict[tuple, int] = {}
        self._rewatch_tasks: set = set()
        self._keyring = keyring
        self._ticket_task: asyncio.Task | None = None
        #: cross-daemon tracing (zipkin_trace.h): when set, every op
        #: carries a fresh trace id and collect_trace() stitches the
        #: multi-daemon timeline from the daemons' span stores
        self.trace_all = False
        self.traces: dict[str, list] = {}
        #: Dapper-style span tracer (common/tracer): samples op_submit
        #: roots per tracer_sample_rate and propagates the context on
        #: Message.trace; finished client spans are reported to the
        #: primary OSD (the Jaeger collector role) so `dump_tracing`
        #: there holds the complete client->osd->store tree
        from ceph_tpu_torch.common.tracer import Tracer

        self.tracer = Tracer(name, config=self.config)
        self.messenger.tracer = self.tracer
        #: trace_id -> span ids already shipped to the collector OSD
        self._reported: dict[str, set] = {}
        #: one deadline sweep for every in-flight op (Objecter::tick)
        #: instead of an asyncio TimerHandle armed+cancelled per op
        self._watchdog = SharedWatchdog()
        #: futures resolved on the next osdmap epoch advance
        self._epoch_waiters: list[asyncio.Future] = []
        #: per-epoch (pool, ps) -> (acting, primary) memo (the daemon's
        #: acting_of idiom client-side: CRUSH runs once per PG per map,
        #: not per op — balanced reads and EC shard fan-out need the
        #: whole acting set, not just the primary)
        self._target_cache: dict[tuple[int, int], tuple[list[int], int]] = {}
        self._target_cache_epoch = -1
        #: (pool, ps) -> (expiry, backfill-target osds) learned from
        #: redirect replies: a PG mid-backfill has acting members that
        #: ALWAYS bounce balanced reads, so the round robin skips them
        #: instead of paying a redirect round trip every size-th read.
        #: Entries die with the epoch (the cache above) or after a TTL —
        #: backfill completion bumps no epoch, so time heals the set
        self._avoid_cache: dict[tuple[int, int], tuple[float, set]] = {}
        #: balanced-read round robin over clean acting members
        self._rr = itertools.count(0)
        #: localize: uds hint path -> exists-on-this-host (stat once per
        #: distinct endpoint, not per read)
        self._local_addr_cache: dict[str, bool] = {}
        #: pool -> EC codec for client-side stripe-layout math (None for
        #: replicated pools / unbuildable profiles)
        self._client_codecs: dict[int, object] = {}
        self.mon.on_map_change(self._note_map_advance)
        self.mon.on_map_change(self._rewatch_on_map)

    async def start(self) -> None:
        self.mon.subscribe()
        await self.mon.wait_for_map()
        if self._keyring is not None:
            # cephx: fetch an OSD service ticket from the AuthMonitor
            # and keep it fresh at half-life (the rotating-key window
            # keeps the old one honored through a rotation)
            await self._renew_ticket()
            self._ticket_task = asyncio.create_task(
                self._ticket_renew_loop()
            )

    async def _renew_ticket(self) -> None:
        from ceph_tpu_torch.auth.cephx import unseal

        rep = await self.mon.command(
            "auth get-ticket", {"service": "osd"}, timeout=10.0
        )
        skey = unseal(
            self._keyring[self.name],
            bytes.fromhex(rep["session_key"]),
        )
        if skey is None:
            raise RadosError("mon returned an unopenable session key")
        self.messenger.tickets["osd"] = (
            bytes.fromhex(rep["ticket"]), skey
        )
        self._ticket_ttl = rep.get("ttl", 3600)

    async def _ticket_renew_loop(self) -> None:
        delay = max(1.0, self._ticket_ttl / 2)
        while True:
            await asyncio.sleep(delay)
            try:
                await self._renew_ticket()
                delay = max(1.0, self._ticket_ttl / 2)
            # cephlint: disable=error-taxonomy (mon churn: keep retrying fast so tickets never lapse)
            except Exception:
                # mon churn: keep retrying FAST until renewed — backing
                # off a whole half-life here is how tickets expire
                delay = 1.0

    async def close(self) -> None:
        if self._ticket_task is not None:
            self._ticket_task.cancel()
            try:
                await self._ticket_task
            except (asyncio.CancelledError, Exception):
                pass
        self._watchdog.stop()
        await self.messenger.shutdown()
        self.tracer.close()

    @property
    def osdmap(self):
        return self.mon.osdmap

    #: optional handler for message types the Objecter doesn't own —
    #: lets higher layers (the CephFS client's MDS session) share this
    #: messenger/monclient instead of running their own transport
    ext_dispatch = None

    async def ms_dispatch(self, conn, msg: Message) -> None:
        if self.ext_dispatch is not None and msg.type.startswith(
            "mds_"
        ):
            await self.ext_dispatch(conn, msg)
            return
        if msg.type in ("osd_op_reply", "osd_admin_reply"):
            p = payload_of(msg)
            # bulk read payload (raw frame segment): materialize the
            # zero-copy frame view here — the librados surface promises
            # bytes, and the frame buffer must not outlive dispatch
            raw = msg.raw
            p["_raw"] = raw if isinstance(raw, bytes) else bytes(raw)
            fut = self._waiters.get(p.get("tid"))
            if fut is not None and not fut.done():
                fut.set_result(p)
        elif msg.type == "watch_notify":
            p = payload_of(msg)
            cb = self._watches.get(
                (p["pool"], p["name"], p.get("cookie", ""))
            )
            # ack even with no callback registered (cookie already
            # unwatched locally): the OSD awaits acks from every watcher
            # it fanned out to, so a dropped ack stalls the NOTIFIER for
            # the whole notify timeout
            try:
                if cb is not None:
                    cb(p["name"], p.get("payload", ""))
            finally:
                conn.send_message(
                    Message(
                        type="notify_ack",
                        payload={"notify_id": p["notify_id"],
                                 "watcher": self.name,
                                 "cookie": p.get("cookie", "")},
                    )
                )

    def _rewatch_on_map(self, _osdmap) -> None:
        """Re-register every watch whose primary moved (the linger-op
        resend contract; the new primary's persisted watcher table lists
        us as missed until this lands)."""
        if self.config.get("objecter_inject_no_watch_ping"):
            # fault injection (options.cc:1066): suppress watch liveness
            # maintenance so tests can exercise stale-watcher handling
            return
        for key in list(self._watches):
            pool_id, name, cookie = key
            try:
                primary = self._calc_target(pool_id, name)
            except RadosError:
                continue
            if self._watch_primary.get(key) == primary:
                continue

            async def rereg(key=key, pool_id=pool_id, name=name,
                           cookie=cookie, primary=primary):
                try:
                    await self.op_submit(
                        pool_id, name, "watch",
                        extra={"watcher": self.name, "cookie": cookie},
                        timeout=10.0,
                    )
                    # recorded only on SUCCESS: a failed re-watch must
                    # stay eligible for the next attempt even if the
                    # primary has not moved again
                    self._watch_primary[key] = primary
                # cephlint: disable=error-taxonomy (retried on the next map change)
                except Exception:
                    pass  # retried on the next map change

            task = asyncio.get_event_loop().create_task(rereg())
            self._rewatch_tasks.add(task)
            task.add_done_callback(self._rewatch_tasks.discard)

    async def osd_admin(
        self, osd: int, cmd: str, args: dict | None = None,
        timeout: float = 30.0,
    ) -> dict:
        """Admin command straight to one daemon (`ceph daemon osd.N cmd` —
        the admin-socket role over the messenger)."""
        addr = self.osdmap.osd_addrs.get(osd)
        if addr is None:
            raise RadosError(f"no address for osd.{osd}")
        tid = next(self._tids)
        payload = {"tid": tid, "cmd": cmd, **(args or {})}
        fut = asyncio.get_event_loop().create_future()
        self._waiters[tid] = fut
        try:
            self.messenger.connect(
                tuple(addr), Policy.lossless_client(),
                local_addr=self.osdmap.osd_local_addrs.get(osd),
            ).send_message(
                Message(type="osd_admin", tid=tid, payload=payload)
            )
            reply = await asyncio.wait_for(fut, timeout)
        finally:
            self._waiters.pop(tid, None)
        if not reply.get("ok"):
            raise RadosError(reply.get("error", "admin command failed"))
        return reply.get("result", {})

    async def collect_trace(self, trace_id: str) -> list:
        """Stitch one traced op's FULL timeline: this client's span
        events + every up OSD's, merged by wall clock (the role of the
        zipkin collector UI, flattened to a sorted list of
        (ts, who, event))."""
        events = list(self.traces.get(trace_id, []))
        for osd in range(self.osdmap.max_osd):
            if self.osdmap.is_down(osd):
                continue
            try:
                rep = await self.osd_admin(
                    osd, "dump_trace", {"trace_id": trace_id},
                    timeout=5.0,
                )
            except RadosError:
                continue
            events.extend(tuple(e) for e in rep.get("events", []))
        return sorted(events)

    # -- targeting ------------------------------------------------------------

    def _effective_pool(self, pool_id: int) -> int:
        """Cache-tier overlay redirect (Objecter::_calc_target's
        read_tier/write_tier handling): IO aimed at a base pool with an
        overlay goes to the cache pool; the cache PG promotes/flushes
        against the base."""
        pool = self.osdmap.pools.get(pool_id)
        if pool is not None and pool.read_tier >= 0:
            return pool.read_tier
        return pool_id

    def _calc_acting(
        self, pool_id: int, name: str
    ) -> tuple[int, int, list[int], int]:
        """pool -> ps -> (effective pool, ps, acting, primary), memoized
        per map epoch (Objecter::_calc_target, extended to the whole
        acting set for balanced-read target selection and EC direct-shard
        fan-out)."""
        pool_id = self._effective_pool(pool_id)
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            raise RadosError(f"no pool {pool_id}")
        ps = pool.raw_pg_to_pg(ceph_str_hash_rjenkins(name))
        epoch = self.osdmap.epoch
        if epoch != self._target_cache_epoch:
            self._target_cache.clear()
            self._avoid_cache.clear()
            self._target_cache_epoch = epoch
        hit = self._target_cache.get((pool_id, ps))
        if hit is None:
            _up, _upp, acting, primary = self.osdmap.pg_to_up_acting_osds(
                pool_id, ps
            )
            hit = (list(acting), primary)
            self._target_cache[(pool_id, ps)] = hit
        return pool_id, ps, hit[0], hit[1]

    def _calc_target(self, pool_id: int, name: str) -> int:
        """pool -> ps -> up/acting -> primary (Objecter::_calc_target)."""
        eff_pool, ps, _acting, primary = self._calc_acting(pool_id, name)
        if primary in (-1, CRUSH_ITEM_NONE):
            raise RadosError(f"pg {eff_pool}.{ps} has no primary")
        return primary

    def _osd_is_local(self, osd: int) -> bool:
        """localize: an OSD whose LocalStack uds endpoint exists on this
        host is colocated — reads sent there ride the shared-memory
        transport instead of TCP. One stat per distinct endpoint."""
        la = self.osdmap.osd_local_addrs.get(osd)
        if not la:
            return False
        hit = self._local_addr_cache.get(la)
        if hit is None:
            hit = la.startswith("uds://") and os.path.exists(
                la.split("://", 1)[1]
            )
            self._local_addr_cache[la] = hit
        return hit

    def _note_map_advance(self, _osdmap) -> None:
        waiters, self._epoch_waiters = self._epoch_waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    async def _refresh_map(self, timeout: float = 0.2) -> None:
        """Catch up to the mon's osdmap: subscribe past our epoch, then
        wait for the actual epoch advance (woken by `on_map_change`)
        with a deadline — not a blind sleep. The deadline matters: after
        a retarget the mon may have nothing newer, and the retry loop
        must keep pacing rather than hang."""
        cur = self.osdmap.epoch if self.osdmap else 0
        self.mon.subscribe(from_epoch=cur)
        deadline = asyncio.get_event_loop().time() + timeout
        while (self.osdmap.epoch if self.osdmap else 0) <= cur:
            left = deadline - asyncio.get_event_loop().time()
            if left <= 0:
                return
            fut = asyncio.get_event_loop().create_future()
            self._epoch_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, left)
            except asyncio.TimeoutError:
                return
            finally:
                if fut in self._epoch_waiters:
                    self._epoch_waiters.remove(fut)

    # -- op submission --------------------------------------------------------

    async def op_submit(
        self,
        pool_id: int,
        name: str,
        op: str,
        data: bytes | None = None,
        timeout: float = 30.0,
        extra: dict | None = None,
        read_policy: str | None = None,
    ) -> dict:
        deadline = asyncio.get_event_loop().time() + timeout
        last_error = "timed out"
        # ONE tid for the op's whole lifetime: resends after a lost reply
        # must carry the same reqid or the OSD's dup detection can never
        # recognize them and non-idempotent ops would double-apply
        tid = next(self._tids)
        trace_id = None
        if self.trace_all:
            # cross-daemon tracing (zipkin_trace.h role): the id rides
            # the op and every sub-op hop; daemons record span events
            # keyed by it, collect_trace() stitches the timeline
            import time as _time
            import uuid as _uuid

            trace_id = _uuid.uuid4().hex[:16]
            self.traces[trace_id] = [(
                _time.time(), self.name, f"op_submit {op} {name}"
            )]
        # Dapper-style span (sampled): covers submit -> completion
        # including every retarget/resend; the context rides the wire.
        # Child-first: inside an already-traced task (a ckpt_save /
        # ckpt_restore root) every op joins THAT tree instead of
        # starting a parallel root, so composite operations dump as a
        # single trace.
        span = self.tracer.child(
            "op_submit", tags={"pool": pool_id, "object": name, "op": op}
        )
        if span is None:
            span = self.tracer.start(
                "op_submit",
                tags={"pool": pool_id, "object": name, "op": op},
                op_type=op,
            )
        wire_ctx = "" if span is None else span.context().encode()
        try:
            return await self._op_submit_inner(
                pool_id, name, op, data, deadline, last_error, tid,
                trace_id, span, wire_ctx, extra, read_policy,
            )
        except BaseException as e:
            if span is not None:
                span.set_tag("error", str(e) or type(e).__name__)
            raise
        finally:
            if span is not None:
                span.finish()
                if span.sampled:
                    self._report_trace(span.trace_id)
                self._relay_promotion(span)

    def _report_trace(self, trace_id: str) -> None:
        """Ship this client's finished spans of one trace to the primary
        it last talked to — the Jaeger agent->collector hop, so a single
        `dump_tracing` on the OSD returns the COMPLETE tree.

        Shared-trace ops (the ckpt path: many op_submit children under
        one ckpt_save root) report after EVERY op, so only spans not yet
        shipped go out — the OSD's adopt() does not dedup."""
        shipped = self._reported.setdefault(trace_id, set())
        if len(self._reported) > 64:  # bound stale per-trace bookkeeping
            for tid in list(self._reported)[:-32]:
                if tid != trace_id:
                    del self._reported[tid]
        spans = [
            s for s in self.tracer.spans_of(trace_id)
            if s["span_id"] not in shipped
        ]
        conn = self._last_conn
        if spans and conn is not None:
            shipped.update(s["span_id"] for s in spans)
            conn.send_message(
                Message(
                    type="trace_report",
                    data=json.dumps({"spans": spans}).encode(),
                )
            )

    def _relay_promotion(self, span) -> None:
        """Tail-sampling relay: when this op's completed trace was
        promoted locally (slow / errored / capture-matched at any
        sample rate), ship the keep decision plus our flight spans to
        the primary we last talked to — the OSD adopts them into ITS
        flight ring and promotes the same trace onto its mgr report.
        One one-way message per PROMOTED op only; the unpromoted hot
        path pays a single dict miss."""
        promoted = self.tracer.take_promoted(span.trace_id)
        conn = self._last_conn
        if promoted is None or conn is None:
            return
        spans = promoted.pop("spans", [])
        conn.send_message(
            Message(
                type="trace_report",
                data=json.dumps(
                    {"spans": spans, "promote": promoted}
                ).encode(),
            )
        )

    #: connection of the most recent op send (trace reporting target)
    _last_conn = None

    def _may_balance(self, op, extra, read_policy) -> bool:
        """Only plain read-only ops are balanced: mutations, snap reads
        (primary-side clone resolution), and exotica always target the
        primary."""
        if read_policy not in ("balance", "localize"):
            return False
        ex = extra or {}
        if ex.get("snapc") is not None or ex.get("snapid") is not None:
            return False
        if op in ("read", "stat"):
            return True
        return op == "ops" and not is_mutating(ex.get("ops") or ())

    async def _op_submit_inner(
        self, pool_id, name, op, data, deadline, last_error, tid,
        trace_id, span, wire_ctx, extra, read_policy=None,
    ) -> dict:
        may_balance = self._may_balance(op, extra, read_policy)
        # a redirect/timeout from a balanced target degrades THIS op to
        # the primary path for the rest of its retry loop (never bounce
        # between replicas while the interval is in doubt)
        forced_primary = False
        while asyncio.get_event_loop().time() < deadline:
            balanced = False
            try:
                eff_pool, ps, acting, primary = self._calc_acting(
                    pool_id, name
                )
                if primary in (-1, CRUSH_ITEM_NONE):
                    raise RadosError(f"pg {eff_pool}.{ps} has no primary")
                target = primary
                if (
                    may_balance
                    and not forced_primary
                    and not self.osdmap.pools[eff_pool].is_erasure()
                ):
                    # EC logical reads stay at the primary (the decode
                    # path); the EC fast path is ec_direct_read
                    cands = self.osdmap.read_candidates(acting)
                    avoid = self._avoid_cache.get((eff_pool, ps))
                    if avoid is not None:
                        now = asyncio.get_event_loop().time()
                        if now >= avoid[0]:
                            del self._avoid_cache[(eff_pool, ps)]
                        else:
                            # skip known backfill targets — they can
                            # only bounce us back to the primary
                            cands = [
                                o for o in cands if o not in avoid[1]
                            ] or cands
                    if read_policy == "localize":
                        local = [
                            o for o in cands if self._osd_is_local(o)
                        ]
                        cands = local or cands
                    if len(cands) > 1:
                        target = cands[next(self._rr) % len(cands)]
                    elif cands:
                        target = cands[0]
                    balanced = target != primary
                addr = self.osdmap.osd_addrs.get(target)
                if addr is None:
                    raise RadosError(f"no address for osd.{target}")
            except RadosError as e:
                last_error = str(e)
                await self._refresh_map()
                continue
            payload = {"tid": tid, "pool": eff_pool, "name": name,
                       "op": op}
            if balanced:
                payload["balanced"] = True
            if trace_id is not None:
                payload["trace_id"] = trace_id
            if extra:
                payload.update(extra)
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = fut
            try:
                conn = self.messenger.connect(
                    tuple(addr), Policy.lossless_client(),
                    local_addr=self.osdmap.osd_local_addrs.get(target),
                )
                self._last_conn = conn
                if span is not None:
                    span.log(
                        f"sent to osd.{target}"
                        + (" (balanced)" if balanced else "")
                    )
                conn.send_message(
                    Message(type="osd_op", tid=tid,
                            epoch=self.osdmap.epoch,
                            payload=payload,
                            raw=data or b"",
                            trace=wire_ctx)
                )
                reply = await self._watchdog.wait(fut, 3.0)
            except asyncio.TimeoutError:
                # target silent (died?): refresh the map and re-target;
                # a silent balanced replica additionally degrades the op
                # to the primary path (kill -9 mid-read lands here)
                if span is not None:
                    span.log(f"resend: osd.{target} silent")
                    span.set_tag("retried", True)
                forced_primary = forced_primary or balanced
                await self._refresh_map()
                continue
            finally:
                self._waiters.pop(tid, None)
            if reply.get("ok"):
                if trace_id is not None:
                    import time as _time

                    self.traces[trace_id].append(
                        (_time.time(), self.name, "op_reply")
                    )
                    reply["trace_id"] = trace_id
                if span is not None:
                    span.log("op_reply")
                    reply["trace"] = span.trace_id
                return reply
            if reply.get("redirect"):
                # the balanced target cannot prove its copy current
                # (peering/backfill/stale marker): finish at the primary
                if span is not None:
                    span.log(f"redirect: osd.{target} -> primary")
                    span.set_tag("redirected", True)
                forced_primary = True
                bf = reply.get("backfill")
                if bf:
                    # remember the PG's backfill targets so FUTURE
                    # balanced reads round-robin past them (satisfied
                    # members still serve; one bounce, not one per
                    # size-th read until the backfill drains)
                    self._avoid_cache[(eff_pool, ps)] = (
                        asyncio.get_event_loop().time()
                        + float(self.config.get(
                            "rados_backfill_hint_ttl")),
                        set(bf),
                    )
                if reply.get("epoch", 0) > self.osdmap.epoch:
                    await self._refresh_map()
                continue
            if reply.get("wrong_primary"):
                # our map was stale; catch up past the OSD's epoch
                if span is not None:
                    span.log(f"retarget: osd.{target} not primary")
                await self._refresh_map()
                continue
            errno = reply.get("errno")
            if errno == "ENOENT":
                raise ObjectNotFound(
                    f"{op} {pool_id}/{name!r}: "
                    + reply.get("error", "no such object")
                )
            if errno is not None:
                # other typed errors (EBUSY, ECANCELED, ...) are final too
                raise RadosError(
                    f"{errno}: " + reply.get("error", "op failed")
                )
            last_error = reply.get("error", "op failed")
            # transient primary-side errors (mid-recovery reads) retry
            await self._refresh_map()
        raise RadosError(
            f"{op} {pool_id}/{name!r} failed: {last_error}"
        )

    # -- EC direct-shard reads -------------------------------------------------

    def _client_codec(self, pool_id: int):
        """Client-side EC codec for stripe-layout math (k, chunk_index),
        built lazily from the pool's profile — the same registry the OSD
        uses, so the computed layout always matches the shards on disk."""
        if pool_id not in self._client_codecs:
            codec = None
            try:
                pool = self.osdmap.pools[pool_id]
                profile = dict(
                    self.osdmap.erasure_code_profiles[
                        pool.erasure_code_profile
                    ]
                )
                plugin = profile.pop("plugin", "tpu")
                from ceph_tpu_torch.ec.registry import factory

                codec = factory(plugin, profile, device=self.device)
            except asyncio.CancelledError:
                raise
            # cephlint: disable=error-taxonomy (no codec = no direct reads; the primary path serves)
            except Exception:
                codec = None
            self._client_codecs[pool_id] = codec
        return self._client_codecs[pool_id]

    async def ec_direct_read(
        self, pool_id: int, name: str, off: int = 0,
        length: int | None = None,
    ) -> bytes | None:
        """Read an EC object by fetching its k data shards straight from
        their acting homes in parallel — no primary gather, no decode
        launch (ECBackend::objects_read_async's not-degraded fast path,
        moved client-side). Returns None whenever the whole acting set
        cannot provably serve — any hole, redirect, timeout, or version
        skew between shards — and the caller falls back to the primary
        read path, which also owns the authoritative ENOENT."""
        if self._effective_pool(pool_id) != pool_id:
            return None  # cache-tier overlay: primary-side logic
        pool = self.osdmap.pools.get(pool_id)
        if pool is None or not pool.is_erasure():
            return None
        ec = self._client_codec(pool_id)
        if ec is None:
            return None
        if length is None and off != 0:
            return None  # open-ended ranged read: size unknown here
        try:
            _pool, ps, acting, primary = self._calc_acting(pool_id, name)
        except RadosError:
            return None
        if not self.osdmap.whole_acting(acting):
            return None  # degraded interval: the primary decodes
        k = ec.get_data_chunk_count()
        positions = [ec.chunk_index(i) for i in range(k)]
        if any(pos >= len(acting) for pos in positions):
            return None
        run = None if length is None else [off, length]
        span = self.tracer.child(
            "ec_direct_read",
            tags={"pool": pool_id, "object": name, "shards": k},
        )
        try:
            reps = await asyncio.gather(
                *(
                    self._shard_read_one(
                        pool_id, name, acting[positions[i]],
                        positions[i], i, run,
                    )
                    for i in range(k)
                )
            )
            if any(r is None or not r.get("ok") for r in reps):
                return None
            # every shard must answer at ONE object version and size:
            # skew means a write landed between our shard reads (or a
            # shard lagged) — never assemble a torn stripe
            if (
                len({r["ver"] for r in reps}) != 1
                or len({r["size"] for r in reps}) != 1
            ):
                return None
            # replies arrive in data-chunk order (gather preserves it);
            # each piece is the shard's clip of the requested logical
            # run, so plain concatenation IS the stripe assembly
            return b"".join(r["_raw"] for r in reps)
        finally:
            if span is not None:
                span.finish()

    async def _shard_read_one(
        self, pool_id: int, name: str, osd: int, pos: int, dpos: int,
        run: list | None,
    ) -> dict | None:
        """One ranged shard read straight to its acting home. Every
        failure shape collapses to None: the caller treats any imperfect
        fan-out as a fallback to the primary path."""
        addr = self.osdmap.osd_addrs.get(osd)
        if addr is None:
            return None
        tid = next(self._tids)
        payload = {"tid": tid, "pool": pool_id, "name": name,
                   "op": "shard_read", "shard": pos, "dpos": dpos}
        if run is not None:
            payload["run"] = run
        fut = asyncio.get_event_loop().create_future()
        self._waiters[tid] = fut
        try:
            conn = self.messenger.connect(
                tuple(addr), Policy.lossless_client(),
                local_addr=self.osdmap.osd_local_addrs.get(osd),
            )
            conn.send_message(
                Message(type="osd_op", tid=tid,
                        epoch=self.osdmap.epoch, payload=payload)
            )
            return await self._watchdog.wait(fut, 2.0)
        except asyncio.TimeoutError:
            return None  # shard home silent: fall back, don't retry here
        finally:
            self._waiters.pop(tid, None)


class IoCtx:
    """Per-pool handle (librados ioctx)."""

    def __init__(self, objecter: Objecter, pool_id: int):
        self.objecter = objecter
        self.pool_id = pool_id
        #: selfmanaged snap context applied to writes
        #: (rados_ioctx_selfmanaged_snap_set_write_ctx)
        self.snapc: dict | None = None
        #: snap id applied to reads (rados_ioctx_snap_set_read)
        self.read_snap: int | None = None
        #: mclock class ops from this handle are queued under at the OSD
        #: (op_queue.QOS_DATA_PREFETCH and friends); None = per-client
        #: default class (the peer name)
        self.qos_class: str | None = None
        #: per-handle override of rados_read_policy ('primary' |
        #: 'balance' | 'localize'); None = follow the config knob
        self.read_policy: str | None = None

    def _qos(self, extra: dict | None) -> dict | None:
        if self.qos_class:
            extra = dict(extra) if extra else {}
            extra["qos"] = self.qos_class
        return extra

    def _read_policy(self) -> str | None:
        """Effective non-primary read policy for this handle, or None
        when reads pin to the primary (the default — the reference only
        spreads reads when osd_read_from_replica says so)."""
        pol = self.read_policy
        if pol is None:
            pol = self.objecter.config.get("rados_read_policy")
        return pol if pol in ("balance", "localize") else None

    # -- selfmanaged snapshots ------------------------------------------------

    def set_selfmanaged_snap_context(self, seq: int, snaps) -> None:
        self.snapc = {"seq": seq, "snaps": sorted(snaps, reverse=True)}

    def snap_set_read(self, snapid: int | None) -> None:
        self.read_snap = snapid

    async def selfmanaged_snap_create(self) -> int:
        r = await self.objecter.mon.command(
            "osd pool selfmanaged-snap create", {"pool_id": self.pool_id}
        )
        return r["snapid"]

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        await self.objecter.mon.command(
            "osd pool selfmanaged-snap rm",
            {"pool_id": self.pool_id, "snapid": snapid},
        )

    # -- op vectors (ObjectOperation / operate) -------------------------------

    async def operate(
        self, name: str, ops: list[dict], datas: list[bytes] = (),
        read_policy: str | None = None,
    ) -> list[dict]:
        """Execute an op vector atomically at the primary
        (rados_write_op/read_op operate). Data-consuming ops take their
        payload from `datas` in op order; read results come back in each
        op's result dict ("data" for reads). A read-only vector may be
        served by any clean replica when `read_policy` says so."""
        extra = {"ops": ops, "data_lens": [len(d) for d in datas]}
        if self.snapc is not None:
            extra["snapc"] = self.snapc
        if self.read_snap is not None:
            extra["snapid"] = self.read_snap
        rep = await self.objecter.op_submit(
            self.pool_id, name, "ops",
            data=b"".join(datas),
            extra=self._qos(extra),
            read_policy=read_policy,
        )
        results = rep.get("results", [])
        raw, off = rep["_raw"], 0
        for res in results:
            if "data_len" in res:
                res["data"] = raw[off: off + res["data_len"]]
                off += res["data_len"]
        return results

    # -- data ops -------------------------------------------------------------

    async def write_full(self, name: str, data: bytes) -> None:
        extra = {"snapc": self.snapc} if self.snapc is not None else None
        await self.objecter.op_submit(
            self.pool_id, name, "write", data, extra=self._qos(extra)
        )

    async def write(self, name: str, data: bytes, off: int = 0) -> None:
        await self.operate(
            name, [{"op": "write", "off": off}], [data]
        )

    async def append(self, name: str, data: bytes) -> None:
        await self.operate(name, [{"op": "append"}], [data])

    async def truncate(self, name: str, size: int) -> None:
        await self.operate(name, [{"op": "truncate", "size": size}])

    async def zero(self, name: str, off: int, length: int) -> None:
        await self.operate(
            name, [{"op": "zero", "off": off, "len": length}]
        )

    async def read(
        self, name: str, off: int = 0, length: int | None = None,
        snapid: int | None = None,
    ) -> bytes:
        snap = snapid if snapid is not None else self.read_snap
        pol = self._read_policy()
        if (
            pol is not None
            and snap is None
            and (length is not None or off == 0)
            and self.objecter.config.get("rados_ec_direct_reads")
        ):
            # EC fast path: ranged shard reads straight to the k data
            # shards, no primary gather/decode; None = fall through to
            # the ordinary (primary or balanced-replica) path
            data = await self.objecter.ec_direct_read(
                self.pool_id, name, off, length
            )
            if data is not None:
                return data
        if off == 0 and length is None:
            extra = {"snapid": snap} if snap is not None else None
            rep = await self.objecter.op_submit(
                self.pool_id, name, "read", extra=self._qos(extra),
                read_policy=pol,
            )
            return rep["_raw"]
        op = {"op": "read", "off": off}
        if length is not None:
            op["length"] = length
        saved = self.read_snap
        if snapid is not None:
            self.read_snap = snapid
        try:
            res = await self.operate(name, [op], read_policy=pol)
        finally:
            self.read_snap = saved
        return res[0]["data"]

    async def remove(self, name: str) -> None:
        extra = {"snapc": self.snapc} if self.snapc is not None else None
        await self.objecter.op_submit(
            self.pool_id, name, "delete", extra=extra
        )

    async def copy_from(
        self, dst_name: str, src_name: str,
        src_pool: int | None = None,
    ) -> None:
        """Server-side object copy (CEPH_OSD_OP_COPY_FROM,
        rados_write_op copy_from): the destination primary pulls the
        source object — data + xattrs + omap — itself; the bytes never
        visit this client."""
        await self.operate(
            dst_name,
            [{"op": "copy_from", "src_name": src_name,
              "src_pool": (self.pool_id if src_pool is None
                           else src_pool)}],
        )

    async def cache_flush(self, name: str) -> None:
        """Flush a dirty cache-tier object to its base pool (the
        `rados cache-flush` op)."""
        await self.objecter.op_submit(self.pool_id, name, "cache_flush")

    async def cache_evict(self, name: str) -> None:
        """Flush if dirty, then drop the cached copy (`rados
        cache-evict`)."""
        await self.objecter.op_submit(self.pool_id, name, "cache_evict")

    async def stat(self, name: str) -> dict:
        pol = self._read_policy()
        st = await self.objecter.op_submit(
            self.pool_id, name, "stat", read_policy=pol
        )
        if "size" not in st:
            res = await self.operate(
                name, [{"op": "stat"}], read_policy=pol
            )
            st["size"] = res[0]["size"]
        return st

    # -- omap (omap_get_vals / omap_set, librados.h) --------------------------

    async def omap_set(self, name: str, kv: dict[bytes, bytes]) -> None:
        await self.operate(
            name,
            [{"op": "omap_set",
              "kv": {k.hex(): v.hex() for k, v in kv.items()}}],
        )

    async def omap_get(
        self, name: str, after: bytes | None = None,
        max_return: int | None = None,
    ) -> dict[bytes, bytes]:
        op = {"op": "omap_get"}
        if after is not None:
            op["after"] = after.hex()
        if max_return is not None:
            op["max_return"] = max_return
        res = await self.operate(name, [op])
        return {
            bytes.fromhex(k): bytes.fromhex(v)
            for k, v in res[0]["kv"].items()
        }

    async def omap_rm(self, name: str, keys) -> None:
        await self.operate(
            name, [{"op": "omap_rm", "keys": [k.hex() for k in keys]}]
        )

    async def omap_clear(self, name: str) -> None:
        await self.operate(name, [{"op": "omap_clear"}])

    # -- xattrs ---------------------------------------------------------------

    async def setxattr(self, name: str, key: str, value: bytes) -> None:
        await self.operate(
            name, [{"op": "setxattr", "name": key, "value": value.hex()}]
        )

    async def getxattr(self, name: str, key: str) -> bytes:
        res = await self.operate(name, [{"op": "getxattr", "name": key}])
        return bytes.fromhex(res[0]["value"])

    async def rmxattr(self, name: str, key: str) -> None:
        await self.operate(name, [{"op": "rmxattr", "name": key}])

    async def getxattrs(self, name: str) -> dict[str, bytes]:
        res = await self.operate(name, [{"op": "getxattrs"}])
        return {
            k: bytes.fromhex(v) for k, v in res[0]["xattrs"].items()
        }

    async def exec(self, name: str, cls: str, method: str,
                   inp: dict | None = None) -> dict:
        """Run an object-class method inside the primary OSD
        (rados_exec / cls, src/objclass)."""
        rep = await self.objecter.op_submit(
            self.pool_id, name, "call",
            extra={"cls": cls, "method": method, "input": inp or {}},
        )
        return rep.get("result", {})

    async def watch(self, name: str, callback, cookie: str = "") -> None:
        """Register `callback(name, payload)` for notifies on the object
        (rados_watch). Watches live on the current primary: re-watch after
        a primary change, as the reference's watch/reconnect contract
        requires."""
        self.objecter._watches[(self.pool_id, name, cookie)] = callback
        await self.objecter.op_submit(
            self.pool_id, name, "watch",
            extra={"watcher": self.objecter.name, "cookie": cookie},
        )
        try:
            self.objecter._watch_primary[
                (self.pool_id, name, cookie)
            ] = self.objecter._calc_target(self.pool_id, name)
        except RadosError:
            pass

    async def unwatch(self, name: str, cookie: str = "") -> None:
        self.objecter._watches.pop((self.pool_id, name, cookie), None)
        self.objecter._watch_primary.pop(
            (self.pool_id, name, cookie), None
        )
        await self.objecter.op_submit(
            self.pool_id, name, "unwatch",
            extra={"watcher": self.objecter.name, "cookie": cookie},
        )

    async def notify(self, name: str, payload: str = "",
                     timeout: float = 5.0) -> dict:
        """Notify every watcher; resolves with who acked and who timed out
        (rados_notify2)."""
        return await self.objecter.op_submit(
            self.pool_id, name, "notify",
            extra={"payload": payload, "timeout": timeout},
        )


class Rados:
    """Cluster handle (librados::Rados): connect, open pools, admin."""

    def __init__(
        self,
        name: str,
        monmap,
        config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        device=None,
    ):
        self.objecter = Objecter(name, monmap, config=config,
                                 keyring=keyring, device=device)

    async def connect(self) -> None:
        await self.objecter.start()

    async def shutdown(self) -> None:
        await self.objecter.close()

    def io_ctx(self, pool_id: int) -> IoCtx:
        return IoCtx(self.objecter, pool_id)

    async def mon_command(self, cmd: str, args: dict | None = None) -> dict:
        return await self.objecter.mon.command(cmd, args)
