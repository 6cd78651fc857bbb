"""MiniCluster: the single-process striped object store (SURVEY §7.8).

This is the minimum end-to-end slice of the reference's data path, one
process, no wire protocol:

  put(name, data)                       rados_write -> Objecter::op_submit
    -> object name -> ps -> pg          ceph_str_hash_rjenkins + stable_mod
       (src/common/ceph_hash.cc:21, osd_types.cc:1628)
    -> pg -> up/acting osds             OSDMap::_pg_to_up_acting_osds
       via the scalar CRUSH mapper      (OSDMap.cc:2591)
    -> stripe + encode on the device    ECBackend/ECTransaction -> ECUtil::encode
       (kernels: ceph_tpu_torch.ops)    (ECTransaction.cc:44)
    -> shard i -> store of acting[i]    ECSubWrite to shard OSDs (ECBackend.cc:910)

  get(name)                             objects_read_async (ECBackend.cc:2154)
    -> probe shards, pick minimum       get_min_avail_to_read_shards ->
       via minimum_to_decode            ec_impl->minimum_to_decode (1605)
    -> decode on the device if degraded ECUtil::decode (2306)

  scrub(deep)/repair()                  PGBackend::be_scan_list /
    -> shard presence/size; deep adds   ECBackend::be_deep_scrub per-shard
       crc32c vs stored HashInfo        cumulative CRC check (ECBackend.cc:2461)

  kill/revive osd + recover()           the qa Thrasher loop (ceph_manager.py:196)
    -> deterministic re-placement on the new map epoch, shard rebuild onto the
       new homes, CLAY pools reading only their repair sub-chunk fraction
       (RecoveryOp, ECBackend.cc:733; minimum_to_repair, ErasureCodeClay.cc:325)

Fault injection mirrors the reference's config hooks: per-store transient op
failures (`ms_inject_socket_failures`, options.cc:1044) retried once by the
client (the Objecter's resend contract), EIO poisoning of individual shards
(test-erasure-eio.sh), and whole-OSD death.

The cluster-level object registry stands in for the PG log (PGLog.cc): real
OSDs discover objects per PG from their logs during peering; here recovery
iterates the registry and asks the SAME placement/decode questions. Each
entry carries the object's version (object_info_t::version,
osd_types.h:object_info_t): every put bumps it and stamps it on each
replica/shard, and reads, recovery, and scrub accept only copies whose
stamp matches — otherwise a kill -> write -> revive -> overwrite -> re-kill
sequence could deterministically re-map onto a stray holding the older
version and serve stale (or version-mixed) data.

`device` (default cuda, which raises without a card) is where every pool's
codec runs — the RS byte-layout GF(2^8) kernel on a card — and is set on the
map as its runtime `OSDMap.device`. Placement, HashInfo crc32c and the
stores stay on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.common.admin import AdminCommands, OpTracker
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins
from ceph_tpu_torch.common.log import LogRegistry
from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.osd.ecutil import HashInfo
from ceph_tpu_torch.osd.memstore import MemStore, ObjectStoreError
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, OSDMap


@dataclass
class ScrubError:
    """One inconsistency found by scrub: shard is None for replicated
    pools; error is missing | stale | size_mismatch | read_error |
    hinfo_missing | digest_mismatch."""

    pool_id: int
    pg: int
    name: str
    shard: int | None
    osd: int
    error: str


@dataclass
class ObjectInfo:
    """Registry entry per object — size + write version (object_info_t)."""

    size: int
    version: int


@dataclass
class MiniCluster:
    osdmap: OSDMap
    #: pool id -> erasure profile (with "plugin"), or None for replicated
    profiles: dict[int, dict | None] = field(default_factory=dict)
    stores: dict[int, MemStore] = field(default_factory=dict)
    _codecs: dict[int, object] = field(default_factory=dict)
    #: (pool, name) -> ObjectInfo; the PG-log stand-in (see module doc)
    registry: dict[tuple[int, str], ObjectInfo] = field(default_factory=dict)
    #: where the pools' codecs and the map's batched mapper run (None =
    #: cuda, which raises without a card); a runtime choice, not compared
    device: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.osdmap.device = self.device
        for osd in range(self.osdmap.max_osd):
            self.stores[osd] = MemStore(osd_id=osd)
        # aux plumbing: per-cluster config + perf counters + op timeline,
        # all reachable through the admin command hub (`admin.handle(...)`)
        self.config = Config()
        self.perf = PerfCountersCollection()
        self.admin = AdminCommands(
            perf=self.perf, config=self.config, op_tracker=OpTracker()
        )
        self.logs = LogRegistry(config=self.config)
        self.dlog = self.logs.get_logger("rados")
        self.admin.register("log dump", self.logs.dump_recent)
        self.admin.register("log clear", self.logs.clear)
        log = self.perf.create("mini_cluster")
        log.add_u64_counter("put_ops", "client writes")
        log.add_u64_counter("put_bytes", "bytes written")
        log.add_u64_counter("get_ops", "client reads")
        log.add_u64_counter("get_bytes", "bytes read back")
        log.add_u64_counter("degraded_reads", "reads that needed decode")
        log.add_u64_counter("recovered_shards", "shards rebuilt by recover()")
        log.add_u64_counter("injected_failures", "transient faults retried")
        log.add_u64_counter("scrubs", "scrub passes run")
        log.add_u64_counter("scrub_errors", "inconsistencies found")
        log.add_time_avg("put_latency", "put wall time")
        log.add_time_avg("get_latency", "get wall time")
        self.log = log
        # the reference drives injection through config observers
        # (md_config_obs_t); mirror that: changing the option at runtime
        # rewires every store. Apply once up front too, so env/file-tier
        # values (which fire no observer) reach the initial stores.
        self.config.observe(
            "ms_inject_socket_failures", self._apply_injection
        )
        self._apply_injection(
            "ms_inject_socket_failures",
            self.config.get("ms_inject_socket_failures"),
        )

    def _apply_injection(self, _name: str, value: int) -> None:
        for store in self.stores.values():
            store.inject_transient_every = int(value)

    # -- plumbing --------------------------------------------------------------

    def codec(self, pool_id: int):
        if pool_id not in self._codecs:
            profile = self.profiles.get(pool_id)
            if profile is None:
                self._codecs[pool_id] = None
            else:
                profile = dict(profile)
                plugin = profile.pop("plugin", "tpu")
                self._codecs[pool_id] = factory(
                    plugin, profile, device=self.device
                )
        return self._codecs[pool_id]

    def object_pg(self, pool_id: int, name: str) -> int:
        pool = self.osdmap.pools[pool_id]
        return pool.raw_pg_to_pg(ceph_str_hash_rjenkins(name))

    def acting(self, pool_id: int, name: str) -> tuple[int, list[int]]:
        pg = self.object_pg(pool_id, name)
        _, _, acting, _ = self.osdmap.pg_to_up_acting_osds(pool_id, pg)
        return pg, acting

    def _op(self, fn, *args, **kw):
        """One retry on injected transient failures — the client resend
        contract (Objecter re-targets and resends on failure/map change)."""
        try:
            return fn(*args, **kw)
        except ObjectStoreError as e:
            if e.code != "ECONN":
                raise
            self.log.inc("injected_failures")
            return fn(*args, **kw)

    # -- client API ------------------------------------------------------------

    def put(self, pool_id: int, name: str, data: bytes) -> None:
        with self.log.time("put_latency"), self.admin.op_tracker.track(
            f"put {pool_id}/{name}"
        ) as op:
            pg, acting = self.acting(pool_id, name)
            op.mark_event("placed")
            prev = self.registry.get((pool_id, name))
            ver = 1 if prev is None else prev.version + 1
            ec = self.codec(pool_id)
            if ec is None:  # replicated: full copy on every acting osd
                for osd in acting:
                    if osd != CRUSH_ITEM_NONE:
                        self._op(
                            self.stores[osd].write, (pool_id, pg, name), data,
                            attrs={"ver": ver},
                        )
            else:
                encoded = ec.encode(range(ec.get_chunk_count()), data)
                op.mark_event("encoded")
                # per-shard cumulative crc32c metadata, stored identically on
                # every shard (ECUtil::HashInfo; verified by deep scrub)
                hinfo = HashInfo.from_shards(encoded, ec.get_chunk_count())
                for shard, osd in enumerate(acting):
                    if osd == CRUSH_ITEM_NONE:
                        continue  # degraded write: shard stays missing
                    self._op(
                        self.stores[osd].write,
                        (pool_id, pg, name, shard),
                        encoded[shard],
                        attrs={"hinfo": hinfo, "ver": ver},
                    )
            op.mark_event("stored")
            if (d := self.dlog.dout(5)) is not None:
                d(f"put {pool_id}/{name} pg {pg} acting {acting} "
                  f"{len(data)} bytes v{ver}")
            self.registry[(pool_id, name)] = ObjectInfo(len(data), ver)
            self.log.inc("put_ops")
            self.log.inc("put_bytes", len(data))

    def get(self, pool_id: int, name: str) -> bytes:
        with self.log.time("get_latency"), self.admin.op_tracker.track(
            f"get {pool_id}/{name}"
        ) as op:
            out = self._get(pool_id, name, op)
            self.log.inc("get_ops")
            self.log.inc("get_bytes", len(out))
            return out

    def _get(self, pool_id: int, name: str, op) -> bytes:
        info = self.registry.get((pool_id, name))
        if info is None:
            raise KeyError(f"no such object {name!r} in pool {pool_id}")
        size = info.size
        pg, acting = self.acting(pool_id, name)
        ec = self.codec(pool_id)
        if ec is None:
            key = (pool_id, pg, name)
            candidates = [o for o in acting if o != CRUSH_ITEM_NONE]
            # stray fallback: previous-interval OSDs may still hold copies —
            # but only at the current write version (module doc: strays can
            # deterministically re-enter the acting set holding old data)
            candidates += [o for o in self.stores if o not in candidates]
            for osd in candidates:
                store = self.stores[osd]
                if key not in store.objects:
                    continue
                if store.attrs.get(key, {}).get("ver") != info.version:
                    continue
                try:
                    return self._op(store.read, key)
                except ObjectStoreError:
                    continue
            raise ErasureCodeError(5, f"no live replica of {name!r}")

        # EC read: probe shard availability, then read only the minimum set
        available = self._probe_shards(
            pool_id, pg, name, ec, acting, info.version
        )
        op.mark_event("probed")
        want = {ec.chunk_index(i) for i in range(ec.get_data_chunk_count())}
        if not want <= set(available):
            self.log.inc("degraded_reads")  # a data chunk must be rebuilt
            if (d := self.dlog.dout(1)) is not None:
                d(f"degraded read {pool_id}/{name}: shards "
                  f"{sorted(set(want) - set(available))} missing")
        return self._read_min_and_decode(
            pool_id, pg, name, ec, available, size, want
        )

    def _probe_shards(
        self, pool_id, pg, name, ec, acting, version
    ) -> dict[int, int]:
        """shard -> osd for every readable current-version shard at its
        acting home."""
        available: dict[int, int] = {}
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            store = self.stores[osd]
            key = (pool_id, pg, name, shard)
            if (
                store.alive
                and key not in store.eio_keys
                and key in store.objects
                and store.attrs.get(key, {}).get("ver") == version
            ):
                available[shard] = osd
        return available

    def _read_min_and_decode(
        self, pool_id, pg, name, ec, available, size, want
    ) -> bytes:
        """Plan the minimum read set, fetch it, decode, truncate — replanning
        without any shard that fails mid-read (handle_sub_read error path,
        ECBackend.cc:985)."""
        while True:
            minimum = ec.minimum_to_decode(want, set(available))
            chunks: dict[int, bytes] = {}
            retry = False
            for shard in minimum:
                key = (pool_id, pg, name, shard)
                try:
                    chunks[shard] = self._op(
                        self.stores[available[shard]].read, key
                    )
                except ObjectStoreError:
                    del available[shard]
                    retry = True
                    break
            if retry:
                continue
            decoded = ec.decode(want, chunks)
            return self._concat(ec, decoded)[:size]

    @staticmethod
    def _concat(ec, decoded: dict[int, bytes]) -> bytes:
        return b"".join(
            decoded[ec.chunk_index(i)] for i in range(ec.get_data_chunk_count())
        )

    # -- scrub (PGBackend::be_scan_list / ECBackend::be_deep_scrub) ------------

    #: inconsistencies repair can fix from surviving copies; "missing"
    #: and "stale" are recovery's job, "size_mismatch" may lack a safe
    #: authority — auto-repair only fires on unambiguous damage
    AUTO_REPAIRABLE = frozenset(
        {"digest_mismatch", "read_error", "hinfo_missing"}
    )

    def scrub(
        self, pool_id: int, deep: bool = False,
        _allow_auto_repair: bool = True,
    ) -> list["ScrubError"]:
        """Consistency check over every registered object's shards/replicas.

        Shallow: presence + size agreement (PGBackend::be_scan_list,
        PGBackend.cc:571). Deep additionally re-reads every shard and checks
        its crc32c against the stored HashInfo (EC: ECBackend::be_deep_scrub,
        ECBackend.cc:2461-2540) or against the replica majority (replicated
        pools' data digest comparison). Faults found are returned, counted,
        and left in place for `repair` — unless `osd_scrub_auto_repair` is
        set, in which case a deep scrub that finds repairable damage runs
        the same primary-driven repair in place.
        """
        errors = self._scrub_pass(pool_id, deep)
        if (
            _allow_auto_repair
            and deep
            and self.config.get("osd_scrub_auto_repair")
            and any(e.error in self.AUTO_REPAIRABLE for e in errors)
        ):
            if (d := self.dlog.dout(1)) is not None:
                d(f"pool {pool_id}: deep scrub auto-repairing "
                  f"{len(errors)} inconsistencies")
            self._drop_inconsistent(errors)
            self.recover(pool_id)
        return errors

    def _scrub_pass(self, pool_id: int, deep: bool) -> list["ScrubError"]:
        ec = self.codec(pool_id)
        errors: list[ScrubError] = []
        for (pid, name), info in list(self.registry.items()):
            if pid != pool_id:
                continue
            pg, acting = self.acting(pool_id, name)
            if ec is None:
                errors.extend(
                    self._scrub_replicated(
                        pool_id, pg, name, acting, deep, info.version
                    )
                )
            else:
                errors.extend(
                    self._scrub_ec(
                        pool_id, pg, name, acting, ec, deep, info.version
                    )
                )
        self.log.inc("scrubs")
        self.log.inc("scrub_errors", len(errors))
        return errors

    @staticmethod
    def _authoritative_size(sizes: dict[int, int], hinfo_size: int | None):
        """The chunk size shards must agree on: the stored HashInfo's when
        available (what ECBackend trusts), else a strict size majority, else
        None (no safe authority — flag nothing rather than risk repair
        deleting good shards on a tie)."""
        if hinfo_size is not None:
            return hinfo_size
        counts: dict[int, int] = {}
        for s in sizes.values():
            counts[s] = counts.get(s, 0) + 1
        best = max(counts, key=counts.get)
        return best if counts[best] * 2 > len(sizes) else None

    def _scrub_ec(self, pool_id, pg, name, acting, ec, deep, version):
        errors = []
        sizes: dict[int, int] = {}
        hinfo_size = None
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE:
                continue
            key = (pool_id, pg, name, shard)
            store = self.stores[osd]
            if not store.alive or key not in store.objects:
                errors.append(ScrubError(pool_id, pg, name, shard, osd,
                                         "missing"))
                continue
            if store.attrs.get(key, {}).get("ver") != version:
                # an older write interval's shard at the acting home
                errors.append(ScrubError(pool_id, pg, name, shard, osd,
                                         "stale"))
                continue
            sizes[shard] = len(store.objects[key])
            if hinfo_size is None:
                hinfo = store.attrs.get(key, {}).get("hinfo")
                if hinfo is not None:
                    hinfo_size = hinfo.total_chunk_size
        if len(set(sizes.values())) > 1 or (
            hinfo_size is not None
            and any(s != hinfo_size for s in sizes.values())
        ):
            # shards of one object must share a chunk size (stripe_info_t)
            auth = self._authoritative_size(sizes, hinfo_size)
            for shard, size in sizes.items():
                if auth is not None and size != auth:
                    errors.append(ScrubError(pool_id, pg, name, shard,
                                             acting[shard], "size_mismatch"))
        if not deep:
            return errors
        for shard, osd in enumerate(acting):
            if osd == CRUSH_ITEM_NONE or shard not in sizes:
                continue
            key = (pool_id, pg, name, shard)
            store = self.stores[osd]
            try:
                # through the client retry contract: a single injected
                # transient fault must not read as permanent corruption
                data = self._op(store.read, key)
                hinfo = self._op(store.getattrs, key).get("hinfo")
            except ObjectStoreError:
                errors.append(ScrubError(pool_id, pg, name, shard, osd,
                                         "read_error"))
                continue
            if hinfo is None:
                errors.append(ScrubError(pool_id, pg, name, shard, osd,
                                         "hinfo_missing"))
                continue
            if ceph_crc32c(0xFFFFFFFF, data) != hinfo.get_chunk_hash(shard):
                errors.append(ScrubError(pool_id, pg, name, shard, osd,
                                         "digest_mismatch"))
        return errors

    def _scrub_replicated(self, pool_id, pg, name, acting, deep, version):
        errors = []
        key = (pool_id, pg, name)
        digests: dict[int, int] = {}
        sizes: dict[int, int] = {}
        for osd in acting:
            if osd == CRUSH_ITEM_NONE:
                continue
            store = self.stores[osd]
            if not store.alive or key not in store.objects:
                errors.append(ScrubError(pool_id, pg, name, None, osd,
                                         "missing"))
                continue
            if store.attrs.get(key, {}).get("ver") != version:
                errors.append(ScrubError(pool_id, pg, name, None, osd,
                                         "stale"))
                continue
            sizes[osd] = len(store.objects[key])
            if deep:
                try:
                    digests[osd] = ceph_crc32c(
                        0xFFFFFFFF, self._op(store.read, key)
                    )
                except ObjectStoreError:
                    errors.append(ScrubError(pool_id, pg, name, None, osd,
                                             "read_error"))
        if len(set(sizes.values())) > 1:
            auth = self._authoritative_size(sizes, None)
            for osd, size in sizes.items():
                if auth is not None and size != auth:
                    errors.append(ScrubError(pool_id, pg, name, None, osd,
                                             "size_mismatch"))
        if deep and len(set(digests.values())) > 1:
            # auth copy = the digest majority (ties -> the primary's copy),
            # like the reference's be_select_auth_object
            counts: dict[int, int] = {}
            for d in digests.values():
                counts[d] = counts.get(d, 0) + 1
            best = max(counts.values())
            majority = {d for d, c in counts.items() if c == best}
            auth = next(
                d for o, d in digests.items() if d in majority
            )
            for osd, d in digests.items():
                if d != auth:
                    errors.append(ScrubError(pool_id, pg, name, None, osd,
                                             "digest_mismatch"))
        return errors

    def repair(self, pool_id: int) -> int:
        """Deep-scrub, drop every inconsistent copy, rebuild via recover()
        (the `ceph pg repair` flow)."""
        errors = self.scrub(pool_id, deep=True, _allow_auto_repair=False)
        self._drop_inconsistent(errors)
        return self.recover(pool_id)

    def _drop_inconsistent(self, errors: list["ScrubError"]) -> None:
        for e in errors:
            if e.error == "missing":
                continue  # nothing stored to drop
            store = self.stores[e.osd]
            key = (
                (e.pool_id, e.pg, e.name)
                if e.shard is None
                else (e.pool_id, e.pg, e.name, e.shard)
            )
            store.objects.pop(key, None)
            store.attrs.pop(key, None)
            store.eio_keys.discard(key)

    # -- failure / recovery (the thrasher loop) --------------------------------

    def kill_osd(self, osd: int) -> None:
        if (d := self.dlog.dout(1)) is not None:
            d(f"osd.{osd} down")
        self.stores[osd].alive = False
        self.osdmap.mark_down(osd)

    def revive_osd(self, osd: int) -> None:
        """Revive with amnesia: the store comes back empty (recovery must
        rebuild), like an OSD replaced after data loss."""
        self.stores[osd] = MemStore(
            osd_id=osd,
            inject_transient_every=self.config.get(
                "ms_inject_socket_failures"
            ),
        )
        self.osdmap.mark_up(osd)

    def recover(self, pool_id: int) -> int:
        """Rebuild missing shards onto their current acting homes.

        For every registered object: any acting position whose store lacks
        its shard gets the shard rebuilt from the minimum surviving set —
        single-shard losses on CLAY pools read only the repair sub-chunk
        fraction (minimum_to_decode -> (offset, count) runs). Returns the
        number of shards rebuilt. Mirrors RecoveryOp (ECBackend.cc:733).
        """
        ec = self.codec(pool_id)
        rebuilt = 0
        for (pid, name), info in list(self.registry.items()):
            if pid != pool_id:
                continue
            ver = info.version
            pg, acting = self.acting(pool_id, name)
            if ec is None:
                key = (pool_id, pg, name)
                data = None
                # acting homes first, then stray stores (MissingLoc contract);
                # only current-version copies are valid pull sources
                candidates = [o for o in acting if o != CRUSH_ITEM_NONE]
                candidates += [o for o in self.stores if o not in candidates]
                for osd in candidates:
                    store = self.stores[osd]
                    if (
                        store.alive
                        and key in store.objects
                        and key not in store.eio_keys
                        and store.attrs.get(key, {}).get("ver") == ver
                    ):
                        data = store.objects[key]
                        break
                if data is None:
                    continue
                for osd in acting:
                    if osd == CRUSH_ITEM_NONE:
                        continue
                    st = self.stores[osd]
                    if (
                        key not in st.objects
                        or st.attrs.get(key, {}).get("ver") != ver
                    ):
                        self._op(st.write, key, data, attrs={"ver": ver})
                        rebuilt += 1
                continue

            # locate every shard: acting home first, then stray stores (the
            # MissingLoc contract, src/osd/MissingLoc.cc — after a remap the
            # surviving shards still live on the previous interval's OSDs)
            available: dict[int, int] = {}
            missing: list[tuple[int, int]] = []

            def readable(osd: int, key: tuple) -> bool:
                st = self.stores[osd]
                return (
                    st.alive
                    and key in st.objects
                    and key not in st.eio_keys
                    and st.attrs.get(key, {}).get("ver") == ver
                )

            for shard, osd in enumerate(acting):
                key = (pool_id, pg, name, shard)
                if osd != CRUSH_ITEM_NONE and readable(osd, key):
                    available[shard] = osd
                    continue
                stray = next(
                    (o for o in self.stores if readable(o, key)), None
                )
                if stray is not None:
                    available[shard] = stray
                if osd != CRUSH_ITEM_NONE:
                    missing.append((shard, osd))
            def hinfo_of(avail: dict[int, int]) -> dict:
                for s, o in avail.items():
                    a = self.stores[o].attrs.get((pool_id, pg, name, s))
                    if a and "hinfo" in a:
                        return {"hinfo": a["hinfo"], "ver": ver}
                return {"ver": ver}

            for shard, osd in missing:
                key = (pool_id, pg, name, shard)
                if shard in available:
                    # log-based recovery: the shard survives on a stray OSD,
                    # push the copy instead of decoding (ReplicatedBackend-
                    # style pull/push vs full rebuild) — but verify the pull
                    # against its own hinfo first, else a silently-corrupted
                    # stray re-infects the acting home on every repair pass
                    src = self.stores[available[shard]]
                    pulled = src.objects[key]
                    hinfo = src.attrs.get(key, {}).get("hinfo")
                    good = hinfo is None or ceph_crc32c(
                        0xFFFFFFFF, pulled
                    ) == hinfo.get_chunk_hash(shard)
                    if good:
                        self._op(
                            self.stores[osd].write, key, pulled,
                            attrs=src.attrs.get(key),
                        )
                        available[shard] = osd
                        rebuilt += 1
                        continue
                    del available[shard]  # corrupt source: decode instead
                sub_total = ec.get_sub_chunk_count()
                while True:  # re-plan without any source that fails mid-read
                    minimum = ec.minimum_to_decode({shard}, set(available))
                    chunk_size = None
                    chunks: dict[int, bytes] = {}
                    partial = False
                    failed_src = None
                    for src, runs in minimum.items():
                        key = (pool_id, pg, name, src)
                        store = self.stores[available[src]]
                        try:
                            n_sub = sum(c for _, c in runs)
                            if n_sub < sub_total:
                                partial = True
                                whole_len = len(store.objects[key])
                                chunk_size = whole_len
                                unit = whole_len // sub_total
                                chunks[src] = self._op(
                                    store.read_runs, key, runs, unit
                                )
                            else:
                                chunks[src] = self._op(store.read, key)
                                chunk_size = len(chunks[src])
                        except ObjectStoreError:
                            failed_src = src
                            break
                    if failed_src is not None:
                        del available[failed_src]
                        continue
                    break
                if partial:
                    decoded = ec.decode({shard}, chunks, chunk_size=chunk_size)
                else:
                    decoded = ec.decode({shard}, chunks)
                self._op(
                    self.stores[osd].write,
                    (pool_id, pg, name, shard),
                    decoded[shard],
                    attrs=hinfo_of(available),
                )
                available[shard] = osd
                rebuilt += 1
        self.log.inc("recovered_shards", rebuilt)
        if (d := self.dlog.dout(1)) is not None:
            d(f"recovery pool {pool_id}: rebuilt {rebuilt} shards")
        return rebuilt
