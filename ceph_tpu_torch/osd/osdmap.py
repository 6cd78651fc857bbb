"""OSDMap: the epoch-versioned cluster map and its placement pipeline.

Re-expresses the reference's `OSDMap` placement path (src/osd/OSDMap.cc):

  pg -> pps (stable-mod + pool hash)          osd_types.cc:1640
     -> raw osds (crush->do_rule)             OSDMap.cc:2359 _pg_to_raw_osds
     -> upmap overrides                       OSDMap.cc:2389 _apply_upmap
     -> up osds (drop/NONE down+dne)          OSDMap.cc:2436 _raw_to_up_osds
     -> primary (affinity-aware)              OSDMap.cc:2460 _apply_primary_affinity
     -> acting (pg_temp/primary_temp)         OSDMap.cc:2515 _get_temp_osds
                                              OSDMap.cc:2591 _pg_to_up_acting_osds

Two drivers share the exact same semantics:

  * `pg_to_up_acting_osds(pool_id, ps)` — scalar, mirrors the C control flow,
    used by tests and one-off lookups;
  * `pool_mappings(pool_id)` — the whole pool in one batched mapper run
    (ceph_tpu_torch.crush.torch_mapper.map_rule: one launch of the straw2
    choose kernel per choose step on a card) plus vectorized numpy
    post-processing: the replacement for the reference's thread-pool
    ParallelPGMapper (OSDMapMapping.h:18).

Copy of ceph_tpu/osd/osdmap.py with the batched mapper swapped for
torch_mapper. One addition: the runtime attribute `device` (default None,
which means cuda; "cpu" when the caller names it) says where the compiled
map lives and where calc_pg_upmaps scores its moves. It is neither encoded
nor compared, so a map's bytes are those of the JAX package's OSDMap.

`calc_pg_upmaps` is the balancer step (OSDMap.cc:4512): it computes per-OSD
PG load from the batched mapping, then greedily moves PGs from the most
overfull OSD to underfull peers via pg_upmap_items entries until the
deviation target or the change budget is hit. Unlike the reference it does
not re-run crush->try_remap_rule per candidate; it restricts replacement
targets to OSDs absent from the PG's up set and re-validates by remapping
the touched PG, which keeps sets duplicate-free (failure-domain validation
beyond that is the caller's concern, as noted in the method doc).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush import mapper as scalar_mapper
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.osd.types import PgPool
from ceph_tpu_torch.crush.hash import crush_hash32_2

CRUSH_ITEM_NONE = 0x7FFFFFFF
DEFAULT_PRIMARY_AFFINITY = 0x10000
MAX_PRIMARY_AFFINITY = 0x10000


@dataclass
class OSDMap:
    crush: CrushMap
    pools: dict[int, PgPool] = field(default_factory=dict)
    max_osd: int = 0
    epoch: int = 1
    # per-osd state; weights are 16.16 fixed point like the crush map's
    osd_exists: np.ndarray | None = None  # bool (max_osd,)
    osd_up: np.ndarray | None = None  # bool (max_osd,)
    osd_weight: np.ndarray | None = None  # int64 16.16 in/out weight
    osd_primary_affinity: np.ndarray | None = None  # int64 16.16
    #: per-osd up_thru epoch (osd_info_t::up_thru): the highest epoch
    #: the mon has confirmed this OSD was alive-and-primary in. The
    #: load-bearing bit of interval math: a past interval whose primary
    #: never got up_thru confirmed inside it CANNOT have served writes
    #: (maybe_went_rw=false), so peering may skip its members
    osd_up_thru: np.ndarray | None = None  # int64 (max_osd,)
    pg_upmap: dict[tuple[int, int], list[int]] = field(default_factory=dict)
    pg_upmap_items: dict[tuple[int, int], list[tuple[int, int]]] = field(
        default_factory=dict
    )
    pg_temp: dict[tuple[int, int], list[int]] = field(default_factory=dict)
    primary_temp: dict[tuple[int, int], int] = field(default_factory=dict)
    #: profile name -> k/v profile, stored in the map like the reference
    #: (OSDMap::erasure_code_profiles; the mon validates + commits them)
    erasure_code_profiles: dict[str, dict] = field(default_factory=dict)
    #: osd -> (host, port) public address (OSDMap::osd_addrs) — how clients
    #: and peers reach a daemon; registered at boot via the mon
    osd_addrs: dict[int, tuple[str, int]] = field(default_factory=dict)
    #: osd -> scheme-tagged local endpoint (uds://...) announced at boot;
    #: co-located clients dial this first and fall back to osd_addrs
    osd_local_addrs: dict[int, str] = field(default_factory=dict)
    #: fencing (OSDMap.h:579 blacklist map): entity identity -> unix expiry.
    #: Identities are "client.name" (every instance of the entity) or
    #: "client.name/nonce" (one messenger instance). OSDs refuse ops from
    #: blocklisted identities; the MDS blocklists before re-granting an
    #: evicted client's caps (mds_session_blacklist_on_evict) so stale
    #: direct-RADOS writes can never race the new cap holder.
    blocklist: dict[str, float] = field(default_factory=dict)
    #: where the batched mapper and the move scorer run (None = cuda, which
    #: raises without a card); a runtime choice, never encoded or compared
    device: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        n = self.max_osd
        if self.osd_exists is None:
            self.osd_exists = np.ones(n, dtype=bool)
        if self.osd_up is None:
            self.osd_up = np.ones(n, dtype=bool)
        if self.osd_weight is None:
            self.osd_weight = np.full(n, 0x10000, dtype=np.int64)
        if self.osd_up_thru is None:
            self.osd_up_thru = np.zeros(n, dtype=np.int64)
        self._compiled = None
        #: BalanceResult of the most recent calc_pg_upmaps pass (not
        #: encoded; diagnostics for the balancer module / bench)
        self.last_balance = None

    # -- state transitions (the failure-detection consumer) -------------------

    # note: up/out/weight changes do NOT invalidate the compiled mapper —
    # compile_map depends only on the crush hierarchy; weights are a per-call
    # input and up/exists are applied in post-processing. Only crush edits
    # need invalidate_compiled().

    def invalidate_compiled(self) -> None:
        """Call after mutating self.crush (buckets/rules/tunables)."""
        self._compiled = None

    def mark_down(self, osd: int) -> None:
        self.osd_up[osd] = False
        self.epoch += 1

    def mark_up(self, osd: int) -> None:
        self.osd_up[osd] = True
        self.epoch += 1

    def mark_out(self, osd: int) -> None:
        self.osd_weight[osd] = 0
        self.epoch += 1

    def reweight(self, osd: int, weight_16_16: int) -> None:
        self.osd_weight[osd] = weight_16_16
        self.epoch += 1

    def is_down(self, osd: int) -> bool:
        return not (0 <= osd < self.max_osd and self.osd_up[osd])

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_exists[osd])

    def is_blocklisted(
        self, name: str, nonce: int = 0, now: float | None = None
    ) -> bool:
        """OSDMap::is_blacklisted: entity-wide entry fences every
        instance; an entity/nonce entry fences one messenger instance.
        Entries expire by wall clock (utime expiry in the reference)."""
        if not self.blocklist:
            return False
        if now is None:
            import time as _time

            now = _time.time()
        for key in (name, f"{name}/{nonce}"):
            exp = self.blocklist.get(key)
            if exp is not None and exp > now:
                return True
        return False

    # -- rule lookup (CrushWrapper::find_rule) ---------------------------------

    def find_rule(self, ruleset: int, pool_type: int, size: int) -> int:
        for rid, rule in sorted(self.crush.rules.items()):
            if (
                rule.ruleset == ruleset
                and rule.type == pool_type
                and rule.min_size <= size <= rule.max_size
            ):
                return rid
        return -1

    # -- scalar pipeline -------------------------------------------------------

    def pg_to_raw_osds(self, pool_id: int, ps: int) -> tuple[list[int], int]:
        """_pg_to_raw_osds (OSDMap.cc:2359): CRUSH + drop nonexistent."""
        pool = self.pools[pool_id]
        pps = pool.raw_pg_to_pps(pool_id, ps)
        ruleno = self.find_rule(pool.crush_rule, pool.type, pool.size)
        if ruleno < 0:
            return [], pps
        raw = scalar_mapper.do_rule(
            self.crush, ruleno, pps, list(self.osd_weight), pool.size
        )
        raw = self._remove_nonexistent(pool, raw)
        return raw, pps

    def _remove_nonexistent(self, pool: PgPool, raw: list[int]) -> list[int]:
        if pool.can_shift_osds():
            return [o for o in raw if o == CRUSH_ITEM_NONE or self.exists(o)]
        return [
            o if o == CRUSH_ITEM_NONE or self.exists(o) else CRUSH_ITEM_NONE
            for o in raw
        ]

    def apply_upmap(self, pool_id: int, ps: int, raw: list[int]) -> list[int]:
        """_apply_upmap (OSDMap.cc:2389): explicit full-set override, then
        per-item from->to replacements; targets marked out are ignored."""
        pool = self.pools[pool_id]
        pg = (pool_id, pool.raw_pg_to_pg(ps))
        full = self.pg_upmap.get(pg)
        if full is not None:
            ok = all(
                not (
                    o != CRUSH_ITEM_NONE
                    and 0 <= o < self.max_osd
                    and self.osd_weight[o] == 0
                )
                for o in full
            )
            if not ok:
                # an out target invalidates the whole explicit mapping AND
                # short-circuits pg_upmap_items (OSDMap.cc:2395-2400 returns)
                return raw
            raw = list(full)
        items = self.pg_upmap_items.get(pg)
        if items is not None:
            raw = list(raw)
            for frm, to in items:
                pos = -1
                exists = False
                for i, o in enumerate(raw):
                    if o == to:
                        exists = True
                        break
                    if (
                        o == frm
                        and pos < 0
                        and not (
                            to != CRUSH_ITEM_NONE
                            and 0 <= to < self.max_osd
                            and self.osd_weight[to] == 0
                        )
                    ):
                        pos = i
                if not exists and pos >= 0:
                    raw[pos] = to
        return raw

    def raw_to_up_osds(self, pool: PgPool, raw: list[int]) -> list[int]:
        """_raw_to_up_osds (OSDMap.cc:2436): drop (replicated) or NONE-out
        (erasure) the down/nonexistent devices."""
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and not self.is_down(o)]
        return [
            o if self.exists(o) and not self.is_down(o) else CRUSH_ITEM_NONE
            for o in raw
        ]

    @staticmethod
    def pick_primary(osds: list[int]) -> int:
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def apply_primary_affinity(
        self, pps: int, pool: PgPool, up: list[int], primary: int
    ) -> tuple[list[int], int]:
        """_apply_primary_affinity (OSDMap.cc:2460)."""
        aff = self.osd_primary_affinity
        if aff is None:
            return up, primary
        if not any(
            o != CRUSH_ITEM_NONE and aff[o] != DEFAULT_PRIMARY_AFFINITY
            for o in up
        ):
            return up, primary
        pos = -1
        for i, o in enumerate(up):
            if o == CRUSH_ITEM_NONE:
                continue
            a = int(aff[o])
            if a < MAX_PRIMARY_AFFINITY and (
                crush_hash32_2(pps, o) >> 16
            ) >= a:
                if pos < 0:
                    pos = i
            else:
                pos = i
                break
        if pos < 0:
            return up, primary
        primary = up[pos]
        if pool.can_shift_osds() and pos > 0:
            up = [up[pos]] + up[:pos] + up[pos + 1 :]
        return up, primary

    def get_temp_osds(
        self, pool_id: int, ps: int
    ) -> tuple[list[int], int]:
        """_get_temp_osds (OSDMap.cc:2515): pg_temp/primary_temp overrides."""
        pool = self.pools[pool_id]
        pg = (pool_id, pool.raw_pg_to_pg(ps))
        raw_temp = self.pg_temp.get(pg, [])
        if pool.can_shift_osds():
            temp = [
                o for o in raw_temp
                if self.exists(o) and not self.is_down(o)
            ]
        else:
            # positional semantics: dead members become NONE holes so the
            # surviving shards keep their offsets (OSDMap.cc:2524-2529)
            temp = [
                o if self.exists(o) and not self.is_down(o)
                else CRUSH_ITEM_NONE
                for o in raw_temp
            ]
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp:
            temp_primary = self.pick_primary(temp)
        return temp, temp_primary

    def pg_to_up_acting_osds(
        self, pool_id: int, ps: int
    ) -> tuple[list[int], int, list[int], int]:
        """_pg_to_up_acting_osds (OSDMap.cc:2591):
        returns (up, up_primary, acting, acting_primary)."""
        pool = self.pools.get(pool_id)
        if pool is None or ps >= pool.pg_num:
            return [], -1, [], -1
        acting, acting_primary = self.get_temp_osds(pool_id, ps)
        raw, pps = self.pg_to_raw_osds(pool_id, ps)
        raw = self.apply_upmap(pool_id, ps, raw)
        up = self.raw_to_up_osds(pool, raw)
        up_primary = self.pick_primary(up)
        up, up_primary = self.apply_primary_affinity(
            pps, pool, up, up_primary
        )
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        return up, up_primary, acting, acting_primary

    def read_candidates(self, acting: list[int]) -> list[int]:
        """Clean-acting balanced-read targets: the live members of the
        acting set (the client side of CEPH_OSD_FLAG_BALANCE_READS
        target selection). Positional EC holes and down members are
        never candidates; backfill targets and peering state are only
        knowable OSD-side, so the serving OSD re-validates and
        redirects when it cannot prove its copy current."""
        return [
            o for o in acting
            if o != CRUSH_ITEM_NONE and not self.is_down(o)
        ]

    def whole_acting(self, acting: list[int]) -> bool:
        """True when every positional slot of the acting set holds a
        live OSD — the precondition for EC direct-shard reads (any hole
        means some shard would need a decode, i.e. the primary path)."""
        return bool(acting) and all(
            o != CRUSH_ITEM_NONE and not self.is_down(o) for o in acting
        )

    # -- batched pipeline (the ParallelPGMapper analogue) ----------------------

    def _compile(self):
        from ceph_tpu_torch.crush import torch_mapper

        if self._compiled is None:
            self._compiled = torch_mapper.compile_map_cached(
                self.crush, device=self.device
            )
        return self._compiled

    def pool_mappings(
        self, pool_id: int, runtime_weights=None, return_raw=False
    ) -> np.ndarray:
        """Up sets for EVERY PG of a pool in one batched mapper run.

        Returns (pg_num, size) int32, CRUSH_ITEM_NONE-padded, after the full
        raw -> upmap -> up pipeline (erasure pools keep positional NONE
        holes; replicated pools are left-compacted). One device launch maps
        the whole pool — the batch axis is the PG id.

        runtime_weights: optional torch_mapper.runtime_weight_arrays overlay —
        candidate choose_args weight-sets read by the choose kernel with no
        recompile (the crush-compat balancer's per-iteration path). Callers
        must keep self.crush.choose_args in sync with the overlay: the
        sparse overrides below (upmap entries, primary-affinity rows) re-run
        through the scalar pipeline, which reads choose_args from the map.

        return_raw=True additionally returns the pre-upmap CRUSH rows
        ((pg_num, size) int32, the _pg_to_raw_osds stage before
        _remove_nonexistent) as a second array: the balancer revalidates
        candidate moves by replaying apply_upmap/raw_to_up_osds over these
        cached rows — bit-identical to a full scalar remap without paying
        the per-PG CRUSH walk per move.
        """
        from ceph_tpu_torch.crush import torch_mapper

        pool = self.pools[pool_id]
        ps = np.arange(pool.pg_num, dtype=np.int64)
        pps = pool.raw_pg_to_pps_np(pool_id, ps)
        ruleno = self.find_rule(pool.crush_rule, pool.type, pool.size)
        if ruleno < 0:
            empty = np.full(
                (pool.pg_num, pool.size), CRUSH_ITEM_NONE, np.int32
            )
            return (empty, empty.copy()) if return_raw else empty
        if not torch_mapper.supports(self.crush, ruleno):
            # PER-RULE scope gate: only rules that reach legacy buckets
            # pay the scalar path — straw2 rules keep the batched 10x
            # even on a map that has a legacy bucket somewhere else
            out = np.full(
                (pool.pg_num, pool.size), CRUSH_ITEM_NONE, np.int32
            )
            raw_out = np.full_like(out, CRUSH_ITEM_NONE)
            for pg_ord in range(pool.pg_num):
                up, *_ = self.pg_to_up_acting_osds(pool_id, pg_ord)
                out[pg_ord, : len(up)] = up
                if return_raw:
                    rr = scalar_mapper.do_rule(
                        self.crush, ruleno,
                        int(pps[pg_ord]), list(self.osd_weight), pool.size,
                    )
                    raw_out[pg_ord, : len(rr)] = rr
            return (out, raw_out) if return_raw else out
        raw = torch_mapper.map_rule(
            self._compile(), ruleno, pps, self.osd_weight,
            pool.size, runtime_weights=runtime_weights,
        )  # (pg_num, size)

        # vectorized _remove_nonexistent + _raw_to_up_osds: valid = exists & up
        osd_ok = self.osd_exists & self.osd_up
        in_range = (raw >= 0) & (raw < self.max_osd)
        valid = np.where(in_range, osd_ok[np.clip(raw, 0, self.max_osd - 1)], False)
        none = raw == CRUSH_ITEM_NONE

        # sparse overrides (upmap entries, and rows touched by non-default
        # primary affinity, which reorders replicated up-sets): few by
        # construction, re-run through the exact scalar pipeline
        out = np.where(valid | none, raw, CRUSH_ITEM_NONE).astype(np.int32)
        # ps < pg_num guards against stale entries after a pool shrink
        overridden = {
            pg[1]
            for pg in list(self.pg_upmap) + list(self.pg_upmap_items)
            if pg[0] == pool_id and pg[1] < pool.pg_num
        }
        aff = self.osd_primary_affinity
        if aff is not None:
            special = np.zeros(self.max_osd + 1, dtype=bool)
            special[:-1] = np.asarray(aff) != DEFAULT_PRIMARY_AFFINITY
            hit = special[
                np.clip(np.where(out == CRUSH_ITEM_NONE, self.max_osd, out),
                        0, self.max_osd)
            ].any(axis=1)
            overridden |= set(np.nonzero(hit)[0].tolist())
        for pg_ord in overridden:
            up, *_ = self.pg_to_up_acting_osds(pool_id, int(pg_ord))
            row = np.full(pool.size, CRUSH_ITEM_NONE, np.int32)
            row[: len(up)] = up
            out[pg_ord] = row

        if pool.can_shift_osds():
            # left-compact each row (replicated semantics): a stable argsort
            # on the NONE mask pulls placed entries left in order — one
            # vectorized pass instead of a per-row python loop (which
            # dominated whole-pool mapping at simulator scale)
            order = np.argsort(out == CRUSH_ITEM_NONE, axis=1, kind="stable")
            out = np.take_along_axis(out, order, axis=1)
        if return_raw:
            return out, np.asarray(raw, dtype=np.int32)
        return out

    # -- balancer (calc_pg_upmaps, OSDMap.cc:4512) ------------------------------

    def calc_pg_upmaps(
        self,
        max_deviation: float = 1.0,
        max_changes: int = 10,
        pools: set[int] | None = None,
    ) -> int:
        """Batched greedy upmap balancing (crush/balance.py).

        Per-OSD PG loads come from one batched mapper launch per pool, every
        candidate (pg, from, to) move is scored in one vectorized call per
        PG-table chunk, and moves are committed greedily with pg_upmap_items
        entries until every OSD's deviation from its weight-proportional
        target is within `max_deviation` PGs or `max_changes` entries were
        made. Returns the number of changes; the full BalanceResult (spread
        before/after, launches, score latency) lands in `self.last_balance`.

        This is the balancer-module usage of the reference's calc_pg_upmaps
        (pybind/mgr/balancer/module.py:902 -> OSDMap.cc:4512).
        """
        from ceph_tpu_torch.crush import balance

        result = balance.calc_pg_upmaps(
            self,
            max_deviation=max_deviation,
            max_changes=max_changes,
            pools=pools,
        )
        self.last_balance = result
        return result.changes


# -- incremental maps + encoding (OSDMap::Incremental, OSDMap.cc:encode) ------
#
# The reference distributes maps as versioned deltas: the mon commits an
# OSDMap::Incremental per epoch (OSDMap.h:class Incremental) and every daemon
# applies them in sequence; full maps are only sent to newcomers. The same
# protocol here, encoded with denc-lite (ceph_tpu_torch.common.encoding).
# The crush map travels as its canonical crushtool text (compiled back on decode) —
# byte-for-byte deterministic and human-auditable, the role the reference's
# binary crush bufferlist plays.

from dataclasses import dataclass as _dataclass, field as _field

from ceph_tpu_torch.common.encoding import Decoder as _Decoder, Encoder as _Encoder


def _enc_pg(e, pg: tuple) -> None:
    e.u64(pg[0]).u64(pg[1])


def _dec_pg(d) -> tuple:
    return (d.u64(), d.u64())


def _enc_pool(e, p: PgPool) -> None:
    e.struct(
        3,
        1,
        lambda b: b.u32(p.pg_num)
        .u32(p.pgp_num)
        .u32(p.size)
        .u32(p.min_size)
        .u8(p.type)
        .u32(p.crush_rule)
        .u64(p.flags)
        .string(p.erasure_code_profile)
        .u64(p.snap_seq)
        .list(sorted(p.removed_snaps), lambda ee, s: ee.u64(s))
        .s32(p.tier_of)
        .s32(p.read_tier)
        .s32(p.write_tier)
        .string(p.cache_mode)
        .u32(p.cache_target_dirty_max),
    )


def _dec_pool(d) -> PgPool:
    def body(b, version):
        p = PgPool(
            pg_num=b.u32(),
            pgp_num=b.u32(),
            size=b.u32(),
            min_size=b.u32(),
            type=b.u8(),
            crush_rule=b.u32(),
            flags=b.u64(),
            erasure_code_profile=b.string(),
        )
        if version >= 2:
            p.snap_seq = b.u64()
            p.removed_snaps = b.list(lambda dd: dd.u64())
        if version >= 3:
            p.tier_of = b.s32()
            p.read_tier = b.s32()
            p.write_tier = b.s32()
            p.cache_mode = b.string()
            p.cache_target_dirty_max = b.u32()
        return p

    return d.struct(3, body)


def _enc_profile(e, prof: dict) -> None:
    e.mapping(
        {str(k): str(v) for k, v in prof.items()},
        lambda enc, k: enc.string(k),
        lambda enc, v: enc.string(v),
    )


def _dec_profile(d) -> dict:
    return d.mapping(lambda dd: dd.string(), lambda dd: dd.string())


@_dataclass
class Incremental:
    """One epoch's delta (OSDMap::Incremental, src/osd/OSDMap.h).

    `epoch` is the epoch the delta PRODUCES: apply_incremental refuses it
    unless the map is currently at epoch-1, which is what makes the mon's
    commit sequence gap-free."""

    epoch: int
    new_max_osd: int | None = None
    #: full crush replacement as canonical crushtool text (None = unchanged)
    new_crush_text: str | None = None
    new_up: list = _field(default_factory=list)
    new_down: list = _field(default_factory=list)
    #: osd -> 16.16 weight (0 = out); CEPH_OSD_IN = 0x10000
    new_weight: dict = _field(default_factory=dict)
    #: osd -> 16.16 primary affinity
    new_primary_affinity: dict = _field(default_factory=dict)
    new_pools: dict = _field(default_factory=dict)
    old_pools: list = _field(default_factory=list)
    new_erasure_code_profiles: dict = _field(default_factory=dict)
    old_erasure_code_profiles: list = _field(default_factory=list)
    new_pg_upmap: dict = _field(default_factory=dict)
    old_pg_upmap: list = _field(default_factory=list)
    new_pg_upmap_items: dict = _field(default_factory=dict)
    old_pg_upmap_items: list = _field(default_factory=list)
    #: pg -> acting override; empty list clears (OSDMap.cc new_pg_temp)
    new_pg_temp: dict = _field(default_factory=dict)
    #: pg -> primary; -1 clears
    new_primary_temp: dict = _field(default_factory=dict)
    #: osd -> (host, port) announced at boot
    new_osd_addrs: dict = _field(default_factory=dict)
    #: osd -> uds:// local endpoint announced at boot ("" clears)
    new_osd_local_addrs: dict = _field(default_factory=dict)
    #: pool -> new snap_seq (selfmanaged_snap_create commits)
    new_pool_snap_seq: dict = _field(default_factory=dict)
    #: pool -> snap ids to append to removed_snaps (snap deletion)
    new_removed_snaps: dict = _field(default_factory=dict)
    #: entity identity -> unix expiry (blocklist add)
    new_blocklist: dict = _field(default_factory=dict)
    #: entity identities to un-blocklist
    old_blocklist: list = _field(default_factory=list)
    #: osd -> confirmed up_thru epoch (OSDMonitor prepare_alive)
    new_up_thru: dict = _field(default_factory=dict)

    def encode(self) -> bytes:
        def body(b):
            b.u64(self.epoch)
            b.s32(-1 if self.new_max_osd is None else self.new_max_osd)
            b.boolean(self.new_crush_text is not None)
            if self.new_crush_text is not None:
                b.string(self.new_crush_text)
            b.list(sorted(self.new_up), lambda e, v: e.u32(v))
            b.list(sorted(self.new_down), lambda e, v: e.u32(v))
            b.mapping(self.new_weight, lambda e, k: e.u32(k),
                      lambda e, v: e.u64(v))
            b.mapping(self.new_primary_affinity, lambda e, k: e.u32(k),
                      lambda e, v: e.u64(v))
            b.mapping(self.new_pools, lambda e, k: e.u64(k), _enc_pool)
            b.list(sorted(self.old_pools), lambda e, v: e.u64(v))
            b.mapping(self.new_erasure_code_profiles,
                      lambda e, k: e.string(k), _enc_profile)
            b.list(sorted(self.old_erasure_code_profiles),
                   lambda e, v: e.string(v))
            b.mapping(self.new_pg_upmap, _enc_pg,
                      lambda e, v: e.list(v, lambda ee, o: ee.s32(o)))
            b.list(sorted(self.old_pg_upmap), _enc_pg)
            b.mapping(
                self.new_pg_upmap_items, _enc_pg,
                lambda e, v: e.list(
                    v, lambda ee, p: ee.s32(p[0]).s32(p[1])
                ),
            )
            b.list(sorted(self.old_pg_upmap_items), _enc_pg)
            b.mapping(self.new_pg_temp, _enc_pg,
                      lambda e, v: e.list(v, lambda ee, o: ee.s32(o)))
            b.mapping(self.new_primary_temp, _enc_pg,
                      lambda e, v: e.s32(v))
            b.mapping(self.new_osd_addrs, lambda e, k: e.u32(k),
                      lambda e, v: e.string(v[0]).u32(v[1]))
            b.mapping(self.new_pool_snap_seq, lambda e, k: e.u64(k),
                      lambda e, v: e.u64(v))
            b.mapping(
                self.new_removed_snaps, lambda e, k: e.u64(k),
                lambda e, v: e.list(sorted(v), lambda ee, s: ee.u64(s)),
            )
            b.mapping(self.new_blocklist, lambda e, k: e.string(k),
                      lambda e, v: e.f64(v))
            b.list(sorted(self.old_blocklist), lambda e, v: e.string(v))
            b.mapping(self.new_up_thru, lambda e, k: e.u32(k),
                      lambda e, v: e.u64(v))
            b.mapping(self.new_osd_local_addrs, lambda e, k: e.u32(k),
                      lambda e, v: e.string(v))

        return _Encoder().struct(5, 1, body).bytes()

    @staticmethod
    def decode(raw: bytes) -> "Incremental":
        def body(b, version):
            inc = Incremental(epoch=b.u64())
            nmo = b.s32()
            inc.new_max_osd = None if nmo < 0 else nmo
            if b.boolean():
                inc.new_crush_text = b.string()
            inc.new_up = b.list(lambda d: d.u32())
            inc.new_down = b.list(lambda d: d.u32())
            inc.new_weight = b.mapping(lambda d: d.u32(), lambda d: d.u64())
            inc.new_primary_affinity = b.mapping(
                lambda d: d.u32(), lambda d: d.u64()
            )
            inc.new_pools = b.mapping(lambda d: d.u64(), _dec_pool)
            inc.old_pools = b.list(lambda d: d.u64())
            inc.new_erasure_code_profiles = b.mapping(
                lambda d: d.string(), _dec_profile
            )
            inc.old_erasure_code_profiles = b.list(lambda d: d.string())
            inc.new_pg_upmap = b.mapping(
                _dec_pg, lambda d: d.list(lambda dd: dd.s32())
            )
            inc.old_pg_upmap = b.list(_dec_pg)
            inc.new_pg_upmap_items = b.mapping(
                _dec_pg,
                lambda d: d.list(lambda dd: (dd.s32(), dd.s32())),
            )
            inc.old_pg_upmap_items = b.list(_dec_pg)
            inc.new_pg_temp = b.mapping(
                _dec_pg, lambda d: d.list(lambda dd: dd.s32())
            )
            inc.new_primary_temp = b.mapping(_dec_pg, lambda d: d.s32())
            inc.new_osd_addrs = b.mapping(
                lambda d: d.u32(), lambda d: (d.string(), d.u32())
            )
            if version >= 2:
                inc.new_pool_snap_seq = b.mapping(
                    lambda d: d.u64(), lambda d: d.u64()
                )
                inc.new_removed_snaps = b.mapping(
                    lambda d: d.u64(),
                    lambda d: d.list(lambda dd: dd.u64()),
                )
            if version >= 3:
                inc.new_blocklist = b.mapping(
                    lambda d: d.string(), lambda d: d.f64()
                )
                inc.old_blocklist = b.list(lambda d: d.string())
            if version >= 4:
                inc.new_up_thru = b.mapping(
                    lambda d: d.u32(), lambda d: d.u64()
                )
            if version >= 5:
                inc.new_osd_local_addrs = b.mapping(
                    lambda d: d.u32(), lambda d: d.string()
                )
            return inc

        return _Decoder(raw).struct(5, body)


def apply_incremental(self, inc: Incremental) -> None:
    """OSDMap::apply_incremental (OSDMap.cc): strict epoch+1 sequencing."""
    if inc.epoch != self.epoch + 1:
        raise ValueError(
            f"incremental for epoch {inc.epoch} cannot apply to map at "
            f"epoch {self.epoch}"
        )
    if inc.new_max_osd is not None and inc.new_max_osd != self.max_osd:
        n = inc.new_max_osd

        def grow(arr, fill, dtype):
            out = np.full(n, fill, dtype=dtype)
            out[: min(len(arr), n)] = arr[: min(len(arr), n)]
            return out

        self.osd_exists = grow(self.osd_exists, True, bool)
        self.osd_up = grow(self.osd_up, True, bool)
        self.osd_weight = grow(self.osd_weight, 0x10000, np.int64)
        self.osd_up_thru = grow(self.osd_up_thru, 0, np.int64)
        if self.osd_primary_affinity is not None:
            self.osd_primary_affinity = grow(
                self.osd_primary_affinity, DEFAULT_PRIMARY_AFFINITY, np.int64
            )
        self.max_osd = n
    if inc.new_crush_text is not None:
        from ceph_tpu_torch.crush.compiler import compile_crushmap

        self.crush = compile_crushmap(inc.new_crush_text)
        self.invalidate_compiled()
    for osd in inc.new_up:
        self.osd_up[osd] = True
    for osd in inc.new_down:
        self.osd_up[osd] = False
    for osd, w in inc.new_weight.items():
        self.osd_weight[osd] = w
    if inc.new_primary_affinity:
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = np.full(
                self.max_osd, DEFAULT_PRIMARY_AFFINITY, dtype=np.int64
            )
        for osd, a in inc.new_primary_affinity.items():
            self.osd_primary_affinity[osd] = a
    for pid, pool in inc.new_pools.items():
        self.pools[pid] = pool
    for pid in inc.old_pools:
        self.pools.pop(pid, None)
    for name, prof in inc.new_erasure_code_profiles.items():
        self.erasure_code_profiles[name] = dict(prof)
    for name in inc.old_erasure_code_profiles:
        self.erasure_code_profiles.pop(name, None)
    self.pg_upmap.update(inc.new_pg_upmap)
    for pg in inc.old_pg_upmap:
        self.pg_upmap.pop(pg, None)
    self.pg_upmap_items.update(inc.new_pg_upmap_items)
    for pg in inc.old_pg_upmap_items:
        self.pg_upmap_items.pop(pg, None)
    for pg, acting in inc.new_pg_temp.items():
        if acting:
            self.pg_temp[pg] = list(acting)
        else:
            self.pg_temp.pop(pg, None)
    for pg, primary in inc.new_primary_temp.items():
        if primary >= 0:
            self.primary_temp[pg] = primary
        else:
            self.primary_temp.pop(pg, None)
    for osd, addr in inc.new_osd_addrs.items():
        self.osd_addrs[osd] = tuple(addr)
    for osd, la in inc.new_osd_local_addrs.items():
        if la:
            self.osd_local_addrs[osd] = la
        else:
            self.osd_local_addrs.pop(osd, None)
    for pid, seq in inc.new_pool_snap_seq.items():
        if pid in self.pools:
            self.pools[pid].snap_seq = max(self.pools[pid].snap_seq, seq)
    for pid, snaps in inc.new_removed_snaps.items():
        if pid in self.pools:
            cur = set(self.pools[pid].removed_snaps)
            cur.update(snaps)
            self.pools[pid].removed_snaps = sorted(cur)
    self.blocklist.update(inc.new_blocklist)
    for entity in inc.old_blocklist:
        self.blocklist.pop(entity, None)
    for osd, e in inc.new_up_thru.items():
        if 0 <= osd < self.max_osd:
            self.osd_up_thru[osd] = max(
                int(self.osd_up_thru[osd]), int(e)
            )
    self.epoch = inc.epoch


def encode_osdmap(self) -> bytes:
    """Full map for newcomers (OSDMap::encode)."""
    from ceph_tpu_torch.crush.compiler import decompile_crushmap

    crush_text = decompile_crushmap(self.crush)

    def body(b):
        b.u64(self.epoch)
        b.u32(self.max_osd)
        b.string(crush_text)
        b.blob(np.asarray(self.osd_exists, np.uint8).tobytes())
        b.blob(np.asarray(self.osd_up, np.uint8).tobytes())
        b.list(
            [int(w) for w in self.osd_weight], lambda e, v: e.u64(v)
        )
        b.boolean(self.osd_primary_affinity is not None)
        if self.osd_primary_affinity is not None:
            b.list(
                [int(a) for a in self.osd_primary_affinity],
                lambda e, v: e.u64(v),
            )
        b.mapping(self.pools, lambda e, k: e.u64(k), _enc_pool)
        b.mapping(self.erasure_code_profiles, lambda e, k: e.string(k),
                  _enc_profile)
        b.mapping(self.pg_upmap, _enc_pg,
                  lambda e, v: e.list(v, lambda ee, o: ee.s32(o)))
        b.mapping(
            self.pg_upmap_items, _enc_pg,
            lambda e, v: e.list(v, lambda ee, p: ee.s32(p[0]).s32(p[1])),
        )
        b.mapping(self.pg_temp, _enc_pg,
                  lambda e, v: e.list(v, lambda ee, o: ee.s32(o)))
        b.mapping(self.primary_temp, _enc_pg, lambda e, v: e.s32(v))
        b.mapping(self.osd_addrs, lambda e, k: e.u32(k),
                  lambda e, v: e.string(v[0]).u32(v[1]))
        b.mapping(self.blocklist, lambda e, k: e.string(k),
                  lambda e, v: e.f64(v))
        b.list(
            [int(v) for v in self.osd_up_thru], lambda e, v: e.u64(v)
        )
        b.mapping(self.osd_local_addrs, lambda e, k: e.u32(k),
                  lambda e, v: e.string(v))

    return _Encoder().struct(4, 1, body).bytes()


def decode_osdmap(raw: bytes, device=None) -> "OSDMap":
    """A map from `encode_osdmap`'s bytes; `device` is where its batched
    mapper will run (not part of the encoding)."""
    from ceph_tpu_torch.crush.compiler import compile_crushmap

    def body(b, version):
        epoch = b.u64()
        max_osd = b.u32()
        crush = compile_crushmap(b.string())
        exists = np.frombuffer(b.blob(), np.uint8).astype(bool)
        up = np.frombuffer(b.blob(), np.uint8).astype(bool)
        weight = np.array(b.list(lambda d: d.u64()), dtype=np.int64)
        paff = None
        if b.boolean():
            paff = np.array(b.list(lambda d: d.u64()), dtype=np.int64)
        m = OSDMap(
            crush=crush,
            max_osd=max_osd,
            epoch=epoch,
            osd_exists=exists,
            osd_up=up,
            osd_weight=weight,
            osd_primary_affinity=paff,
            device=device,
        )
        m.pools = b.mapping(lambda d: d.u64(), _dec_pool)
        m.erasure_code_profiles = b.mapping(
            lambda d: d.string(), _dec_profile
        )
        m.pg_upmap = b.mapping(
            _dec_pg, lambda d: d.list(lambda dd: dd.s32())
        )
        m.pg_upmap_items = b.mapping(
            _dec_pg, lambda d: d.list(lambda dd: (dd.s32(), dd.s32()))
        )
        m.pg_temp = b.mapping(
            _dec_pg, lambda d: d.list(lambda dd: dd.s32())
        )
        m.primary_temp = b.mapping(_dec_pg, lambda d: d.s32())
        m.osd_addrs = b.mapping(
            lambda d: d.u32(), lambda d: (d.string(), d.u32())
        )
        if version >= 2:
            m.blocklist = b.mapping(
                lambda d: d.string(), lambda d: d.f64()
            )
        if version >= 3:
            m.osd_up_thru = np.array(
                b.list(lambda d: d.u64()), dtype=np.int64
            )
            if len(m.osd_up_thru) != m.max_osd:
                m.osd_up_thru = np.zeros(m.max_osd, dtype=np.int64)
        if version >= 4:
            m.osd_local_addrs = b.mapping(
                lambda d: d.u32(), lambda d: d.string()
            )
        return m

    return _Decoder(raw).struct(4, body)


# bound here so the dataclass body above stays focused on placement; these
# names are the public API (map.apply_incremental(inc), map.encode(),
# OSDMap.decode(raw))
OSDMap.apply_incremental = apply_incremental
OSDMap.encode = encode_osdmap
OSDMap.decode = staticmethod(decode_osdmap)
