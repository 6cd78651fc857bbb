"""BalancerModule: upmap + crush-compat balancing over a live cluster.

The loop the reference's balancer module runs (pybind/mgr/balancer):

  1. fetch the latest committed OSDMap from the mon (MgrStandby's map
     subscription);
  2. optimize: OSDMap.calc_pg_upmaps on a local copy — the batched move
     scorer (crush/balance.py) evaluates every candidate
     (pg, from, to) move per device launch, so max_changes is a real
     per-tick budget instead of a wall of 10;
  3. execute: commit the new pg_upmap_items via mon commands
     (`ceph osd pg-upmap-items` per PG; module.py:execute), after which the
     next map epoch re-routes the moved PGs and primaries re-peer.

`run_once(mode="crush-compat")` is the reference's other mode
(module.py do_crush_compat, :63-78): instead of per-PG upmap exceptions
it writes a compat WEIGHT-SET (choose_args) that nudges each device's
straw2 draw weight until observed PG counts track crush-weight targets —
older clients that know nothing of upmaps still map identically. Each
candidate weight-set rides into the compiled batched mapper as RUNTIME
inputs (torch_mapper.runtime_weight_arrays, one (positions, slots) tensor
read by the choose kernel): one batched run per pool per iteration, zero
recompiles across iterations — the map is compiled once and only the
weight tensor changes.

Defaults for deviation/changes/mode come from the `balancer_*` config
knobs when a Config is wired in (the mgr daemon passes its own);
explicit arguments always win. The module keeps a `balancer` perf block
(moves, launches, score latency, spread before/after) that the mgr's
prometheus exporter scrapes, and tags its `mgr_balancer_tick` span with
launches + spread so traces show what a tick actually did.

Port of ceph_tpu/mgr/balancer.py. `device` (None = cuda) is where the
module's scratch maps compile and score: `OSDMap.decode(raw, device=...)`.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.common.perf_counters import PerfCounters
from ceph_tpu_torch.crush.types import ChooseArg
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, OSDMap


def _make_perf() -> PerfCounters:
    p = PerfCounters("balancer")
    p.add_u64_counter("moves", "pg_upmap_items entries committed")
    p.add_u64_counter(
        "launches",
        "device launches spent (pool maps + move-scoring chunks)",
    )
    p.add_u64_counter("ticks", "balancer passes run")
    p.add_time_avg(
        "score_lat", "host-visible seconds inside batched move scoring"
    )
    p.add_u64(
        "spread_before",
        "max |PG-count deviation| entering the last pass (rounded)",
    )
    p.add_u64(
        "spread_after",
        "max |PG-count deviation| leaving the last pass (rounded)",
    )
    return p


class BalancerModule:
    def __init__(self, mon_client, tracer=None, config=None, device=None):
        self.mon = mon_client
        #: where scratch maps run the batched mapper and the move scorer
        self.device = device
        #: optional common.tracer.Tracer: each run_once becomes a root
        #: `mgr_balancer_tick` span (sampled by tracer_sample_rate_
        #: balancer) whose mon command hops nest beneath it
        self.tracer = tracer
        #: optional common.config.Config supplying balancer_* defaults
        self.config = config
        self.perf = _make_perf()

    def _default(self, name: str, fallback):
        if self.config is not None:
            return self.config.get(name)
        return fallback

    async def run_once(
        self,
        pools: set[int] | None = None,
        max_deviation: float | None = None,
        max_changes: int | None = None,
        mode: str | None = None,
    ) -> dict:
        """One balancer pass; returns {changes, mappings} as committed."""
        if max_deviation is None:
            max_deviation = self._default("balancer_max_deviation", 1.0)
        if max_changes is None:
            max_changes = self._default("balancer_max_changes", 10)
        if mode is None:
            mode = self._default("balancer_mode", "upmap")
        span = token = None
        if self.tracer is not None:
            span = self.tracer.start(
                "mgr_balancer_tick", tags={"mode": mode},
                op_type="balancer",
            )
            token = self.tracer.use(span) if span is not None else None
        try:
            result = await self._run_once_inner(
                pools, max_deviation, max_changes, mode
            )
            self.perf.inc("ticks")
            self.perf.inc("moves", result.get("changes", 0))
            self.perf.inc("launches", result.get("launches", 0))
            if "score_seconds" in result:
                self.perf.tinc("score_lat", result["score_seconds"])
            if "spread_before" in result:
                self.perf.set(
                    "spread_before", int(round(result["spread_before"]))
                )
                self.perf.set(
                    "spread_after",
                    int(round(result.get("spread_after", 0.0))),
                )
            if span is not None:
                span.set_tag("changes", result.get("changes", 0))
                span.set_tag("launches", result.get("launches", 0))
                if "spread_before" in result:
                    span.set_tag(
                        "spread_before", result["spread_before"]
                    )
                    span.set_tag(
                        "spread_after", result.get("spread_after")
                    )
            return result
        finally:
            if span is not None:
                self.tracer.release(token)
                span.finish()

    async def _run_once_inner(
        self, pools, max_deviation, max_changes, mode
    ) -> dict:
        if mode == "crush-compat":
            return await self.crush_compat(pools=pools)
        osdmap = await self.mon.wait_for_map()
        # optimize on a scratch copy: the real map only changes when the
        # mon commits (balancer module works on an OSDMap::Incremental)
        scratch = OSDMap.decode(osdmap.encode(), device=self.device)
        before = dict(scratch.pg_upmap_items)
        changes = scratch.calc_pg_upmaps(
            max_deviation=max_deviation,
            max_changes=max_changes,
            pools=pools,
        )
        bal = scratch.last_balance
        stats = {}
        if bal is not None:
            stats = {
                "launches": bal.launches,
                "spread_before": bal.spread_before,
                "spread_after": bal.spread_after,
                "score_seconds": bal.score_seconds,
            }
        if not changes:
            return {"changes": 0, "mappings": {}, **stats}
        mappings: dict[str, list] = {}
        for pg, items in scratch.pg_upmap_items.items():
            if before.get(pg) != items:
                mappings[f"{pg[0]}.{pg[1]}"] = [list(p) for p in items]
        for pg in before:
            if pg not in scratch.pg_upmap_items:
                mappings[f"{pg[0]}.{pg[1]}"] = []
        result = await self.mon.command(
            "osd pg-upmap-items", {"mappings": mappings}
        )
        return {"changes": changes, "mappings": mappings, **stats, **result}

    async def crush_compat(
        self,
        pools: set[int] | None = None,
        max_iterations: int = 8,
        step: float = 0.5,
    ) -> dict:
        """One crush-compat pass: iterate multiplicative weight-set
        adjustments (w *= (target/actual)^step, the reference's
        do_crush_compat feedback loop), keep the best iterate by PG-count
        spread, and commit the choose_args through `osd crush set` (the
        whole-map commit path every client re-reads).

        The map is compiled ONCE; every candidate weight-set is threaded
        into the compiled mapper as a runtime device tensor, so evaluating
        an iterate costs one batched run per pool and never recompiles.
        """
        from ceph_tpu_torch.crush import torch_mapper
        from ceph_tpu_torch.crush.compiler import decompile_crushmap

        osdmap = await self.mon.wait_for_map()
        scratch = OSDMap.decode(osdmap.encode(), device=self.device)
        cmap = scratch.crush
        target_pools = sorted(pools if pools else scratch.pools)
        if not target_pools:
            return {"changes": 0}

        # crush-weight targets: device weights from the hierarchy
        dev_weight = np.zeros(scratch.max_osd, dtype=np.float64)
        for b in cmap.buckets.values():
            for j, item in enumerate(b.items):
                if 0 <= item < scratch.max_osd:
                    w = (
                        b.item_weights[j]
                        if b.item_weights else b.item_weight
                    )
                    dev_weight[item] += w
        if dev_weight.sum() == 0:
            return {"changes": 0}

        # start from the existing compat weight-set (or item weights)
        from ceph_tpu_torch.crush.types import BucketAlg

        amap: dict[int, ChooseArg] = {}
        for bid, b in cmap.buckets.items():
            # weight-sets drive straw2 draws only (bucket_straw2_choose
            # is the lone consumer of choose_args in both mappers);
            # EVERY straw2 bucket participates — inner buckets too, or
            # cross-host imbalance would be unreachable (the host draw
            # happens at the root's weights)
            if b.alg != BucketAlg.STRAW2 or not b.items:
                continue
            existing = cmap.choose_args.get(bid)
            if existing is not None and existing.weight_set:
                rows = [list(r) for r in existing.weight_set]
            else:
                rows = [[
                    b.item_weights[j] if b.item_weights
                    else b.item_weight
                    for j in range(len(b.items))
                ]]
            # ids (if any) are preserved: the compiled mapper baked them
            # and only weights ride as runtime inputs
            amap[bid] = ChooseArg(
                ids=(list(existing.ids)
                     if existing is not None and existing.ids else None),
                weight_set=rows,
            )

        def subtree_devices(item: int) -> list[int]:
            if item >= 0:
                return [item] if item < scratch.max_osd else []
            out: list[int] = []
            b = cmap.buckets.get(item)
            if b is not None:
                for child in b.items:
                    out.extend(subtree_devices(child))
            return out

        def install(a: dict[int, ChooseArg]) -> None:
            # choose_args stay in sync with the runtime overlay: the
            # sparse scalar re-runs inside pool_mappings read the map
            cmap.choose_args = a
            cmap.choose_args_maps = {-1: a} if a else {}

        # compiled once — candidate weight-sets ride in as traced inputs
        compiled = scratch._compile()
        launches = 0

        def pg_counts() -> np.ndarray:
            nonlocal launches
            rt = torch_mapper.runtime_weight_arrays(
                compiled,
                {bid: a.weight_set for bid, a in cmap.choose_args.items()},
            )
            c = np.zeros(scratch.max_osd, dtype=np.int64)
            for pid in target_pools:
                pool = scratch.pools[pid]
                rows = scratch.pool_mappings(pid, runtime_weights=rt)
                launches += 1
                flat = rows[rows != CRUSH_ITEM_NONE]
                c += np.bincount(
                    flat, minlength=scratch.max_osd
                )[: scratch.max_osd]
                # acting differs from up only where pg_temp overrides
                # placement mid-recovery: patch those few rows sparsely
                for (tp, tps) in scratch.pg_temp:
                    if tp != pid or tps >= pool.pg_num:
                        continue
                    row = rows[tps]
                    for o in row[row != CRUSH_ITEM_NONE]:
                        c[o] -= 1
                    for o in scratch.pg_to_up_acting_osds(pid, tps)[2]:
                        if 0 <= o < scratch.max_osd:
                            c[o] += 1
            return c

        def spread(c: np.ndarray) -> float:
            share = dev_weight / dev_weight.sum()
            expect = c.sum() * share
            mask = dev_weight > 0
            return float(np.abs(c - expect)[mask].max())

        install(amap)
        counts = pg_counts()
        best = {bid: ChooseArg(
            weight_set=[list(r) for r in a.weight_set]
        ) for bid, a in amap.items()}
        best_spread = spread(counts)
        start_spread = best_spread
        for _ in range(max_iterations):
            share = dev_weight / dev_weight.sum()
            expect = counts.sum() * share
            factor = np.ones(scratch.max_osd)
            mask = (dev_weight > 0) & (counts > 0)
            factor[mask] = (expect[mask] / counts[mask]) ** step
            factor = np.clip(factor, 0.5, 2.0)

            def item_factor(item: int) -> float:
                # a bucket child's adjustment is its subtree's
                # weight-averaged device factor (the hierarchy-wide
                # sweep do_crush_compat performs)
                devs = subtree_devices(item)
                wsum = sum(dev_weight[d] for d in devs)
                if not devs or wsum == 0:
                    return 1.0
                return float(
                    sum(factor[d] * dev_weight[d] for d in devs)
                    / wsum
                )

            for bid, arg in amap.items():
                items = cmap.buckets[bid].items
                for row in arg.weight_set:
                    for j, item in enumerate(items):
                        row[j] = max(
                            1, int(row[j] * item_factor(item))
                        )
            install(amap)
            counts = pg_counts()
            s = spread(counts)
            if s < best_spread:
                best_spread = s
                best = {bid: ChooseArg(
                    weight_set=[list(r) for r in a.weight_set]
                ) for bid, a in amap.items()}
        if best_spread >= start_spread:
            return {
                "changes": 0, "spread": start_spread,
                "launches": launches,
            }
        install(best)
        await self.mon.command(
            "osd crush set",
            {"crush_text": decompile_crushmap(cmap)},
        )
        return {
            "changes": len(best),
            "spread_before": start_spread,
            "spread_after": best_spread,
            "launches": launches,
        }
