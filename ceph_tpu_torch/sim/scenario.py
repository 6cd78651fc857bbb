"""Deterministic event scripts + balancer convergence over synthetic maps.

run_scenario drives a build_cluster map through seeded churn epochs —
each epoch flaps OSDs out/in and reweights a few survivors, then remaps
every pool with the batched mapper and diffs placements against the
previous epoch: PGs whose up set changed are the backfill a real cluster
would schedule, and moved-PGs x bytes-per-PG is the storm estimate the
operator cares about. After the churn the batched balancer
(crush/balance.calc_pg_upmaps) runs and the report records convergence:
spread before/after, moves committed, rounds/launches spent.

Determinism contract: everything derives from numpy's seeded Generator
and the map's own placement function — the SAME seed and parameters
produce a byte-identical report. Wall-clock numbers (mapping rate,
balance time) exist only under measure=True and live in a separate
"timing" key so deterministic consumers can compare reports wholesale.

Port of ceph_tpu/sim/scenario.py; `device` (None = cuda) is the map's.
"""

from __future__ import annotations

import time

import numpy as np

from ceph_tpu_torch.crush import balance
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, OSDMap
from ceph_tpu_torch.sim.cluster import build_cluster


def _map_pools(osdmap: OSDMap) -> dict[int, np.ndarray]:
    return {
        pid: np.asarray(osdmap.pool_mappings(pid))
        for pid in sorted(osdmap.pools)
    }


def _spread(osdmap: OSDMap, rows: dict[int, np.ndarray]) -> float:
    """Max |PG-count deviation| from the weight-share target (the
    balancer's convergence metric, over the in+up devices)."""
    n = osdmap.max_osd
    weights = np.asarray(
        osdmap.osd_weight * (osdmap.osd_exists & osdmap.osd_up),
        dtype=np.int64,
    )
    wtotal = int(weights.sum())
    counts = np.zeros(n, dtype=np.int64)
    total = 0
    for pid, r in rows.items():
        pool = osdmap.pools[pid]
        total += pool.pg_num * pool.size
        flat = r[r != CRUSH_ITEM_NONE]
        counts += np.bincount(flat, minlength=n)[:n]
    if wtotal == 0 or total == 0:
        return 0.0
    target = weights.astype(np.float64) * (total / wtotal)
    mask = (weights > 0) | (counts > 0)
    return float(np.abs((counts - target)[mask]).max()) if mask.any() else 0.0


def run_scenario(
    n_osd: int = 64,
    osds_per_host: int = 8,
    hosts_per_rack: int = 4,
    rep_pg_num: int = 256,
    ec_pg_num: int = 128,
    seed: int = 1,
    epochs: int = 3,
    flap_fraction: float = 0.02,
    reweight_fraction: float = 0.02,
    bytes_per_pg: int = 8 << 30,
    balance_after: bool = True,
    max_deviation: float = 1.0,
    max_changes: int = 512,
    measure: bool = False,
    device=None,
) -> dict:
    """One full simulator run; returns the (deterministic) report dict.
    Pool mappings and move scoring run on `device` (None = cuda)."""
    t_start = time.perf_counter() if measure else 0.0
    rng = np.random.default_rng(seed)
    osdmap = build_cluster(
        n_osd, osds_per_host=osds_per_host, hosts_per_rack=hosts_per_rack,
        rep_pg_num=rep_pg_num, ec_pg_num=ec_pg_num, device=device,
    )
    report: dict = {
        "seed": int(seed),
        "osds": int(n_osd),
        "hosts": sum(
            1 for b in osdmap.crush.buckets.values() if b.type == 1
        ),
        "racks": sum(
            1 for b in osdmap.crush.buckets.values() if b.type == 3
        ),
        "pools": {
            str(pid): {
                "type": "erasure" if p.is_erasure() else "replicated",
                "pg_num": p.pg_num,
                "size": p.size,
            }
            for pid, p in sorted(osdmap.pools.items())
        },
        "pg_instances": sum(
            p.pg_num * p.size for p in osdmap.pools.values()
        ),
        "epochs": [],
    }

    t_map0 = time.perf_counter() if measure else 0.0
    rows = _map_pools(osdmap)
    map_seconds = (time.perf_counter() - t_map0) if measure else 0.0
    pgs_mapped = sum(r.shape[0] for r in rows.values())
    out: set[int] = set()

    for e in range(epochs):
        events: list[list] = []
        # flap out: healthy OSDs lose their in-weight this epoch
        alive = [o for o in range(n_osd) if o not in out]
        n_flap = max(1, int(n_osd * flap_fraction)) if alive else 0
        for o in rng.choice(
            alive, size=min(n_flap, len(alive)), replace=False
        ):
            o = int(o)
            osdmap.osd_weight[o] = 0
            out.add(o)
            events.append(["out", o])
        # flap back in: previously-out OSDs return at full weight
        returners = [o for o in sorted(out) if rng.random() < 0.5]
        for o in returners:
            osdmap.osd_weight[o] = 0x10000
            out.discard(o)
            events.append(["in", o])
        # reweight: a few survivors drop to a random fraction
        alive = [o for o in range(n_osd) if o not in out]
        n_rw = max(1, int(n_osd * reweight_fraction)) if alive else 0
        for o in rng.choice(
            alive, size=min(n_rw, len(alive)), replace=False
        ):
            o = int(o)
            frac = 0.5 + 0.5 * float(rng.random())
            osdmap.osd_weight[o] = int(frac * 0x10000)
            events.append(["reweight", o, round(frac, 4)])
        osdmap.epoch += 1

        t0 = time.perf_counter() if measure else 0.0
        new_rows = _map_pools(osdmap)
        if measure:
            map_seconds += time.perf_counter() - t0
        pgs_mapped += sum(r.shape[0] for r in new_rows.values())
        moved = sum(
            int((new_rows[pid] != rows[pid]).any(axis=1).sum())
            for pid in rows
        )
        rows = new_rows
        report["epochs"].append({
            "epoch": e + 1,
            "events": events,
            "pgs_moved": moved,
            "bytes_moved": moved * int(bytes_per_pg),
        })

    if balance_after:
        t0 = time.perf_counter() if measure else 0.0
        changes = osdmap.calc_pg_upmaps(
            max_deviation=max_deviation, max_changes=max_changes
        )
        balance_seconds = (time.perf_counter() - t0) if measure else 0.0
        r = osdmap.last_balance
        rows = _map_pools(osdmap)
        report["balance"] = {
            "changes": int(changes),
            "rounds": int(r.rounds),
            "launches": int(r.launches),
            "spread_before": float(r.spread_before),
            "spread_after": float(r.spread_after),
            "converged": bool(r.spread_after <= max_deviation),
            "upmap_entries": len(osdmap.pg_upmap_items),
        }
        if measure:
            report.setdefault("timing", {})[
                "balance_seconds"
            ] = balance_seconds
            report["timing"]["score_seconds"] = float(r.score_seconds)
    report["final_spread"] = _spread(osdmap, rows)

    if measure:
        timing = report.setdefault("timing", {})
        timing["map_seconds"] = map_seconds
        timing["pgs_mapped"] = int(pgs_mapped)
        timing["pgs_mapped_per_s"] = (
            pgs_mapped / map_seconds if map_seconds > 0 else 0.0
        )
        timing["total_seconds"] = time.perf_counter() - t_start
    return report
