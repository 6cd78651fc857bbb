"""Deterministic chaos scenarios — one seeded script, two executors.

`chaos_script` compiles a seed into a fixed timeline of chaos events:
OSD flaps, an asymmetric (one-way) partition, a kill -9 of a backfill
source mid-push, and probabilistic wire-fault storms.  Every event
carries the `ms_inject_chaos_schedule` string that arms it on a live
fleet, so the SAME script drives both executors:

* `ceph_tpu_torch.tools.chaos_tool` runs it against a live cluster — real
  daemons, real TCP, a consistency oracle asserting zero acked-data
  loss, convergence to clean, and bounded client p99;
* `run_chaos` (this module) replays it daemon-free over a
  `build_cluster` map and reports the placement-level damage — degraded
  PGs/objects per step, placement moves, the recovery debt an amnesiac
  kill creates — plus the exact wire-fault decision stream every armed
  (src, dst) pair would draw from `common/faults.py`.

Determinism contract (same as scenario.run_scenario): everything
derives from `random.Random(seed)` and the map's placement function, so
one seed produces a byte-identical script and report.  Wall-clock
numbers exist only under measure=True in a separate "timing" key.

Copy of ceph_tpu/sim/chaos.py; `run_chaos` takes the map's `device` (None =
cuda), where `_map_pools` runs the batched CRUSH mapper.
"""

from __future__ import annotations

import random
import time

from ceph_tpu_torch.common.faults import WireFaults
from ceph_tpu_torch.sim.cluster import build_cluster
from ceph_tpu_torch.sim.scenario import _map_pools

#: frames each armed (src, dst) pair is judged per step in run_chaos —
#: enough draws that probabilistic rules show up in the histogram
FRAMES_PER_PAIR = 16

#: redundancy floor the script promises never to exceed concurrently
#: (rep size 3 and EC m=2 both absorb two simultaneous losses)
MAX_CONCURRENT_DOWN = 2


def chaos_script(seed: int, n_osd: int = 6, steps: int = 8) -> dict:
    """Compile `seed` into a deterministic chaos timeline.

    The first three events always cover the crash matrix — a flap, a
    one-way partition, and a kill -9 of a backfill source — in a
    seed-shuffled order; remaining steps draw from the full menu.
    `fallback_osd` on the kill event is the victim when the live
    executor finds no backfill in flight at that moment.
    """
    rng = random.Random(int(seed))
    osds = list(range(n_osd))
    steps = max(3, int(steps))
    kinds = ["flap", "partition_oneway", "kill_backfill_source"]
    rng.shuffle(kinds)
    menu = ["flap", "partition_sym", "storm_drop", "storm_delay",
            "storm_dup"]
    while len(kinds) < steps:
        kinds.append(rng.choice(menu))

    events: list[dict] = []
    down_until: dict[int, int] = {}  # osd -> first step it is back
    for step, kind in enumerate(kinds):
        alive = [o for o in osds if down_until.get(o, 0) <= step]
        n_down = sum(1 for s in down_until.values() if s > step)
        if kind == "flap":
            if n_down >= MAX_CONCURRENT_DOWN or not alive:
                continue  # redundancy floor: skip this flap
            osd = rng.choice(alive)
            d = rng.randint(1, 2)
            down_until[osd] = step + 1 + d
            events.append({
                "step": step, "kind": "flap", "osd": osd,
                "down_steps": d,
            })
        elif kind == "kill_backfill_source":
            if n_down >= MAX_CONCURRENT_DOWN or not alive:
                continue
            osd = rng.choice(alive)
            d = rng.randint(1, 2)
            down_until[osd] = step + 1 + d
            events.append({
                "step": step, "kind": "kill_backfill_source",
                "fallback_osd": osd, "down_steps": d,
            })
        elif kind in ("partition_oneway", "partition_sym"):
            if len(alive) < 2:
                continue
            a, b = rng.sample(alive, 2)
            hold = rng.randint(1, 2)
            if kind == "partition_oneway":
                sched = f"partition:osd.{a}>osd.{b}"
            else:
                sched = f"partition:osd.{a}|osd.{b}"
            events.append({
                "step": step, "kind": kind, "src": a, "dst": b,
                "hold_steps": hold, "schedule": sched,
            })
        else:  # storm_drop / storm_delay / storm_dup
            target = rng.choice(osds)
            prob = round(rng.uniform(0.05, 0.25), 3)
            hold = rng.randint(1, 2)
            fault = kind.split("_", 1)[1]
            sched = f"{fault}:osd.*>osd.{target}:{prob}"
            events.append({
                "step": step, "kind": kind, "target": target,
                "prob": prob, "hold_steps": hold, "schedule": sched,
            })
    return {
        "seed": int(seed), "n_osd": int(n_osd), "steps": steps,
        "events": events,
    }


def _pairs_for(event: dict, n_osd: int) -> list[tuple[str, str]]:
    """Concrete (src, dst) messenger-name pairs an armed event covers."""
    if event["kind"] == "partition_oneway":
        return [(f"osd.{event['src']}", f"osd.{event['dst']}")]
    if event["kind"] == "partition_sym":
        return [
            (f"osd.{event['src']}", f"osd.{event['dst']}"),
            (f"osd.{event['dst']}", f"osd.{event['src']}"),
        ]
    t = event["target"]
    return [
        (f"osd.{i}", f"osd.{t}") for i in range(n_osd) if i != t
    ]


def run_chaos(
    seed: int = 1,
    n_osd: int = 16,
    osds_per_host: int = 4,
    rep_pg_num: int = 32,
    ec_pg_num: int = 16,
    steps: int = 8,
    objects_per_pg: int = 64,
    measure: bool = False,
    device=None,
) -> dict:
    """Daemon-free replay of `chaos_script(seed)`: placement damage plus
    wire-fault decision histograms, byte-identical per seed. The pools are
    mapped on `device` (None = cuda, which raises without a card)."""
    t0 = time.perf_counter() if measure else 0.0
    script = chaos_script(seed, n_osd=n_osd, steps=steps)
    osdmap = build_cluster(
        n_osd, osds_per_host=osds_per_host,
        rep_pg_num=rep_pg_num, ec_pg_num=ec_pg_num, device=device,
    )
    rows = _map_pools(osdmap)
    by_step: dict[int, list[dict]] = {}
    for e in script["events"]:
        by_step.setdefault(e["step"], []).append(e)

    report: dict = {
        "seed": int(seed), "osds": int(n_osd),
        "script_events": len(script["events"]),
        "steps": [],
    }
    down_until: dict[int, int] = {}     # osd -> step it revives
    amnesiac: set[int] = set()          # kill -9 victims (store lost)
    armed: list[tuple[dict, int, WireFaults]] = []  # (event, until, wf)
    max_down = 0

    for step in range(script["steps"] + 3):  # +3 drains the tail
        # revivals due this step (amnesiac victims return empty:
        # their whole placement share is recovery debt)
        recovery_debt = 0
        for osd, until in sorted(down_until.items()):
            if until == step:
                osdmap.osd_weight[osd] = 0x10000
                if osd in amnesiac:
                    amnesiac.discard(osd)
                    owned = sum(
                        int((r == osd).any(axis=1).sum())
                        for r in rows.values()
                    )
                    recovery_debt = owned * objects_per_pg
        down_until = {o: u for o, u in down_until.items() if u > step}
        armed = [(e, u, wf) for e, u, wf in armed if u > step]

        entry: dict = {"step": step, "events": []}
        degraded_pgs = 0
        for e in by_step.get(step, ()):  # arm this step's events
            entry["events"].append(e)
            if e["kind"] in ("flap", "kill_backfill_source"):
                osd = e.get("osd", e.get("fallback_osd"))
                degraded_pgs += sum(
                    int((r == osd).any(axis=1).sum())
                    for r in rows.values()
                )
                osdmap.osd_weight[osd] = 0
                down_until[osd] = step + 1 + e["down_steps"]
                if e["kind"] == "kill_backfill_source":
                    amnesiac.add(osd)
            else:
                armed.append((
                    e, step + e["hold_steps"],
                    WireFaults(e["schedule"], seed=script["seed"]),
                ))
        max_down = max(max_down, len(down_until))

        # every armed schedule judges FRAMES_PER_PAIR frames per
        # concrete pair this step — the deterministic decision stream a
        # live fleet would draw
        wire = {"drop": 0, "delay": 0, "dup": 0, "none": 0}
        for e, _until, wf in armed:
            for src, dst in _pairs_for(e, n_osd):
                pf = wf.pair(src, dst)
                for _ in range(FRAMES_PER_PAIR):
                    act = pf.next_action() if pf else None
                    wire[act[0] if act else "none"] += 1

        osdmap.epoch += 1
        new_rows = _map_pools(osdmap)
        moved = sum(
            int((new_rows[pid] != rows[pid]).any(axis=1).sum())
            for pid in rows
        )
        rows = new_rows
        entry.update({
            "pgs_degraded": degraded_pgs,
            "objects_degraded": degraded_pgs * objects_per_pg,
            "recovery_debt_objects": recovery_debt,
            "pgs_moved": moved,
            "wire_decisions": wire,
        })
        report["steps"].append(entry)

    report["final"] = {
        "max_concurrent_down": max_down,
        "data_safe": max_down <= MAX_CONCURRENT_DOWN,
        "converged": not down_until and not armed,
    }
    if measure:
        report["timing"] = {
            "total_seconds": time.perf_counter() - t0,
        }
    return report
