"""PgAutoscaler: propose (and optionally commit) pg_num for each pool.

The reference module (src/pybind/mgr/pg_autoscaler/module.py) sizes each
pool from its share of the cluster's data: a pool holding most of the
bytes deserves most of the PG budget (mon_target_pg_per_osd * OSDs),
scaled by replication factor, rounded to a power of two, and only acted
on when the ideal differs from the actual by >= 3x (the threshold that
stops flapping). Same math here over per-primary pool stats gathered
through the admin surface; `run_once(apply=True)` commits the growth via
`osd pool set pg_num` and the OSDs split PGs on the map change.

Copy of ceph_tpu/mgr/autoscaler.py with its imports rewired.
"""

from __future__ import annotations


class PgAutoscaler:
    def __init__(self, objecter, target_pg_per_osd: int = 100):
        self.objecter = objecter
        self.target_pg_per_osd = target_pg_per_osd

    async def _gather_pool_stats(self) -> dict[int, dict]:
        osdmap = self.objecter.osdmap
        totals: dict[int, dict] = {
            pid: {"objects": 0, "bytes": 0}
            for pid in osdmap.pools
        }
        for osd in range(osdmap.max_osd):
            if osdmap.is_down(osd):
                continue
            try:
                stats = await self.objecter.osd_admin(
                    osd, "pool_stats", timeout=10.0
                )
            # cephlint: disable=error-taxonomy (OSD restarting or pool gone mid-scan: next tick re-polls)
            except Exception:
                continue
            for pid_s, st in stats.items():
                t = totals.setdefault(
                    int(pid_s), {"objects": 0, "bytes": 0}
                )
                t["objects"] += st["objects"]
                t["bytes"] += st["bytes"]
        return totals

    async def run_once(self, apply: bool = False) -> dict:
        """One autoscale pass: per-pool {current, ideal, action}."""
        osdmap = self.objecter.osdmap
        # capacity gate: pg splits multiply object placements; growing
        # pg_num into NEARFULL/FULL osds makes the squeeze worse (the
        # module's own full-cluster guard)
        health = await self.objecter.mon.command("health")
        if any(
            k in health.get("checks", {})
            for k in ("OSD_NEARFULL", "OSD_BACKFILLFULL", "OSD_FULL")
        ):
            return {"skipped": "cluster near capacity"}
        stats = await self._gather_pool_stats()
        n_up = int(osdmap.max_osd - sum(
            1 for o in range(osdmap.max_osd) if osdmap.is_down(o)
        ))
        total_bytes = sum(t["bytes"] for t in stats.values())
        budget = max(1, self.target_pg_per_osd * max(1, n_up))
        report: dict[str, dict] = {}
        for pid, pool in sorted(osdmap.pools.items()):
            share = (
                stats.get(pid, {}).get("bytes", 0) / total_bytes
                if total_bytes
                else 1.0 / max(1, len(osdmap.pools))
            )
            ideal = budget * share / max(1, pool.size)
            # round to the NEAREST power of two, floor 8 (the module's
            # nearest_power_of_two + min guard)
            p = 8
            while p * 2 <= ideal:
                p *= 2
            if ideal - p > p * 2 - ideal:
                p *= 2
            entry = {
                "current": pool.pg_num,
                "ideal": p,
                "bytes": stats.get(pid, {}).get("bytes", 0),
                "action": "none",
            }
            # >=3x off triggers action; shrink is reported but never
            # committed (pg_num only grows here, like pre-nautilus)
            if p >= pool.pg_num * 3:
                entry["action"] = "grow"
                if apply:
                    await self.objecter.mon.command(
                        "osd pool set",
                        {"pool_id": pid, "name": "pg_num",
                         "value": p},
                    )
                    entry["applied"] = True
            elif p * 3 <= pool.pg_num:
                entry["action"] = "shrink-advised"
            report[str(pid)] = entry
        return report
