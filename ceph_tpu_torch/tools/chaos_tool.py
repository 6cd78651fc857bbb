"""chaos_tool — run a seeded chaos script against a LIVE cluster.

The live half of the chaos harness (the qa Thrasher +
msgr-failures-fragment role): `ceph_tpu_torch.sim.chaos.chaos_script(seed)`
compiles the seed into a deterministic timeline — OSD flaps, asymmetric
partitions, a kill -9 of the backfill source mid-push, wire-fault
storms — and this tool executes it against real daemons over real TCP
while a client workload runs throughout, then settles and judges three
oracles:

* zero acked-data loss — every acked write reads back (failed writes
  may land either way, the RadosModel either/or discipline);
* convergence to clean — every OSD back up, no backfill in flight,
  deep scrub of every pool reports zero inconsistencies;
* bounded client p99 — op latency through the storm stays under
  --p99-budget, and no step fully starves the client.

Replayable: the same --seed produces the same scripted timeline (wire
faults draw from per-pair streams seeded by ms_inject_chaos_seed).

    python -m ceph_tpu_torch.tools.chaos_tool --seed 7 [--steps 8] [--json]
        [--device cpu]

Exit status 0 = all oracles hold; 1 = a violation (details on stderr).

Port of the reference package's `tools/chaos_tool.py`. `--device` (default
cuda, which raises without a card) is where every monitor, OSD and the
client run their codecs: on a card the EC pool's writes, degraded reads and
recovery launch the GF(2^8) kernel. The device is opened, and the kernel's
library loaded, before the cluster starts, so that no build or context
creation lands inside the storm that the p99 oracle judges.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

N_OSDS = 6
REP_POOL = 1
EC_POOL = 2


def chaos_config():
    from ceph_tpu_torch.common.config import Config

    cfg = Config()
    cfg.set("mon_lease", 0.1)
    cfg.set("mon_election_timeout", 0.4)
    cfg.set("osd_heartbeat_interval", 0.15)
    cfg.set("osd_heartbeat_grace", 2)
    cfg.set("osd_min_pg_log_entries", 20)  # trim -> backfill in play
    return cfg


class LiveCluster:
    """In-process mons + osds sharing ONE Config object, so a single
    `cfg.set("ms_inject_chaos_schedule", ...)` arms every messenger at
    once (the rules' src/dst globs confine the blast radius). Every daemon
    runs on `device` (None = cuda), opened here by `vstart.init_device`."""

    def __init__(self, cfg, device=None):
        from ceph_tpu_torch.mon import MonMap
        from ceph_tpu_torch.vstart import init_device

        self.device = init_device(device)
        self.cfg = cfg
        self.monmap = MonMap(addrs=[("127.0.0.1", 0)] * 3)
        self.mons = []
        self.osds = {}

    async def start(self):
        from ceph_tpu_torch.mon import Monitor
        from ceph_tpu_torch.vstart import initial_osdmap

        base = initial_osdmap(N_OSDS)
        self.mons = [
            Monitor(r, self.monmap, base, config=self.cfg,
                    device=self.device)
            for r in range(3)
        ]
        for m in self.mons:
            await m.bind()
        for m in self.mons:
            m.go()
        for osd_id in range(N_OSDS):
            await self.start_osd(osd_id)

    async def start_osd(self, osd_id, db=None):
        from ceph_tpu_torch.osd.daemon import OSDService

        osd = OSDService(osd_id, self.monmap, db=db, config=self.cfg,
                         device=self.device)
        await osd.start()
        self.osds[osd_id] = osd
        return osd

    async def kill_osd(self, osd_id):
        """Process-kill semantics: the daemon dies mid-whatever, the
        store object survives for revival (qa Thrasher kill_osd)."""
        osd = self.osds.pop(osd_id)
        db = osd.store.db
        await osd.stop()
        return db

    async def create_pools(self, rados):
        await rados.mon_command(
            "osd erasure-code-profile set",
            {"name": "k2m2",
             "profile": {"plugin": "tpu", "k": "2", "m": "2"}},
        )
        await rados.mon_command(
            "osd pool create",
            {"pool_id": REP_POOL, "crush_rule": 1, "size": 3,
             "pg_num": 8},
        )
        await rados.mon_command(
            "osd pool create",
            {"pool_id": EC_POOL, "crush_rule": 0,
             "erasure_code_profile": "k2m2", "pg_num": 8},
        )

    def client(self, name):
        from ceph_tpu_torch.rados.client import Rados

        return Rados(name, self.monmap, config=self.cfg, device=self.device)

    async def stop(self):
        for osd in list(self.osds.values()):
            await osd.stop()
        for m in self.mons:
            await m.stop()


async def wait_until(pred, timeout=60.0):
    from ceph_tpu_torch.msg.messenger import next_dispatch_event

    loop = asyncio.get_event_loop()
    end = loop.time() + timeout
    while not pred():
        remaining = end - loop.time()
        if remaining <= 0:
            raise TimeoutError
        try:
            await asyncio.wait_for(
                next_dispatch_event(), min(0.25, remaining)
            )
        except asyncio.TimeoutError:
            pass


def backfill_source(cluster):
    """The OSD currently pushing a backfill (primary of a PG with
    backfill targets), or None when nothing is in flight."""
    for osd_id, osd in sorted(cluster.osds.items()):
        for pg in osd.pgs.values():
            if pg.backfill_targets:
                return osd_id
    return None


async def run_chaos_live(seed, steps=8, step_seconds=2.0,
                         p99_budget=8.0, progress=print, device=None,
                         on_settled=None):
    """Execute chaos_script(seed) against a live cluster on `device` (None
    = cuda); returns the oracle report dict (raises nothing — violations
    are in the dict). `on_settled(cluster, rados)`, when given, is awaited
    after the oracles and before the cluster stops (to inspect its
    stores)."""
    from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError
    from ceph_tpu_torch.sim.chaos import chaos_script

    script = chaos_script(seed, n_osd=N_OSDS, steps=steps)
    cluster = LiveCluster(chaos_config(), device=device)
    await cluster.start()
    cluster.cfg.set("ms_inject_chaos_seed", int(seed))
    rados = cluster.client("client.chaos")
    await rados.connect()
    await cluster.create_pools(rados)

    loop = asyncio.get_event_loop()
    #: (pool, name) -> set of acceptable payloads (RadosModel either/or)
    model: dict[tuple[int, str], set] = {}
    lat: list[float] = []
    step_ok = []          # successful client ops per step
    import random as _random

    wrng = _random.Random(seed ^ 0xC0FFEE)

    async def one_op():
        pool = wrng.choice([REP_POOL, EC_POOL])
        name = f"c{wrng.randrange(24)}"
        data = bytes([wrng.randrange(256)]) * wrng.randrange(64, 2048)
        key = (pool, name)
        t0 = loop.time()
        try:
            await rados.objecter.op_submit(
                pool, name, "write", data, timeout=8.0
            )
            model[key] = {data}
            lat.append(loop.time() - t0)
            return True
        except RadosError:
            model[key] = model.get(key, {None}) | {data}
            return False

    dead: dict[int, object] = {}       # osd -> saved db (None=amnesiac)
    revive_at: dict[int, int] = {}
    armed: list[tuple[str, int]] = []  # (schedule, expires_step)
    executed = []

    def arm():
        cluster.cfg.set(
            "ms_inject_chaos_schedule",
            ";".join(s for s, _ in armed),
        )

    by_step: dict[int, list[dict]] = {}
    for e in script["events"]:
        by_step.setdefault(e["step"], []).append(e)

    total_steps = script["steps"] + 3  # tail drains holds + revivals
    for step in range(total_steps):
        # revivals and schedule expiry due this step
        for osd in [o for o, s in revive_at.items() if s <= step]:
            del revive_at[osd]
            await cluster.start_osd(osd, db=dead.pop(osd))
        if any(s <= step for _, s in armed):
            armed = [(x, s) for x, s in armed if s > step]
            arm()

        for e in by_step.get(step, ()):
            kind = e["kind"]
            if kind == "flap":
                if e["osd"] in cluster.osds:
                    dead[e["osd"]] = await cluster.kill_osd(e["osd"])
                    revive_at[e["osd"]] = step + 1 + e["down_steps"]
                    executed.append(["flap", e["osd"]])
            elif kind == "kill_backfill_source":
                # provoke a backfill: amnesiac-kill the fallback, write
                # through the hole, revive it EMPTY -> backfill starts,
                # then kill -9 whichever source is pushing to it
                v = e["fallback_osd"]
                if v in cluster.osds and len(dead) < 2:
                    await cluster.kill_osd(v)  # db discarded: amnesiac
                    for _ in range(12):
                        await one_op()
                    await cluster.start_osd(v)
                    try:
                        await wait_until(
                            lambda: backfill_source(cluster) is not None,
                            timeout=20,
                        )
                    except TimeoutError:
                        pass
                    src = backfill_source(cluster)
                    if src is None:
                        src = next(
                            o for o in sorted(cluster.osds) if o != v
                        )
                    dead[src] = await cluster.kill_osd(src)
                    revive_at[src] = step + 1 + e["down_steps"]
                    executed.append(["kill_backfill_source", src])
            else:  # partitions and storms: arm the wire schedule
                armed.append((e["schedule"], step + e["hold_steps"]))
                arm()
                executed.append([kind, e["schedule"]])

        # client workload rides through the whole step
        ok = 0
        end = loop.time() + step_seconds
        while loop.time() < end:
            ok += 1 if await one_op() else 0
        step_ok.append(ok)
        progress(
            f"step {step}: ok_ops={ok} dead={sorted(dead)} "
            f"armed={len(armed)}"
        )

    # settle: disarm, revive everything, wait for clean
    armed = []
    arm()
    for osd in list(dead):
        await cluster.start_osd(osd, db=dead.pop(osd))
    revive_at.clear()
    await wait_until(
        lambda: all(
            not any(o.osdmap.is_down(i) for i in range(N_OSDS))
            for o in cluster.osds.values()
        ),
        timeout=90,
    )
    await wait_until(
        lambda: backfill_source(cluster) is None, timeout=90
    )

    # oracle 1: zero acked-data loss
    lost = []
    for (pool, name), want in sorted(model.items()):
        try:
            rep = await rados.objecter.op_submit(
                pool, name, "read", timeout=15.0
            )
            got = rep["_raw"]
        except ObjectNotFound:
            got = None
        if got not in want:
            lost.append([pool, name])

    # oracle 2: convergence to clean — deep scrub everything (polled:
    # stray copies from the churn settle over a few peering passes)
    async def scrub_errors():
        errs = []
        for o in list(cluster.osds.values()):
            for pool in (REP_POOL, EC_POOL):
                rep = await rados.objecter.osd_admin(
                    o.id, "scrub", {"pool": pool, "deep": True}
                )
                errs.extend(rep["errors"])
        return errs

    deadline = loop.time() + 90
    errors = await scrub_errors()
    while errors and loop.time() < deadline:
        await asyncio.sleep(1)
        errors = await scrub_errors()

    # oracle 3: bounded client p99, never fully starved
    p99 = sorted(lat)[int(len(lat) * 0.99)] if lat else 0.0
    starved = [i for i, n in enumerate(step_ok) if n == 0]

    if on_settled is not None:
        await on_settled(cluster, rados)
    await rados.shutdown()
    await cluster.stop()
    return {
        "seed": int(seed),
        "script_events": len(script["events"]),
        "executed": executed,
        "client_ops": len(lat) + len(lost),
        "acked_keys": len(model),
        "lost": lost,
        "scrub_errors": len(errors),
        "p99_s": round(p99, 4),
        "p99_budget_s": p99_budget,
        "starved_steps": starved,
        "ok": (not lost and not errors and p99 <= p99_budget
               and not starved),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos_tool")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--step-seconds", type=float, default=2.0)
    ap.add_argument("--p99-budget", type=float, default=8.0,
                    help="max acceptable client p99 (seconds)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the daemons and the client run: cuda "
                         "(default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    progress = (lambda *_: None) if args.quiet or args.json else print
    report = asyncio.run(run_chaos_live(
        args.seed, steps=args.steps, step_seconds=args.step_seconds,
        p99_budget=args.p99_budget, progress=progress,
        device=args.device,
    ))
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(
            f"seed {report['seed']}: {report['client_ops']} client ops, "
            f"p99 {report['p99_s']}s, lost={len(report['lost'])}, "
            f"scrub_errors={report['scrub_errors']}, "
            f"starved_steps={report['starved_steps']}"
        )
    if not report["ok"]:
        print(f"ORACLE VIOLATION: {report}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
