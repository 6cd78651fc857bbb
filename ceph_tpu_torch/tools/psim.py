"""psim — the placement simulator CLI (reference: src/tools/psim.cc,
grown into the ceph_tpu_torch.sim front end).

Port of tools/psim.py, run as `python -m ceph_tpu_torch.tools.psim` with the
same flags plus `--device` (default cuda; `--device cpu` runs the plain
versions of the kernels).

Two modes:

* **Map-file mode** (the reference's psim.cc): read an osdmaptool-created
  map, drive 10 namespaces x 5000 files x 4 blocks of synthetic object
  names through the full object -> ps -> pg -> acting pipeline, and print
  per-osd placement counts with avg/stddev. Where the reference maps each
  object's PG one call at a time, this hashes all 200k names host-side
  and maps every distinct PG in one batched mapper run
  (OSDMap.pool_mappings).

      python -m ceph_tpu_torch.tools.osdmaptool .ceph_osdmap --createsimple 40 \\
          --with-default-pool
      python -m ceph_tpu_torch.tools.psim .ceph_osdmap

* **Scenario mode** (`--scenario`, ceph_tpu_torch.sim): build a synthetic
  cluster (host/rack hierarchy, replicated + EC pools), run a seeded
  deterministic event script (OSD flaps out/in, reweights, map churn
  epochs) with per-epoch backfill-storm estimates, then converge the
  batched balancer and report spread before/after, moves, launches —
  JSON with --json, wall-clock timings only with --measure.

      python -m ceph_tpu_torch.tools.psim --scenario --osds 1024 --seed 1 --json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE
from ceph_tpu_torch.tools.osdmaptool import load_osdmap

NAMESPACES, FILES, BLOCKS = 10, 5000, 4


def run_mapfile(mapfn: str, device=None) -> int:
    """The reference psim.cc flow over an existing map file."""
    if not os.path.exists(mapfn):
        print(
            f"{sys.argv[0]}: error reading {mapfn}: create one with "
            "osdmaptool --createsimple first",
            file=sys.stderr,
        )
        return 1
    osdmap = load_osdmap(mapfn, device=device)
    if not osdmap.pools:
        print(f"{mapfn} has no pools (use --with-default-pool)",
              file=sys.stderr)
        return 1
    pool_id = sorted(osdmap.pools)[0]
    pool = osdmap.pools[pool_id]

    # object name -> ps for the whole synthetic workload: 200k distinct
    # "<file>.<block>" names (the reference's 10 namespaces x 5000 files x 4
    # blocks, psim.cc:52-60; the ps hash covers the object name)
    pg_obj_count = np.zeros(pool.pg_num, dtype=np.int64)
    for f in range(NAMESPACES * FILES):
        for b in range(BLOCKS):
            ps = pool.raw_pg_to_pg(ceph_str_hash_rjenkins(f"{f}.{b}"))
            pg_obj_count[ps] += 1

    ups = osdmap.pool_mappings(pool_id)  # one batched run
    n = osdmap.max_osd
    count = np.zeros(n, dtype=np.int64)
    first_count = np.zeros(n, dtype=np.int64)
    primary_count = np.zeros(n, dtype=np.int64)
    # acting/primary overrides (pg_temp/primary_temp) are sparse; take the
    # scalar pipeline's word for affected PGs (psim.cc uses
    # pg_to_acting_osds) and the batched up sets for everything else
    overridden = {
        pg[1] for pg in list(osdmap.pg_temp) + list(osdmap.primary_temp)
        if pg[0] == pool_id
    }
    for ps in range(pool.pg_num):
        if ps in overridden:
            _, _, acting, primary = osdmap.pg_to_up_acting_osds(pool_id, ps)
            osds = [int(o) for o in acting if o != CRUSH_ITEM_NONE]
        else:
            osds = [int(o) for o in ups[ps] if o != CRUSH_ITEM_NONE]
            primary = osds[0] if osds else -1
        for o in osds:
            count[o] += pg_obj_count[ps]
        if osds:
            first_count[osds[0]] += pg_obj_count[ps]
        if primary >= 0:
            primary_count[primary] += pg_obj_count[ps]

    for o in range(n):
        print(f"osd.{o}\t{count[o]}\t{first_count[o]}\t{primary_count[o]}")
    avg = int(count.sum()) // n
    dev = math.sqrt(float(((count - avg) ** 2).mean()))
    print(f"avg {avg} stddev {dev:g}")
    return 0


def run_scenario_cli(args) -> int:
    from ceph_tpu_torch.sim import run_scenario

    cfg = Config()
    n_osd = args.osds if args.osds else cfg.get("psim_default_osds")
    seed = args.seed if args.seed is not None else cfg.get(
        "psim_default_seed"
    )
    bytes_per_pg = (
        args.bytes_per_pg if args.bytes_per_pg
        else cfg.get("psim_bytes_per_pg")
    )
    rep_pgs = args.rep_pgs if args.rep_pgs else max(64, n_osd * 32)
    ec_pgs = args.ec_pgs if args.ec_pgs is not None else max(
        32, n_osd * 8
    )
    report = run_scenario(
        n_osd=n_osd,
        osds_per_host=args.osds_per_host,
        hosts_per_rack=args.hosts_per_rack,
        rep_pg_num=rep_pgs,
        ec_pg_num=ec_pgs,
        seed=seed,
        epochs=args.epochs,
        bytes_per_pg=bytes_per_pg,
        balance_after=not args.no_balance,
        max_deviation=args.max_deviation,
        max_changes=args.max_changes,
        measure=args.measure,
        device=args.device,
    )
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0
    print(
        f"cluster: {report['osds']} osds / {report['hosts']} hosts / "
        f"{report['racks']} racks, {report['pg_instances']} pg instances"
    )
    for ep in report["epochs"]:
        names = ",".join(ev[0] for ev in ep["events"]) or "none"
        print(
            f"epoch {ep['epoch']}: events [{names}] moved "
            f"{ep['pgs_moved']} pgs (~{ep['bytes_moved'] >> 30} GiB "
            "backfill)"
        )
    bal = report.get("balance")
    if bal:
        print(
            f"balance: {bal['changes']} moves in {bal['rounds']} rounds "
            f"({bal['launches']} launches), spread "
            f"{bal['spread_before']:.2f} -> {bal['spread_after']:.2f} "
            f"{'CONVERGED' if bal['converged'] else 'NOT converged'}"
        )
    timing = report.get("timing")
    if timing:
        print(
            f"timing: {timing['pgs_mapped']} pgs mapped in "
            f"{timing['map_seconds']:.3f}s "
            f"({timing['pgs_mapped_per_s']:.0f}/s), balance "
            f"{timing.get('balance_seconds', 0.0):.3f}s, total "
            f"{timing['total_seconds']:.3f}s"
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="psim", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("mapfile", nargs="?", default=None,
                    help="osdmaptool map file (map-file mode)")
    ap.add_argument("--scenario", action="store_true",
                    help="run a ceph_tpu_torch.sim synthetic-cluster scenario")
    ap.add_argument("--osds", type=int, default=0,
                    help="cluster size (default: psim_default_osds knob)")
    ap.add_argument("--osds-per-host", type=int, default=8)
    ap.add_argument("--hosts-per-rack", type=int, default=4)
    ap.add_argument("--rep-pgs", type=int, default=0,
                    help="replicated pool pg_num (default: osds*32)")
    ap.add_argument("--ec-pgs", type=int, default=None,
                    help="EC pool pg_num (default: osds*8; 0 disables)")
    ap.add_argument("--seed", type=int, default=None,
                    help="event RNG seed (default: psim_default_seed knob)")
    ap.add_argument("--epochs", type=int, default=3,
                    help="churn epochs to script")
    ap.add_argument("--bytes-per-pg", type=int, default=0,
                    help="backfill estimate scale "
                         "(default: psim_bytes_per_pg knob)")
    ap.add_argument("--no-balance", action="store_true",
                    help="skip the balancer convergence stage")
    ap.add_argument("--max-deviation", type=float, default=1.0)
    ap.add_argument("--max-changes", type=int, default=512)
    ap.add_argument("--measure", action="store_true",
                    help="include wall-clock timings (report is no "
                         "longer byte-deterministic)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    ap.add_argument("--device", default=None,
                    help="where mapping and move scoring run (default cuda)")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])

    if args.scenario:
        return run_scenario_cli(args)
    return run_mapfile(args.mapfile if args.mapfile else ".ceph_osdmap",
                       device=args.device)


if __name__ == "__main__":
    sys.exit(main())
