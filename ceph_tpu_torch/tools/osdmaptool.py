"""osdmaptool — create/inspect/test OSD maps (reference CLI parity).

Port of tools/osdmaptool.py, run as `python -m ceph_tpu_torch.tools.osdmaptool`
with the same flags plus `--device` (default cuda; `--device cpu` runs the
batched mapper's plain version). Mirrors src/tools/osdmaptool.cc for the
workflows the framework supports:

    osdmaptool --createsimple <numosd> map.json [--pg-bits B] \\
               [--with-default-pool] [--clobber]
    osdmaptool map.json --print
    osdmaptool map.json --tree
    osdmaptool map.json --test-map-pgs [--pool N] [--pg-num N]
    osdmaptool map.json --test-map-pgs-dump [--pool N]
    osdmaptool map.json --test-map-object <name> [--pool N]
    osdmaptool map.json --mark-out <osd>
    osdmaptool map.json --upmap out.txt [--upmap-max N] \\
               [--upmap-deviation D] [--upmap-save]

The whole-pool mapping behind --test-map-pgs is the batched mapper
(OSDMap.pool_mappings over the straw2 choose kernel) — the reference does this one PG at a time on one
thread (osdmaptool.cc test_map_pgs loop) or on a thread pool
(ParallelPGMapper); output formats (per-osd count table, avg/stddev, size
histogram, `ceph osd pg-upmap-items` command stream) mirror the reference.

Storage is a JSON envelope (crushmap as its canonical text form + pool/osd
state), not the reference's binary encoding; see tools/crushtool.py. The
files are interchangeable with tools/osdmaptool.py's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

from ceph_tpu_torch.crush import builder as cb
from ceph_tpu_torch.crush.compiler import compile_crushmap, decompile_crushmap
from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, OSDMap
from ceph_tpu_torch.osd.types import TYPE_REPLICATED, PgPool

STORE_VERSION = 1


# -- storage -----------------------------------------------------------------


def save_map(osdmap: OSDMap, path: str) -> None:
    doc = {
        "ceph_tpu_osdmap": STORE_VERSION,
        "epoch": osdmap.epoch,
        "max_osd": osdmap.max_osd,
        "crush": decompile_crushmap(osdmap.crush),
        "pools": {
            str(pid): {
                "pg_num": p.pg_num, "pgp_num": p.pgp_num, "size": p.size,
                "min_size": p.min_size, "type": p.type,
                "crush_rule": p.crush_rule, "flags": p.flags,
                "erasure_code_profile": p.erasure_code_profile,
            }
            for pid, p in osdmap.pools.items()
        },
        "osd_exists": osdmap.osd_exists.astype(int).tolist(),
        "osd_up": osdmap.osd_up.astype(int).tolist(),
        "osd_weight": osdmap.osd_weight.tolist(),
        "osd_primary_affinity": (
            osdmap.osd_primary_affinity.tolist()
            if osdmap.osd_primary_affinity is not None
            else None
        ),
        "pg_upmap": [
            [list(pg), list(osds)] for pg, osds in osdmap.pg_upmap.items()
        ],
        "pg_upmap_items": [
            [list(pg), [list(pair) for pair in items]]
            for pg, items in osdmap.pg_upmap_items.items()
        ],
        "pg_temp": [
            [list(pg), list(osds)] for pg, osds in osdmap.pg_temp.items()
        ],
        "primary_temp": [
            [list(pg), osd] for pg, osd in osdmap.primary_temp.items()
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_osdmap(path: str, device=None) -> OSDMap:
    """The map stored at `path`; its batched mapper runs on `device`."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("ceph_tpu_osdmap") != STORE_VERSION:
        raise SystemExit(f"{path}: not a ceph_tpu osdmap store")
    cmap = compile_crushmap(doc["crush"])
    m = OSDMap(crush=cmap, max_osd=doc["max_osd"], epoch=doc["epoch"],
               device=device)
    for pid, p in doc["pools"].items():
        pool = PgPool(
            pg_num=p["pg_num"], pgp_num=p["pgp_num"], size=p["size"],
            min_size=p["min_size"], type=p["type"],
            crush_rule=p["crush_rule"],
            erasure_code_profile=p.get("erasure_code_profile", ""),
        )
        if "flags" in p:
            pool.flags = p["flags"]
        m.pools[int(pid)] = pool
    m.osd_exists = np.asarray(doc["osd_exists"], dtype=bool)
    m.osd_up = np.asarray(doc["osd_up"], dtype=bool)
    m.osd_weight = np.asarray(doc["osd_weight"], dtype=np.int64)
    if doc.get("osd_primary_affinity") is not None:
        m.osd_primary_affinity = np.asarray(
            doc["osd_primary_affinity"], dtype=np.int64
        )
    for pg, osds in doc.get("pg_upmap", []):
        m.pg_upmap[tuple(pg)] = list(osds)
    for pg, items in doc.get("pg_upmap_items", []):
        m.pg_upmap_items[tuple(pg)] = [tuple(i) for i in items]
    for pg, osds in doc.get("pg_temp", []):
        m.pg_temp[tuple(pg)] = list(osds)
    for pg, osd in doc.get("primary_temp", []):
        m.primary_temp[tuple(pg)] = osd
    return m


# -- createsimple (OSDMap::build_simple) -------------------------------------


def build_simple(
    n_osd: int, pg_bits: int = 6, with_default_pool: bool = False,
    osds_per_host: int = 4,
) -> OSDMap:
    """A generic map: hosts of `osds_per_host` osds under one root, one
    replicated rule; optionally a default pool with n_osd << pg_bits PGs
    spread over it (the shape OSDMap::build_simple produces)."""
    cmap = CrushMap(tunables=Tunables.jewel())
    cmap.type_names = {0: "osd", 1: "host", 10: "root"}
    host_ids, host_ws = [], []
    osd = 0
    n_hosts = max(1, (n_osd + osds_per_host - 1) // osds_per_host)
    for h in range(n_hosts):
        items = list(range(osd, min(osd + osds_per_host, n_osd)))
        if not items:
            break
        osd += len(items)
        b = cb.make_bucket(
            cmap, -(h + 2), BucketAlg.STRAW2, 1, items,
            [0x10000] * len(items),
        )
        cmap.item_names[b.id] = f"host{h}"
        host_ids.append(b.id)
        host_ws.append(b.weight)
    root = cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, host_ids, host_ws)
    cmap.item_names[root.id] = "default"
    for o in range(n_osd):
        cmap.item_names[o] = f"osd.{o}"
    cb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
    cmap.rule_names[0] = "replicated_rule"
    m = OSDMap(crush=cmap, max_osd=n_osd)
    if with_default_pool:
        m.pools[1] = PgPool(
            pg_num=n_osd << pg_bits, size=3, type=TYPE_REPLICATED,
            crush_rule=0,
        )
    return m


# -- the map-pgs engine ------------------------------------------------------


def run_test_map_pgs(osdmap: OSDMap, pool: int, pg_num: int, dump: bool,
                 out) -> None:
    n = osdmap.max_osd
    count = np.zeros(n, dtype=np.int64)
    first_count = np.zeros(n, dtype=np.int64)
    primary_count = np.zeros(n, dtype=np.int64)
    size_hist: dict[int, int] = {}
    saved_geometry: dict[int, tuple[int, int]] = {}
    # the primary differs from up[0] only under primary-affinity or
    # primary_temp overrides; take the scalar pipeline's word then, and the
    # cheap first-osd answer otherwise
    affinity_default = (
        osdmap.osd_primary_affinity is None
        or bool((osdmap.osd_primary_affinity == 0x10000).all())
    )
    need_scalar_primary = bool(osdmap.primary_temp) or not affinity_default
    for pid in sorted(osdmap.pools):
        if pool != -1 and pid != pool:
            continue
        p = osdmap.pools[pid]
        if pg_num > 0:
            # a DIAGNOSTIC override: remember the real geometry (main
            # restores it before any save) and drop per-PG overrides that
            # point past the new pg_num
            saved_geometry[pid] = (p.pg_num, p.pgp_num)
            p.pg_num = pg_num
            p.pgp_num = pg_num
        print(f"pool {pid} pg_num {p.pg_num}", file=out)
        ups = osdmap.pool_mappings(pid)  # the batched mapper
        for ps in range(p.pg_num):
            osds = [int(o) for o in ups[ps] if o != CRUSH_ITEM_NONE]
            if need_scalar_primary:
                _, _, _, primary = osdmap.pg_to_up_acting_osds(pid, ps)
            else:
                primary = osds[0] if osds else -1
            size_hist[len(osds)] = size_hist.get(len(osds), 0) + 1
            if dump:
                vec = "[" + ",".join(str(o) for o in osds) + "]"
                print(f"{pid}.{ps:x}\t{vec}\t{primary}", file=out)
            for o in osds:
                count[o] += 1
            if osds:
                first_count[osds[0]] += 1
            if primary >= 0:
                primary_count[primary] += 1

    weights = osdmap.osd_weight
    print("#osd\tcount\tfirst\tprimary\tc wt\twt", file=out)
    in_osds = []
    for o in range(n):
        if not osdmap.osd_exists[o] or weights[o] <= 0:
            continue
        in_osds.append(o)
        cw = _crush_weightf(osdmap.crush, o)
        print(
            f"osd.{o}\t{count[o]}\t{first_count[o]}\t{primary_count[o]}"
            f"\t{cw:g}\t{weights[o] / 65536:g}",
            file=out,
        )
    if not in_osds:
        return
    counts_in = count[in_osds]
    total = int(counts_in.sum())
    avg = total // len(in_osds)
    dev = math.sqrt(float(((avg - counts_in) ** 2).mean()))
    edev = math.sqrt(
        total / len(in_osds) * (1.0 - 1.0 / len(in_osds))
    )
    print(f" in {len(in_osds)}", file=out)
    print(
        f" avg {avg} stddev {dev:g} ({dev / avg if avg else 0:g}x) "
        f"(expected {edev:g} {edev / avg if avg else 0:g}x))",
        file=out,
    )
    nz = [o for o in in_osds if count[o]]
    if nz:
        mn = min(nz, key=lambda o: count[o])
        mx = max(nz, key=lambda o: count[o])
        print(f" min osd.{mn} {count[mn]}", file=out)
        print(f" max osd.{mx} {count[mx]}", file=out)
    for s in sorted(size_hist):
        print(f"size {s}\t{size_hist[s]}", file=out)
    # undo the diagnostic pg_num override so a later save cannot persist it
    for pid, (old_pg, old_pgp) in saved_geometry.items():
        osdmap.pools[pid].pg_num = old_pg
        osdmap.pools[pid].pgp_num = old_pgp


def _crush_weightf(cmap: CrushMap, osd: int) -> float:
    for b in cmap.buckets.values():
        if osd in b.items:
            return b.item_weights[b.items.index(osd)] / 65536.0
    return 0.0


def upmap_commands(osdmap: OSDMap, before: dict) -> list[str]:
    """`ceph osd pg-upmap-items` command stream for NEW entries
    (osdmaptool.cc:79-84)."""
    cmds = []
    for pg, items in sorted(osdmap.pg_upmap_items.items()):
        if before.get(pg) == items:
            continue
        pairs = " ".join(f"{a} {b}" for a, b in items)
        cmds.append(f"ceph osd pg-upmap-items {pg[0]}.{pg[1]:x} {pairs}")
    return cmds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("mapfn")
    ap.add_argument("--createsimple", type=int, metavar="numosd")
    ap.add_argument("--pg-bits", type=int, default=6)
    ap.add_argument("--with-default-pool", action="store_true")
    ap.add_argument("--clobber", action="store_true")
    ap.add_argument("--print", dest="do_print", action="store_true")
    ap.add_argument("--tree", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--test-map-pgs-dump", action="store_true")
    ap.add_argument("--test-map-object", metavar="name")
    ap.add_argument("--pool", type=int, default=-1)
    ap.add_argument("--pg-num", type=int, default=-1)
    ap.add_argument("--mark-out", type=int, default=None, metavar="osd")
    ap.add_argument("--upmap", metavar="file")
    ap.add_argument("--upmap-max", type=int, default=100)
    ap.add_argument("--upmap-deviation", type=float, default=5.0)
    ap.add_argument("--upmap-save", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the batched mapper runs (default cuda)")
    args = ap.parse_args(argv)

    if args.createsimple is not None:
        if os.path.exists(args.mapfn) and not args.clobber:
            print(
                f"osdmaptool: {args.mapfn} exists, --clobber to overwrite",
                file=sys.stderr,
            )
            return 1
        m = build_simple(
            args.createsimple, args.pg_bits, args.with_default_pool
        )
        save_map(m, args.mapfn)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.mapfn}")
        return 0

    osdmap = load_osdmap(args.mapfn, device=args.device)
    dirty = False

    if args.mark_out is not None:
        osdmap.mark_out(args.mark_out)
        dirty = True

    if args.do_print:
        print(f"epoch {osdmap.epoch}")
        print(f"max_osd {osdmap.max_osd}")
        for pid in sorted(osdmap.pools):
            p = osdmap.pools[pid]
            kind = "replicated" if p.type == TYPE_REPLICATED else "erasure"
            print(
                f"pool {pid} '{kind}' size {p.size} min_size {p.min_size} "
                f"crush_rule {p.crush_rule} pg_num {p.pg_num} "
                f"pgp_num {p.pgp_num}"
            )
        for o in range(osdmap.max_osd):
            state = "up" if osdmap.osd_up[o] else "down"
            inout = "in" if osdmap.osd_weight[o] > 0 else "out"
            print(
                f"osd.{o} {state} {inout} "
                f"weight {osdmap.osd_weight[o] / 65536:g}"
            )

    if args.tree:
        from ceph_tpu_torch.tools.crushtool import dump_tree

        dump_tree(osdmap.crush, sys.stdout)

    if args.test_map_pgs or args.test_map_pgs_dump:
        run_test_map_pgs(
            osdmap, args.pool, args.pg_num, args.test_map_pgs_dump,
            sys.stdout,
        )

    if args.test_map_object:
        from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

        if args.pool == -1 and not osdmap.pools:
            print("osdmaptool: map has no pools", file=sys.stderr)
            return 1
        pool = args.pool if args.pool != -1 else sorted(osdmap.pools)[0]
        if pool not in osdmap.pools:
            print(f"osdmaptool: There is no pool {pool}", file=sys.stderr)
            return 1
        p = osdmap.pools[pool]
        ps = p.raw_pg_to_pg(ceph_str_hash_rjenkins(args.test_map_object))
        up, up_primary, acting, _ = osdmap.pg_to_up_acting_osds(pool, ps)
        vec = "[" + ",".join(str(o) for o in acting) + "]"
        print(
            f" object '{args.test_map_object}' -> {pool}.{ps:x} -> {vec}"
        )

    if args.upmap:
        before = {
            pg: list(items) for pg, items in osdmap.pg_upmap_items.items()
        }
        changed = osdmap.calc_pg_upmaps(
            max_deviation=args.upmap_deviation,
            max_changes=args.upmap_max,
            pools=None if args.pool == -1 else {args.pool},
        )
        cmds = upmap_commands(osdmap, before)
        out = sys.stdout if args.upmap == "-" else open(args.upmap, "w")
        for c in cmds:
            print(c, file=out)
        if out is not sys.stdout:
            out.close()
        print(f"changed {changed} pgs", file=sys.stderr)
        if args.upmap_save:
            dirty = True

    if dirty:
        save_map(osdmap, args.mapfn)
        print(f"osdmaptool: writing epoch {osdmap.epoch} to {args.mapfn}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
