"""crushtool — compile/decompile/test crush maps (reference CLI parity).

Port of tools/crushtool.py (same flags, byte-identical output), run as
`python -m ceph_tpu_torch.tools.crushtool`. Mirrors src/tools/crushtool.cc's
surface for the workflows the framework supports:

    crushtool -c map.txt -o map.bin        # compile text -> stored map
    crushtool -d map.bin [-o map.txt]      # decompile stored map -> text
    crushtool -i map.bin --test [...]      # CrushTester placement engine
    crushtool -i map.bin --tree            # hierarchy dump

--device (default cuda; raises without a card) is where --test maps: the
batched mapper and its CUDA kernel on a card, the plain torch version with
--device cpu.

Tester flags (crushtool.cc:535+): --min-x/--max-x/--x, --num-rep/--min-rep/
--max-rep, --rule, --ruleset, --weight <devno> <w>,
--show-mappings, --show-bad-mappings, --show-utilization,
--show-utilization-all, --show-statistics, --pool-id.

The stored-map container is JSON (schema below), NOT the reference's binary
bufferlist encoding — reading maps produced by the C crushtool is not
supported (decode of its wire format is future work); text maps are the
interchange format. `-i`/`-d` sniff text crushmaps and accept them directly,
so `crushtool -i map.txt --test` works on reference fixture files.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.crush.compiler import (
    CompileError,
    compile_crushmap,
    decompile_crushmap,
)
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import CrushMap

STORE_VERSION = 1


def store_map(cmap: CrushMap) -> str:
    """Serialize via the text form inside a versioned JSON envelope: the text
    grammar is the canonical (and reference-compatible) representation."""
    return json.dumps(
        {"ceph_tpu_crushmap": STORE_VERSION, "text": decompile_crushmap(cmap)}
    )


def load_map(path: str) -> CrushMap:
    with open(path, "rb") as f:
        data = f.read()
    try:
        text = data.decode()
    except UnicodeDecodeError as e:
        raise CompileError(
            f"{path}: binary crushmaps from the reference crushtool are not "
            "supported; use the text form"
        ) from e
    stripped = text.lstrip()
    if stripped.startswith("{"):
        doc = json.loads(text)
        if doc.get("ceph_tpu_crushmap") != STORE_VERSION:
            raise CompileError(f"{path}: not a ceph_tpu crushmap store")
        return compile_crushmap(doc["text"])
    return compile_crushmap(text)


def dump_tree(cmap: CrushMap, out) -> None:
    """`crushtool --tree` style hierarchy dump over the shared
    CrushTreeDumper walk (ceph_tpu_torch.crush.tree)."""
    from ceph_tpu_torch.crush.tree import dump_items

    print("ID\tWEIGHT\tTYPE NAME", file=out)
    for node in dump_items(cmap):
        indent = "\t" * node["depth"]
        label = (
            node["name"] if node["type"] == "osd"
            else f"{node['type']} {node['name']}"
        )
        print(
            f"{node['id']}\t{node['weight']:.5f}\t{indent}{label}",
            file=out,
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool", add_help=True)
    ap.add_argument("-i", "--infn", metavar="map")
    ap.add_argument("-c", "--compile", metavar="map.txt", dest="srcfn")
    ap.add_argument("-d", "--decompile", metavar="map")
    ap.add_argument("-o", "--outfn", metavar="out")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--tree", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="validate map structure (cycles, dangling "
                         "items, weight sums)")
    ap.add_argument("--min-x", type=int, default=-1)
    ap.add_argument("--max-x", type=int, default=-1)
    ap.add_argument("--x", type=int, default=None)
    ap.add_argument("--num-rep", type=int, default=None)
    ap.add_argument("--min-rep", type=int, default=-1)
    ap.add_argument("--max-rep", type=int, default=-1)
    ap.add_argument("--rule", type=int, default=-1)
    ap.add_argument("--ruleset", type=int, default=-1)
    ap.add_argument("--pool-id", type=int, default=-1)
    ap.add_argument("--weight", nargs=2, action="append", default=[],
                    metavar=("devno", "weight"))
    for tun in ("choose-local-tries", "choose-local-fallback-tries",
                "choose-total-tries", "chooseleaf-descend-once",
                "chooseleaf-vary-r", "chooseleaf-stable",
                "straw-calc-version"):
        ap.add_argument(f"--set-{tun}", type=int, default=None,
                        dest=f"set_{tun.replace('-', '_')}")
    ap.add_argument("--show-mappings", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-utilization-all", action="store_true")
    ap.add_argument("--show-statistics", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where --test maps: cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        if args.srcfn:  # -c: compile
            with open(args.srcfn) as f:
                cmap = compile_crushmap(f.read())
            if args.outfn:
                with open(args.outfn, "w") as f:
                    f.write(store_map(cmap))
            return 0

        if args.decompile:  # -d
            cmap = load_map(args.decompile)
            text = decompile_crushmap(cmap)
            if args.outfn:
                with open(args.outfn, "w") as f:
                    f.write(text)
            else:
                sys.stdout.write(text)
            return 0

        if not args.infn:
            ap.error("no action specified (use -i/-c/-d)")
        cmap = load_map(args.infn)

        for tun in ("choose_local_tries", "choose_local_fallback_tries",
                    "choose_total_tries", "chooseleaf_descend_once",
                    "chooseleaf_vary_r", "chooseleaf_stable",
                    "straw_calc_version"):
            val = getattr(args, f"set_{tun}")
            if val is not None:
                setattr(cmap.tunables, tun, val)
                if tun == "straw_calc_version":
                    # straw lengths are a build-time product of this tunable
                    from ceph_tpu_torch.crush.builder import calc_straws
                    from ceph_tpu_torch.crush.types import BucketAlg

                    for b in cmap.buckets.values():
                        if b.alg == BucketAlg.STRAW:
                            b.straws = calc_straws(b.item_weights, val)

        if args.tree:
            dump_tree(cmap, sys.stdout)
            return 0

        if args.check:
            from ceph_tpu_torch.crush.tree import validate

            problems = validate(cmap)
            for p in problems:
                print(p, file=sys.stderr)
            return 1 if problems else 0

        if args.test:
            tester = CrushTester(cmap, device=args.device)
            tester.min_x, tester.max_x = args.min_x, args.max_x
            if args.x is not None:
                tester.min_x = tester.max_x = args.x
            tester.min_rep, tester.max_rep = args.min_rep, args.max_rep
            if args.num_rep is not None:
                tester.min_rep = tester.max_rep = args.num_rep
            if args.rule >= 0:
                tester.min_rule = tester.max_rule = args.rule
            tester.ruleset = args.ruleset
            tester.pool_id = args.pool_id
            for devno, w in args.weight:
                # crushtool parses weight as float (1.0 = 0x10000)
                tester.device_weight[int(devno)] = int(float(w) * 0x10000)
            tester.output_mappings = args.show_mappings
            tester.output_bad_mappings = args.show_bad_mappings
            tester.output_utilization = args.show_utilization
            tester.output_utilization_all = args.show_utilization_all
            tester.output_statistics = args.show_statistics
            # the reference CLI folds utilization output into statistics
            # mode (crushtool.cc:1271-1274)
            if tester.output_utilization or tester.output_utilization_all:
                tester.output_statistics = True
            return tester.test()

        ap.error("nothing to do with -i (use --test/--tree/-d)")
    except CompileError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
