"""Runs one cell in sets of runs, as a check does, and reports each metric's
spread: the tool that the bounds in BENCHMARK.json are set with.

    python3 benchmark/sets.py --workload <name> --seeds <n> ... [--sets 2] [--seconds 10]
        [--trace 0] [--out bench_out/sets]

Each run is its own process (`benchmark/run.py`), one after another; every
set runs the same seeds in the same order. Per set and metric it prints
the median and the spread (the distance between the quartiles of
`statistics.quantiles(values, n=4)`, as a share of the median), and per
metric the widest spread over the sets and five times it, the bound that
spread suggests (never under 1%). Each run's result line and the end of
its standard error are written under --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one_run(workload: str, seed: int, seconds: float, trace: int) -> tuple[dict | None, str, float]:
    cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return result, out.stderr[-4000:], wall


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="runs a cell in sets and reports spreads")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=os.path.join(ROOT, "bench_out", "sets"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    values: list[dict[str, list[float]]] = []
    runs = []
    for s in range(args.sets):
        per: dict[str, list[float]] = {}
        for seed in args.seeds:
            result, err, wall = one_run(args.workload, seed, args.seconds, args.trace)
            tag = f"{args.workload}.t{args.trace}.set{s}.{seed}"
            with open(os.path.join(args.out, tag + ".err"), "w") as f:
                f.write(err)
            runs.append({"set": s, "seed": seed, "wall_s": wall, "result": result})
            if result is None:
                print(f"set {s} seed {seed}: no result\n{err[-1500:]}", flush=True)
                continue
            print(f"set {s} seed {seed} correct {result['correct']} wall {wall:.1f} s "
                  + " ".join(f"{k} {v['value']!r}" for k, v in result["metrics"].items()),
                  flush=True)
            for k, v in result["metrics"].items():
                per.setdefault(k, []).append(v["value"])
        values.append(per)
    summary = {}
    for name in sorted({k for per in values for k in per}):
        sets = [per.get(name, []) for per in values]
        spreads = [yardstick.spread(v) if len(v) >= 2 else None for v in sets]
        medians = [statistics.median(v) if v else None for v in sets]
        widest = max((x for x in spreads if x is not None), default=None)
        summary[name] = {"medians": medians, "spreads": spreads, "widest": widest,
                         "bound_5x": None if widest is None else max(0.01, 5 * widest)}
        print(f"{name}: medians {medians} spreads {spreads} widest {widest}", flush=True)
    with open(os.path.join(args.out, f"{args.workload}.t{args.trace}.summary.json"), "w") as f:
        json.dump({"workload": args.workload, "seconds": args.seconds, "runs": runs,
                   "summary": summary}, f, indent=1)
    return 0 if all(r["result"] and r["result"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
