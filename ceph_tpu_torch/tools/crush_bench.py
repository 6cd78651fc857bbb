"""crush_bench — BASELINE config 5 on the port: straw2 mapping of 1M PGs over
a 10k-OSD map.

    python -m ceph_tpu_torch.tools.crush_bench [--pgs 1000000] [--osds 10000]
        [--replicas 3] [--mode firstn|indep] [--device cuda|cpu] [--repeats 3]

The map is tools/crush_bench.py's build_map: hosts of 50 straw2 OSDs under
one straw2 root, jewel tunables, and rule 0 = take root, chooseleaf <mode> 0
type host, emit (`--mode indep --replicas 11` is the placement of an RS(8,3)
erasure-coded pool). Prints one JSON line per measurement: the best of
`--repeats` timed torch_mapper.map_rule calls over x = 0..pgs-1 (host to
host: the x upload, every stage's kernel and the result's assembly), with
the device's name and, on a card, nvidia-smi's power limit.

tools/crush_bench.py also times the reference C mapper (bench_c, bench_c_mt)
and checks against it (validate); that needs the reference's sources and a C
compiler, which the port's machines do not have, so it is left out here. The
port's own tests hold map_rule against the scalar mapper instead.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.crush import builder as cb
from ceph_tpu_torch.crush import torch_mapper as tm
from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
from ceph_tpu_torch.device import resolve_device


def build_map(n_osds: int, osds_per_host: int = 50, mode: str = "firstn") -> CrushMap:
    """n_osds/50 straw2 hosts of 50 OSDs (weight 1.0) under straw2 root -1,
    jewel tunables; rule 0 chooses `mode` leaves over hosts."""
    cmap = CrushMap(tunables=Tunables.jewel())
    host_ids, host_w = [], []
    osd = 0
    for h in range(n_osds // osds_per_host):
        items = list(range(osd, osd + osds_per_host))
        osd += osds_per_host
        b = cb.make_bucket(
            cmap, -(h + 2), BucketAlg.STRAW2, 1, items, [0x10000] * osds_per_host
        )
        host_ids.append(b.id)
        host_w.append(b.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, host_ids, host_w)
    cb.make_simple_rule(cmap, 0, -1, 1, mode, 0)
    return cmap


def device_label(dev: torch.device) -> tuple[str, str | None]:
    """(name, power limit) of the device: nvidia-smi's for a card."""
    if dev.type != "cuda":
        return "cpu", None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(dev), smi.split(",")[-1].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crush_bench")
    ap.add_argument("--pgs", type=int, default=1_000_000)
    ap.add_argument("--osds", type=int, default=10_000)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--mode", choices=("firstn", "indep"), default="firstn")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cmap = build_map(args.osds, mode=args.mode)
    weight = [0x10000] * args.osds
    compiled = tm.compile_map(cmap, device=dev)
    xs = np.arange(args.pgs)
    tm.map_rule(compiled, 0, xs[:4096], weight, args.replicas)  # build + warm
    best = float("inf")
    for _ in range(max(args.repeats, 1)):
        t0 = time.perf_counter()
        out = tm.map_rule(compiled, 0, xs, weight, args.replicas)
        best = min(best, time.perf_counter() - t0)
    placed = int((out != tm.CRUSH_ITEM_NONE).sum())
    name, power = device_label(dev)
    print(json.dumps({
        "metric": "crush_straw2_mappings_per_s",
        "value": args.pgs / best,
        "unit": "mappings/s",
        "seconds": best,
        "pgs": args.pgs, "osds": args.osds, "replicas": args.replicas,
        "mode": args.mode, "placed": placed,
        "device": name, "power_limit": power,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
