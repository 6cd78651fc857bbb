"""Runs one cell of the benchmark of ceph_tpu_torch and prints its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The run makes its inputs from the seed, builds the codec,
warms every job of the cell (set-up, reported as `setup_s`), measures for
`--seconds`, judges the outputs against the plain reference, and prints as
the last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number beside its limit. The same numbers are the
last lines of standard error. Without a card it prints no result and exits
with 2.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_environment(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout (the program's own
    nvcc builds already go to ceph_tpu_torch/_build/ there)."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_environment(harness.ROOT)
    if harness.ROOT not in sys.path:
        sys.path.insert(1, harness.ROOT)
    import torch

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device, STARTED)
    if "error" in result:
        print(result["error"], file=sys.stderr)
        return 3
    print(f"device {result['device']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
