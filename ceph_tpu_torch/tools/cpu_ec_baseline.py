"""Measure the in-repo CPU erasure-code baselines of the host it runs on.

Two measured numbers for RS(8,3) encode, single thread:

  1. `numpy`  — the pure-numpy GF(2^8) oracle (ceph_tpu_torch.ops.gf.gf_matmul),
     log/antilog table gathers: the slow correctness reference.
  2. `c-xor`  — native/ec_cpu_baseline.c: bit-plane XOR-schedule encode in
     64-bit words, the same algorithm class as the reference's jerasure
     bitmatrix techniques (ErasureCodeJerasure.cc:305 prepare_schedule),
     built with -march=native into `_build/` (keyed on the source, the
     flags and the host CPU's model and feature flags). It is the single-core CPU number a device
     codec is set beside.

Usage: python -m ceph_tpu_torch.tools.cpu_ec_baseline [--size BYTES_PER_CHUNK]
[--iters N]. Prints one JSON line with both GB/s figures and the host CPU's
model (from /proc/cpuinfo): the numbers are the host's, not a card's.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import time

import numpy as np

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.native import build
from ceph_tpu_torch.ops import gf

K, M = 8, 3
SOURCE = os.path.join(build.NATIVE_DIR, "ec_cpu_baseline.c")
FLAGS = ["-O3", "-march=native"]


def _cpuinfo(field: str) -> str | None:
    """The value of the first `field` line of /proc/cpuinfo, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == field:
                    return value.strip()
    except OSError:
        pass
    return None


def cpu_model() -> str:
    """The host CPU as /proc/cpuinfo names it: model name (vendor, family,
    model), else platform's guess."""
    name = _cpuinfo("model name") or platform.processor() or platform.machine()
    ids = [_cpuinfo(f) for f in ("vendor_id", "cpu family", "model")]
    if any(ids):
        name += f" ({ids[0]}, family {ids[1]}, model {ids[2]})"
    return name


def build_baseline() -> str | None:
    """The baseline program in `_build/`, built on first use; None without
    a C compiler or when the build fails."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        return None
    # -march=native: the key holds the CPU's model and feature flags, so a
    # program built for another host's CPU is never run
    key = build.source_key(SOURCE, FLAGS + [cpu_model(), _cpuinfo("flags") or ""])
    out = os.path.join(build.BUILD_DIR, f"ec_cpu_baseline-{key}")
    if not os.path.exists(out):
        try:
            build.compile_into([cc, *FLAGS], out, SOURCE)
        except subprocess.CalledProcessError:
            return None
    return out


def measure_numpy(chunk: int, iters: int) -> float:
    rng = np.random.default_rng(0)
    parity = matrices.build_parity_matrix("isa_cauchy", K, M)
    data = rng.integers(0, 256, (K, chunk), np.uint8)
    gf.gf_matmul(parity, data)  # warm tables
    t0 = time.perf_counter()
    for _ in range(iters):
        gf.gf_matmul(parity, data)
    dt = time.perf_counter() - t0
    return K * chunk * iters / dt / 1e9


def measure_c(chunk: int, iters: int) -> float | None:
    out = build_baseline()
    if out is None:
        return None
    parity = matrices.build_parity_matrix("isa_cauchy", K, M)
    bits = gf.matrix_to_bitmatrix(parity)
    psize = 2048  # jerasure default packetsize (ErasureCodeJerasure.h:140)
    feed = f"{K} {M} {psize} {iters} {chunk}\n" + " ".join(
        str(int(v)) for v in bits.reshape(-1)
    )
    best = None
    for _ in range(3):
        proc = subprocess.run(
            [out], input=feed, capture_output=True, text=True, check=True
        )
        el = float(proc.stdout.strip())
        best = el if best is None else min(best, el)
    return K * chunk * iters / best / 1e9


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1 << 22,
                    help="bytes per chunk (default 4 MiB)")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    numpy_gbps = measure_numpy(args.size, max(1, args.iters // 4))
    c_gbps = measure_c(args.size, args.iters)
    print(json.dumps({
        "config": f"RS({K},{M}) encode, {args.size} B chunks, single thread",
        "cpu": cpu_model(),
        "numpy_gbps": round(numpy_gbps, 3),
        "c_xor_gbps": round(c_gbps, 3) if c_gbps else None,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
