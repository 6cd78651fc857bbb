"""ec_bench — drop-in CLI for the reference's ceph_erasure_code_benchmark.

Port of tools/ec_bench.py. Accepts the same flags
(ceph_erasure_code_benchmark.cc:40-66) and emits the same output format:
`elapsed_seconds \t KiB_processed` (.cc:179,310), so the reference's sweep
scripts (qa/workunits/erasure-code/bench.sh) can drive the port unmodified:

    python -m ceph_tpu_torch.tools.ec_bench -p isa -P k=8 -P m=3 \
        -P technique=cauchy -s 1048576 -i 100 -w encode

Extensions: --batch N packs N objects into one (N, k, chunk) array call on
the codec's device (default 1 keeps the reference's one-object-at-a-time
behavior); --device picks the device (default cuda).

Workloads:
  encode — encode `iterations` times, print wall seconds and KiB encoded.
  decode — encode once; per iteration erase chunks (at random, from --erased,
           or exhaustively over all combinations with -E exhaustive, verifying
           rebuilt content each time) and decode. With --batch N > 1 (random
           or --erased) each iteration rebuilds the erased chunks of all N
           objects in one `decode_array` call, and every rebuilt chunk is
           checked after the timed loop.

Every plugin of the registry runs here: the RS matrix techniques, jerasure's
liberation / blaum_roth / liber8tion, shec, lrc and clay. Chunk ids given
with --erased are physical ids, as in the byte API.

Profiling (the `bench_profile` knob, e.g. CEPH_TPU_BENCH_PROFILE=true): the
loop runs under torch.profiler (the device's activity; the host's on a CPU
codec) with the codec's hot-path spans on (`common.tracer.hot_spans`), and
one Chrome trace is written into `bench_profile_trace_dir`: the profiler's
events and the spans as host "X" events, on the trace's clock.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import tempfile
import time

import numpy as np
import torch


def parse_args(argv):
    p = argparse.ArgumentParser(
        prog="ec_bench", description="erasure code benchmark (CUDA backend)"
    )
    p.add_argument("-v", "--verbose", action="store_true", help="explain what happens")
    p.add_argument("-s", "--size", type=int, default=1024 * 1024,
                   help="size of the buffer to be encoded")
    p.add_argument("-i", "--iterations", type=int, default=1,
                   help="number of encode/decode runs")
    p.add_argument("-p", "--plugin", default="jerasure",
                   help="erasure code plugin name")
    p.add_argument("-w", "--workload", default="encode",
                   choices=["encode", "decode"], help="run either encode or decode")
    p.add_argument("-e", "--erasures", type=int, default=1,
                   help="number of erasures when decoding")
    p.add_argument("--erased", type=int, action="append", default=[],
                   help="erased chunk (repeat if more than one chunk is erased)")
    p.add_argument("-E", "--erasures-generation", default="random",
                   choices=["random", "exhaustive"], dest="erasures_generation")
    p.add_argument("-P", "--parameter", action="append", default=[],
                   help="add a parameter to the erasure code profile (k=v)")
    p.add_argument("--batch", type=int, default=1,
                   help="extension: objects packed per device launch")
    p.add_argument("--device", default="cuda",
                   help="extension: device the codec runs on (cuda or cpu)")
    return p.parse_args(argv)


def build_profile(params: list[str]) -> dict:
    profile = {}
    for item in params:
        if item.count("=") != 1:
            print(
                f"--parameter {item} ignored because it does not contain "
                "exactly one =",
                file=sys.stderr,
            )
            continue
        key, value = item.split("=")
        profile[key] = value
    return profile


def display_chunks(chunks, chunk_count):
    out = "chunks "
    for chunk in range(chunk_count):
        out += f"({chunk})  " if chunk not in chunks else f" {chunk}   "
    print(out + "(X) is an erased chunk")


def run_encode(ec, args) -> float:
    data = b"X" * args.size
    if args.batch > 1:
        chunks, _ = ec.encode_prepare(data)
        batch = torch.from_numpy(np.repeat(chunks, args.batch, axis=0)).to(ec.device)
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            out = ec.encode_array(batch)
        out[0, 0, :1].cpu()  # waits for the device
        return time.perf_counter() - t0
    want = set(range(ec.get_chunk_count()))
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        ec.encode(want, data)
    return time.perf_counter() - t0


def decode_erasures(ec, all_chunks, chunks, start, want_erasures, verbose):
    """Exhaustive erasure enumeration with verification (.cc:196-244)."""
    n = ec.get_chunk_count()
    if want_erasures == 0:
        if verbose:
            display_chunks(chunks, n)
        want_to_read = {c for c in range(n) if c not in chunks}
        decoded = ec.decode(want_to_read, chunks)
        for c in want_to_read:
            # chunks absent from all_chunks (pre-erased via --erased) cannot
            # be verified; the reference dereferences map.end() here
            if c in all_chunks and decoded[c] != all_chunks[c]:
                raise SystemExit(
                    f"chunk {c} content and recovered content are different"
                )
        return
    for i in range(start, n):
        # the reference recurses even when i is already absent (erase is a
        # no-op but want_erasures still decrements, .cc:234-240)
        one_less = {c: v for c, v in chunks.items() if c != i}
        decode_erasures(ec, all_chunks, one_less, i + 1, want_erasures - 1, verbose)


def run_decode_batch(ec, args) -> float:
    """--batch N > 1: one (N, k+m, chunk) stripe batch on the device; each
    iteration rebuilds the erased chunks of all N objects with one
    decode_array call (logical ids). Rebuilt chunks are checked after the
    timed loop."""
    n = ec.get_chunk_count()
    chunks, _ = ec.encode_prepare(b"X" * args.size)
    batch = torch.from_numpy(np.repeat(chunks, args.batch, axis=0)).to(ec.device)
    full = torch.cat([batch, ec.encode_array(batch)], dim=1)  # logical order
    erased = sorted({ec.logical_index(c) for c in args.erased})
    if args.erased:
        display_chunks({ec.chunk_index(i) for i in range(n)} - set(args.erased), n)
    runs = []
    t0 = time.perf_counter()
    for _ in range(args.iterations):
        lost = erased or sorted(random.sample(range(n), args.erasures))
        present = [i for i in range(n) if i not in lost]
        runs.append((lost, ec.decode_array(present, lost, full[:, present])))
    runs[-1][1][0, 0, :1].cpu()  # waits for the device
    elapsed = time.perf_counter() - t0
    for lost, out in runs:
        if not torch.equal(out, full[:, lost]):
            raise SystemExit(f"chunks {lost}: content and recovered content are different")
    return elapsed


def run_decode(ec, args) -> float:
    if args.batch > 1 and args.erasures_generation != "exhaustive":
        return run_decode_batch(ec, args)
    data = b"X" * args.size
    n = ec.get_chunk_count()
    encoded = ec.encode(range(n), data)
    want_to_read = set(range(n))

    if args.erased:
        for c in args.erased:
            encoded.pop(c, None)
        display_chunks(encoded, n)

    t0 = time.perf_counter()
    for _ in range(args.iterations):
        if args.erasures_generation == "exhaustive":
            decode_erasures(ec, encoded, encoded, 0, args.erasures, args.verbose)
        elif args.erased:
            ec.decode(want_to_read, encoded)
        else:
            chunks = dict(encoded)
            for _ in range(args.erasures):
                while True:
                    erasure = random.randrange(n)
                    if erasure in chunks:
                        break
                del chunks[erasure]
            ec.decode(want_to_read, chunks)
    return time.perf_counter() - t0


def spans_as_trace_events(records: list[tuple], offset_ns: int, base_ns: int) -> list[dict]:
    """Hot-path span records (`perf_counter_ns` stamps) as Chrome-trace "X"
    events on a trace whose `ts` counts microseconds after `base_ns` on the
    wall clock; `offset_ns` is the wall clock less `perf_counter_ns`."""
    pid = os.getpid()
    return [{"ph": "X", "cat": "hot_span", "name": name, "pid": pid, "tid": "codec spans",
             "ts": (start + offset_ns - base_ns) / 1e3, "dur": (end - start) / 1e3,
             "args": {"parent": parent}}
            for name, parent, start, end in records]


def profiled(run, device, trace_dir: str) -> tuple[float, str]:
    """run() under torch.profiler with the hot-path spans on; returns its
    result and the path of the Chrome trace written into `trace_dir`."""
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.common.tracer import hot_spans

    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    hot_spans.drain()
    with profile(activities=[activity]) as prof:
        p0 = time.perf_counter_ns()
        wall = time.time_ns()
        offset_ns = wall - (p0 + time.perf_counter_ns()) // 2
        elapsed = run()
    records = hot_spans.drain()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"ec_bench.{os.getpid()}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"] += spans_as_trace_events(records, offset_ns, base_ns)
    with open(path, "w") as f:
        json.dump(doc, f)
    return elapsed, path


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from ceph_tpu_torch.common.config import config
    from ceph_tpu_torch.ec.registry import factory

    ec = factory(args.plugin, build_profile(args.parameter), device=args.device)

    def run():
        if args.workload == "encode":
            return run_encode(ec, args)
        return run_decode(ec, args)

    # profiling hook (SURVEY §5), the analogue of the reference's LTTng
    # tracepoints around the op loop
    if config.get("bench_profile"):
        trace_dir = (config.get("bench_profile_trace_dir")
                     or os.path.join(tempfile.gettempdir(), "ceph_tpu_torch_trace"))
        elapsed, path = profiled(run, ec.device, trace_dir)
        print(f"# torch.profiler trace with the codec's spans written to {path}",
              file=sys.stderr)
    else:
        elapsed = run()
    kib = args.iterations * (args.size // 1024) * max(1, args.batch)
    print(f"{elapsed:.6f}\t{kib}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
