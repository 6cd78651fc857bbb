#!/usr/bin/env python3
"""chip_smoke.py — drive ceph_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Two main paths, each driven with the launch counts zeroed just before it and
read just after. The RS erasure-code data path as an OSD meets it: the
plugin registry (`factory("isa", k=8 m=3 technique=cauchy)`), the batching
`EncodeService`, and the hand-written GF(2^8) CUDA kernel under both. Then
CRUSH placement as `crushtool --test` meets it (BASELINE config 5: 1M x over
a 10k-OSD straw2 map): `CrushTester`, the port's crushtool and
`torch_mapper.map_rule`, over the hand-written straw2 choose kernel. Phases:

  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build every kernel under ceph_tpu_torch/csrc with nvcc (ptxas report);
  3. each kernel against its plain torch version on the card, bit-exact, at
     the main path's shapes and a few others, and a column window against the
     numpy GF(2^8) oracle;
  4. the main path, with launch counts zeroed just before and read just
     after: 64 concurrent 4 MiB objects through EncodeService.encode (one
     launch), the rebuild of data chunks {0,1,2} of all 64 through
     EncodeService.decode (one launch), a byte-API round trip of one object,
     and the port's ec_bench in encode and decode;
  5. times (CUDA events): the kernel beside its memory bound, its plain
     version, and the EncodeService batch split into host pack,
     host-to-device copy, kernel, device-to-host copy, the per-chunk result
     bytes, and the rest of the flush (its encode_batch tracer span), beside
     the whole warm encode;
  6. the CRUSH choose kernel against its plain torch version on the card,
     bit-exact, stage by stage: firstn and indep, chooseleaf and not, static
     and chained starts, reweighted devices, weight-set positions > 1 through
     choose_args, and run-time weight-sets, on the 10k-OSD map and small maps;
  7. the CRUSH main path over x = 0..999999 on the 10k-OSD map, for rule 0
     (BASELINE's chooseleaf firstn over hosts, 3 replicas) and rule 1 (a
     chooseleaf indep over hosts rule with 11 positions: the placement of an
     RS(8,3) pool): CrushTester --show-statistics, the port's crushtool
     --test, and map_rule; no rule may go to the scalar mapper;
  8. its outputs: all 1M rows of map_rule equal the plain version on the
     card, the first 4096 x equal the scalar mapper, and the tester's and
     crushtool's outputs agree;
  9. times (CUDA events; host clock for whole calls): each stage's kernel
     beside its operation bound (the straw2 draws the run made, counted by
     the kernel, times the integer operations per draw in its source, over
     the INT32 rate), its plain version, map_rule mappings/s, and the
     tester run split into mapping and host aggregation;
  10. a `kernels` JSON line; 11. the `ok` JSON line, last.

Any failed phase raises, so the script exits non-zero and prints no result.
It needs a CUDA card and the repository around it; with neither it fails.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
K, M = 8, 3
PROFILE = {"k": str(K), "m": str(M), "technique": "cauchy"}
OBJECTS = 64
OBJECT_BYTES = 4 << 20
N4 = 8 << 20  # int32 words per planar row of the 64-object batch
ERASED = (0, 1, 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TIMED_LAUNCHES = 50

CRUSH_OSDS = 10_000
CRUSH_X = 1_000_000
#: (rule, result_max): BASELINE's replicated rule and an RS(8,3) EC rule
CRUSH_RULES = ((0, 3), (1, K + M))
SCALAR_CHECK = 4096
#: H100 SXM: 132 SMs x 64 INT32 lanes per SM per clock x 1.98 GHz boost
#: (NVIDIA Hopper architecture whitepaper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: integer operations of one straw2 draw in csrc/crush_choose.cu, counted
#: from the source on its shortest path (a 64-bit operation counts once)
OPS_PER_DRAW = {
    "hash32_3: 3 seed xors, 5 mixes of 9 x (2 sub, shift, xor), mask": 3 + 5 * 36 + 1,
    "crush_ln: +1, range test, 4 index ops, 64-bit mul, >>48, &0xFF, 5 adds/shifts": 14,
    "draw: weight test, -2^48, negate, 64-bit divide, negate": 5,
    "argmax compare and the slot loop": 6,
}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


class SpanTimes:
    """A duck-typed tracer for EncodeService: keeps each span's seconds by
    name (the service opens encode_wait per op and encode_batch per flush)."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}

    def child(self, name, tags=None):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: SpanTimes, name: str):
        self.owner, self.name, self.t0 = owner, name, time.perf_counter()

    def set_tag(self, key, value) -> None:
        pass

    def finish(self) -> None:
        self.owner.seconds.setdefault(self.name, []).append(
            time.perf_counter() - self.t0)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_words(rows: int, n4: int, gen: torch.Generator) -> torch.Tensor:
    data = torch.randint(0, 256, (rows, n4 * 4), dtype=torch.uint8,
                         device="cuda", generator=gen)
    return data.view(torch.int32)


def check_kernel(name, gc, packed, tables, words) -> int:
    """Kernel vs plain version on the same card tensors; returns the max
    absolute byte difference (0, or the phase fails)."""
    got = gc.gf_matmul_packed(packed, words, tables=tables)
    torch.cuda.synchronize()
    want = gc.gf_matmul_packed_plain(packed, words)
    torch.cuda.synchronize()
    err = int((got.view(torch.uint8).to(torch.int16)
               - want.view(torch.uint8).to(torch.int16)).abs().max())
    print(f"  {name}: words {tuple(words.shape)} -> {tuple(got.shape)}, "
          f"max_abs_err {err}, equal {torch.equal(got, want)}", flush=True)
    if not torch.equal(got, want):
        raise AssertionError(f"kernel != plain for {name}")
    return err


def phase_kernels(gc, gf, codec, factory) -> int:
    """Phase 3: every comparison of the kernel with its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    words = random_words(K, N4, gen)
    enc = codec._encode
    errs = [check_kernel("isa cauchy RS(8,3) encode", gc, enc.packed_t,
                         enc.tables_t, words)]
    # a column window of the same launch against the numpy oracle
    got = gc.gf_matmul_packed(enc.packed_t, words, tables=enc.tables_t)
    window = slice(12345, 12345 + 4096)
    data_bytes = words[:, window].contiguous().view(torch.uint8).cpu().numpy()
    out_bytes = got[:, window].contiguous().view(torch.uint8).cpu().numpy()
    if not np.array_equal(out_bytes, gf.gf_matmul(codec._gen[K:], data_bytes)):
        raise AssertionError("kernel disagrees with the numpy GF(2^8) oracle")
    print("  oracle window: equal True", flush=True)

    present = [i for i in range(K + M) if i not in ERASED][:K]
    dec = codec.decode_bitmatrix(present, list(ERASED))
    errs.append(check_kernel("decode of erased {0,1,2}", gc, dec.packed_t,
                             dec.tables_t, words))

    jer = factory("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"})
    errs.append(check_kernel("jerasure reed_sol_van k=4 m=2", gc,
                             jer._encode.packed_t, jer._encode.tables_t,
                             words[:4].contiguous()))

    rng = np.random.default_rng(SEED)
    bitmat = (rng.random((8 * M, 8 * K)) < 0.5).astype(np.int8)
    errs.append(check_kernel(
        "random {0,1} bit-matrix", gc,
        torch.from_numpy(gc.pack_matrix(bitmat)).cuda(),
        torch.from_numpy(gc.nibble_tables(bitmat)).cuda(), words))

    ragged = random_words(K, N4 + 37, gen)
    errs.append(check_kernel("ragged N4 = 8 Mi + 37", gc, enc.packed_t,
                             enc.tables_t, ragged))
    return max(errs)


def phase_main_path(codec, EncodeService, ec_bench) -> tuple[list[bytes], dict]:
    """Phase 4: the slice end to end through its user entry points."""
    blob = np.random.default_rng(SEED).bytes(OBJECTS * OBJECT_BYTES)
    objs = [blob[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES] for i in range(OBJECTS)]
    svc = EncodeService()

    async def encode_all():
        return await asyncio.gather(*(svc.encode(codec, o) for o in objs))

    t0 = time.perf_counter()
    encoded = asyncio.run(encode_all())
    enc_s = time.perf_counter() - t0
    print(f"  EncodeService.encode: {OBJECTS} x {OBJECT_BYTES} B objects, "
          f"launches {svc.launches}, objects {svc.objects}, {enc_s:.4f} s", flush=True)
    if (svc.launches, svc.objects) != (1, OBJECTS):
        raise AssertionError(f"encode took {svc.launches} launches")

    survivors = [{i: c for i, c in e.items() if i not in ERASED} for e in encoded]

    async def decode_all():
        return await asyncio.gather(
            *(svc.decode(codec, set(ERASED), s) for s in survivors))

    t0 = time.perf_counter()
    rebuilt = asyncio.run(decode_all())
    dec_s = time.perf_counter() - t0
    print(f"  EncodeService.decode of chunks {set(ERASED)}: launches "
          f"{svc.launches - 1}, objects {svc.objects - OBJECTS}, {dec_s:.4f} s",
          flush=True)
    if (svc.launches, svc.objects) != (2, 2 * OBJECTS):
        raise AssertionError(f"decode took {svc.launches - 1} launches")
    for e, r in zip(encoded, rebuilt):
        if any(r[i] != e[i] for i in ERASED):
            raise AssertionError("decode did not rebuild the erased chunks")

    # byte API on one object: encode -> erase -> decode_concat
    chunks = codec.encode(range(K + M), objs[0])
    if chunks != encoded[0]:
        raise AssertionError("byte-API chunks differ from EncodeService's")
    back = codec.decode_concat({i: c for i, c in chunks.items() if i not in ERASED})
    if back[:OBJECT_BYTES] != objs[0]:
        raise AssertionError("byte-API round trip lost data")
    print("  byte API encode -> erase {0,1,2} -> decode_concat: equal True", flush=True)

    bench = ["-p", "isa", "-P", "k=8", "-P", "m=3", "-P", "technique=cauchy",
             "-s", str(OBJECT_BYTES), "-i", "4"]
    for workload in (["-w", "encode"], ["-w", "decode", "-e", "3"]):
        print(f"  ec_bench {' '.join(bench + workload)}:", flush=True)
        if ec_bench.main(bench + workload) != 0:
            raise AssertionError("ec_bench failed")
    return objs, encoded[0]


def check_outputs(codec, gf, objs, chunks0) -> None:
    """Phase 4b: object 0's parity against the numpy table oracle."""
    bs = len(chunks0[0])
    planes = np.frombuffer(objs[0], dtype=np.uint8).reshape(K, bs)
    want = gf.gf_region_matmul(codec._gen[K:], planes)
    for i in range(M):
        if chunks0[K + i] != want[i].tobytes():
            raise AssertionError(f"parity chunk {K + i} disagrees with the oracle")
    print(f"  parity of object 0 vs numpy oracle: equal True ({bs} B chunks)", flush=True)


def phase_times(gc, codec, es, smi: str) -> dict:
    """Phase 5: kernel, plain version and EncodeService batch split."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    words = random_words(K, N4, gen)
    enc = codec._encode
    kernel_ms = cuda_ms(
        lambda: gc.gf_matmul_packed(enc.packed_t, words, tables=enc.tables_t),
        TIMED_LAUNCHES)
    plain_ms = cuda_ms(lambda: gc.gf_matmul_packed_plain(enc.packed_t, words), 3)
    moved = (K + M) * N4 * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"  [{smi}] gf_matmul_packed ({K}, {N4}) -> ({M}, {N4}) int32: "
          f"kernel {kernel_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({moved} B at 3.35 TB/s), roofline share {bound_ms / kernel_ms:.3f}, "
          f"{moved / kernel_ms / 1e6:.1f} GB/s; plain {plain_ms:.3f} ms; "
          "library call: none", flush=True)

    # EncodeService batch split, stage by stage, on the main path's batch shape
    blob = np.random.default_rng(SEED + 2).bytes(OBJECTS * OBJECT_BYTES)
    items = [(blob[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES], OBJECT_BYTES // K)
             for i in range(OBJECTS)]
    t0 = time.perf_counter()
    planes = es.pack_objects(K, items)
    pack_ms = (time.perf_counter() - t0) * 1e3
    host = torch.from_numpy(planes.view(np.int32))
    h2d_ms = cuda_ms(lambda: host.to("cuda"), 3)
    dev = host.to("cuda")
    kern_ms = cuda_ms(lambda: codec.encode_words(dev), 10)
    out = codec.encode_words(dev)
    d2h_ms = cuda_ms(lambda: out.cpu(), 3)
    # result assembly as the flush does it: one bytes object per chunk
    parity = out.cpu().numpy().view(np.uint8).reshape(M, -1)
    bs = OBJECT_BYTES // K
    t0 = time.perf_counter()
    results = [
        [planes[i, j * bs:(j + 1) * bs].tobytes() for i in range(K)]
        + [parity[i, j * bs:(j + 1) * bs].tobytes() for i in range(M)]
        for j in range(OBJECTS)
    ]
    bytes_ms = (time.perf_counter() - t0) * 1e3
    del results

    # the whole batch through the service, warm: what a burst of writes waits
    spans = SpanTimes()
    svc = es.EncodeService(tracer=spans)

    async def encode_all():
        return await asyncio.gather(*(svc.encode(codec, d) for d, _bs in items))

    t0 = time.perf_counter()
    asyncio.run(encode_all())
    total_ms = (time.perf_counter() - t0) * 1e3
    flush_ms = spans.seconds["encode_batch"][0] * 1e3
    rest_ms = flush_ms - pack_ms - h2d_ms - kern_ms - d2h_ms - bytes_ms
    print(f"  [{smi}] EncodeService batch of {OBJECTS} x 4 MiB: host pack "
          f"{pack_ms:.3f} ms, H2D {h2d_ms:.3f} ms, kernel {kern_ms:.4f} ms, "
          f"D2H {d2h_ms:.3f} ms, result bytes {bytes_ms:.3f} ms; flush "
          f"(encode_batch span) {flush_ms:.3f} ms, so the rest of the flush "
          f"{rest_ms:.3f} ms; "
          f"whole encode {total_ms:.3f} ms "
          f"({OBJECTS * OBJECT_BYTES / total_ms / 1e6:.3f} GB/s of object data), "
          f"outside the flush {total_ms - flush_ms:.3f} ms", flush=True)
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


# -- the CRUSH path -------------------------------------------------------------


def stage_params(cmap, firstn, numrep, want_type, recurse):
    """The choose-stage parameters map_rule derives for a rule step."""
    t = cmap.tunables
    tries = t.choose_total_tries + 1
    recurse_tries = (1 if t.chooseleaf_descend_once else tries) if firstn else 1
    return dict(firstn=firstn, numrep=numrep, want_type=want_type,
                recurse=recurse, tries=tries, recurse_tries=recurse_tries,
                vary_r=t.chooseleaf_vary_r, stable=t.chooseleaf_stable,
                out_slots=numrep)


def small_maps(cb, T):
    """Small maps of the test suite's shapes: hosts under a root with
    choose_args (ids and two weight-set positions), and racks of hosts
    under firefly tunables (stable 0)."""
    rng = np.random.default_rng(SEED)

    def bucket(cmap, bid, typ, items, weights):
        return cb.make_bucket(cmap, bid, T.BucketAlg.STRAW2, typ, items, weights)

    args = T.CrushMap(tunables=T.Tunables.jewel())
    hosts = [bucket(args, -2 - h, 1, [4 * h + i for i in range(4)],
                    [int(w) for w in rng.integers(1, 8 * 0x10000, 4)]) for h in range(6)]
    root = bucket(args, -1, 10, [b.id for b in hosts], [b.weight for b in hosts])
    args.choose_args[-1] = T.ChooseArg(
        ids=[100 + i for i in range(root.size)],
        weight_set=[[int(w) for w in rng.integers(1, 8 * 0x10000, root.size)]
                    for _ in range(2)])
    for b in hosts:
        args.choose_args[b.id] = T.ChooseArg(
            weight_set=[[int(w) for w in rng.integers(1, 8 * 0x10000, b.size)]])

    racks = T.CrushMap(tunables=T.Tunables.firefly())
    osd, bid, rack_ids, rack_w = 0, -2, [], []
    for _ in range(4):
        hs = []
        for _ in range(3):
            hs.append(bucket(racks, bid, 1, [osd, osd + 1],
                             [int(w) for w in rng.integers(1, 6 * 0x10000, 2)]))
            osd, bid = osd + 2, bid - 1
        rb = bucket(racks, bid, 2, [b.id for b in hs], [b.weight for b in hs])
        bid -= 1
        rack_ids.append(rb.id)
        rack_w.append(rb.weight)
    bucket(racks, -1, 10, rack_ids, rack_w)
    return args, racks


def check_stage(name, cc, tm, cm, xs, start, wv, params, rt=None):
    """Kernel vs plain version of one stage on the same card tensors;
    returns (max_abs_err, kernel outputs). Fails unless bit-exact."""
    got = cc.crush_choose(cm, xs, start, wv, rt=rt, **params)
    torch.cuda.synchronize()
    want = tm.choose_stage_plain(cm, xs, start, wv, rt=rt, **params)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"  {name}: x {xs.shape[0]}, out {tuple(got[0].shape)}, "
          f"max_abs_err {err}, equal {equal}", flush=True)
    if not equal:
        raise AssertionError(f"crush_choose kernel != plain for {name}")
    return err, got


def phase_crush_kernels(cc, tm, cb, T, big) -> int:
    """Phase 6: every comparison of the choose kernel with its plain version."""
    cm = tm.compile_map(big, device="cuda")
    xs = torch.arange(1 << 16, dtype=torch.int32, device="cuda") * 3 + 1
    wv = torch.full((CRUSH_OSDS,), 0x10000, dtype=torch.int64, device="cuda")
    firstn = stage_params(big, True, 3, 1, True)
    errs = [check_stage("10k: chooseleaf firstn 3 over hosts", cc, tm, cm, xs, -1, wv, firstn)[0]]
    errs.append(check_stage("10k: chooseleaf indep 11 over hosts", cc, tm, cm, xs, -1, wv,
                            stage_params(big, False, K + M, 1, True))[0])
    err, (hosts, _) = check_stage("10k: choose firstn 3 hosts", cc, tm, cm, xs, -1, wv,
                                  stage_params(big, True, 3, 1, False))
    errs.append(err)
    errs.append(check_stage("10k: chained choose firstn 2 osds per host", cc, tm, cm, xs,
                            hosts[:, 0].contiguous(), wv,
                            stage_params(big, True, 2, 0, False))[0])
    errs.append(check_stage("10k: chained choose indep 2 osds per host", cc, tm, cm, xs,
                            hosts[:, 1].contiguous(), wv,
                            stage_params(big, False, 2, 0, False))[0])
    reweighted = wv.clone()
    reweighted[::7] = 0x8000
    reweighted[:50] = 0  # host -2 out
    errs.append(check_stage("10k: chooseleaf firstn, reweighted and out osds", cc, tm, cm,
                            xs, -1, reweighted, firstn)[0])
    rt = tm.runtime_weight_arrays(cm, {-2 - h: [[0x8000] * 50] for h in range(0, 200, 3)})
    errs.append(check_stage("10k: chooseleaf firstn, run-time weight-sets", cc, tm, cm, xs,
                            -1, wv, firstn, rt)[0])

    args, racks = small_maps(cb, T)
    cm_args = tm.compile_map(args, device="cuda")
    wv_args = torch.full((args.max_devices,), 0x10000, dtype=torch.int64, device="cuda")
    errs.append(check_stage("choose_args: chooseleaf firstn 3, positions 2", cc, tm, cm_args,
                            xs, -1, wv_args, stage_params(args, True, 3, 1, True))[0])
    errs.append(check_stage("choose_args: chooseleaf indep 4", cc, tm, cm_args, xs, -1,
                            wv_args, stage_params(args, False, 4, 1, True))[0])
    sets = {bid: [[w // 3 + 1 for w in row] for row in ca.weight_set] * 3
            for bid, ca in args.choose_args.items()}
    errs.append(check_stage("choose_args: run-time weight-sets, 3 positions", cc, tm,
                            cm_args, xs, -1, wv_args, stage_params(args, True, 3, 1, True),
                            tm.runtime_weight_arrays(cm_args, sets))[0])
    cm_racks = tm.compile_map(racks, device="cuda")
    wv_racks = torch.full((racks.max_devices,), 0x10000, dtype=torch.int64, device="cuda")
    wv_racks[:2] = 0
    err, (rk, _) = check_stage("racks (firefly): choose firstn 2 racks", cc, tm, cm_racks,
                               xs, -1, wv_racks, stage_params(racks, True, 2, 2, False))
    errs.append(err)
    for j in range(2):
        errs.append(check_stage(f"racks (firefly): chained chooseleaf firstn 2, rack {j}",
                                cc, tm, cm_racks, xs, rk[:, j].contiguous(), wv_racks,
                                stage_params(racks, True, 2, 1, True))[0])
    return max(errs)


def _scalar_rows(job):
    """Worker: the port's scalar mapper over x in [lo, hi)."""
    from ceph_tpu_torch.crush import mapper as sm

    cmap, rule, result_max, lo, hi = job
    weight = [0x10000] * cmap.max_devices
    ws = sm.Workspace()
    return [sm.do_rule(cmap, rule, x, weight, result_max, ws) for x in range(lo, hi)]


def phase_crush_main(tm, crushtool, CrushTester, text_map, path) -> dict:
    """Phase 7: CrushTester, the crushtool main (what `python -m
    ceph_tpu_torch.tools.crushtool` runs) and map_rule over 1M x."""
    out = {}
    weight = [0x10000] * CRUSH_OSDS
    compiled = tm.compile_map_cached(text_map, device="cuda")
    for rule, result_max in CRUSH_RULES:
        buf = io.StringIO()
        tester = CrushTester(text_map, device="cuda", min_x=0, max_x=CRUSH_X - 1,
                             min_rule=rule, max_rule=rule, min_rep=result_max,
                             max_rep=result_max, output_statistics=True, out=buf)
        t0 = time.perf_counter()
        tester.test()
        tester_s = time.perf_counter() - t0
        print(f"  CrushTester rule {rule} num_rep {result_max} x 0..{CRUSH_X - 1}: "
              f"{tester_s:.4f} s, scalar-path rules {tester.scalar_rules}", flush=True)
        for line in buf.getvalue().splitlines():
            print(f"    {line}", flush=True)
        if tester.scalar_rules:
            raise AssertionError("the tester sent a rule to the scalar mapper")
        argv = ["-i", path, "--test", "--rule", str(rule), "--num-rep", str(result_max),
                "--min-x", "0", "--max-x", str(CRUSH_X - 1), "--show-statistics",
                "--device", "cuda"]
        tool_out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tool_out):
            rc = crushtool.main(argv)
        tool_s = time.perf_counter() - t0
        print(f"  crushtool {' '.join(argv[2:])}: rc {rc}, {tool_s:.4f} s, "
              f"output equals the tester's {tool_out.getvalue() == buf.getvalue()}",
              flush=True)
        if rc != 0 or tool_out.getvalue() != buf.getvalue():
            raise AssertionError("crushtool --test disagrees with CrushTester")
        t0 = time.perf_counter()
        rows, lengths = tm.map_rule(compiled, rule, np.arange(CRUSH_X), weight,
                                    result_max, return_lengths=True)
        map_s = time.perf_counter() - t0
        print(f"  map_rule rule {rule}: {rows.shape}, {map_s:.4f} s cold", flush=True)
        out[rule] = dict(rows=rows, lengths=lengths, tester_s=tester_s,
                         tester_map_s=tester.map_seconds, tool_s=tool_s,
                         report=buf.getvalue())
    return out


def phase_crush_outputs(tm, big, main) -> tuple[int, dict]:
    """Phase 8: map_rule's rows against the plain version on the card (all
    1M x) and the scalar mapper (the first 4096 x); returns the max abs err
    and the plain version's ms per stage."""
    cm = tm.compile_map(big, device="cuda")
    xs = torch.arange(CRUSH_X, dtype=torch.int32, device="cuda")
    wv = torch.full((CRUSH_OSDS,), 0x10000, dtype=torch.int64, device="cuda")
    plain_ms, err = {}, 0
    for (rule, result_max), firstn in zip(CRUSH_RULES, (True, False)):
        params = stage_params(big, firstn, result_max, 1, True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        leaves = torch.cat([
            tm.choose_stage_plain(cm, xs[lo:lo + (1 << 18)], -1, wv, **params)[1]
            for lo in range(0, CRUSH_X, 1 << 18)])
        end.record()
        torch.cuda.synchronize()
        plain_ms[rule] = start.elapsed_time(end)
        want, _ = tm._assemble_blocks([(firstn, leaves.cpu().numpy())], CRUSH_X, result_max)
        rows = main[rule]["rows"]
        err = max(err, int(np.abs(rows.astype(np.int64) - want.astype(np.int64)).max()))
        equal = np.array_equal(rows, want)
        print(f"  rule {rule}: map_rule rows == plain version on the card for all "
              f"{CRUSH_X} x: {equal} (plain {plain_ms[rule]:.1f} ms)", flush=True)
        if not equal:
            raise AssertionError(f"rule {rule}: map_rule != plain version")

    workers = min(8, os.cpu_count() or 1)
    step = -(-SCALAR_CHECK // workers)
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        for rule, result_max in CRUSH_RULES:
            jobs = [(big, rule, result_max, lo, min(lo + step, SCALAR_CHECK))
                    for lo in range(0, SCALAR_CHECK, step)]
            want = [row for part in pool.map(_scalar_rows, jobs) for row in part]
            rows, lengths = main[rule]["rows"], main[rule]["lengths"]
            bad = [x for x in range(SCALAR_CHECK)
                   if rows[x, :lengths[x]].tolist() != want[x]]
            print(f"  rule {rule}: first {SCALAR_CHECK} x equal the scalar mapper: "
                  f"{not bad}", flush=True)
            if bad:
                raise AssertionError(f"rule {rule}: x {bad[0]} differs from do_rule")
        pool.close()
        pool.join()
    for rule, result_max in CRUSH_RULES:
        sizes = np.bincount(main[rule]["lengths"], minlength=result_max + 1)
        if sizes[result_max] != CRUSH_X or not (main[rule]["rows"] < CRUSH_OSDS).all():
            raise AssertionError(f"rule {rule}: rows not all of {result_max} osds")
    return err, plain_ms


def phase_crush_times(cc, tm, big, main, plain_ms, smi: str) -> dict:
    """Phase 9: each stage's kernel beside its bound, and the end-to-end rates."""
    cm = tm.compile_map(big, device="cuda")
    xs = torch.arange(CRUSH_X, dtype=torch.int32, device="cuda")
    wv = torch.full((CRUSH_OSDS,), 0x10000, dtype=torch.int64, device="cuda")
    ops_per_draw = sum(OPS_PER_DRAW.values())
    stats = {}
    for (rule, result_max), firstn in zip(CRUSH_RULES, (True, False)):
        params = stage_params(big, firstn, result_max, 1, True)
        ms = cuda_ms(lambda: cc.crush_choose(cm, xs, -1, wv, **params), 10)
        draws = torch.zeros(CRUSH_X, dtype=torch.int32, device="cuda")
        cc.crush_choose(cm, xs, -1, wv, draws=draws, **params)
        n_draws = int(draws.sum(dtype=torch.int64))
        ops_ms = n_draws * ops_per_draw / INT32_OPS_PER_S * 1e3
        moved = (CRUSH_X * 4 + 2 * CRUSH_X * result_max * 4 + wv.numel() * 8
                 + sum(t.numel() * t.element_size() for t in (
                     cm.offsets, cm.sizes, cm.items, cm.ids, cm.weights,
                     cm.row_of, cm.type_of_bucket, cm.ln_tables)))
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            tm.map_rule(cm, rule, np.arange(CRUSH_X), [0x10000] * CRUSH_OSDS, result_max)
            best = min(best, time.perf_counter() - t0)
        m = main[rule]
        print(f"  [{smi}] crush_choose rule {rule} ({'firstn' if firstn else 'indep'} "
              f"{result_max}, {CRUSH_X} x): kernel {ms:.4f} ms, {n_draws} straw2 draws "
              f"({n_draws / CRUSH_X:.2f} per x) x {ops_per_draw} int ops / "
              f"{INT32_OPS_PER_S:.4g} ops/s = bound {ops_ms:.4f} ms (bytes {bytes_ms:.5f} "
              f"ms for {moved} B), share {bound_ms / ms:.3f}; plain {plain_ms[rule]:.1f} ms; "
              "library call: none", flush=True)
        print(f"  [{smi}] map_rule rule {rule}: best of 3 {best:.4f} s = "
              f"{CRUSH_X / best:.1f} mappings/s (kernel {ms / 1e3 / best:.3f} of it); "
              f"CrushTester --show-statistics {m['tester_s']:.4f} s = mapping "
              f"{m['tester_map_s']:.4f} s + host aggregation "
              f"{m['tester_s'] - m['tester_map_s']:.4f} s "
              f"({CRUSH_X / m['tester_s']:.1f} x/s); crushtool --test {m['tool_s']:.4f} s",
              flush=True)
        stats[rule] = dict(ms=ms, bound_ms=bound_ms, plain_ms=plain_ms[rule])
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
              "required", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ceph_tpu_torch.crush import builder as cb
    from ceph_tpu_torch.crush import torch_mapper as tm
    from ceph_tpu_torch.crush import types as crush_types
    from ceph_tpu_torch.crush.compiler import compile_crushmap, decompile_crushmap
    from ceph_tpu_torch.crush.tester import CrushTester
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import crush_cuda as cc
    from ceph_tpu_torch.ops import cuda_build, gf
    from ceph_tpu_torch.ops import gf_cuda as gc
    from ceph_tpu_torch.osd import encode_service as es
    from ceph_tpu_torch.tools import crush_bench, crushtool, ec_bench

    print("phase 1: device", flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind}, count {count}", flush=True)
    print(smi, flush=True)

    print("phase 2: build", flush=True)
    t0 = time.perf_counter()
    libs = cuda_build.build()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    print("phase 3: kernel vs plain on the card", flush=True)
    codec = factory("isa", dict(PROFILE))
    max_err = phase_kernels(gc, gf, codec, factory)

    print("phase 4: main path", flush=True)
    gc.gf_matmul_packed.launches = 0
    objs, chunks0 = phase_main_path(codec, es.EncodeService, ec_bench)
    torch.cuda.synchronize()
    launches = gc.gf_matmul_packed.launches
    print(f"  gf_matmul_packed launches on the main path: {launches}", flush=True)
    if launches < 1:
        raise AssertionError("the main path never launched gf_matmul_packed")
    check_outputs(codec, gf, objs, chunks0)

    print("phase 5: times", flush=True)
    times = phase_times(gc, codec, es, smi)

    print("phase 6: crush kernel vs plain on the card", flush=True)
    big = crush_bench.build_map(CRUSH_OSDS)
    cb.make_simple_rule(big, 1, -1, 1, "indep", 0)
    crush_err = phase_crush_kernels(cc, tm, cb, crush_types, big)

    print("phase 7: crush main path", flush=True)
    path = os.path.join(cuda_build.BUILD_DIR, "crush_smoke_map.txt")
    with open(path, "w") as f:
        f.write(decompile_crushmap(big))
    text_map = compile_crushmap(decompile_crushmap(big))
    cc.crush_choose.launches = 0
    crush_main = phase_crush_main(tm, crushtool, CrushTester, text_map, path)
    torch.cuda.synchronize()
    crush_launches = cc.crush_choose.launches
    print(f"  crush_choose launches on the main path: {crush_launches}", flush=True)
    if crush_launches < 1:
        raise AssertionError("the CRUSH path never launched crush_choose")

    print("phase 8: crush outputs", flush=True)
    err, plain_ms = phase_crush_outputs(tm, big, crush_main)
    crush_err = max(crush_err, err)

    print("phase 9: crush times", flush=True)
    crush_times = phase_crush_times(cc, tm, big, crush_main, plain_ms, smi)

    kernels = [{
        "name": "gf_matmul_packed",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:141",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "crush_choose",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_choose.cu",
        "replaces": "ceph_tpu/crush/jax_mapper.py:952",
        "launches": crush_launches,
        "max_abs_err": crush_err,
        "ms": crush_times[0]["ms"],
        "plain_ms": crush_times[0]["plain_ms"],
        "bound_ms": crush_times[0]["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
