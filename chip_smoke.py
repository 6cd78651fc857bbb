#!/usr/bin/env python3
"""chip_smoke.py — drive ceph_tpu_torch's main path once on one CUDA card.

    python3 chip_smoke.py

Eight main paths, each driven with the launch counts zeroed just before it
and read just after. The RS erasure-code data path as an OSD meets it: the
plugin registry (`factory("isa", k=8 m=3 technique=cauchy)`), the batching
`EncodeService`, and the hand-written GF(2^8) CUDA kernel under both. Then
CRUSH placement as `crushtool --test` meets it (BASELINE config 5: 1M x over
a 10k-OSD straw2 map): `CrushTester`, the port's crushtool and
`torch_mapper.map_rule`, over the hand-written straw2 choose kernel. Then
placement balancing at the JAX package's own balancer scale (bench.py's
_balance_line: 1024 OSDs, a replicated pool of 262,144 PGs x 3 and an EC
pool of 32,768 PGs x 6): the port's psim scenario (`OSDMap.pool_mappings`
over the choose kernel, `calc_pg_upmaps` over the hand-written move-scoring
kernel) and the mgr `BalancerModule` in upmap and crush-compat modes. Then
the other EC families (shec, lrc, clay, jerasure's liberation) through
`ec_bench --batch`, their array APIs, clay's MSR repair, the corpus and
`EncodeService`, over the hand-written byte-layout GF(2^8) matmul, XOR and
row-product kernels. Then the RADOS data path as an EC pool's users meet it:
MiniCluster puts of 4 MiB objects into an isa k=8 m=3 pool (CRUSH placement,
encode on the card through the byte-layout matmul, HashInfo crc32c, the
stores), degraded gets after OSDs die, recovery onto their new homes and deep
scrub. Then the live daemon path as a cluster's clients meet it: three
monitors, twelve OSD daemons and a Rados client in this process over
loopback, EC writes encoded by each primary's EncodeService, degraded reads
and recovery decoding through it, all over the GF(2^8) kernel, and the
checkpoint store on those daemons: GPT-2 small's parameters saved,
saved again incrementally, verified, collected and restored onto the card
and onto device meshes. Then the device mesh as a multi-device OSD meets it:
the sharded GF(2^8) matmul (B8, one launch of the byte-layout kernel per mesh
slot) through sharded_encode/decode, the planar entry points and
EncodeService's mesh path. Then the cluster as its users deploy it: a
process per monitor and per OSD daemon (vstart), each OSD on BlockStore and
each with its own CUDA context, its EncodeService encoding, degraded-decoding
and recovering through the GF(2^8) kernel; on it, block images with their
snapshots, clones and mirror, CephFS through mds processes, and S3 objects
through an rgw process. Phases:

  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build every kernel under ceph_tpu_torch/csrc with nvcc (ptxas report);
  3. each kernel against its plain torch version on the card, bit-exact, at
     the main path's shapes and a few others, and a column window against the
     numpy GF(2^8) oracle; for B1 every launch plan (64-, 128- and
     256-thread blocks: one object's width, a width between, the burst) and
     variant (tables in the launch parameter or in device memory, 16-byte
     or masked accesses): encode and decode with r = 1..3 at one object's
     width, r = 4, 5 and k = 1, a ragged N4, a bit-matrix that is not
     GF(2^8)'s and r * k * 32 at the 48 KiB limit, and the chaos pool's
     tpu k = 2 (encode r = 2, decode r = 1 and 2 at N4 = 1, 7, 64, 257),
     under torch.profiler, failing unless every packed variant the
     launcher names was launched;
  4. the main path, with launch counts zeroed just before and read just
     after: 64 concurrent 4 MiB objects through EncodeService.encode (one
     launch), the rebuild of data chunks {0,1,2} of all 64 through
     EncodeService.decode (one launch), a byte-API round trip of one object,
     and the port's ec_bench in encode and decode;
  5. times (CUDA events): the kernel beside its memory bound at the
     burst's width and at one object's width (the daemons'), its plain
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
  8. its outputs: map_rule's rows equal the plain version on the card (all
     1M of rule 0, the first 2^18 of rule 1), the first 512 x equal the
     scalar mapper, and the tester's and
     crushtool's outputs agree;
  9. times (CUDA events; host clock for whole calls): each stage's kernel
     beside its operation bound (the straw2 draws the run made, counted by
     the kernel, times the integer operations per draw in its source, over
     the INT32 rate), its plain version, map_rule mappings/s, and the
     tester run split into mapping and host aggregation;
  10. the upmap move-scoring kernel against its plain torch version on the
      card, bit-exact (gain as float32 bits): round 1 of calc_pg_upmaps on
      the balancer cell's map, its inputs rebuilt as score_round builds
      them (whole-pool launches, as the main path makes, and the JAX
      package's chunks), and crafted chunks (gain ties, float32 rounding
      ties between slots at S = 3 and 6, all-illegal rows, NONE slots,
      unreachable domains, 11-wide rows, 10,000 and 30,000 OSDs), so that
      every instantiation of the kernel (S = 3, S = 6 and the generic one,
      each with the targets staged or read from global memory) is checked:
      the phase runs under torch.profiler and fails unless the kernels it
      launched are all the instantiations the source's launcher names;
  11. the balancer main path, counts zeroed just before: psim --scenario
      --json, then again with --measure (equal reports but for its timing),
      then
      BalancerModule.run_once in upmap and crush-compat modes through an
      in-process mon client; then its outputs: every PG an upmap touched
      and 512 sampled PGs per pool equal the scalar pipeline (worker
      processes), one replica per host, no duplicate OSD, the move budget
      and spread held, and the committed compat weight-set maps as the
      run-time overlay of the same weights does;
  12. times: the scoring kernel over one round (CUDA events) beside its
      operation bound (the integer and float32 operations the function
      needs on the round's data, each at its own rate), its plain version,
      its two ways of reading the per-OSD arrays (staged in shared memory
      or from global memory), alternated; the same for a round at 10,000
      OSDs (the rule-0 rows of x = 0..262,143 on phase 6's map, deviations
      from their per-OSD counts); three calc_pg_upmaps passes, each split
      into pool mapping, scoring and host greedy/revalidation, a pass under
      torch.profiler (device busy time, idle share), the scenario's PGs
      mapped per second, and each crush-compat iteration;
  13. the four kernels of the EC families against their plain versions on
      the card, bit-exact: the byte-layout GF(2^8) matmul at shec's encode
      and lrc's global layer (64 x 1 MiB chunks), a shec decode matrix on
      strided survivors, a ragged width, k = 1 and a bit-matrix that is not
      GF(2^8)'s; the XOR-of-rows kernel at lrc's local layer, strided,
      ragged, k = 1, rows not 16-byte aligned and more items than grid
      rows, and on planar words at (8, 8 Mi), (2, 32 Mi) and a ragged
      width; the row product at liberation's encode and decode, ragged and
      strided, and at C = 289; the byte-layout matmul also at one object's
      width (MiniCluster's put, and its decode from strided survivors),
      with its tables in device memory (aligned and ragged) and at the
      48 KiB limit; under torch.profiler, failing unless every byte-form
      variant the launcher names was launched;
  14. the EC families' main path, the four new counts zeroed just before
      and read just after: for shec k=4 m=3 c=2, lrc k=4 m=2 l=3, clay
      k=4 m=2 d=5 and liberation k=4 m=2 w=7 packetsize=2048, ec_bench
      --batch 64 (clay: 4) -s 4 MiB encode and decode of each erasure set,
      then the batch encode and decode on the card against the same codec
      on the CPU, and clay's MSR repair of a whole batch through
      repair_array; the eight corpus profiles of these families on the
      card (golden chunks, every single and pair erasure as on the CPU);
      EncodeService bursts of 64 x 4 MiB on the lrc codec (per-object
      fallback) and on an m=1 planar codec (jerasure k=2 m=1, one XOR
      launch);
  15. times: each new kernel (CUDA events) beside its bytes bound and its
      plain version (B2 and its library call, torch.bitwise_xor, timed in
      turns), the byte-layout matmul also at one object's width (1, 8,
      512 KiB), and each family's batch encode and decode (GB/s, the
      H2D and D2H copies, one profiled run each: device busy time, the new
      kernels' share of it, idle share);
  16. the RADOS data path, the byte-layout matmul's count zeroed before each
      step and read after it: a MiniCluster on the card over 12 straw2 hosts
      of 4 OSDs (jewel tunables) with an isa k=8 m=3 cauchy pool (pg_num 256,
      size 11, indep over hosts), a replicated size-3 pool (pg_num 128) and a
      clay k=4 m=2 d=5 pool (pg_num 32); 256, 32 and 8 objects of 4 MiB put,
      16 of the EC pool's overwritten, 3 OSDs on 3 hosts killed, every object
      read back (degraded where a shard is lost), the 3 marked out and each
      pool recovered and deep-scrubbed, every object read again; times (put
      GB/s and ms an object split into placement, the encode call, HashInfo
      crc32c and store writes; degraded-get GB/s; recover seconds) and the
      device's idle share over 16 puts under torch.profiler, which must show
      the kernel in a put and in a degraded get; 16 sampled EC objects' shards
      against the CPU isa codec; then the same sequence at 4 objects a pool
      on the card and on the CPU, whose stores must end equal;
  17. the native plugin built from ceph_tpu_torch/native/ec_plugin.cpp: its
      k=8 m=3 chunks equal isa's on the card (cauchy, reed_sol_van) on 4
      objects of 4 MiB; `python -m ceph_tpu_torch.tools.ec_non_regression
      --check --device cuda` over tests/corpus (17 profiles, native among
      them); `python -m ceph_tpu_torch.tools.cpu_ec_baseline`'s line, with
      the host CPU's model (a host number, not the card's);
  18. the live daemon path, B1's count zeroed before each window and read
      after it: B1 warmed at the pool's shape first, then 3 monitors, 12 OSD
      daemons (a host each, straw2, jewel; rule 0 takes k + m) and a Rados
      client in this process on the card; pool 1 isa k=8 m=3 cauchy (pg_num
      16), pool 2 replicated size 3 (pg_num 8); the write window (32 x 4
      MiB into pool 1 at concurrency 32, 8 into pool 2, 8 partial
      overwrites, 16 rewrites traced and 16 under torch.profiler), a read of
      every object, 2 OSDs stopped and marked down, the degraded-read window
      (every pool-1 object), the recovery window (the 2 back on empty
      stores, as after a disk replacement, until the PGs are clean and the
      pushes stop), every object read again; every read exact, B1 launched
      in each window and no B1 call raised, every stored pool-1 shard and
      its hinfo digest equal to the CPU isa codec's, the acting positions
      recovery left without their shard counted; times
      (write and read GB/s, ms an object, the put's tracer spans, the idle
      share, B1's widths and its time at the most common one beside its
      bound, degraded-read GB/s, recovery seconds); then the checkpoint
      window on the same cluster: GPT-2 small's parameters (published
      widths, the first 6 of its 12 blocks: 328 MB of float32 made on the
      card from the seed; cut from the training state, whose Adam moments
      would triple it, to keep the run's time; the embeddings and MLP
      weights laid out on a 1x1 mesh's `stripe`
      axis) saved into pool 1 with B1 counted, saved
      again with save_async after one layer changed (dedup ratio, stall
      against persist time, idle share under torch.profiler), verified,
      collected by `ckpt_tool gc --keep-last 1` in its own process (the old
      save's objects gone but those the new one references), then restored
      onto the card, every leaf equal to its source (phase 20 runs
      daemon_bench, multi-process; phase 21 restores onto fleet meshes);
  19. the device mesh (B8), the byte-layout matmul's count zeroed before
      and read after: sharded_encode and sharded_decode (erasures {0,1,2})
      of 64 x (8, 512 KiB) and mesh_encode_planar / mesh_decode_planar on the
      burst's (8, 32 MiB) planes, on the 1x1 mesh and on the 2x2 mesh of four
      slots on the card, each output equal to one launch of the byte-layout
      kernel over the whole batch and to its plain version, each call one
      launch a slot (one a card on a mesh of distinct cards), counted call
      by call; EncodeService(mesh=2x2) on phase 4's burst, encode and
      decode through the mesh path, its chunks equal phase 4's, its calls
      counted the same way; after phase 20 (no daemon or worker process
      left, the live child count printed), times (CUDA events): B8's call
      on each mesh beside one launch over the whole batch, the plain
      version and the bytes bound;
  20. the multi-process cluster, B1 counted in each OSD process per window
      (`status`'s EncodeService launches and `perf dump`'s wrapper counts,
      over osd_admin): vstart.VStart on the card builds the kernels and the
      native libraries, then spawns 3 monitor and 12 OSD processes, each OSD
      on BlockStore (FileDB and a block file in a temporary run dir), each
      daemon with its own CUDA context; rule 0's max_size raised to 11 with
      `osd crush set` (the operator's route); pool 1 isa k=8 m=3 cauchy
      (pg_num 32), pool 2 replicated size 3 (pg_num 16); the write window
      (64 x 4 MiB into pool 1 and 16 into pool 2 by 4 client processes, 32
      in flight in all), a read of every object; the crash window (2 OSD
      processes SIGKILLed and marked down, every pool-1 object read degraded,
      16 more written); the restart window (the 2 restarted over their
      surviving stores until every PG is clean and the pushes stop), every
      object read again; every daemon stopped with SIGTERM (each must exit
      0), then every stopped store read offline with the port's
      objectstore_tool: each pool-1 shard and its hinfo digest equal the CPU
      isa codec's, and `objectstore_tool --op fsck` clean on each; times
      (boot, PG activation, write, read and degraded-read GB/s, ms an
      object, time to clean); then `daemon_bench --multiprocess` at the
      reference README's hot-set configuration on the card;
  21. the training fleet and the dataset store on phase 20's cluster,
      before its SIGTERM, B1 counted in the OSD processes per window: the
      dataset window (32,768 records of 1,024 uint16 GPT-2 tokens, 64 MiB
      from the seed, ingested through DataStore into pool 1; `python -m
      ceph_tpu_torch.tools.data_tool ... verify` in its own process; one
      epoch read as 4 hosts at batch 12, with the prefetch pipeline (cut
      to 64 batches a host) and without it (cut to 16); each host's
      records equal the source rows at the ids epoch_permutation and
      host_slice give, no record twice or missing;
      ingest and read GB/s, records/s, block-cache hit rate); the
      fleet-parallel save window (4 in-process Fleet members, each on its
      own client, save GPT-2 small's parameters collectively from a 4-slot
      fleet mesh on the card, then restore_mesh, every rank's
      restore_rank_shards, and restore_mesh on a 3-slot mesh after one
      member leaves; every leaf and slab equal to its source; save and
      restore GB/s, each rank's prepared bytes as a share of the tree); the
      failover window (3 `python -m ceph_tpu_torch.tools.fleet_tool worker`
      processes on the card at tests/test_fleet_live.py's shape, the leader
      SIGKILLed mid-save; the survivors re-elect, restore the committed HEAD
      and resume with no acknowledged record twice or missing; the final
      HEAD equals the tool's `_tree(step)`; `fleet_tool status` prints the
      roster);
  22. the manager daemon, the chaos harness and the recovery A/B. On phase
      20's cluster, before its SIGTERM: VStart spawns a mgr process on the
      card (`python -m ceph_tpu_torch.mgr`); every OSD reports to it, and
      its /metrics holds each OSD's `kernels.osd.N` block with a
      gf_matmul_packed count equal to that OSD's perf dump; `python -m
      ceph_tpu_torch.tools.ceph_top --json` counts the client ops of a
      write window (B1 counted in it); a tail-captured traced write reaches
      the mgr's trace store, `ceph trace show` gives it and `trace_tool`
      renders its tree; the mgr exits 0 on SIGTERM. After phase 20:
      ceph_tpu_torch.sim.run_chaos for seeds 1 and 7 on the card (B6 maps
      the pools), each report equal to the CPU's; chaos_tool's live run
      (seed 1, 8 steps; 3 mons, 6 OSDs, a tpu k=2 m=2 pool on B1 and a
      size-3 pool) with its oracles (no acked write lost, no scrub error,
      converged, p99 within budget), B1 launched with no call raising, and
      every stored EC shard equal to the CPU tpu codec's; `daemon_bench
      --recovery` at its defaults (the replicated pool: B1 is not expected
      there); `daemon_bench --mgr`;
  23. block images, their mirror and CephFS on phase 20's cluster, after
      phase 22's mgr window and before the SIGTERM, B1 counted in the OSD
      processes per window: 4 client processes on the card, each a thin
      2 GiB image of order 22 (4 MiB objects) in pool 1 opened exclusive,
      writing 128 MiB in 4 MiB writes, 4 in flight on disjoint objects
      (`rbd bench --io-size 4M --io-total 512M --io-threads 16` over the
      four), then a 4 KiB read-modify-write in each of its first 16
      objects; image 0's snapshot, 16 overwrites read at the snapshot and listed exactly
      by `diff`, a protected clone and a copy-up write into it; every
      image read back whole (its written span and a hole) and
      `object_map_check` empty on each; one OSD process SIGKILLed, the
      images read again degraded (B1's decode), the OSD restarted and
      every PG clean; a journaled image (64 MiB, 16 writes of 4 KiB-4 MiB
      and a resize) replayed into pool 2 by `ImageReplayer.run_once`, the
      replica equal to the source and the journal trimmed; two mds
      processes (`python -m ceph_tpu_torch.cephfs`) serving CephFS on pool
      2 (an EC pool has no omap for its directories), 8 directories of 4
      files of 64 KiB-4 MiB, the active SIGKILLed, the standby taking the
      rank and answering a resent request from its journal replay, every
      file equal; after the SIGTERM, every rbd_data head object's shards
      checked offline with phase 20's;
  24. the object gateway on phase 20's cluster, after phase 23 and before
      the SIGTERM, B1 counted in the OSD processes over its window: VStart
      spawns an rgw process on the card with phase 23's mds processes, so
      that it boots while the images are written (`python -m
      ceph_tpu_torch.rgw`: S3 over HTTP, data in pool 1, the bucket index in
      pool 2, whose omap an EC pool cannot hold); 4 client processes, each with its own SigV4
      client written from the AWS specification and 5 requests in flight
      (MinIO warp's `put` defaults: 10 MiB objects, 20 concurrent), create
      a bucket, PUT 8 objects of 10 MiB, upload 64 MiB in 8 MiB parts
      (the AWS CLI's multipart defaults) and complete it, GET everything
      back (bytes and ETag, the crc32c, exact), page through the bucket's
      listing 5 keys at a time, and put one key twice in a versioned bucket
      and list its versions; the rgw process exits 0 on SIGTERM, and the
      gateway's data objects, parts and manifests in pool 1 are checked
      offline with phase 20's (the CPU codec's parity of phases 20, 23 and
      24's objects, all known from the seed, made in worker processes from
      phase 18 on);
  25. no process this script started is left (nvcc, nvidia-smi, the
      worker processes, the daemons and the tools are all waited for);
  26. a `kernels` JSON line, then the `ok` JSON line, last.

Each kernel is timed three ways: `ms`, its call time (CUDA events around
back-to-back calls of its wrapper, as every share and comparison uses);
`held_ms`, its device time (the same with the stream held while the calls
are enqueued, so no host time enters); `host_us`, its wrapper's host time
per call. The `kernels` line carries all three.

Any failed phase raises, so the script exits non-zero and prints no result.
It needs a CUDA card and the repository around it; with neither it fails.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import ctypes
import functools
import hashlib
import hmac
import io
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import time
import urllib.parse

import numpy as np
import torch

SEED = 20261016
K, M = 8, 3
PROFILE = {"k": str(K), "m": str(M), "technique": "cauchy"}
OBJECTS = 64
OBJECT_BYTES = 4 << 20
N4 = 8 << 20  # int32 words per planar row of the 64-object batch
#: int32 words per planar row of one object: the width the daemons' EncodeService
#: and MiniCluster launch the GF(2^8) kernel at
OBJECT_N4 = OBJECT_BYTES // K // 4
ERASED = (0, 1, 2)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TIMED_LAUNCHES = 50

CRUSH_OSDS = 10_000
CRUSH_X = 1_000_000
#: (rule, result_max): BASELINE's replicated rule and an RS(8,3) EC rule
CRUSH_RULES = ((0, 3), (1, K + M))
#: x checked against the scalar mapper, a cut for the 1200 s limit
SCALAR_CHECK = 512
#: x of each rule's map_rule rows checked against the plain version in phase
#: 8 (and its time): all of rule 0's; rule 1's plain version took 25 s over
#: all 1M x, cut to the first 2^18 for the 1200 s limit
PLAIN_CHECK_X = {0: CRUSH_X, 1: 1 << 18}
#: H100 SXM: 132 SMs x 64 INT32 lanes per SM per clock x 1.98 GHz boost
#: (NVIDIA Hopper architecture whitepaper)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: H100 SXM float32 outside the tensor cores (NVIDIA's data sheet)
FP32_OPS_PER_S = 67e12
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
    """Mean milliseconds of fn() over reps back-to-back calls, by CUDA
    events, warm: the call time, each kernel's `ms`. A call's host work (a
    wrapper's checks, allocation and launch) shows in it wherever the host
    takes longer than the device, and the first call's always does."""
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


#: GPU clock cycles held_ms and host_us hold the stream for each call they
#: are about to enqueue: about 1 ms at the H100's 1.98 GHz, more than the
#: host takes to enqueue one call of a wrapper
HOLD_CYCLES_PER_CALL = 2_000_000


def held_ms(fn, reps: int) -> float:
    """As cuda_ms, but a spin kernel (torch.cuda._sleep) holds the stream
    while the start event and the calls are enqueued, so the events bracket
    the calls' device work back to back and no host time enters: the device
    time, printed beside the call time as `held_ms`."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Mean host microseconds to enqueue fn() while a spin kernel holds the
    stream, so the card never holds the host back: the wrapper's own cost
    per call (`host_us`)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES_PER_CALL * reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / reps * 1e6


def kernel_times(fn, reps: int) -> dict:
    """A kernel's three readings: call time (ms), device time (held_ms) and
    host time per call (host_us)."""
    return {"ms": cuda_ms(fn, reps), "held_ms": held_ms(fn, reps),
            "host_us": host_us(fn, reps)}


def times_text(t: dict) -> str:
    return (f"{t['ms']:.5f} ms a call (device time {t['held_ms']:.5f} ms with the stream "
            f"held; host {t['host_us']:.2f} us a call)")


#: the GF(2^8) kernels' variants as torch.profiler names them: the packed (B1)
#: or byte (B3) form, its tables in the launch parameter (true) or in device
#: memory, 16-byte accesses (true) or masked ones
GF_VARIANT = re.compile(r"gf_matmul_(packed|bytes)_kernel<(true|false), (true|false)>")
#: the variants csrc/gf_matmul.cu's dispatch launches
GF_DISPATCH = re.compile(r"launch<kBatched, (true|false), (true|false)>")


def gf_variants_checked(gc, form: str, busy: dict, phase: str) -> list[str]:
    """The `form` ("packed" or "bytes") variants a profiled phase launched,
    with their counts printed; raises unless they are every variant the
    source's dispatch names."""
    with open(os.path.join(os.path.dirname(os.path.abspath(gc.__file__)), os.pardir, "csrc",
                           "gf_matmul.cu")) as f:
        named = {f"gf_matmul_{form}_kernel<{p}, {v}>" for p, v in GF_DISPATCH.findall(f.read())}
    ran: dict[str, int] = {}
    for kname, (n, _ms) in busy.items():
        for f, p, v in GF_VARIANT.findall(kname):
            if f == form:
                key = f"gf_matmul_{f}_kernel<{p}, {v}>"
                ran[key] = ran.get(key, 0) + n
    print(f"  variants launched in this phase (torch.profiler): "
          f"{', '.join(f'{k} x{n}' for k, n in sorted(ran.items()))}; the launcher names "
          f"{len(named)}", flush=True)
    if not named or set(ran) != named:
        raise AssertionError(f"phase {phase} launched {sorted(ran)}, the launcher names "
                             f"{sorted(named)}")
    return sorted(ran)


def gf_plan(gc, work: int) -> str:
    """The launch plan csrc/gf_matmul.cu picks on this card for `work`
    16-byte groups (a case label)."""
    threads, blocks = gc.launch_plan(work)
    return f"{blocks} blocks of {threads} threads"


def device_memory_route(gc, tables, inp, words: bool) -> torch.Tensor:
    """One launch of the GF(2^8) kernel through its C entry point without the
    host copy of the tables, so that it reads them from device memory at any
    r * k (the wrappers pass the copy, and the launcher then carries tables of
    r * k <= kParamTables in the launch parameter). Counts nothing."""
    lib = gc._lib()
    r, k = tables.shape[:2]
    stream = torch.cuda.current_stream().cuda_stream
    if words:
        out = inp.new_empty((r, inp.shape[1]))
        err = lib.gf_matmul_packed_launch(tables.data_ptr(), None, inp.data_ptr(),
                                          out.data_ptr(), k, r, inp.shape[1], stream)
    else:
        batch, _, length = inp.shape
        out = inp.new_empty((batch, r, length))
        err = lib.gf_matmul_bytes_launch(tables.data_ptr(), None, inp.data_ptr(),
                                         out.data_ptr(), k, r, batch, length, inp.stride(0),
                                         inp.stride(1), stream)
    if err != 0:
        raise AssertionError(f"device-memory route launch failed: CUDA error {err}")
    return out


def random_words(rows: int, n4: int, gen: torch.Generator) -> torch.Tensor:
    data = torch.randint(0, 256, (rows, n4 * 4), dtype=torch.uint8,
                         device="cuda", generator=gen)
    return data.view(torch.int32)


def check_kernel(name, gc, packed, tables, words, device_memory=False) -> int:
    """Kernel vs plain version on the same card tensors (through the wrapper,
    or with `device_memory` through the route that reads the tables from
    device memory); returns the max absolute byte difference (0, or the
    phase fails)."""
    got = (device_memory_route(gc, tables, words, True) if device_memory
           else gc.gf_matmul_packed(packed, words, tables=tables))
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


def phase_kernels(gc, gf, codec, factory) -> tuple[int, list[str]]:
    """Phase 3: every comparison of the kernel with its plain version, for
    every launch plan and variant, under torch.profiler: it fails unless
    every packed variant the launcher names was launched. Returns the max
    error and the variants seen."""
    errs = []
    _, busy = profiled(lambda: errs.extend(packed_cases(gc, gf, codec, factory)))
    return max(errs), gf_variants_checked(gc, "packed", busy, "3")


def packed_cases(gc, gf, codec, factory) -> list[int]:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    words = random_words(K, N4, gen)
    enc = codec._encode
    errs = [check_kernel(f"isa cauchy RS(8,3) encode, burst width ({gf_plan(gc, N4 // 4)})", gc,
                         enc.packed_t, enc.tables_t, words)]
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

    # one object's width, as the daemons launch it: encode, decode with
    # r = 1..3, and the tables read from device memory
    obj = random_words(K, OBJECT_N4, gen)
    label = gf_plan(gc, OBJECT_N4 // 4)
    errs.append(check_kernel(f"object width encode ({label})", gc, enc.packed_t,
                             enc.tables_t, obj))
    for r in (1, 2, 3):
        d = codec.decode_bitmatrix(present, list(ERASED[:r]))
        errs.append(check_kernel(f"object width decode r={r}", gc, d.packed_t, d.tables_t,
                                 obj))
    errs.append(check_kernel("object width encode, tables from device memory", gc,
                             enc.packed_t, enc.tables_t, obj, device_memory=True))
    mid = random_words(K, 160_000, gen)
    errs.append(check_kernel(f"encode ({gf_plan(gc, 160_000 // 4)})", gc, enc.packed_t,
                             enc.tables_t, mid))

    jer = factory("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"})
    errs.append(check_kernel("jerasure reed_sol_van k=4 m=2", gc,
                             jer._encode.packed_t, jer._encode.tables_t,
                             words[:4].contiguous()))

    rng = np.random.default_rng(SEED)
    bitmat = (rng.random((8 * M, 8 * K)) < 0.5).astype(np.int8)
    errs.append(check_kernel(
        "random {0,1} bit-matrix", gc,
        torch.from_numpy(gc.pack_matrix(bitmat)).cuda(),
        torch.from_numpy(gc.kernel_tables(bitmat)).cuda(), words))
    for r, k in ((4, K), (5, K), (3, 1)):
        t = card_tables(gf_matrix=rng.integers(0, 256, (r, k), np.uint8))
        errs.append(check_kernel(f"r={r} k={k} at the object width", gc, t.packed_t,
                                 t.tables_t, obj[:k].contiguous()))
    # r * k * 32 at the 48 KiB limit: tables in device memory, two row groups
    # of four passes, sixteen load groups
    wide = card_tables(bits=(rng.random((8 * 12, 8 * 128)) < 0.5).astype(np.int8))
    errs.append(check_kernel("r=12 k=128 (48 KiB of tables)", gc, wide.packed_t,
                             wide.tables_t, random_words(128, 3000, gen)))

    # the chaos harness's EC pool: the tpu plugin at k=2 m=2 on objects of
    # 64-2047 B, so a few to a few hundred words a row
    tpu = factory("tpu", {"k": "2", "m": "2"})
    for n4 in CHAOS_N4:
        small = random_words(2, n4, gen)
        errs.append(check_kernel(f"tpu k=2 m=2 encode r=2 at N4={n4} "
                                 f"({gf_plan(gc, -(-n4 // 4))})", gc, tpu._encode.packed_t,
                                 tpu._encode.tables_t, small))
        for present, erased in (([1, 2], [0]), ([2, 3], [0, 1])):
            d = tpu.decode_bitmatrix(present, erased)
            errs.append(check_kernel(f"tpu k=2 m=2 decode r={len(erased)} at N4={n4}", gc,
                                     d.packed_t, d.tables_t, small))

    ragged = random_words(K, N4 + 37, gen)
    errs.append(check_kernel("ragged N4 = 8 Mi + 37", gc, enc.packed_t,
                             enc.tables_t, ragged))
    errs.append(check_kernel("ragged N4 = object width + 37, tables from device memory", gc,
                             enc.packed_t, enc.tables_t, random_words(K, OBJECT_N4 + 37, gen),
                             device_memory=True))
    return errs


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
    return objs, encoded


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
    kt = kernel_times(
        lambda: gc.gf_matmul_packed(enc.packed_t, words, tables=enc.tables_t),
        TIMED_LAUNCHES)
    kernel_ms = kt["ms"]
    plain_ms = cuda_ms(lambda: gc.gf_matmul_packed_plain(enc.packed_t, words), 3)
    moved = (K + M) * N4 * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"  [{smi}] gf_matmul_packed ({K}, {N4}) -> ({M}, {N4}) int32: "
          f"kernel {times_text(kt)}, bound {bound_ms:.4f} ms "
          f"({moved} B at 3.35 TB/s), roofline share {bound_ms / kernel_ms:.3f} "
          f"(of the device time {bound_ms / kt['held_ms']:.3f}), "
          f"{moved / kernel_ms / 1e6:.1f} GB/s; plain {plain_ms:.3f} ms; "
          "library call: none", flush=True)

    obj = random_words(K, OBJECT_N4, gen)
    ot = kernel_times(
        lambda: gc.gf_matmul_packed(enc.packed_t, obj, tables=enc.tables_t), 200)
    obj_moved = (K + M) * OBJECT_N4 * 4
    obj_bound = obj_moved / HBM_BYTES_PER_S * 1e3
    print(f"  [{smi}] gf_matmul_packed at one object's width ({K}, {OBJECT_N4}) -> "
          f"({M}, {OBJECT_N4}) int32, as the daemons launch it: kernel {times_text(ot)}, "
          f"bound {obj_bound:.5f} ms ({obj_moved} B at 3.35 TB/s), roofline share "
          f"{obj_bound / ot['ms']:.3f} (of the device time {obj_bound / ot['held_ms']:.3f}); "
          f"beside the burst width's share {bound_ms / kernel_ms:.3f} "
          f"(of the device time {bound_ms / kt['held_ms']:.3f})", flush=True)
    # what holds it there: the launch itself, and the table route
    one = torch.zeros(1, device="cuda")
    floor_ms = held_ms(lambda: one.zero_(), 200)
    dm_ms = held_ms(lambda: device_memory_route(gc, enc.tables_t, obj, True), 200)
    print(f"  [{smi}] beside it, device time a launch: a trivial kernel (zero_ of one "
          f"element) {floor_ms:.5f} ms; the object width with its tables read from device "
          f"memory instead of the launch parameter {dm_ms:.5f} ms", flush=True)

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
    return {**kt, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "at_object_width": {**ot, "bound_ms": obj_bound, "launch_floor_ms": floor_ms,
                                "device_memory_held_ms": dm_ms}}


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


#: what a worker process runs: chip_smoke.<fn>(job) from a pickle on stdin,
#: its result pickled to stdout (anything the job prints goes to stderr)
WORKER = """import pickle, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
fn, job = pickle.load(sys.stdin.buffer)
out, sys.stdout = sys.stdout.buffer, sys.stderr
pickle.dump(getattr(chip_smoke, fn)(job), out)
"""


def in_workers(fn: str, jobs: list) -> list:
    """chip_smoke.<fn>(job) for each job, each in a Python process of its
    own, all started together; returns the results in order. Every process
    is waited for, and killed first if one fails. Plain subprocesses rather
    than multiprocessing, whose spawn start method leaves a resource-tracker
    process behind the script."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for _ in jobs:
            procs.append(subprocess.Popen([sys.executable, "-c", WORKER, here],
                                          stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        for proc, job in zip(procs, jobs):
            pickle.dump((fn, job), proc.stdin)
            proc.stdin.close()
        results = []
        for proc in procs:
            raw = proc.stdout.read()
            if proc.wait() != 0:
                raise AssertionError(f"worker {fn} exited {proc.returncode}")
            results.append(pickle.loads(raw))
        return results
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()


def own_children() -> list[str]:
    """Every process whose parent is this one, running or not yet reaped
    (from /proc), as "pid (name)"."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        head, tail = stat[:stat.rindex(")") + 1], stat[stat.rindex(")") + 2:].split()
        if int(tail[1]) == os.getpid():
            found.append(head)
    return found


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
    """Phase 8: map_rule's rows against the plain version on the card (the
    first PLAIN_CHECK_X x of each rule) and the scalar mapper (the first
    SCALAR_CHECK x, in worker processes while the plain version runs);
    returns the max abs err and the plain version's ms per stage."""
    import concurrent.futures

    # two cores left to this process, so that the plain version's timing
    # does not wait for a core
    workers = max(1, (min(8, os.cpu_count() or 1) - 2) // len(CRUSH_RULES))
    step = -(-SCALAR_CHECK // workers)
    jobs = [(big, rule, result_max, lo, min(lo + step, SCALAR_CHECK))
            for rule, result_max in CRUSH_RULES for lo in range(0, SCALAR_CHECK, step)]
    pool = concurrent.futures.ThreadPoolExecutor(1)
    scalar = pool.submit(in_workers, "_scalar_rows", jobs)
    cm = tm.compile_map(big, device="cuda")
    xs = torch.arange(CRUSH_X, dtype=torch.int32, device="cuda")
    wv = torch.full((CRUSH_OSDS,), 0x10000, dtype=torch.int64, device="cuda")
    plain_ms, err = {}, 0
    for (rule, result_max), firstn in zip(CRUSH_RULES, (True, False)):
        params = stage_params(big, firstn, result_max, 1, True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        n = PLAIN_CHECK_X[rule]
        start.record()
        leaves = torch.cat([
            tm.choose_stage_plain(cm, xs[lo:min(lo + (1 << 18), n)], -1, wv, **params)[1]
            for lo in range(0, n, 1 << 18)])
        end.record()
        torch.cuda.synchronize()
        plain_ms[rule] = start.elapsed_time(end)
        want, _ = tm._assemble_blocks([(firstn, leaves.cpu().numpy())], n, result_max)
        rows = main[rule]["rows"][:n]
        err = max(err, int(np.abs(rows.astype(np.int64) - want.astype(np.int64)).max()))
        equal = np.array_equal(rows, want)
        print(f"  rule {rule}: map_rule rows == plain version on the card for the first "
              f"{n} x of {CRUSH_X}: {equal} (plain {plain_ms[rule]:.1f} ms)", flush=True)
        if not equal:
            pool.shutdown()
            raise AssertionError(f"rule {rule}: map_rule != plain version")

    parts = scalar.result()
    pool.shutdown()
    for rule, _result_max in CRUSH_RULES:
        want = [row for job, part in zip(jobs, parts) if job[1] == rule for row in part]
        rows, lengths = main[rule]["rows"], main[rule]["lengths"]
        bad = [x for x in range(SCALAR_CHECK)
               if rows[x, :lengths[x]].tolist() != want[x]]
        print(f"  rule {rule}: first {SCALAR_CHECK} x equal the scalar mapper: "
              f"{not bad}", flush=True)
        if bad:
            raise AssertionError(f"rule {rule}: x {bad[0]} differs from do_rule")
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
        kt = kernel_times(lambda: cc.crush_choose(cm, xs, -1, wv, **params), 10)
        ms = kt["ms"]
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
              f"{result_max}, {CRUSH_X} x): kernel {times_text(kt)}, {n_draws} straw2 draws "
              f"({n_draws / CRUSH_X:.2f} per x) x {ops_per_draw} int ops / "
              f"{INT32_OPS_PER_S:.4g} ops/s = bound {ops_ms:.4f} ms (bytes {bytes_ms:.5f} "
              f"ms for {moved} B), share {bound_ms / ms:.3f} "
              f"(of the device time {bound_ms / kt['held_ms']:.3f}); plain {plain_ms[rule]:.1f} ms "
              f"over the first {PLAIN_CHECK_X[rule]} x; library call: none", flush=True)
        print(f"  [{smi}] map_rule rule {rule}: best of 3 {best:.4f} s = "
              f"{CRUSH_X / best:.1f} mappings/s (kernel {ms / 1e3 / best:.3f} of it); "
              f"CrushTester --show-statistics {m['tester_s']:.4f} s = mapping "
              f"{m['tester_map_s']:.4f} s + host aggregation "
              f"{m['tester_s'] - m['tester_map_s']:.4f} s "
              f"({CRUSH_X / m['tester_s']:.1f} x/s); crushtool --test {m['tool_s']:.4f} s",
              flush=True)
        stats[rule] = dict(kt, bound_ms=bound_ms, plain_ms=plain_ms[rule])
    return stats


# -- the balancer path ------------------------------------------------------------

BAL_OSDS = 1024
BAL_REP_PGS = 262_144
BAL_EC_PGS = 32_768
BAL_CHANGES = 2048
#: calc_pg_upmaps passes timed in phase 12, each on a fresh map: a pass's
#: host clock spreads by several tenths of a second between runs; one pass
#: for the 1200 s limit, the pass under torch.profiler a second reading
BAL_PASSES = 1
#: PGs a pool sampled for the scalar check, a cut for the 1200 s limit
BAL_SAMPLE = 512
BAL_SCENARIO = dict(n_osd=BAL_OSDS, rep_pg_num=BAL_REP_PGS, ec_pg_num=BAL_EC_PGS,
                    seed=1, epochs=1, max_changes=BAL_CHANGES)
PSIM_ARGV = ["--scenario", "--osds", str(BAL_OSDS), "--rep-pgs", str(BAL_REP_PGS),
             "--ec-pgs", str(BAL_EC_PGS), "--epochs", "1", "--seed", "1",
             "--max-changes", str(BAL_CHANGES), "--json", "--device", "cuda"]
#: operations upmap_score's function needs, as (integer, float32) per
#: occurrence, by how far a candidate (row, slot s, target t) gets through
#: its rules (the kernel's loop control, shuffle reduction and loads are
#: not counted); score_ops counts the occurrences on this run's inputs
SCORE_OPS = {
    "target": (2, 1),     # per OSD: valid && dom >= 0; tdev < -max_dev
    "source": (4, 1),     # per (row, slot): placed, domain >= 0, &&, the
                          # slot's occupied-domain id; fdev > max_dev
    "member": (4, 0),     # per (row, valid target, slot): == t and | (t in
                          # the row), == tdom and | (t's domain occupied)
    "candidate": (2, 0),  # source ok, t valid and not in the row: the domain
                          # rule (same domain | domain not occupied)
    "dom_ok": (0, 2),     # domain rule held: d = fdev - tdev, d > 1
    "d_ok": (1, 0),       # d > 1: the band, fdev > max_dev | tdev < -max_dev
    "legal": (0, 2),      # legal: g = d - 1, the argmax compare
}


def score_ops(up, dev, valid, dom, max_dev, chunk: int) -> tuple[int, int]:
    """(integer, float32) operations upmap_score's function needs on these
    inputs: SCORE_OPS times how often a candidate gets that far, from the
    masks of the plain version, `chunk` rows at a time."""
    c, s = up.shape
    n = dev.shape[0] - 1
    max_dev = torch.tensor(max_dev, dtype=torch.float32, device=dev.device)
    tdev, tdom = dev[:-1], dom[:-1]
    tval = valid[:-1] & (tdom >= 0)
    seen = {"target": n, "source": c * s, "member": c * int(tval.sum()) * s}
    targets = torch.arange(n, dtype=up.dtype, device=up.device)
    for lo in range(0, c, chunk):
        frm = up[lo:lo + chunk]
        fc = torch.where(frm >= 0, frm, n).clamp(max=n).long()
        fdev, fdom = dev[fc], dom[fc]
        reach = tval[None, :] & ~(frm[:, :, None] == targets).any(dim=1)        # (C, N)
        occ = (torch.where(frm >= 0, fdom, -2)[:, :, None] == tdom).any(dim=1)   # (C, N)
        src_ok = (frm >= 0) & (fdom >= 0)                                         # (C, S)
        cand = src_ok[:, :, None] & reach[:, None, :]                             # (C, S, N)
        dom_ok = cand & (~occ[:, None, :] | (fdom[:, :, None] == tdom))
        d_ok = dom_ok & (fdev[:, :, None] - tdev > 1.0)
        legal = d_ok & ((fdev > max_dev)[:, :, None] | (tdev < -max_dev))
        for k, mask in (("candidate", cand), ("dom_ok", dom_ok), ("d_ok", d_ok),
                        ("legal", legal)):
            seen[k] = seen.get(k, 0) + int(mask.sum())
    return (sum(SCORE_OPS[k][0] * v for k, v in seen.items()),
            sum(SCORE_OPS[k][1] * v for k, v in seen.items()))


def round1_inputs(balance, tm, m) -> tuple[list[tuple[str, tuple]], float]:
    """Round 1 of calc_pg_upmaps on map m, the scorer's inputs on the card
    as its score_round builds them: (pool name, (up, dev, valid, dom,
    max_dev)) per pool, and the spread the pass starts from."""
    n = m.max_osd
    weights = np.asarray(m.osd_weight * (m.osd_exists & m.osd_up), dtype=np.int64)
    counts = np.zeros(n, dtype=np.int64)
    total = 0
    rows = {}
    for pid in sorted(m.pools):
        pool = m.pools[pid]
        total += pool.pg_num * pool.size
        rows[pid] = np.array(m.pool_mappings(pid), dtype=np.int32)
        counts += np.bincount(rows[pid][rows[pid] != tm.CRUSH_ITEM_NONE], minlength=n)[:n]
    target = weights.astype(np.float64) * (total / int(weights.sum()))
    considered = (weights > 0) | (counts > 0)
    spread = float(np.abs((counts - target)[considered]).max())
    dev = torch.from_numpy(np.concatenate(
        [(counts - target).astype(np.float32), [np.float32(0.0)]])).cuda()
    valid = torch.from_numpy(np.concatenate([weights > 0, [False]])).cuda()
    out = []
    for pid, r in rows.items():
        pool = m.pools[pid]
        rule = m.find_rule(pool.crush_rule, pool.type, pool.size)
        dom = balance._dense_domains(balance.rule_failure_domains(m.crush, rule, n))
        up = torch.from_numpy(np.where(r == tm.CRUSH_ITEM_NONE, -1, r)).cuda()
        dom = torch.from_numpy(np.concatenate([dom, [np.int32(-2)]])).cuda()
        out.append(("EC pool" if pool.is_erasure() else "replicated pool",
                    (up, dev, valid, dom, 1.0)))
    return out, spread


def score_err(name, got, want, quiet=False) -> float:
    """Kernel vs plain scores: bit-exact or the phase fails; returns the max
    abs difference (gain where both are finite, from and to)."""
    (g, f, t), (pg, pf, pt) = got, want
    equal = (torch.equal(g.view(torch.int32), pg.view(torch.int32))
             and torch.equal(f, pf) and torch.equal(t, pt))
    err = 0.0
    if g.numel():
        fin = torch.isfinite(g) & torch.isfinite(pg)
        if not torch.equal(torch.isfinite(g), torch.isfinite(pg)):
            err = float("inf")
        elif bool(fin.any()):
            err = float((g[fin] - pg[fin]).abs().max())
        err = max(err, float((f.long() - pf.long()).abs().max()),
                  float((t.long() - pt.long()).abs().max()))
    if not quiet or not equal:
        legal = int(torch.isfinite(pg).sum())
        print(f"  {name}: rows {g.numel()}, rows with a legal move {legal}, "
              f"max_abs_err {err}, equal {equal}", flush=True)
    if not equal:
        raise AssertionError(f"upmap_score kernel != plain for {name}")
    return err


def plain_chunks(balance, args, chunk: int):
    up = args[0]
    parts = [balance.score_chunk_plain(up[lo:lo + chunk], *args[1:])
             for lo in range(0, up.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


#: an instantiation of the scoring kernel, in csrc/upmap_score.cu's launcher
#: and in the kernel names torch.profiler reports
UPMAP_INSTANTIATION = re.compile(r"upmap_score_(?:regs<\d+, (?:true|false)>|generic<(?:true|false)>)")

#: csrc/upmap_score.cu with the generic kernel's argmax (one running best,
#: compared by flat index s * n + t) in the register instantiations, in
#: place of their per-slot first maxima: phase 12 times it against the
#: source as it is, which is why the two procedures stay apart
FLAT_ARGMAX = [
    ("float (&best)[S],\n    int (&best_t)[S]) {", "float& best, int& best_idx) {"),
    ("      if (ok && g > best[s]) {\n        best[s] = g;\n        best_t[s] = t;\n      }",
     "      const int idx = s * n + t;\n"
     "      if (ok && better(g, idx, best, best_idx)) {\n"
     "        best = g;\n        best_idx = idx;\n      }"),
    ("    float best[S];\n    int best_t[S];\n#pragma unroll\n    for (int s = 0; s < S; ++s) {\n"
     "      best[s] = -inf;\n      best_t[s] = 0;\n    }\n",
     "    float bg = -inf;\n    int bi = NO_INDEX;\n"),
    ("over, best, best_t);", "over, bg, bi);"),
    ("    float bg = -inf;\n    int bi = NO_INDEX;\n#pragma unroll\n    for (int s = 0; s < S; ++s) {\n"
     "      if (best[s] > bg) {\n        bg = best[s];\n        bi = s * n + best_t[s];\n"
     "      }\n    }\n", ""),
]


def flat_argmax_lib(uc) -> ctypes.CDLL:
    """Builds FLAT_ARGMAX's variant of the scoring kernel under _build/ and
    loads it with the same C signature. Fails if the source no longer has
    the text the variant replaces."""
    cb = uc.cuda_build
    with open(os.path.join(cb.CSRC_DIR, "upmap_score.cu")) as f:
        src = f.read()
    for old, new in FLAT_ARGMAX:
        if src.count(old) < 1:
            raise AssertionError(f"upmap_score.cu no longer has {old!r}")
        src = src.replace(old, new)
    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    path = os.path.join(cb.BUILD_DIR, "upmap_score_flat_argmax.cu")
    with open(path, "w") as f:
        f.write(src)
    lib_path = path[:-3] + ".so"
    done = subprocess.run([cb.nvcc(), *cb.NVCC_FLAGS, "-o", lib_path, path],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"flat-argmax variant build failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.upmap_score_launch.argtypes = uc._lib().upmap_score_launch.argtypes
    lib.upmap_score_launch.restype = ctypes.c_int
    return lib


def crafted_scores(balance, crush_bench, round1):
    """Chunks the scenario does not make: (name, args) on the card."""
    rng = np.random.default_rng(SEED)
    (up3, dev, valid, dom3, _), (up6, _, _, dom6, _) = round1
    n = dev.shape[0] - 1

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def dev_of(counts, target):
        return cuda(np.concatenate([(counts - target).astype(np.float32), [np.float32(0)]]))

    rows = up3[:32768].contiguous()
    ties = dev_of(rng.integers(958, 963, n), 960.5)  # equal weights: integer gains tie
    cases = [("ties, equal weights", (rows, ties, valid, dom3, 1.0)),
             ("ties, max_dev 0", (rows, ties, valid, dom3, 0.0)),
             ("all-illegal (flat deviations)", (rows, torch.zeros_like(dev), valid, dom3, 1.0))]
    # float32 rounding ties between slots: half the OSDs 700 + 0..3 ulps of
    # 700 (2^-14), half -2500 less distinct multiples of 0.5, so on a row's
    # one best target fdev - tdev (ulp 2^-12) rounds alike for sources that
    # differ, and the lower slot must win
    high = rng.random(n) < 0.5
    ulps = np.where(high, np.float32(700) + rng.integers(0, 4, n).astype(np.float32)
                    * np.float32(2**-14),
                    np.float32(-2500) - rng.permutation(n).astype(np.float32) * np.float32(0.5))
    ulps = cuda(np.concatenate([ulps.astype(np.float32), [np.float32(0)]]))
    cases.append(("S = 3, float32 rounding ties between slots", (rows, ulps, valid, dom3, 1.0)))
    cases.append(("S = 6, float32 rounding ties between slots",
                  (up6[:8192].contiguous(), ulps, valid, dom6, 1.0)))
    holes = rows.clone()
    holes[cuda(rng.random(holes.shape) < 0.25)] = -1
    holes[:64] = -1
    cases.append(("NONE slots", (holes, ties, valid, dom3, 0.5)))
    unreachable = dom3.clone()
    unreachable[:n][cuda(rng.random(n) < 0.3)] = -1
    cases.append(("unreachable (-1) domains", (rows, ties, valid, unreachable, 1.0)))
    hosts = np.argsort(rng.random((8192, n // 8)), axis=1)[:, :11]
    wide = (hosts * 8 + rng.integers(0, 8, hosts.shape)).astype(np.int32)
    cases.append(("S = 11 rows", (cuda(wide), ties, valid, dom6, 1.0)))

    big = crush_bench.build_map(CRUSH_OSDS)
    dom_big = balance._dense_domains(balance.rule_failure_domains(big, 0, CRUSH_OSDS))
    hosts = np.argsort(rng.random((4096, CRUSH_OSDS // 50)), axis=1)[:, :3]
    up_big = (hosts * 50 + rng.integers(0, 50, hosts.shape)).astype(np.int32)
    cases.append(("n = 10,000 (crush_bench.build_map)", (
        cuda(up_big), dev_of(rng.integers(20, 42, CRUSH_OSDS), 30.7),
        cuda(np.concatenate([rng.random(CRUSH_OSDS) > 0.05, [False]])),
        cuda(np.concatenate([dom_big, [np.int32(-2)]]).astype(np.int32)), 1.0)))
    # past the kernel's shared-memory staging: targets read from global
    # memory, in each instantiation
    wide_n = 30_000
    wide_dev = dev_of(rng.integers(20, 42, wide_n), 30.7)
    wide_valid = cuda(np.concatenate([rng.random(wide_n) > 0.05, [False]]))
    wide_dom = cuda(np.concatenate([np.arange(wide_n) // 50, [-2]]).astype(np.int32))
    for s in (3, 6, 11):
        hosts = np.argsort(rng.random((2048, wide_n // 50)), axis=1)[:, :s]
        cases.append((f"S = {s}, n = {wide_n:,} (targets not staged in shared memory)", (
            cuda((hosts * 50 + rng.integers(0, 50, hosts.shape)).astype(np.int32)),
            wide_dev, wide_valid, wide_dom, 1.0)))
    return cases


def phase_upmap_kernels(uc, balance, tm, build_cluster, crush_bench):
    """Phase 10: the scoring kernel against its plain version on the card.
    The launches run under torch.profiler, and the phase fails unless every
    instantiation that the source's launcher names was launched."""
    t0 = time.perf_counter()
    m = build_cluster(BAL_OSDS, rep_pg_num=BAL_REP_PGS, ec_pg_num=BAL_EC_PGS, device="cuda")
    pools, spread = round1_inputs(balance, tm, m)
    print(f"  round 1 of calc_pg_upmaps on the balancer cell's map (what "
          f"BalancerModule.run_once scores first): inputs rebuilt in "
          f"{time.perf_counter() - t0:.4f} s, spread before {spread}", flush=True)
    round1 = [args for _, args in pools]
    cases = [(f"round 1, {name}: the main path's whole-pool launch {tuple(args[0].shape)}",
              args) for name, args in pools]
    cases += crafted_scores(balance, crush_bench, round1)
    chunks = [balance.plain_chunk_rows(args[0].shape[1], args[1].shape[0] - 1)
              for _, args in cases]
    wants = [plain_chunks(balance, args, c) for (_, args), c in zip(cases, chunks)]
    got, chunk_got = [], []

    def launch_all():
        got.extend(uc.upmap_score(*args) for _, args in cases)
        # round 1 again in the JAX package's chunks, each launched alone
        for (_, args), c in zip(cases[:len(pools)], chunks):
            up = args[0]
            chunk_got.append([uc.upmap_score(up[lo:lo + c], *args[1:])
                              for lo in range(0, up.shape[0], c)])

    _, busy = profiled(launch_all)
    errs = [score_err(name, g, w) for (name, _), g, w in zip(cases, got, wants)]
    for (name, _), c, want, parts in zip(pools, chunks, wants, chunk_got):
        errs += [score_err(f"chunk {i}", part, tuple(w[i * c:(i + 1) * c] for w in want),
                           quiet=True) for i, part in enumerate(parts)]
        print(f"  round 1, {name}: {len(parts)} chunks of {c} rows (the JAX package's "
              "chunking), each launched alone: equal True", flush=True)
    with open(os.path.join(os.path.dirname(os.path.abspath(uc.__file__)), os.pardir, "csrc",
                           "upmap_score.cu")) as f:
        named = set(UPMAP_INSTANTIATION.findall(f.read()))
    ran = {}
    for kname, (n, _ms) in busy.items():
        for inst in UPMAP_INSTANTIATION.findall(kname):
            ran[inst] = ran.get(inst, 0) + n
    print(f"  instantiations launched in this phase (torch.profiler): "
          f"{', '.join(f'{k} x{n}' for k, n in sorted(ran.items()))}; the launcher names "
          f"{len(named)}", flush=True)
    if not named or set(ran) != named:
        raise AssertionError(f"phase 10 launched {sorted(ran)}, the launcher names "
                             f"{sorted(named)}")
    return max(errs), round1, spread


class FakeMon:
    """The mon client BalancerModule talks to, in process: the committed map
    and the two commands the module sends, applied as the mon applies them."""

    def __init__(self, osdmap, compile_crushmap):
        self.osdmap, self.compile, self.commands = osdmap, compile_crushmap, []

    async def wait_for_map(self):
        return self.osdmap

    async def command(self, name, args):
        self.commands.append(name)
        m = self.osdmap
        if name == "osd pg-upmap-items":
            for key, items in args["mappings"].items():
                pg = tuple(int(v) for v in key.split("."))
                if items:
                    m.pg_upmap_items[pg] = [tuple(p) for p in items]
                else:
                    m.pg_upmap_items.pop(pg, None)
            m.epoch += 1
            return {"applied": len(args["mappings"])}
        if name == "osd crush set":
            m.crush = self.compile(args["crush_text"])
            m.invalidate_compiled()
            m.epoch += 1
            return {}
        raise ValueError(f"unexpected mon command {name}")


def run_psim(psim, argv) -> tuple[str, float]:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = psim.main(argv)
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"psim {' '.join(argv)} exited {rc}")
    return buf.getvalue(), secs


def phase_balancer_main(psim, BalancerModule, build_cluster, compile_crushmap) -> dict:
    """Phase 11: psim's scenario and both balancer modes, as a user runs them."""
    first, s1 = run_psim(psim, PSIM_ARGV)
    # the second run is --measure's: its report is the first's plus "timing"
    measured, s2 = run_psim(psim, PSIM_ARGV + ["--measure"])
    report, again = json.loads(first), json.loads(measured)
    timing = again.pop("timing")
    print(f"  psim {' '.join(PSIM_ARGV)}: {s1:.4f} s, again with --measure {s2:.4f} s, "
          f"reports equal but for its timing {again == report}", flush=True)
    if again != report:
        raise AssertionError("psim's scenario report is not deterministic")
    print(f"  report: pg_instances {report['pg_instances']}, epochs "
          f"{[(e['pgs_moved'], len(e['events'])) for e in report['epochs']]}, "
          f"balance {report['balance']}, final_spread {report['final_spread']}", flush=True)
    print(f"  psim --measure timing {timing}", flush=True)

    out = {"report": report, "timing": timing}
    for mode in ("upmap", "crush-compat"):
        live = build_cluster(BAL_OSDS, rep_pg_num=BAL_REP_PGS, ec_pg_num=BAL_EC_PGS,
                             device="cuda")
        mon = FakeMon(live, compile_crushmap)
        module = BalancerModule(mon, device="cuda")
        t0 = time.perf_counter()
        res = asyncio.run(module.run_once(mode=mode, max_deviation=1.0,
                                          max_changes=BAL_CHANGES))
        secs = time.perf_counter() - t0
        shown = {k: v for k, v in res.items() if k != "mappings"}
        print(f"  BalancerModule.run_once(mode={mode!r}): {secs:.4f} s, {shown}, "
              f"mon commands {mon.commands}", flush=True)
        out[mode] = dict(live=live, result=res, seconds=secs, perf=module.perf.dump())
    return out


def _scalar_up_rows(job):
    """Worker: the port's scalar pipeline for each (pool, ps) of the job."""
    from ceph_tpu_torch.osd.osdmap import OSDMap

    raw, pgs = job
    m = OSDMap.decode(raw, device="cpu")
    return [m.pg_to_up_acting_osds(pid, ps)[0] for pid, ps in pgs]


def check_balancer_outputs(tm, balance, OSDMap, bal, spread1) -> None:
    """Phase 11b: the main path's outputs against the scalar pipeline and the
    placement rules; `spread1` is the spread of phase 10's rebuilt round 1."""
    if bal["upmap"]["result"]["spread_before"] != spread1:
        raise AssertionError("phase 10's round 1 is not the balancer module's: spread "
                             f"{spread1} != {bal['upmap']['result']['spread_before']}")
    for name, b in (("psim scenario", bal["report"]["balance"]),
                    ("BalancerModule upmap", bal["upmap"]["result"])):
        if not (0 < b["changes"] <= BAL_CHANGES and b["spread_after"] <= b["spread_before"]):
            raise AssertionError(f"{name}: changes {b['changes']}, spread "
                                 f"{b['spread_before']} -> {b['spread_after']}")
    live = bal["upmap"]["live"]
    if len(live.pg_upmap_items) != len(bal["upmap"]["result"]["mappings"]):
        raise AssertionError("the mon did not commit the balancer's mappings")
    rng = np.random.default_rng(SEED)
    pgs = set(live.pg_upmap_items)
    for pid, pool in live.pools.items():
        pgs |= {(pid, int(ps)) for ps in rng.choice(pool.pg_num, BAL_SAMPLE, replace=False)}
    pgs = sorted(pgs)
    rows = {pid: live.pool_mappings(pid) for pid in live.pools}
    workers = min(8, os.cpu_count() or 1)
    step = -(-len(pgs) // workers)
    raw = live.encode()
    t0 = time.perf_counter()
    parts = in_workers("_scalar_up_rows", [(raw, pgs[lo:lo + step])
                                           for lo in range(0, len(pgs), step)])
    want = [up for part in parts for up in part]
    bad = []
    for (pid, ps), up in zip(pgs, want):
        row = np.full(live.pools[pid].size, tm.CRUSH_ITEM_NONE, np.int32)
        row[:len(up)] = up
        if not np.array_equal(rows[pid][ps], row):
            bad.append((pid, ps))
    print(f"  {len(live.pg_upmap_items)} upmapped PGs + {BAL_SAMPLE} sampled per pool: "
          f"{len(pgs)} pool_mappings rows equal the scalar pipeline: {not bad} "
          f"({workers} worker processes, {time.perf_counter() - t0:.2f} s)", flush=True)
    if bad:
        raise AssertionError(f"pool_mappings differs from the scalar pipeline at {bad[:5]}")
    for pid, pool in live.pools.items():
        rule = live.find_rule(pool.crush_rule, pool.type, pool.size)
        host = balance.rule_failure_domains(live.crush, rule, live.max_osd)
        for ps in {ps for p, ps in pgs if p == pid}:
            placed = [int(o) for o in rows[pid][ps] if o != tm.CRUSH_ITEM_NONE]
            if len(placed) != pool.size or len(set(placed)) != len(placed) \
                    or len({int(host[o]) for o in placed}) != len(placed):
                raise AssertionError(f"pg {pid}.{ps} {placed}: not one OSD per host")
    print("  every checked PG: full size, no duplicate OSD, one replica per host: True",
          flush=True)

    res, live = bal["crush-compat"]["result"], bal["crush-compat"]["live"]
    if not (res["changes"] > 0 and res["spread_after"] < res["spread_before"]):
        raise AssertionError(f"crush-compat made no progress: {res}")
    args = live.crush.choose_args
    straw2 = [bid for bid, b in live.crush.buckets.items() if b.items]
    if sorted(args) != sorted(straw2):
        raise AssertionError("the committed map lacks a compat weight-set")
    # the committed weight-sets, compiled, map as the run-time overlay of
    # the same weights over the map compiled without them
    bare = OSDMap.decode(live.encode(), device="cuda")
    bare.crush.choose_args, bare.crush.choose_args_maps = {}, {}
    bare.invalidate_compiled()
    rt = tm.runtime_weight_arrays(bare._compile(), {b: a.weight_set for b, a in args.items()})
    counts = np.zeros(live.max_osd, np.int64)
    for pid in live.pools:
        got = live.pool_mappings(pid)
        if not np.array_equal(got, bare.pool_mappings(pid, runtime_weights=rt)):
            raise AssertionError(f"pool {pid}: compiled weight-set != run-time overlay")
        counts += np.bincount(got[got != tm.CRUSH_ITEM_NONE], minlength=live.max_osd)
    expect = counts.sum() / live.max_osd
    print(f"  crush-compat: {len(args)} weight-sets committed; the committed map equals "
          f"the run-time overlay of its weights on both pools: True; its spread "
          f"{float(np.abs(counts - expect).max()):.4f} (module's best iterate "
          f"{res['spread_after']:.4f}, before {res['spread_before']:.4f}; the text "
          "form keeps 3 decimals of each weight)", flush=True)


def profiled(fn) -> tuple[float, dict]:
    """Runs fn under torch.profiler; returns its host-clock seconds and
    {name: (count, ms)} of the kernels and copies the card ran meanwhile
    (the opening op's few microseconds included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the first launches after the window opens came back without device
        # events (2 of 12 short calls): open it with a small op and a pause
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_busy(prof)


def device_busy(prof) -> dict[str, tuple[int, float]]:
    """{name: (count, ms)} of the kernels and copies a profile saw on the card."""
    from torch.autograd import DeviceType

    busy: dict[str, tuple[int, float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = busy.get(e.name, (0, 0.0))
            busy[e.name] = (n + 1, ms + e.device_time_total / 1e3)
    return busy


def crush_round(balance, tm, big, rows) -> list[tuple]:
    """A scoring round at CRUSH_OSDS OSDs on real CRUSH rows: the scorer's
    inputs for `rows` (rule 0 of `big`, 3 replicas over hosts), every OSD a
    valid target, dev their per-OSD counts less the equal-weight target."""
    n = CRUSH_OSDS
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    counts = np.bincount(rows[rows != tm.CRUSH_ITEM_NONE], minlength=n)[:n]
    dev = np.concatenate([(counts - counts.sum() / n).astype(np.float32), [np.float32(0)]])
    dom = balance._dense_domains(balance.rule_failure_domains(big, 0, n))
    return [(torch.from_numpy(np.where(rows == tm.CRUSH_ITEM_NONE, -1, rows)).cuda(),
             torch.from_numpy(dev).cuda(),
             torch.from_numpy(np.concatenate([np.ones(n, bool), [False]])).cuda(),
             torch.from_numpy(np.concatenate([dom, [np.int32(-2)]]).astype(np.int32)).cuda(),
             1.0)]


def time_score_round(uc, balance, rnd, label, smi, flat_lib=None) -> dict:
    """The scoring kernel over one round `rnd` ((up, dev, valid, dom,
    max_dev) per pool) beside its operation bound and its plain version,
    then its two ways of reading the per-target arrays, alternated, and
    with `flat_lib` the kernel against its flat-argmax variant, alternated."""
    chunks = [balance.plain_chunk_rows(a[0].shape[1], a[1].shape[0] - 1) for a in rnd]
    want = [plain_chunks(balance, a, c) for a, c in zip(rnd, chunks)]
    for a, w in zip(rnd, want):
        score_err(f"{label} {tuple(a[0].shape)}", uc.upmap_score(*a), w)
    kt = kernel_times(lambda: [uc.upmap_score(*a) for a in rnd], 10)
    ms = kt["ms"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a, c in zip(rnd, chunks):
        plain_chunks(balance, a, c)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    candidates = sum(a[0].shape[0] * a[0].shape[1] * (a[1].shape[0] - 1) for a in rnd)
    int_ops = fp_ops = 0
    for a, c in zip(rnd, chunks):
        i, f = score_ops(*a, chunk=c)
        int_ops, fp_ops = int_ops + i, fp_ops + f
    moved = sum(a[0].numel() * 4 + a[1].numel() * 9 + a[0].shape[0] * 12 for a in rnd)
    # the SM runs integer and float32 operations in separate pipes
    int_ms = int_ops / INT32_OPS_PER_S * 1e3
    fp_ms = fp_ops / FP32_OPS_PER_S * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound_ms = max(int_ms, fp_ms, bytes_ms)
    print(f"  [{smi}] upmap_score, {label} ({' + '.join(str(tuple(a[0].shape)) for a in rnd)} "
          f"rows x {rnd[0][1].shape[0] - 1} OSDs = {candidates} candidates): kernel "
          f"{times_text(kt)} ({candidates / ms / 1e6:.1f} G candidates/s); the function needs "
          f"{int_ops} integer ops / {INT32_OPS_PER_S:.4g} ops/s = {int_ms:.4f} ms and "
          f"{fp_ops} float32 ops / {FP32_OPS_PER_S:.4g} ops/s = {fp_ms:.4f} ms "
          f"({(int_ops + fp_ops) / candidates:.3f} per candidate); bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.5f} ms for {moved} B), share {bound_ms / ms:.3f} "
          f"(of the device time {bound_ms / kt['held_ms']:.3f}); plain "
          f"{plain_ms:.1f} ms; library call: none", flush=True)

    # the two ways the kernel reads the per-target arrays, alternated at
    # this n: staged in each block's shared memory, or from global memory
    lib = uc._lib()
    outs = [tuple(torch.empty(a[0].shape[0], dtype=dt, device="cuda")
                  for dt in (torch.float32, torch.int32, torch.int32)) for a in rnd]

    def launch(staged: int, lib=lib) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        for (up, dev, valid, dom, max_dev), (g, f, t) in zip(rnd, outs):
            err = lib.upmap_score_launch(
                up.data_ptr(), dev.data_ptr(), valid.data_ptr(), dom.data_ptr(),
                float(np.float32(max_dev)), dev.shape[0] - 1, up.shape[1], up.shape[0],
                g.data_ptr(), f.data_ptr(), t.data_ptr(), staged, stream)
            if err:
                raise RuntimeError(f"upmap_score_launch(staged={staged}): CUDA error {err}")

    variant = {1: [], 0: []}
    for staged in (1, 0, 1, 0):
        variant[staged].append(cuda_ms(lambda: launch(staged), 10))
        for o, w in zip(outs, want):
            score_err(f"staged={staged}", o, w, quiet=True)
    print(f"  [{smi}] upmap_score per-target arrays, {label}, alternated: staged in shared "
          f"memory {', '.join(f'{x:.4f}' for x in variant[1])} ms; read from global memory "
          f"{', '.join(f'{x:.4f}' for x in variant[0])} ms; both equal the plain version",
          flush=True)
    if flat_lib is not None:
        argmax = {"per-slot": [], "flat": []}
        for kind in ("per-slot", "flat", "per-slot", "flat"):
            which = lib if kind == "per-slot" else flat_lib
            argmax[kind].append(cuda_ms(lambda: launch(1, which), 10))
            for o, w in zip(outs, want):
                score_err(f"{kind} argmax", o, w, quiet=True)
        print(f"  [{smi}] upmap_score argmax of the register instantiations, {label}, "
              f"alternated: per-slot first maxima (the source) "
              f"{', '.join(f'{x:.4f}' for x in argmax['per-slot'])} ms; the generic kernel's "
              f"flat-index compare {', '.join(f'{x:.4f}' for x in argmax['flat'])} ms; both "
              "equal the plain version", flush=True)
    return {**kt, "plain_ms": plain_ms, "bound_ms": bound_ms}


def phase_balancer_times(uc, balance, tm, build_cluster, BalancerModule, OSDMap,
                         compile_crushmap, round1, bal, big, crush_rows, smi) -> dict:
    """Phase 12: the scoring kernel over one round beside its bound and its
    plain version, at the balancer cell and at CRUSH_OSDS OSDs;
    calc_pg_upmaps split, and each crush-compat iteration."""
    times = time_score_round(uc, balance, round1, "one round at the balancer cell", smi,
                             flat_argmax_lib(uc))
    time_score_round(uc, balance, crush_round(balance, tm, big, crush_rows[:BAL_REP_PGS]),
                     f"one round at {CRUSH_OSDS:,} OSDs (rule-0 rows of x = 0.."
                     f"{BAL_REP_PGS - 1:,})", smi)
    ms = times["ms"]

    for run in range(BAL_PASSES):
        m = build_cluster(BAL_OSDS, rep_pg_num=BAL_REP_PGS, ec_pg_num=BAL_EC_PGS,
                          device="cuda")
        for pid in m.pools:
            m.pool_mappings(pid)  # the compile cache is warm, as on a balancer tick
        map_s = []
        real = m.pool_mappings

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = real(*args, **kw)
            map_s.append(time.perf_counter() - t0)
            return out

        m.pool_mappings = timed
        t0 = time.perf_counter()
        res = balance.calc_pg_upmaps(m, max_deviation=1.0, max_changes=BAL_CHANGES)
        total = time.perf_counter() - t0
        greedy = total - sum(map_s) - res.score_seconds
        print(f"  [{smi}] calc_pg_upmaps pass {run + 1} of {BAL_PASSES} ({BAL_OSDS} OSDs, "
              f"{res.pgs} PG instances, budget {BAL_CHANGES}): {total:.4f} s = pool mapping "
              f"{sum(map_s):.4f} s ({len(map_s)} pools) + scoring {res.score_seconds:.4f} s "
              f"({res.rounds} rounds, {res.launches - len(map_s)} kernel launches, "
              f"~{res.rounds * ms:.1f} ms of kernel; the rest copies and candidate lists) + "
              f"host greedy/revalidation {greedy:.4f} s; {res.changes} moves, spread "
              f"{res.spread_before:.4f} -> {res.spread_after:.4f}", flush=True)
    # the same pass on a fresh map under torch.profiler: how long the card
    # is busy (kernels and copies) against the host clock
    m = build_cluster(BAL_OSDS, rep_pg_num=BAL_REP_PGS, ec_pg_num=BAL_EC_PGS, device="cuda")
    for pid in m.pools:
        m.pool_mappings(pid)
    wall, busy = profiled(
        lambda: balance.calc_pg_upmaps(m, max_deviation=1.0, max_changes=BAL_CHANGES))
    busy_ms = sum(ms for _, ms in busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1][1])[:4]
    idle = f"{1 - busy_ms / 1e3 / wall:.5f}" if busy else "not measured (no device event traced)"
    print(f"  [{smi}] calc_pg_upmaps under torch.profiler: {wall:.4f} s, device busy "
          f"{busy_ms:.4f} ms ({len(busy)} kinds of device event), idle share {idle}; "
          "largest: " + "; ".join(f"{name[:60]} x{n} {ms:.4f} ms" for name, (n, ms) in top),
          flush=True)
    t = bal["timing"]
    print(f"  [{smi}] psim scenario: {t['pgs_mapped']} PGs mapped in {t['map_seconds']:.4f} s "
          f"= {t['pgs_mapped_per_s']:.1f} PGs/s; balance {t['balance_seconds']:.4f} s "
          f"(scoring {t['score_seconds']:.4f} s); total {t['total_seconds']:.4f} s", flush=True)

    calls = []
    real_cls = OSDMap.pool_mappings

    def timed_cls(self, *args, **kw):
        t0 = time.perf_counter()
        out = real_cls(self, *args, **kw)
        calls.append(time.perf_counter() - t0)
        return out

    live = build_cluster(BAL_OSDS, rep_pg_num=BAL_REP_PGS, ec_pg_num=BAL_EC_PGS, device="cuda")
    module = BalancerModule(FakeMon(live, compile_crushmap), device="cuda")
    OSDMap.pool_mappings = timed_cls
    try:
        t0 = time.perf_counter()
        res = asyncio.run(module.crush_compat())
        total = time.perf_counter() - t0
    finally:
        OSDMap.pool_mappings = real_cls
    pools = len(live.pools)
    per_iter = [sum(calls[i:i + pools]) for i in range(0, len(calls), pools)]
    print(f"  [{smi}] crush-compat pass: {total:.4f} s, {len(per_iter)} evaluations "
          f"(start + {len(per_iter) - 1} iterations), pool mapping with run-time "
          f"weights per evaluation (both pools): "
          f"{', '.join(f'{s:.4f}' for s in per_iter)} s; spread "
          f"{res.get('spread_before', 0.0):.4f} -> {res.get('spread_after', 0.0):.4f}",
          flush=True)
    return times


# -- the other EC families -------------------------------------------------------

#: (name, plugin, profile, erasure sets as physical ids, objects per batch).
#: clay's plane schedule and pairwise coupling are host numpy (as in the JAX
#: package), about 0.5 s per 4 MiB object and pass on the H100 machine's
#: host: its batch is cut to 4 objects for the 1200 s limit, every width
#: kept (PERF.md section 4)
CLAY_OBJECTS = 4
FAMILIES = [
    ("shec", "shec", {"k": "4", "m": "3", "c": "2"}, [(0, 5)], OBJECTS),
    ("lrc", "lrc", {"k": "4", "m": "2", "l": "3"}, [(0,), (0, 1)], OBJECTS),
    ("clay", "clay", {"k": "4", "m": "2", "d": "5"}, [(0, 5)], CLAY_OBJECTS),
    ("liberation", "jerasure", {"k": "4", "m": "2", "w": "7", "technique": "liberation",
                                "packetsize": "2048"}, [(1, 4)], OBJECTS),
]
#: clay's MSR single-node repair: the lost chunk
CLAY_REPAIR = 1
#: objects of each batch also run through the same codec on the CPU
CPU_CHECK_OBJECTS = 4
#: an m=1 planar codec (the reference's example XOR plugin's geometry)
XOR_PLUGIN, XOR_PROFILE = "jerasure", {"k": "2", "m": "1", "technique": "reed_sol_van"}
#: the corpus profiles of the other families (tests/corpus)
CORPUS_OTHER = [
    ("jerasure", {"k": "4", "m": "2", "w": "5", "technique": "liberation",
                  "packetsize": "32"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "w": "6", "technique": "blaum_roth",
                  "packetsize": "32"}, 4096),
    ("jerasure", {"k": "6", "m": "2", "technique": "liber8tion", "packetsize": "32"}, 4096),
    ("shec", {"k": "4", "m": "3", "c": "2"}, 4096),
    ("shec", {"k": "6", "m": "4", "c": "3"}, 4096),
    ("lrc", {"k": "4", "m": "2", "l": "3"}, 4096),
    ("clay", {"k": "4", "m": "2", "d": "5"}, 4096),
    ("clay", {"k": "8", "m": "4", "d": "11"}, 98304),
]
#: names of the new kernels in a torch.profiler trace
FAMILY_KERNELS = ("gf_matmul_bytes_kernel", "xor_rows_kernel", "xor_rowmatmul_kernel")


def byte_err(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Kernel output against its plain version, bit for bit; returns the
    max absolute byte difference (0, or the phase fails)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    err = byte_err(got.view(torch.uint8), want.view(torch.uint8))
    print(f"  {name}: {tuple(got.shape)}, max_abs_err {err}, equal {torch.equal(got, want)}",
          flush=True)
    if not torch.equal(got, want):
        raise AssertionError(f"kernel != plain for {name}")
    return err


def random_bytes(shape, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)


def family_codecs(factory) -> dict:
    """Each family's codec on the card, by name."""
    return {name: factory(plugin, dict(prof)) for name, plugin, prof, _e, _o in FAMILIES}


def phase_family_kernels(bp, gc, bmx, codecs, rs_codec) -> tuple[dict, list[str]]:
    """Phase 13: the four new kernels against their plain versions on the
    card, at the main path's shapes and on crafted ones, under
    torch.profiler: it fails unless every byte-form variant of the GF(2^8)
    kernel that the launcher names was launched. Returns the max errors and
    those variants."""
    errs = {"gf_matmul_bitplane": [], "xor_reduce": [], "xor_reduce_words": [],
            "xor_rowmatmul": []}
    _, busy = profiled(lambda: family_cases(bp, gc, bmx, codecs, rs_codec, errs))
    return ({name: max(v) for name, v in errs.items()},
            gf_variants_checked(gc, "bytes", busy, "13"))


def family_cases(bp, gc, bmx, codecs, rs_codec, errs) -> None:
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    chunk = OBJECT_BYTES // 4
    shec, lrc, lib = codecs["shec"], codecs["lrc"], codecs["liberation"]

    def b3(name, tables, data, device_memory=False):
        got = (device_memory_route(gc, tables.tables_t, data, False) if device_memory
               else bp.gf_matmul_bitplane(tables.bits_t, data, tables=tables.tables_t))
        errs["gf_matmul_bitplane"].append(
            check_equal(name, got, bp.gf_matmul_bitplane_plain(tables.bits_t, data)))

    def b4(name, data):
        errs["xor_reduce"].append(check_equal(name, bp.xor_reduce(data),
                                              bp.xor_reduce_plain(data)))

    def b5(name, mat, rows):
        got = bmx.xor_rowmatmul(mat.bits_t, rows, lists=mat.lists_t)
        errs["xor_rowmatmul"].append(
            check_equal(name, got, bmx.xor_rowmatmul_plain(mat.bits_t, rows)))

    # B3: the main path's shapes, then ragged, k = 1, strided, not GF(2^8)
    data = random_bytes((OBJECTS, 4, chunk), gen)
    b3("B3 shec k=4 m=3 encode", shec._encode, data)
    b3("B3 lrc global layer RS(4,2)", lrc.layers[0].erasure_code._encode, data)
    n = shec.k + shec.m
    want, avails = [1, 0, 0, 0, 0, 1, 0], [0, 1, 1, 1, 1, 0, 1]
    entry = shec._make_decoding_matrix(want, avails)
    surv = random_bytes((OBJECTS, n, chunk), gen)
    b3("B3 shec decode of {0,5} (inverse rows, strided survivors)", entry[4],
       surv[:, 1 : 1 + len(entry[0])])
    ragged = random_bytes((3, 6, 1000003), gen)
    b3("B3 ragged L = 1000003, strided", shec._encode, ragged[:, 1:5])
    rs1 = card_tables(gf_matrix=np.random.default_rng(SEED).integers(0, 256, (3, 1), np.uint8))
    b3("B3 k = 1, L = 77", rs1, random_bytes((5, 1, 77), gen))
    rng = np.random.default_rng(SEED + 13)
    foreign = card_tables(bits=(rng.random((40, 48)) < 0.5).astype(np.int8))
    b3("B3 random {0,1} bit-matrix (not GF(2^8)'s), r=5 k=6", foreign,
       random_bytes((OBJECTS, 6, chunk // 4 + 5), gen))
    # one object's width, MiniCluster's put (1, 8, 512 KiB) and its degraded
    # get (the survivors a strided view), then the tables from device memory
    obj_len = OBJECT_BYTES // K
    enc = rs_codec._encode
    b3(f"B3 isa k=8 m=3 encode at one object's width ({gf_plan(gc, obj_len // 16)})", enc,
       random_bytes((1, K, obj_len), gen))
    present = [i for i in range(K + M) if i not in ERASED][:K]
    surv = random_bytes((1, K + M, obj_len), gen)
    b3("B3 decode of {0,1,2} at one object's width, strided survivors",
       rs_codec.decode_bitmatrix(present, list(ERASED)), surv[:, M:])
    b3("B3 object width encode, tables from device memory", enc,
       random_bytes((1, K, obj_len), gen), device_memory=True)
    b3("B3 ragged L = 1000003, strided, tables from device memory", shec._encode,
       ragged[:, 1:5], device_memory=True)
    wide = card_tables(bits=(rng.random((8 * 12, 8 * 128)) < 0.5).astype(np.int8))
    b3("B3 r=12 k=128 (48 KiB of tables)", wide, random_bytes((2, 128, 4096), gen))
    # B4: lrc's local layer, then ragged, k = 1, strided
    b4("B4 lrc local layer k=3", random_bytes((OBJECTS, 3, chunk), gen))
    phys = random_bytes((OBJECTS, 8, chunk), gen)
    b4("B4 strided rows of the physical tensor", phys[:, 4:7])
    b4("B4 ragged L = 1000003", random_bytes((3, 3, 1000003), gen))
    b4("B4 k = 1 (a copy)", random_bytes((4, 1, 12345), gen))
    b4("B4 rows starting 3 bytes into their buffer (masked path)", phys[:, 4:7, 3:chunk])
    b4("B4 more items (70,000) than grid rows", random_bytes((70_000, 2, 48), gen))
    # B2: planar words, (k, 8 Mi) and the m=1 burst's (2, 32 Mi)
    for rows, n4 in ((K, N4), (2, 4 * N4), (3, N4 + 37)):
        words = random_words(rows, n4, gen)
        errs["xor_reduce_words"].append(check_equal(
            f"B2 ({rows}, {n4}) words", gc.xor_reduce_words(words),
            gc.xor_reduce_words_plain(words)))
    # B5: liberation encode at the main path's shape, its decode, ragged, strided
    L = lib.get_chunk_size(OBJECT_BYTES)
    rows = lib._rows(random_bytes((OBJECTS, 4, L), gen))
    b5("B5 liberation k=4 w=7 encode", lib._encode, rows)
    b5("B5 liberation decode of {1,4}", lib._decode_rows([0, 2, 3, 5], [1, 4]), rows)
    b5("B5 ragged P = 2048 * 3 + 12, strided",
       lib._encode, random_bytes((3, 30, 2048 * 3 + 12), gen)[:, 1:29])
    wide = bmx.RowMatrix(bmx.liberation_bitmatrix(17, 17), torch.device("cuda"))
    b5("B5 liberation k=17 w=17 (C = 289)", wide, random_bytes((2, 289, 4096), gen))


def card_tables(gf_matrix=None, bits=None):
    """CodingTables on the card for a GF(2^8) matrix or a {0,1} bit-matrix."""
    from ceph_tpu_torch.ec.rs import CodingTables
    from ceph_tpu_torch.ops.gf import matrix_to_bitmatrix

    bits = matrix_to_bitmatrix(gf_matrix) if bits is None else bits
    return CodingTables.from_bitmatrix(bits, torch.device("cuda"))


def bench_seconds(ec_bench, argv) -> float:
    """One ec_bench run (cold: the codec is built and its tables uploaded
    inside it); echoes its output and returns its `seconds` field."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = ec_bench.main(argv)
    text = out.getvalue()
    print("  ec_bench " + " ".join(argv) + ":\n    " + text.strip().replace("\n", "\n    "),
          flush=True)
    if rc != 0:
        raise AssertionError("ec_bench failed")
    return float(text.strip().splitlines()[-1].split("\t")[0])


def family_batch(codec, objects: int, gen: torch.Generator) -> torch.Tensor:
    return random_bytes((objects, codec.k, codec.get_chunk_size(OBJECT_BYTES)), gen)


def clay_batch_repair(codec, full: torch.Tensor, lost: int) -> tuple[int, int]:
    """MSR repair of chunk `lost` of every object in `full` (B, n, L) through
    repair_array, from the repair planes of d helpers only; returns (bytes
    read, bytes a plain k-chunk decode would read). Fails unless exact."""
    batch, n, length = full.shape
    S = codec.sub_chunk_no
    sc = length // S
    minimum = codec.minimum_to_decode({lost}, set(range(n)) - {lost})
    planes = [z for off, cnt in codec.get_repair_subchunks(codec._node_of(lost))
              for z in range(off, off + cnt)]
    helpers = {
        c: full[:, c].reshape(batch, S, sc)[:, planes].transpose(0, 1)
        .reshape(len(planes), batch * sc)
        for c in minimum
    }
    rebuilt = codec.repair_array(lost, helpers, batch * sc)
    got = rebuilt.reshape(S, batch, sc).transpose(0, 1).reshape(batch, length)
    if not torch.equal(got, full[:, lost]):
        raise AssertionError("clay repair_array did not rebuild the lost chunk")
    return sum(h.numel() for h in helpers.values()), codec.k * batch * length


def phase_family_main(factory, ec_bench, codecs) -> None:
    """Phase 14a: each family through ec_bench --batch (encode, and decode of
    each erasure set), then its batch encode and decode against the same
    codec on the CPU; clay's MSR repair of a whole batch."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for name, plugin, prof, erasure_sets, objects in FAMILIES:
        params = [x for key, v in prof.items() for x in ("-P", f"{key}={v}")]
        base = ["-p", plugin, *params, "--batch", str(objects), "-s", str(OBJECT_BYTES)]
        bench_seconds(ec_bench, base + ["-w", "encode"])
        for lost in erasure_sets:
            bench_seconds(
                ec_bench, base + ["-w", "decode"] + [x for c in lost for x in ("--erased", str(c))])
        codec, cpu = codecs[name], factory(plugin, dict(prof), device="cpu")
        data = family_batch(codec, objects, gen)
        parity = codec.encode_array(data)
        full = torch.cat([data, parity], dim=1)
        check = data[:CPU_CHECK_OBJECTS].cpu()
        if not torch.equal(cpu.encode_array(check), parity[:CPU_CHECK_OBJECTS].cpu()):
            raise AssertionError(f"{name}: card encode != CPU encode")
        n = codec.get_chunk_count()
        for lost in erasure_sets:
            logical = sorted(codec.logical_index(c) for c in lost)
            present = [i for i in range(n) if i not in logical]
            got = codec.decode_array(present, logical, full[:, present])
            if not torch.equal(got, full[:, logical]):
                raise AssertionError(f"{name}: decode of {lost} did not rebuild the chunks")
            cpu_got = cpu.decode_array(present, logical, full[:CPU_CHECK_OBJECTS, present].cpu())
            if not torch.equal(cpu_got, got[:CPU_CHECK_OBJECTS].cpu()):
                raise AssertionError(f"{name}: card decode of {lost} != CPU decode")
        line = (f"  {name}: {objects} x {OBJECT_BYTES} B, chunk {data.shape[-1]} B; encode "
                f"and decode of {erasure_sets} equal the CPU codec on {CPU_CHECK_OBJECTS} "
                f"objects and rebuild all {objects}")
        if name == "clay":
            read, plain = clay_batch_repair(codec, full, CLAY_REPAIR)
            line += (f"; MSR repair of chunk {CLAY_REPAIR} via repair_array reads {read} B "
                     f"({read / plain:.3f} of a k-chunk decode's {plain} B), exact")
        print(line, flush=True)


def load_corpus(plugin, profile, stripe_width):
    parts = [f"plugin={plugin}", f"stripe-width={stripe_width}"]
    parts += [f"{key}={v}" for key, v in profile.items()]
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "corpus",
                     " ".join(parts))
    with open(os.path.join(d, "content"), "rb") as f:
        content = f.read()
    golden = {}
    for fname in os.listdir(d):
        if fname.startswith("chunk."):
            with open(os.path.join(d, fname), "rb") as f:
                golden[int(fname.split(".")[1])] = f.read()
    return content, golden


def decode_outcome(codec, lost, avail):
    from ceph_tpu_torch.ec.interface import ErasureCodeError

    try:
        out = codec.decode(set(lost), avail)
    except ErasureCodeError as e:
        return ("errno", e.code)
    return {i: out[i] for i in lost}


def phase_corpus_on_card(factory) -> int:
    """Phase 14b: the eight corpus profiles of these families on the card:
    re-encode to the golden chunks; every single and pair erasure rebuilt,
    or refused with the errno of the same codec on the CPU."""
    sets = 0
    for plugin, prof, sw in CORPUS_OTHER:
        content, golden = load_corpus(plugin, prof, sw)
        ec, cpu = factory(plugin, dict(prof)), factory(plugin, dict(prof), device="cpu")
        n = ec.get_chunk_count()
        if ec.encode(range(n), content) != golden:
            raise AssertionError(f"{plugin} {prof}: chunks drifted from the corpus")
        for lost in [(i,) for i in range(n)] + [(i, j) for i in range(n) for j in range(i + 1, n)]:
            avail = {i: golden[i] for i in range(n) if i not in lost}
            got = decode_outcome(ec, lost, avail)
            if got != decode_outcome(cpu, lost, avail):
                raise AssertionError(f"{plugin} {prof}: erasure {lost} differs from the CPU")
            if isinstance(got, dict) and got != {i: golden[i] for i in lost}:
                raise AssertionError(f"{plugin} {prof}: erasure {lost} mis-decoded")
            sets += 1
    print(f"  corpus: {len(CORPUS_OTHER)} profiles re-encode to their golden chunks; "
          f"{sets} single and pair erasure sets rebuilt or refused as on the CPU", flush=True)
    return sets


def phase_service_bursts(factory, EncodeService, codecs) -> None:
    """Phase 14c: EncodeService bursts of 64 x 4 MiB: the lrc codec (no planar
    API: per-object fallback), and an m=1 planar codec (one XOR launch)."""
    blob = np.random.default_rng(SEED + 15).bytes(OBJECTS * OBJECT_BYTES)
    objs = [blob[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES] for i in range(OBJECTS)]
    lrc_prof = next(prof for name, _p, prof, _e, _o in FAMILIES if name == "lrc")
    for name, plugin, prof in (("lrc", "lrc", lrc_prof), ("xor", XOR_PLUGIN, XOR_PROFILE)):
        codec = codecs["lrc"] if name == "lrc" else factory(plugin, dict(prof))
        svc = EncodeService()

        async def burst():
            return await asyncio.gather(*(svc.encode(codec, o) for o in objs))

        t0 = time.perf_counter()
        encoded = asyncio.run(burst())
        seconds = time.perf_counter() - t0
        cpu = factory(plugin, dict(prof), device="cpu")
        if encoded[0] != cpu.encode(range(cpu.get_chunk_count()), objs[0]):
            raise AssertionError(f"EncodeService {name}: object 0 differs from the CPU codec")
        if name == "xor":
            half = OBJECT_BYTES // 2
            for j in (0, OBJECTS - 1):
                a = np.frombuffer(objs[j][:half], np.uint8)
                b = np.frombuffer(objs[j][half:], np.uint8)
                if encoded[j][2] != (a ^ b).tobytes():
                    raise AssertionError("m=1 parity is not the XOR of the data chunks")
            if svc.launches != 1 or not codec._xor_ok:
                raise AssertionError(f"m=1 burst took {svc.launches} launches")
        print(f"  EncodeService {name} ({codec.k}+{codec.get_chunk_count() - codec.k}): "
              f"{OBJECTS} x {OBJECT_BYTES} B in {seconds:.4f} s "
              f"({OBJECTS * OBJECT_BYTES / seconds / 1e9:.3f} GB/s), launches {svc.launches}, "
              f"objects {svc.objects}; object 0 equals the CPU codec", flush=True)


def host_seconds(fn, reps: int) -> float:
    """Best host-clock seconds of fn() + synchronize over reps, warm."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_family_times(bp, gc, bmx, codecs, rs_codec, smi: str) -> dict:
    """Phase 15: each new kernel beside its bytes bound and its plain
    version, at the main path's shapes, and beside the one PyTorch call that
    computes the same function where there is one (B2 at k=2 is
    torch.bitwise_xor of its two rows); then each family's batch encode and
    decode: GB/s, the H2D / card call / D2H split, and one profiled run each
    (device busy time, of it the new kernels, idle share)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    chunk = OBJECT_BYTES // 4
    shec, lib = codecs["shec"], codecs["liberation"]
    enc = shec._encode
    b3_in = random_bytes((OBJECTS, 4, chunk), gen)
    b4_in = random_bytes((OBJECTS, 3, chunk), gen)
    b2_in = random_words(2, 4 * N4, gen)
    b5_in = lib._rows(random_bytes((OBJECTS, 4, lib.get_chunk_size(OBJECT_BYTES)), gen))
    cases = {
        "gf_matmul_bitplane": (
            "shec k=4 m=3 encode (64, 4, 1 MiB) -> (64, 3, 1 MiB)",
            lambda: bp.gf_matmul_bitplane(enc.bits_t, b3_in, tables=enc.tables_t),
            lambda: bp.gf_matmul_bitplane_plain(enc.bits_t, b3_in), b3_in.numel(), None),
        "xor_reduce": (
            "lrc local layer (64, 3, 1 MiB) -> (64, 1, 1 MiB)",
            lambda: bp.xor_reduce(b4_in), lambda: bp.xor_reduce_plain(b4_in), b4_in.numel(),
            None),
        "xor_reduce_words": (
            "m=1 burst (2, 32 Mi) int32 -> (1, 32 Mi)",
            lambda: gc.xor_reduce_words(b2_in), lambda: gc.xor_reduce_words_plain(b2_in),
            b2_in.numel() * 4, lambda: torch.bitwise_xor(b2_in[0], b2_in[1])),
        "xor_rowmatmul": (
            "liberation k=4 w=7 encode (64, 28, 155648) -> (64, 14, 155648)",
            lambda: bmx.xor_rowmatmul(lib._encode.bits_t, b5_in, lists=lib._encode.lists_t),
            lambda: bmx.xor_rowmatmul_plain(lib._encode.bits_t, b5_in), b5_in.numel(), None),
    }
    times = {}
    for name, (shape, kernel, plain, in_bytes, library) in cases.items():
        out = kernel()
        out_bytes = out.numel() * out.element_size()
        if library is None:
            kt, library_ms = kernel_times(kernel, 20), None
            lib_text = "none"
        else:
            # in turns (kernel, library, kernel, library), so that a slot
            # effect cannot decide the comparison; the means are kept, of
            # the call times and of the device times
            turns = [kernel_times(fn, 20) for fn in (kernel, library, kernel, library)]
            kt = {key: (turns[0][key] + turns[2][key]) / 2 for key in turns[0]}
            lt = {key: (turns[1][key] + turns[3][key]) / 2 for key in turns[1]}
            library_ms = lt["ms"]
            lib_text = f"{times_text(lt)}; in turns: " + "; ".join(
                f"{who} {t['ms']:.4f} / {t['held_ms']:.4f} ms"
                for who, t in zip(("kernel", "library", "kernel", "library"), turns))
        ms = kt["ms"]
        plain_ms = cuda_ms(plain, 2)
        moved = in_bytes + out_bytes
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        print(f"  [{smi}] {name} {shape}: kernel {times_text(kt)}, bound {bound_ms:.4f} ms "
              f"({moved} B at 3.35 TB/s), roofline share {bound_ms / ms:.3f} "
              f"(of the device time {bound_ms / kt['held_ms']:.3f}), "
              f"{moved / ms / 1e6:.1f} GB/s; plain {plain_ms:.3f} ms; library call: "
              f"{lib_text}", flush=True)
        times[name] = {**kt, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "library_ms": library_ms}

    # B3 at one object's width: MiniCluster's put, one launch per object
    enc = rs_codec._encode
    obj = random_bytes((1, K, OBJECT_BYTES // K), gen)
    ot = kernel_times(lambda: bp.gf_matmul_bitplane(enc.bits_t, obj, tables=enc.tables_t), 200)
    moved = (K + M) * OBJECT_BYTES // K
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    b3 = times["gf_matmul_bitplane"]
    print(f"  [{smi}] gf_matmul_bitplane at one object's width (1, {K}, {OBJECT_BYTES // K}) -> "
          f"(1, {M}, {OBJECT_BYTES // K}), as MiniCluster's puts launch it: kernel "
          f"{times_text(ot)}, bound {bound_ms:.5f} ms ({moved} B at 3.35 TB/s), roofline "
          f"share {bound_ms / ot['ms']:.3f} (of the device time {bound_ms / ot['held_ms']:.3f}); "
          f"beside shec's (64, 4, 1 MiB) share {b3['bound_ms'] / b3['ms']:.3f} (of the device "
          f"time {b3['bound_ms'] / b3['held_ms']:.3f})", flush=True)
    b3["at_object_width"] = {**ot, "bound_ms": bound_ms}

    for name, plugin, prof, erasure_sets, objects in FAMILIES:
        codec = codecs[name]
        data = family_batch(codec, objects, gen)
        host = data.cpu()
        h2d_ms = cuda_ms(lambda: host.to("cuda"), 3)
        reps = 1 if name == "clay" else 4
        enc_s = host_seconds(lambda: codec.encode_array(data), reps)
        parity = codec.encode_array(data)
        d2h_ms = cuda_ms(lambda: parity.cpu(), 3)
        full = torch.cat([data, parity], dim=1)
        n = codec.get_chunk_count()
        lost = sorted(codec.logical_index(c) for c in erasure_sets[-1])
        present = [i for i in range(n) if i not in lost]
        surv = full[:, present]
        dec_s = host_seconds(lambda: codec.decode_array(present, lost, surv), reps)
        nbytes = objects * OBJECT_BYTES
        parts = []
        for what, fn in (("encode", lambda: codec.encode_array(data)),
                         ("decode", lambda: codec.decode_array(present, lost, surv))):
            # several calls in one window: a window of one short call came
            # back from torch.profiler with no device events at all; the
            # launches it saw are printed beside the calls made
            # (clay's window cut to one call of its several seconds: the
            # smoke's time limit)
            calls = 1 if name == "clay" else reps * 3
            wall, busy = profiled(lambda: [fn() for _ in range(calls)])
            device_ms = sum(ms for _n, ms in busy.values())
            kern_ms = sum(ms for kname, (_n, ms) in busy.items()
                          if any(k in kname for k in FAMILY_KERNELS))
            launches = sum(c for kname, (c, _ms) in busy.items()
                           if any(k in kname for k in FAMILY_KERNELS))
            parts.append(f"{what} x{calls} under torch.profiler {wall * 1e3:.3f} ms: "
                         f"device busy {device_ms:.3f} ms, of it the new kernels "
                         f"{kern_ms:.3f} ms in {launches} launches seen; idle share "
                         f"{1 - device_ms / (wall * 1e3):.5f}")
        print(f"  [{smi}] {name} batch of {objects} x 4 MiB: encode {enc_s * 1e3:.3f} ms "
              f"({nbytes / enc_s / 1e9:.3f} GB/s of object data), decode of {erasure_sets[-1]} "
              f"{dec_s * 1e3:.3f} ms ({nbytes / dec_s / 1e9:.3f} GB/s); H2D of the data "
              f"{h2d_ms:.3f} ms, D2H of the parity {d2h_ms:.3f} ms; " + "; ".join(parts),
              flush=True)
    return times


# -- phases 16-17: the RADOS data path, and the native plugin and EC tools ----

#: BASELINE.json's north-star profile on an EC pool of 4 MiB objects (the
#: RADOS/RBD default object size, rbd_default_order 22), over 12 straw2 hosts
#: of 4 OSDs (jewel tunables): rule 0 chooseleaf indep over hosts, rule 1
#: chooseleaf firstn over hosts
RADOS_HOSTS, RADOS_PER_HOST = 12, 4
EC_POOL, REP_POOL, CLAY_POOL = 1, 2, 3
#: pool id -> (erasure profile or None, size, pg_num, rule, objects)
RADOS_POOLS = {
    EC_POOL: ({"plugin": "isa", "k": "8", "m": "3", "technique": "cauchy"}, 11, 256, 0, 256),
    REP_POOL: (None, 3, 128, 1, 32),
    CLAY_POOL: ({"plugin": "clay", "k": "4", "m": "2", "d": "5"}, 6, 32, 0, 8),
}
RADOS_OVERWRITES = 16
RADOS_SAMPLED = 16
#: objects per pool of the run held against a MiniCluster on the CPU
RADOS_IDENTITY_OBJECTS = 4
#: B3, the kernel under every RS put, degraded get and EC recovery
B3_KERNEL = "gf_matmul_bytes_kernel"


def rados_cluster(device):
    """A MiniCluster on `device` over the 12-host map with the three pools."""
    from ceph_tpu_torch.crush import builder as cb
    from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import TYPE_ERASURE, TYPE_REPLICATED, PgPool
    from ceph_tpu_torch.rados import MiniCluster

    cmap = CrushMap(tunables=Tunables.jewel())
    host_ids, host_weights = [], []
    for h in range(RADOS_HOSTS):
        items = list(range(h * RADOS_PER_HOST, (h + 1) * RADOS_PER_HOST))
        b = cb.make_bucket(cmap, -2 - h, BucketAlg.STRAW2, 1, items,
                           [0x10000] * RADOS_PER_HOST)
        host_ids.append(b.id)
        host_weights.append(b.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, host_ids, host_weights)
    # the EC rule takes up to k + m positions, as the rule Ceph creates for
    # an erasure-code profile does (make_simple_rule's default stops at 10)
    cb.make_simple_rule(cmap, 0, -1, 1, "indep", 0).max_size = K + M
    cb.make_simple_rule(cmap, 1, -1, 1, "firstn", 0)
    m = OSDMap(crush=cmap, max_osd=cmap.max_devices)
    profiles = {}
    for pool, (profile, size, pg_num, rule, _n) in RADOS_POOLS.items():
        kind = TYPE_REPLICATED if profile is None else TYPE_ERASURE
        m.pools[pool] = PgPool(pg_num=pg_num, size=size, type=kind, crush_rule=rule)
        profiles[pool] = profile
    c = MiniCluster(osdmap=m, profiles=profiles, device=device)
    # the data path's level-1 dout lines (one per degraded read) go to a
    # buffer; its log ring keeps them as always
    c.dlog._stream = io.StringIO()
    return c


def rados_objects(seed: int, per_pool: int | None = None) -> dict:
    """{(pool, name): bytes} of every object to put, from `seed`."""
    rng = np.random.default_rng(seed)
    return {(pool, f"obj-{pool}-{i}"): rng.bytes(OBJECT_BYTES)
            for pool, (*_, n) in RADOS_POOLS.items()
            for i in range(n if per_pool is None else per_pool)}


def pick_victims(c, objects) -> list[int]:
    """Three OSDs on three hosts: the homes of data shards 0-2 of the first
    EC object whose loss leaves every object readable (a replicated object
    keeps a copy, a clay object loses at most m = 2 shards)."""
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE

    acting = {key: set(c.acting(*key)[1]) - {CRUSH_ITEM_NONE} for key in objects}
    for (pool, name) in objects:
        if pool != EC_POOL:
            continue
        victims = c.acting(pool, name)[1][:3]
        if len({o // RADOS_PER_HOST for o in victims}) < 3:
            raise AssertionError(f"{name}: data shards 0-2 are not on three hosts: {victims}")
        if all(len(a & set(victims)) < (len(a) if p == REP_POOL else 3 if p == CLAY_POOL else 4)
               for (p, _n), a in acting.items()):
            return victims
    raise AssertionError("no three OSDs leave every object readable")


def store_view(c) -> dict:
    """Every store's keys, bytes, hinfo and version stamp."""
    def attrs(a):
        h = a.get("hinfo")
        return (a.get("ver"), None if h is None else (h.total_chunk_size,
                                                       tuple(h.cumulative_shard_hashes)))
    return {osd: {key: (st.objects[key], attrs(st.attrs.get(key, {})))
                  for key in st.objects}
            for osd, st in c.stores.items()}


def rados_sequence(c, objects: dict, on_step=None, want: dict | None = None) -> dict:
    """The data-path sequence (test_thrash_kill_revive_recover and
    test_remap_after_permanent_loss's API order): put every object,
    overwrite some of the EC pool's, kill three OSDs on three hosts, read
    every object back (degraded where a shard is lost), mark them out and
    recover() each pool, deep-scrub each pool, read every object again.
    `on_step(name, fn)` runs each step (the full-width run times them);
    `want` (filled here) holds the bytes last put of each object. Every
    read-back and scrub is checked; returns the victims and recover counts."""
    step = on_step or (lambda _name, fn: fn())
    want = {} if want is None else want
    want.update(objects)
    ec_keys = [k for k in objects if k[0] == EC_POOL]
    rewrites = {k: bytes(reversed(want[k])) for k in ec_keys[:RADOS_OVERWRITES]}

    def put_all():
        for (pool, name), data in objects.items():
            c.put(pool, name, data)

    def overwrite():
        for (pool, name), data in rewrites.items():
            c.put(pool, name, data)
            want[(pool, name)] = data

    step("put", put_all)
    step("overwrite", overwrite)
    victims = pick_victims(c, objects)
    for osd in victims:
        c.kill_osd(osd)

    def read_all():
        for (pool, name), data in want.items():
            if c.get(pool, name) != data:
                raise AssertionError(f"get {pool}/{name} returned other bytes")

    step("degraded get", read_all)
    for osd in victims:
        c.osdmap.mark_out(osd)
    recovered = {}

    def recover():
        for pool in RADOS_POOLS:
            recovered[pool] = c.recover(pool)

    step("recover", recover)

    def scrub():
        for pool in RADOS_POOLS:
            errors = c.scrub(pool, deep=True)
            if errors:
                raise AssertionError(f"deep scrub of pool {pool} after recovery: {errors[:4]}")

    step("deep scrub", scrub)
    step("get", read_all)
    return {"victims": victims, "recovered": recovered}


class CallTimes:
    """Seconds spent in chosen callables, by label: each is wrapped where
    the data path looks it up (an instance or module attribute) and put
    back by `undo`."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._undo = []

    def wrap(self, owner, attr: str, label: str) -> None:
        fn = getattr(owner, attr)
        had = attr in vars(owner)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn if had else None))

    def undo(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._undo.clear()


def device_ms(busy: dict, names=None) -> float:
    return sum(ms for kname, (_n, ms) in busy.items()
               if names is None or any(k in kname for k in names))


def phase_rados_main(bp, factory, smi: str) -> dict:
    """Phase 16: the RADOS data path at full width on the card, through
    MiniCluster's entry points; B3's launches are counted per step. Returns
    the launches of the whole drive."""
    from ceph_tpu_torch.common import crc
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE

    if not crc.HAVE_NATIVE:
        raise AssertionError("the C crc32c did not load (common/crc.py fell back to numpy)")
    t0 = time.perf_counter()
    objects = rados_objects(SEED)
    c = rados_cluster("cuda")
    ec = c.codec(EC_POOL)
    print(f"  map: {RADOS_HOSTS} hosts x {RADOS_PER_HOST} OSDs; pools "
          + ", ".join(f"{p}: {prof or 'replicated'} size {size} pg_num {pg}, {n} objects"
                      for p, (prof, size, pg, _r, n) in RADOS_POOLS.items())
          + f"; {len(objects)} objects of {OBJECT_BYTES} B made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ec_keys = [k for k in objects if k[0] == EC_POOL]
    launches = {}
    times = {}
    profiles = {}

    def on_step(name, fn):
        bp.gf_matmul_bitplane.launches = 0
        if name == "put":
            # the EC pool's puts, timed part by part (the wrappers' own cost
            # is a few microseconds a call); the last 16 under torch.profiler
            calls = CallTimes()
            calls.wrap(c, "acting", "placement")
            calls.wrap(ec, "encode", "encode (H2D, kernel, D2H, bytes)")
            calls.wrap(ecutil, "ceph_crc32c", "HashInfo crc32c")
            for st in c.stores.values():
                calls.wrap(st, "write", "store writes")
            timed_keys = ec_keys[:-16]
            t = time.perf_counter()
            for key in timed_keys:
                c.put(*key, objects[key])
            torch.cuda.synchronize()
            put_s = time.perf_counter() - t
            calls.undo()
            wall, busy = profiled(lambda: [c.put(*key, objects[key]) for key in ec_keys[-16:]])
            if not busy:  # as for the degraded gets below
                print("  torch.profiler returned no device event for 16 puts; putting them "
                      "again under it", flush=True)
                wall, busy = profiled(lambda: [c.put(*key, objects[key]) for key in ec_keys[-16:]])
            profiles["put"] = (wall, busy)
            rest = [k for k in objects if k[0] != EC_POOL]
            t = time.perf_counter()
            for key in rest:
                c.put(*key, objects[key])
            rest_s = time.perf_counter() - t
            n = len(timed_keys)
            split = "; ".join(f"{label} {s / n * 1e3:.3f}" for label, s in calls.seconds.items())
            other = put_s - sum(calls.seconds.values())
            times["put"] = {"gbps": n * OBJECT_BYTES / put_s / 1e9, "ms": put_s / n * 1e3}
            print(f"  [{smi}] put of {n} EC objects (4 MiB, k=8 m=3): {put_s:.3f} s, "
                  f"{times['put']['gbps']:.4f} GB/s, {put_s / n * 1e3:.3f} ms an object = "
                  f"{split}; other {other / n * 1e3:.3f} ms; the other pools' "
                  f"{len(rest)} puts {rest_s:.3f} s", flush=True)
            kernel = device_ms(busy, [B3_KERNEL])
            print(f"  [{smi}] 16 EC puts under torch.profiler: {wall * 1e3:.3f} ms, device busy "
                  f"{device_ms(busy):.3f} ms, of it B3 {kernel:.3f} ms; idle share "
                  f"{1 - device_ms(busy) / (wall * 1e3):.5f}; device events: "
                  + ", ".join(f"{k} x{cnt} {ms:.3f} ms" for k, (cnt, ms) in sorted(busy.items())),
                  flush=True)
        elif name == "degraded get":
            # the EC objects with a data shard on a down OSD (a hole in the
            # acting set) need a decode; their gets are timed, the last 16
            # under torch.profiler, then every object of every pool is read
            k = ec.get_data_chunk_count()
            degraded = [key for key in ec_keys if CRUSH_ITEM_NONE in c.acting(*key)[1][:k]]
            t = time.perf_counter()
            for key in degraded[:-16]:
                if c.get(*key) != want[key]:
                    raise AssertionError(f"degraded get {key} returned other bytes")
            torch.cuda.synchronize()
            get_s = time.perf_counter() - t
            n = len(degraded) - 16
            wall, busy = profiled(lambda: [c.get(*key) for key in degraded[-16:]])
            if not busy:
                # a window of short calls has come back from torch.profiler
                # with no device event at all (not even the copies); once
                # more, said aloud
                print("  torch.profiler returned no device event for 16 degraded gets; "
                      "profiling them again", flush=True)
                wall, busy = profiled(lambda: [c.get(*key) for key in degraded[-16:]])
            profiles[name] = (wall, busy)
            times[name] = {"gbps": n * OBJECT_BYTES / get_s / 1e9, "ms": get_s / n * 1e3}
            print(f"  [{smi}] degraded get of {n} EC objects: {get_s:.3f} s, "
                  f"{times[name]['gbps']:.4f} GB/s, {get_s / n * 1e3:.3f} ms an object; 16 more "
                  f"under torch.profiler: device busy {device_ms(busy):.3f} ms of "
                  f"{wall * 1e3:.3f} ms, B3 {device_ms(busy, [B3_KERNEL]):.3f} ms; idle share "
                  f"{1 - device_ms(busy) / (wall * 1e3):.5f}", flush=True)
            fn()
        else:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name] = {"s": time.perf_counter() - t}
        launches[name] = bp.gf_matmul_bitplane.launches

    want = {}
    out = rados_sequence(c, objects, on_step, want)
    print(f"  killed OSDs {out['victims']} (hosts "
          f"{[o // RADOS_PER_HOST for o in out['victims']]}); recover {times['recover']['s']:.3f} s, "
          f"shards rebuilt {out['recovered']}; deep scrub of every pool {times['deep scrub']['s']:.3f} s, "
          f"clean; every object read back after recovery in {times['get']['s']:.3f} s", flush=True)
    print(f"  B3 launches by step: {launches}", flush=True)
    if launches["put"] < 1 or launches["degraded get"] < 1:
        raise AssertionError(f"B3 did not launch on both the puts and the degraded gets: {launches}")
    for step in ("put", "degraded get"):
        if not any(B3_KERNEL in k for k in profiles[step][1]):
            raise AssertionError(f"torch.profiler saw no {B3_KERNEL} in a {step}: "
                                 f"{sorted(profiles[step][1])}")
    if sum(out["recovered"].values()) < 1:
        raise AssertionError("recover() rebuilt no shard")
    # sampled EC objects: the stored shards are what the isa codec on the
    # CPU makes of the same bytes
    cpu = factory("isa", {k: v for k, v in RADOS_POOLS[EC_POOL][0].items() if k != "plugin"},
                  device="cpu")
    n = cpu.get_chunk_count()
    for key in ec_keys[RADOS_OVERWRITES:RADOS_OVERWRITES + RADOS_SAMPLED]:
        pg, acting = c.acting(*key)
        chunks = cpu.encode(range(n), want[key])
        for shard, osd in enumerate(acting):
            if c.stores[osd].objects[(EC_POOL, pg, key[1], shard)] != chunks[shard]:
                raise AssertionError(f"{key} shard {shard} differs from the CPU isa codec")
    print(f"  {RADOS_SAMPLED} sampled EC objects: every stored shard equals the CPU isa "
          f"codec's; C crc32c loaded", flush=True)
    total = sum(launches.values())
    del c, objects, out, want
    return {"launches": total, "times": times}


def _rados_view(device: str) -> tuple[dict, dict, float]:
    """Phase 16b's sequence at RADOS_IDENTITY_OBJECTS objects a pool on
    `device`: (every store's view, the shards recovered, seconds)."""
    objects = rados_objects(SEED + 1, RADOS_IDENTITY_OBJECTS)
    c = rados_cluster(device)
    t = time.perf_counter()
    out = rados_sequence(c, objects)
    return store_view(c), out["recovered"], time.perf_counter() - t


def phase_rados_identity() -> None:
    """Phase 16b: the same sequence at RADOS_IDENTITY_OBJECTS objects a pool
    on the card and on the CPU (in a worker process, beside the card's):
    every store ends equal (keys, bytes, hinfo, version stamps)."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(in_workers, "_rados_view", ["cpu"])
        views = [_rados_view("cuda"), cpu.result()[0]]
    if views[0][0] != views[1][0] or views[0][1] != views[1][1]:
        raise AssertionError("the card cluster's stores differ from the CPU cluster's")
    keys = sum(len(v) for v in views[0][0].values())
    print(f"  identity at {RADOS_IDENTITY_OBJECTS} objects a pool: {keys} stored shards and "
          f"copies equal on the card ({views[0][2]:.2f} s) and the CPU ({views[1][2]:.2f} s); "
          f"recovered {views[0][1]} on both", flush=True)


#: plugin=native against the port's isa on the card, on 4 objects of 4 MiB
NATIVE_OBJECTS = 4


def phase_native_and_tools(factory, smi: str) -> None:
    """Phase 17: libec_native built from the port's ec_plugin.cpp into
    _build/; its k=8 m=3 chunks equal the port's isa on the card for both
    techniques; the corpus gate `python -m ceph_tpu_torch.tools.
    ec_non_regression --check --device cuda` (the native profile among its
    17); the CPU baseline tool's line beside the host CPU's model."""
    from ceph_tpu_torch.native import build

    t = time.perf_counter()
    path = build.build_plugin("native")
    print(f"  built {os.path.relpath(path, os.path.dirname(os.path.abspath(__file__)))} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data = torch.randint(0, 256, (NATIVE_OBJECTS, K, OBJECT_BYTES // K), dtype=torch.uint8,
                         device="cuda", generator=gen)
    for technique in ("cauchy", "reed_sol_van"):
        prof = {"k": str(K), "m": str(M), "technique": technique}
        native, isa = factory("native", dict(prof)), factory("isa", dict(prof))
        t = time.perf_counter()
        got = native.encode_array(data)
        native_s = time.perf_counter() - t
        want = isa.encode_array(data)
        if got.device.type != "cpu" or not torch.equal(got, want.cpu()):
            raise AssertionError(f"native {technique} chunks differ from isa's on the card")
        obj = bytes(data[0].cpu().numpy().tobytes())
        if native.encode(range(K + M), obj) != isa.encode(range(K + M), obj):
            raise AssertionError(f"native {technique} byte API differs from isa's")
        print(f"  native {technique}: {NATIVE_OBJECTS} x 4 MiB parity equal to isa on the "
              f"card (host encode {native_s * 1e3:.1f} ms)", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    for argv in (["-m", "ceph_tpu_torch.tools.ec_non_regression", "--check", "--device", "cuda"],
                 ["-m", "ceph_tpu_torch.tools.cpu_ec_baseline"]):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=here, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(argv)} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        if argv[1].endswith("ec_non_regression"):
            checked = [line for line in lines if line.startswith("check ")]
            if len(checked) != 17 or not all(line.endswith(": ok") for line in checked) or \
                    not any("plugin=native" in line for line in checked):
                raise AssertionError(f"corpus check output: {lines}")
            print(f"  ec_non_regression --check --device cuda: {len(checked)} profiles ok, "
                  f"the native one among them, in {seconds:.2f} s", flush=True)
        else:
            line = json.loads(lines[-1])
            print(f"  cpu_ec_baseline (the host's CPU, not the card; {smi}): "
                  f"{json.dumps(line)}", flush=True)


# -- the live daemon path -------------------------------------------------------

#: phase 18: 3 mons and DAEMON_OSDS OSDs (a host each) and a client in this
#: process over loopback; pool 1 isa k=8 m=3 cauchy, pool 2 replicated
DAEMON_OSDS = 12
DAEMON_EC_PROFILE = {"plugin": "isa", "k": str(K), "m": str(M), "technique": "cauchy"}
#: a cut for the 1200 s limit: every map epoch makes each of the 12 OSDs
#: place every PG with the scalar mapper on the one loop (at 64 + 32 PGs the
#: cluster's start took 85 s and its recovery 62 s on the card)
DAEMON_PG_NUM = {EC_POOL: 16, REP_POOL: 8}
#: pool-1 and pool-2 objects, cut as the smoke grew to keep its whole run
#: inside the 1200 s limit
DAEMON_OBJECTS = {EC_POOL: 32, REP_POOL: 8}
DAEMON_CONCURRENCY = 32
DAEMON_PARTIAL = 8
#: full rewrites of pool-1 objects traced (spans), then under torch.profiler
DAEMON_WINDOW = 16
DAEMON_VICTIMS = (3, 7)
DAEMON_RECOVERY_S = 300
#: recovery is done when every PG is clean and no push came for this many
#: polls in a row (0.2 s apart; a map epoch that holds the loop for seconds
#: counts as one poll)
DAEMON_QUIET_POLLS = 25
#: B1, the kernel under every daemon-path encode, degraded read and rebuild
B1_KERNEL = "gf_matmul_packed_kernel"


def daemon_config():
    """The daemons' shared config: the monitors' default lease and election
    timing, and daemon_bench's heartbeat interval. Every map epoch makes each
    OSD place every PG with the scalar CRUSH mapper (about 5 ms a PG at 11
    positions), so an epoch holds the one event loop for seconds;
    daemon_bench's 0.1 s monitor lease would lose the quorum to that. The
    grace outlasts the victims' whole time down: a peer keeps a down OSD's
    last heartbeat stamp, and reports the revived OSD failed at once when
    that stamp is older than the grace (ROADMAP §C); the victims are marked
    down by command instead."""
    from ceph_tpu_torch.common.config import Config

    cfg = Config()
    for key, value in (("osd_heartbeat_interval", 0.5), ("osd_heartbeat_grace", 120)):
        cfg.set(key, value)
    return cfg


class DaemonCluster:
    """Monitors, OSD daemons and a client of the port, all on `device`."""

    def __init__(self, device):
        from ceph_tpu_torch.mon import MonMap

        self.device = device
        self.cfg = daemon_config()
        self.monmap = MonMap(addrs=[("127.0.0.1", 0)] * 3)
        self.mons, self.osds, self.rados = [], {}, None
        #: the leader's placements of the epoch `placed` last read
        self._placed, self._placed_epoch = {}, None

    async def start(self):
        from ceph_tpu_torch.mon import Monitor
        from ceph_tpu_torch.rados.client import Rados
        from ceph_tpu_torch.vstart import initial_osdmap

        base = initial_osdmap(DAEMON_OSDS)
        # rule 0 takes k + m positions (make_simple_rule's default stops at 10)
        base.crush.rules[0].max_size = K + M
        self.mons = [Monitor(r, self.monmap, base, config=self.cfg, device=self.device)
                     for r in range(3)]
        for m in self.mons:
            await m.bind()
        for m in self.mons:
            m.go()
        for i in range(DAEMON_OSDS):
            await self.start_osd(i)
        self.rados = Rados("client.smoke", self.monmap, config=self.cfg, device=self.device)
        await self.rados.connect()
        await self.rados.mon_command("osd erasure-code-profile set",
                                     {"name": "smoke", "profile": dict(DAEMON_EC_PROFILE)})
        await self.rados.mon_command("osd pool create", {
            "pool_id": EC_POOL, "crush_rule": 0, "erasure_code_profile": "smoke",
            "pg_num": DAEMON_PG_NUM[EC_POOL]})
        await self.rados.mon_command("osd pool create", {
            "pool_id": REP_POOL, "crush_rule": 1, "size": 3, "pg_num": DAEMON_PG_NUM[REP_POOL]})
        for osd in self.osds.values():
            osd.codec(EC_POOL)  # every OSD's codec, so its B1 calls can be watched
        await self.wait_until(self.pgs_clean, 600, "every PG active")

    async def start_osd(self, osd_id: int) -> None:
        """An OSD daemon on an empty store (a new disk under the same id)."""
        from ceph_tpu_torch.osd.daemon import OSDService

        self.osds[osd_id] = OSDService(osd_id, self.monmap, config=self.cfg, device=self.device)
        await self.osds[osd_id].start()

    @property
    def leader(self):
        """The monitor leading the quorum, or None during an election."""
        return next((m for m in self.mons if m.is_leader), None)

    async def wait_until(self, pred, timeout: float, what: str):
        """Polls `pred` every 0.2 s (it may read every store) until true."""
        loop = asyncio.get_running_loop()
        end = loop.time() + timeout
        while not pred():
            if loop.time() > end:
                raise AssertionError(f"timed out after {timeout} s waiting for {what}")
            await asyncio.sleep(0.2)

    def down(self, osds, down=True) -> bool:
        leader = self.leader
        return leader is not None and all(leader.osdmap.is_down(o) == down for o in osds)

    def placed(self, pool: int, ps: int):
        """(up, up_primary, acting, primary) on the leader's map, memoized
        for its epoch, or None during an election."""
        leader = self.leader
        if leader is None:
            return None
        m = leader.osdmap
        if self._placed_epoch != m.epoch:
            self._placed, self._placed_epoch = {}, m.epoch
        if (pool, ps) not in self._placed:
            self._placed[(pool, ps)] = m.pg_to_up_acting_osds(pool, ps)
        return self._placed[(pool, ps)]

    def pgs_clean(self, backfill_too=True) -> bool:
        """Every PG's primary (on the leader's map) runs here with the PG
        active and (with `backfill_too`) nothing to backfill: the daemons'
        own view of done."""
        for pool, pg_num in DAEMON_PG_NUM.items():
            for ps in range(pg_num):
                placed = self.placed(pool, ps)
                if placed is None or placed[3] not in self.osds:
                    return False
                pg = self.osds[placed[3]].pgs.get((pool, ps))
                if pg is None or not pg.active or backfill_too and (
                        pg.backfill_targets or pg.self_backfill):
                    return False
        return True

    async def recovered(self, timeout: float) -> float:
        """Waits until every PG is clean in the daemons' view and no push
        was made for DAEMON_QUIET_POLLS polls; returns the seconds from the
        call to the first of those polls."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        last, quiet, since = self.pushes(), 0, t0
        while quiet < DAEMON_QUIET_POLLS:
            if loop.time() - t0 > timeout:
                raise AssertionError(f"recovery did not finish within {timeout} s")
            await asyncio.sleep(0.2)
            pushes = self.pushes()
            if pushes != last or not self.pgs_clean():
                last, quiet = pushes, 0
                continue
            if quiet == 0:
                since = loop.time()
            quiet += 1
        return since - t0

    def pushes(self) -> int:
        return sum(o.perf.dump().get("recovery_pushes", 0) for o in self.osds.values())

    def unfilled(self, want: dict) -> list[tuple[str, int, int]]:
        """(object, position, OSD) of every live acting position that holds
        no copy or shard of the object at its newest version."""
        from ceph_tpu_torch.osd.daemon import pg_coll, shard_name
        from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE

        some = next(iter(self.osds.values()))
        out = []
        for pool, name in want:
            ps = some.object_pg(pool, name)
            acting, _primary = some.acting_of(pool, ps)
            held = {}
            for pos, osd in enumerate(acting):
                if osd == CRUSH_ITEM_NONE or osd not in self.osds:
                    continue
                obj = shard_name(name, pos if pool == EC_POOL else None)
                store = self.osds[osd].store
                if store.exists(pg_coll(pool, ps), obj):
                    held[(pos, osd)] = store.getattrs(pg_coll(pool, ps), obj).get("ver")
            newest = max(held.values(), default=None)
            for pos, osd in enumerate(acting):
                if osd != CRUSH_ITEM_NONE and osd in self.osds and \
                        held.get((pos, osd), "absent") != newest:
                    out.append((name, pos, osd))
        return out

    async def stop(self):
        if self.rados is not None:
            await self.rados.shutdown()
        for osd in self.osds.values():
            await osd.stop()
        for m in self.mons:
            await m.stop()


def daemon_objects(seed: int) -> dict:
    """{(pool, name): bytes} of phase 18's objects, 4 MiB each, from `seed`."""
    rng = np.random.default_rng(seed)
    return {(pool, f"d-{pool}-{i}"): rng.bytes(OBJECT_BYTES)
            for pool, n in DAEMON_OBJECTS.items() for i in range(n)}


async def daemon_gather(calls, concurrency: int) -> list[float]:
    """Run the coroutine factories in `calls` `concurrency` at a time (a
    worker each, as daemon_bench streams); returns each call's seconds."""
    calls = list(calls)
    seconds = [0.0] * len(calls)
    nxt = iter(range(len(calls)))

    async def worker():
        for i in nxt:
            t = time.perf_counter()
            await calls[i]()
            seconds[i] = time.perf_counter() - t

    await asyncio.gather(*(worker() for _ in range(min(concurrency, len(calls)))))
    return seconds


class B1Watch:
    """B1's launches, counted two ways (the wrapper's count and the OSDs'
    EncodeService launches), the planar widths of every call the daemons'
    codecs make, and the calls that raised: the daemon turns a decode that
    raised into "unrecoverable this pass" (`osd/daemon.py:2409`), so a
    failing launch would otherwise show only as a recovery that stalls."""

    def __init__(self, gc, cluster: DaemonCluster):
        self.gc, self.cluster = gc, cluster
        self.widths: list[tuple[str, int, int]] = []
        self.raised: list[str] = []
        for osd in cluster.osds.values():
            self.watch_osd(osd)

    def watch_osd(self, osd) -> None:
        codec = osd.codec(EC_POOL)
        for kind in ("encode_words", "decode_words"):
            self._watch(codec, kind)

    def _watch(self, codec, kind: str) -> None:
        fn = getattr(codec, kind)

        def watched(*args):
            words = args[-1]
            self.widths.append((kind, int(words.shape[0]), int(words.shape[1])))
            try:
                return fn(*args)
            except Exception as e:
                self.raised.append(f"{kind} {tuple(words.shape)}: {e!r}")
                raise

        setattr(codec, kind, watched)

    def service_launches(self) -> int:
        return sum(o.encode_service.launches for o in self.cluster.osds.values())

    def start(self) -> None:
        self.gc.gf_matmul_packed.launches = 0
        self._svc = self.service_launches()

    def read(self) -> tuple[int, int]:
        torch.cuda.synchronize()
        return self.gc.gf_matmul_packed.launches, self.service_launches() - self._svc


async def profiled_async(coro_fn) -> tuple[float, dict]:
    """profiled() for a coroutine run on the running event loop."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        await asyncio.sleep(0.05)
        t0 = time.perf_counter()
        await coro_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, device_busy(prof)


def span_split(cluster: DaemonCluster) -> dict[str, tuple[int, float]]:
    """{span name: (count, total ms)} over every daemon's and the client's
    flight ring (the spans the tracer kept since they were cleared)."""
    out: dict[str, tuple[int, float]] = {}
    tracers = [o.tracer for o in cluster.osds.values()] + [cluster.rados.objecter.tracer]
    for tracer in tracers:
        for span in tracer._flight:
            # adopted copies of other daemons' spans are dicts: skipped, as
            # their own tracer counts them
            if isinstance(span, dict) or span.end is None:
                continue
            n, ms = out.get(span.name, (0, 0.0))
            out[span.name] = (n + 1, ms + (span.end - span.start) * 1e3)
    return out


async def daemon_sequence(gc, cluster: DaemonCluster, objects: dict, smi: str) -> dict:
    """Phase 18's drive on a started cluster: writes, partial overwrites,
    reads, 2 OSDs killed, degraded reads, mark-out and recovery, reads
    again. Returns the bytes each object must hold, the B1 counts per
    window, the widths B1 was called at and the times."""
    rados = cluster.rados
    io = {pool: rados.io_ctx(pool) for pool in DAEMON_OBJECTS}
    ec_keys = [k for k in objects if k[0] == EC_POOL]
    rep_keys = [k for k in objects if k[0] == REP_POOL]
    want = dict(objects)
    watch = B1Watch(gc, cluster)
    out = {"launches": {}, "times": {}}

    def write(key, data=None):
        return lambda: io[key[0]].write_full(key[1], objects[key] if data is None else data)

    def read_check(key):
        async def call():
            if await io[key[0]].read(key[1]) != want[key]:
                raise AssertionError(f"read {key} returned other bytes")
        return call

    # write window: 32 EC puts, 8 replicated, 8 partial overwrites, 16
    # traced rewrites, 16 profiled rewrites
    watch.start()
    t = time.perf_counter()
    lat = await daemon_gather([write(k) for k in ec_keys], DAEMON_CONCURRENCY)
    ec_s = time.perf_counter() - t
    t = time.perf_counter()
    await daemon_gather([write(k) for k in rep_keys], DAEMON_CONCURRENCY)
    rep_s = time.perf_counter() - t
    rng = np.random.default_rng(SEED + 18)
    partial0 = sum(o.perf.dump().get("op_w_partial", 0) for o in cluster.osds.values())
    for key in ec_keys[:DAEMON_PARTIAL]:
        off = int(rng.integers(0, OBJECT_BYTES - 8192))
        patch = rng.bytes(4096)
        await io[EC_POOL].write(key[1], patch, off)
        want[key] = want[key][:off] + patch + want[key][off + 4096:]
    partial = sum(o.perf.dump().get("op_w_partial", 0) for o in cluster.osds.values()) - partial0
    if partial < 1:
        raise AssertionError("no partial overwrite took the sub-stripe path")
    window = ec_keys[DAEMON_PARTIAL:DAEMON_PARTIAL + DAEMON_WINDOW]
    cluster.cfg.set("tracer_sample_rate", 0.0)
    cluster.cfg.set("tracer_enabled", True)
    tracers = [o.tracer for o in cluster.osds.values()] + [rados.objecter.tracer]
    for tracer in tracers:
        tracer._flight.clear()
    t = time.perf_counter()
    await daemon_gather([write(k) for k in window], DAEMON_WINDOW)
    traced_s = time.perf_counter() - t
    cluster.cfg.set("tracer_enabled", False)
    spans = span_split(cluster)
    wall, busy = await profiled_async(
        lambda: daemon_gather([write(k) for k in window], DAEMON_WINDOW))
    if not busy:  # as phase 16 does, once more, said aloud
        print("  torch.profiler returned no device event for 16 writes; writing them again "
              "under it", flush=True)
        wall, busy = await profiled_async(
            lambda: daemon_gather([write(k) for k in window], DAEMON_WINDOW))
    out["launches"]["write"] = watch.read()
    n_ec, n_rep = len(ec_keys), len(rep_keys)
    out["times"]["write"] = {"gbps": n_ec * OBJECT_BYTES / ec_s / 1e9, "s": ec_s,
                             "ms_per_object": ec_s / n_ec * 1e3,
                             "latency_ms": float(np.mean(lat)) * 1e3}
    print(f"  [{smi}] write of {n_ec} EC objects (4 MiB, isa k=8 m=3) at concurrency "
          f"{DAEMON_CONCURRENCY}: {ec_s:.3f} s, {out['times']['write']['gbps']:.4f} GB/s, "
          f"{ec_s / n_ec * 1e3:.3f} ms an object, mean op latency {np.mean(lat) * 1e3:.3f} ms "
          f"(p50 {np.percentile(lat, 50) * 1e3:.3f}, max {max(lat) * 1e3:.3f}); {n_rep} "
          f"replicated in {rep_s:.3f} s ({n_rep * OBJECT_BYTES / rep_s / 1e9:.4f} GB/s); "
          f"{DAEMON_PARTIAL} partial overwrites, {partial} on the sub-stripe path", flush=True)
    print(f"  [{smi}] {DAEMON_WINDOW} traced rewrites at concurrency {DAEMON_WINDOW}: "
          f"{traced_s:.3f} s; spans (count, mean ms, ms per write): "
          + "; ".join(f"{name} {n} {ms / n:.3f} {ms / DAEMON_WINDOW:.3f}"
                      for name, (n, ms) in sorted(spans.items(), key=lambda kv: -kv[1][1])),
          flush=True)
    kernel = device_ms(busy, [B1_KERNEL])
    print(f"  [{smi}] {DAEMON_WINDOW} rewrites under torch.profiler: {wall * 1e3:.3f} ms, "
          f"device busy {device_ms(busy):.3f} ms, of it B1 {kernel:.3f} ms; idle share "
          f"{1 - device_ms(busy) / (wall * 1e3):.5f}; device events: "
          + ", ".join(f"{k} x{cnt} {ms:.3f} ms" for k, (cnt, ms) in sorted(busy.items())),
          flush=True)

    t = time.perf_counter()
    await daemon_gather([read_check(k) for k in want], DAEMON_CONCURRENCY)
    read_s = time.perf_counter() - t
    out["times"]["read"] = {"gbps": len(want) * OBJECT_BYTES / read_s / 1e9, "s": read_s}
    print(f"  [{smi}] read of all {len(want)} objects: {read_s:.3f} s, "
          f"{out['times']['read']['gbps']:.4f} GB/s, every read exact", flush=True)

    # degraded-read window: 2 OSDs stopped and marked down
    for victim in DAEMON_VICTIMS:
        await cluster.osds.pop(victim).stop()
        await rados.mon_command("osd down", {"osd": victim})
    await cluster.wait_until(lambda: cluster.down(DAEMON_VICTIMS), 60, "the victims marked down")
    t = time.perf_counter()
    await cluster.wait_until(lambda: cluster.pgs_clean(backfill_too=False), 600,
                             "every PG active again")
    repeer_s = time.perf_counter() - t
    watch.start()
    t = time.perf_counter()
    await daemon_gather([read_check(k) for k in ec_keys], DAEMON_CONCURRENCY)
    deg_s = time.perf_counter() - t
    out["launches"]["degraded read"] = watch.read()
    out["times"]["degraded read"] = {"gbps": len(ec_keys) * OBJECT_BYTES / deg_s / 1e9,
                                     "s": deg_s}
    print(f"  [{smi}] OSDs {list(DAEMON_VICTIMS)} stopped and marked down, every PG active "
          f"again in {repeer_s:.3f} s; degraded read of "
          f"{len(ec_keys)} EC objects: {deg_s:.3f} s, "
          f"{out['times']['degraded read']['gbps']:.4f} GB/s, every read exact", flush=True)

    # recovery window: the victims come back on empty stores (their disks
    # replaced); the primaries rebuild every copy and shard they held
    pushes0 = cluster.pushes()
    watch.start()
    t = time.perf_counter()
    for victim in DAEMON_VICTIMS:
        await cluster.start_osd(victim)
        watch.watch_osd(cluster.osds[victim])
    await cluster.wait_until(lambda: cluster.down(DAEMON_VICTIMS, down=False), 120,
                             "the victims up again")
    up_s = time.perf_counter() - t
    rec_s = up_s + await cluster.recovered(DAEMON_RECOVERY_S)
    out["launches"]["recovery"] = watch.read()
    healed = cluster.pushes() - pushes0
    unfilled = cluster.unfilled(want)
    out["times"]["recovery"] = {"s": rec_s, "pushes": healed, "unfilled": len(unfilled)}
    print(f"  [{smi}] OSDs {list(DAEMON_VICTIMS)} back on empty stores and up in {up_s:.3f} s; "
          f"recovered in {rec_s:.3f} s from their restart (every PG clean, no push for "
          f"{DAEMON_QUIET_POLLS} polls): {healed} objects and shards pushed; acting positions "
          f"left without their current copy or shard: {len(unfilled)} {unfilled[:6]}",
          flush=True)
    t = time.perf_counter()
    await daemon_gather([read_check(k) for k in want], DAEMON_CONCURRENCY)
    print(f"  read of all {len(want)} objects after recovery: {time.perf_counter() - t:.3f} s, "
          "every read exact", flush=True)
    out["ckpt"] = await ckpt_window(cluster, watch, smi)
    out["launches"]["ckpt save"] = out["ckpt"]["launches"]
    out["want"] = want
    out["widths"] = watch.widths
    out["raised"] = watch.raised
    return out


def check_daemon_stores(cluster: DaemonCluster, want: dict, factory) -> int:
    """Every pool-1 shard on every surviving OSD, and its own position's
    hinfo digest, equal what the isa codec on the CPU makes of the bytes
    the object must hold. Returns the shards checked."""
    from ceph_tpu_torch.common.crc import ceph_crc32c
    from ceph_tpu_torch.osd.ecutil import SEED as HINFO_SEED

    cpu = factory("isa", {k: v for k, v in DAEMON_EC_PROFILE.items() if k != "plugin"},
                  device="cpu")
    n = cpu.get_chunk_count()
    stored: dict[str, list] = {}
    for osd_id, osd in cluster.osds.items():
        for coll in osd.store.list_collections():
            if not coll.startswith(f"pg_{EC_POOL}_"):
                continue
            for obj in osd.store.list_objects(coll):
                base, sep, pos = obj.rpartition(".s")
                if sep and pos.isdigit():
                    stored.setdefault(base, []).append((osd_id, coll, obj, int(pos)))
    checked = 0
    for (pool, name), data in want.items():
        if pool != EC_POOL:
            continue
        if name not in stored:
            raise AssertionError(f"no OSD holds a shard of {name}")
        chunks = cpu.encode(range(n), data)
        for osd_id, coll, obj, pos in stored[name]:
            store = cluster.osds[osd_id].store
            hinfo = store.getattrs(coll, obj)["hinfo"]
            if store.read(coll, obj) != chunks[pos]:
                raise AssertionError(f"osd.{osd_id} {obj} differs from the CPU isa codec's chunk")
            if (hinfo.total_chunk_size != len(chunks[pos]) or
                    hinfo.cumulative_shard_hashes[pos] != ceph_crc32c(HINFO_SEED, chunks[pos])):
                raise AssertionError(f"osd.{osd_id} {obj}: hinfo differs from the chunk's")
            checked += 1
    return checked


# -- phase 18's checkpoint window -------------------------------------------------

#: GPT-2 small at its published widths (OpenAI's GPT-2 release; Hugging
#: Face `gpt2` config): n_layer 12, n_embd 768, n_head 12, vocab 50257,
#: n_positions 1024
GPT2 = {"n_layer": 12, "n_embd": 768, "n_head": 12, "vocab": 50257, "n_positions": 1024}
#: the checkpoint windows (phases 18 and 21) save the first 6 of its 12
#: blocks at their full widths, a depth cut for the 1200 s limit
CKPT_LAYERS = 6
#: wte, wpe and ln_f, and 12 e^2 + 13 e in each block
GPT2_PARAMS = (GPT2["vocab"] + GPT2["n_positions"] + 2) * GPT2["n_embd"] + CKPT_LAYERS * (
    12 * GPT2["n_embd"] ** 2 + 13 * GPT2["n_embd"])
CKPT_NAME = "gpt2"
#: chunk objects of 4 MiB (phase 18's object size, a multiple of the pool's
#: k x stripe_unit alignment) written 32 at a time (its write concurrency)
CKPT_CONFIG = {"ckpt_chunk_target_bytes": 4 << 20, "ckpt_max_inflight": 32}
#: the layer whose tensors change before the second, incremental save
CKPT_CHANGED_LAYER = 5
#: tensors saved laid out on a mesh's `stripe` axis: the embeddings and the
#: MLP weights
CKPT_SHARDED = ("wte", "wpe", "c_fc.weight", "mlp.c_proj.weight")


def gpt2_shapes() -> dict[str, tuple[int, ...]]:
    """{dotted name: shape} of GPT-2 small's parameters in its first
    CKPT_LAYERS blocks (Conv1D weights as Hugging Face stores them, lm_head
    tied to wte)."""
    e, v, p = GPT2["n_embd"], GPT2["vocab"], GPT2["n_positions"]
    shapes = {"wte": (v, e), "wpe": (p, e)}
    for i in range(CKPT_LAYERS):
        for name, shape in (("ln_1.weight", (e,)), ("ln_1.bias", (e,)),
                            ("attn.c_attn.weight", (e, 3 * e)), ("attn.c_attn.bias", (3 * e,)),
                            ("attn.c_proj.weight", (e, e)), ("attn.c_proj.bias", (e,)),
                            ("ln_2.weight", (e,)), ("ln_2.bias", (e,)),
                            ("mlp.c_fc.weight", (e, 4 * e)), ("mlp.c_fc.bias", (4 * e,)),
                            ("mlp.c_proj.weight", (4 * e, e)), ("mlp.c_proj.bias", (e,))):
            shapes[f"h.{i}.{name}"] = shape
    shapes["ln_f.weight"] = shapes["ln_f.bias"] = (e,)
    return shapes


def gpt2_state(sh, mesh, gen: torch.Generator, only: str = "") -> dict:
    """GPT-2 small's parameters, float32 on the card from `gen`: {"params":
    {dotted name: tensor}}; the CKPT_SHARDED tensors are MeshArrays on
    `mesh` with spec ("stripe", None). `only` keeps the names that start
    with it. Cut from the full training state: Adam's two moments would
    triple the 498 MB of all 12 blocks (1.49 GB), and with them the window
    took 155 s on the H100, which would put the smoke more than 120 s past
    its earlier time."""
    shapes = {n: s for n, s in gpt2_shapes().items() if n.startswith(only)}

    def leaf(name):
        t = torch.randn(shapes[name], generator=gen, device="cuda") * 0.02
        if name.endswith(CKPT_SHARDED):
            return sh.place(t, ("stripe", None), mesh)
        return t

    return {"params": {n: leaf(n) for n in shapes}}


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from leaves(tree[key], path + (key,))
        else:
            yield path + (key,), tree[key]


def as_full(leaf) -> torch.Tensor:
    return leaf.full("cuda") if hasattr(leaf, "slots") else leaf


def check_restored(label: str, got: dict, want: dict) -> None:
    """Every restored leaf equal to its source."""
    got_leaves = dict(leaves(got))
    if set(got_leaves) != {p for p, _ in leaves(want)}:
        raise AssertionError(f"{label}: the restored tree has other leaves")
    for path, src in leaves(want):
        if not torch.equal(got_leaves[path], as_full(src)):
            raise AssertionError(f"{label}: {'/'.join(path)} differs")


async def ckpt_tool(cluster, *argv) -> dict:
    """`python -m ceph_tpu_torch.tools.ckpt_tool` as an operator runs it: a
    process of its own, over TCP to this cluster's monitors."""
    here = os.path.dirname(os.path.abspath(__file__))
    hosts = ",".join(f"{h}:{p}" for h, p in cluster.monmap.addrs)
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "ceph_tpu_torch.tools.ckpt_tool", "--mon-host", hosts,
        "--pool", str(EC_POOL), "--device", "cuda", *argv, cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(), 300)
    if proc.returncode != 0:
        raise AssertionError(f"ckpt_tool {' '.join(argv)} exited {proc.returncode}:\n"
                             f"{out.decode()[-2000:]}{err.decode()[-2000:]}")
    return json.loads(out.decode())


async def ckpt_window(cluster: DaemonCluster, watch, smi: str) -> dict:
    """Phase 18's checkpoint window on the live cluster: GPT-2 small's
    parameters saved into pool 1, saved again in the background after
    one layer changed (incremental), verified, collected by ckpt_tool gc
    --keep-last 1, then restored whole onto the card; B1 counted over the
    first save. (Its restores onto the 1x1 and 2x2 meshes were cut for
    time: phase 21 restores onto fleet meshes through the same reader.)"""
    from ceph_tpu_torch.ckpt import CkptStore, layout
    from ceph_tpu_torch.ckpt.gc import list_objects
    from ceph_tpu_torch.parallel import sharding as sh

    for key, value in CKPT_CONFIG.items():
        cluster.cfg.set(key, value)
    io = cluster.rados.io_ctx(EC_POOL)
    store = CkptStore(io, CKPT_NAME)
    mesh1 = sh.ec_mesh(devices=MESHES[0][1])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 180)
    t = time.perf_counter()
    tree = gpt2_state(sh, mesh1, gen)
    torch.cuda.synchronize()
    records = layout.flatten_tree(tree)
    nbytes = sum(4 * int(np.prod(r["shape"])) for r in records)
    if nbytes != 4 * GPT2_PARAMS or {r["dtype"] for r in records} != {"<f4"}:
        raise AssertionError(f"the GPT-2 small state holds {nbytes} B")
    chunk = layout.chunk_bytes(CKPT_CONFIG["ckpt_chunk_target_bytes"],
                               layout.pool_alignment(cluster.rados.objecter.osdmap, EC_POOL))
    print(f"  GPT-2 small {GPT2} parameters, its first {CKPT_LAYERS} blocks: {len(records)} "
          f"float32 tensors, {nbytes} B, made on the card in {time.perf_counter() - t:.2f} s; "
          f"chunk objects of {chunk} B", flush=True)
    out = {"bytes": nbytes}

    watch.start()
    t = time.perf_counter()
    await store.save(tree, save_id=f"{CKPT_NAME}-0")
    save_s = time.perf_counter() - t
    out["launches"] = watch.read()
    if min(out["launches"]) < 1:
        raise AssertionError(f"B1 did not launch in the save window: {out['launches']}")
    out["save_gbps"] = nbytes / save_s / 1e9
    print(f"  [{smi}] save {CKPT_NAME}-0: {save_s:.3f} s, {out['save_gbps']:.4f} GB/s, "
          f"{store.perf.dump()['save_chunks']} chunk objects; B1 launches (wrapper count, "
          f"EncodeService launches) {out['launches']}", flush=True)

    tree["params"].update(gpt2_state(sh, mesh1, gen, only=f"h.{CKPT_CHANGED_LAYER}.")["params"])
    pending = []

    async def background_save():
        pending.append(await store.save_async(tree, save_id=f"{CKPT_NAME}-1"))
        await pending[0].wait()

    wall, busy = await profiled_async(background_save)
    ps = pending[0]
    manifest = await store.reader().read_manifest(f"{CKPT_NAME}-1")
    dedup = layout.manifest_dedup(manifest)
    out.update(stall_s=ps.blocking_s, wall_s=ps.wall_s, dedup=dedup["dedup_ratio"],
               idle=1 - device_ms(busy) / (wall * 1e3))
    print(f"  [{smi}] save_async {CKPT_NAME}-1 after layer {CKPT_CHANGED_LAYER} changed: stall "
          f"{ps.blocking_s:.3f} s (the snapshot to the host), persist {ps.wall_s:.3f} s, "
          f"{dedup['chunks_referenced']} of {dedup['chunks']} chunks referenced from "
          f"{CKPT_NAME}-0 (dedup ratio {dedup['dedup_ratio']}); under torch.profiler "
          f"{wall * 1e3:.3f} ms, device busy {device_ms(busy):.3f} ms, idle share "
          f"{out['idle']:.5f}; device events: "
          + ", ".join(f"{k} x{cnt} {ms:.3f} ms" for k, (cnt, ms) in sorted(busy.items())),
          flush=True)

    t = time.perf_counter()
    verify = await store.verify()
    if not verify["ok"]:
        raise AssertionError(f"verify found bad chunks: {verify['bad'][:4]}")
    print(f"  verify {CKPT_NAME}-1: {verify['chunks']} chunks crc-clean in "
          f"{time.perf_counter() - t:.3f} s", flush=True)

    t = time.perf_counter()
    gc_out = await ckpt_tool(cluster, "gc", CKPT_NAME, "--keep-last", "1")
    old = await list_objects(io, prefix=f"{CKPT_NAME}@{CKPT_NAME}-0")
    referenced = {c["object"] for c in manifest["chunks"]}
    if gc_out["reclaimed_saves"] != [f"{CKPT_NAME}-0"] or set(old) - referenced:
        raise AssertionError(f"gc left objects of {CKPT_NAME}-0: {sorted(set(old) - referenced)[:4]}")
    print(f"  ckpt_tool gc --keep-last 1 (its own process): {len(gc_out['removed'])} objects of "
          f"{CKPT_NAME}-0 removed, {len(old)} of its chunks kept (referenced by "
          f"{CKPT_NAME}-1), {time.perf_counter() - t:.3f} s", flush=True)

    t = time.perf_counter()
    back = await store.restore(device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    check_restored("restore onto the card", back, tree)
    del back
    out["restore_gbps"] = nbytes / restore_s / 1e9
    print(f"  [{smi}] restore onto cuda {restore_s:.3f} s ({out['restore_gbps']:.4f} GB/s); "
          f"every leaf equal to its source (mesh restores: phase 21)", flush=True)
    return out


def phase_daemon_path(gc, factory, smi: str) -> dict:
    """Phase 18: the port's monitors, OSD daemons and client in this process
    on the card, driven through Rados; B1's launches counted in the write,
    degraded-read and recovery windows. Returns B1's launches and times."""
    # warm B1 at the pool's shape before any daemon starts: the daemons share
    # this thread's event loop, and a first use inside an OSD would stall
    # its heartbeats
    codec = factory("isa", {k: v for k, v in DAEMON_EC_PROFILE.items() if k != "plugin"})
    words = torch.zeros((K, OBJECT_BYTES // K // 4), dtype=torch.int32, device="cuda")
    codec.encode_words(words)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    objects = daemon_objects(SEED + 18)
    print(f"  B1 warm at ({K}, {OBJECT_BYTES // K // 4}) int32; {len(objects)} objects of "
          f"{OBJECT_BYTES} B made in {time.perf_counter() - t0:.2f} s", flush=True)

    async def drive():
        cluster = DaemonCluster("cuda")
        t = time.perf_counter()
        await cluster.start()
        print(f"  3 mons, {DAEMON_OSDS} OSDs (a host each, straw2, jewel) and a client up in "
              f"{time.perf_counter() - t:.2f} s; pool {EC_POOL}: isa k={K} m={M} cauchy pg_num "
              f"{DAEMON_PG_NUM[EC_POOL]}, pool {REP_POOL}: replicated size 3 pg_num "
              f"{DAEMON_PG_NUM[REP_POOL]}", flush=True)
        try:
            out = await daemon_sequence(gc, cluster, objects, smi)
        finally:
            await cluster.stop()
        return cluster, out

    cluster, out = asyncio.run(asyncio.wait_for(drive(), 900))
    print(f"  B1 launches (wrapper count, EncodeService launches) by window: {out['launches']}; "
          f"B1 calls that raised: {len(out['raised'])} {out['raised'][:4]}", flush=True)
    if out["raised"]:
        raise AssertionError(f"B1 calls raised on the daemon path: {out['raised'][:4]}")
    for window, counts in out["launches"].items():
        if min(counts) < 1:
            raise AssertionError(f"B1 did not launch in the {window} window: {counts}")
    t = time.perf_counter()
    checked = check_daemon_stores(cluster, out["want"], factory)
    print(f"  {checked} pool-{EC_POOL} shards on the {len(cluster.osds)} OSDs equal the "
          f"CPU isa codec's chunks, each with its hinfo digest ({time.perf_counter() - t:.2f} s)",
          flush=True)
    widths: dict[tuple[str, int, int], int] = {}
    for call in out["widths"]:
        widths[call] = widths.get(call, 0) + 1
    print("  B1 calls by (kind, rows, int32 words a row): "
          + ", ".join(f"{k} x{n}" for k, n in sorted(widths.items(), key=lambda kv: -kv[1])),
          flush=True)
    kind, rows, width = max(widths, key=lambda key: (widths[key], key[2]))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    words = random_words(rows, width, gen)
    enc = codec._encode
    kt = kernel_times(lambda: gc.gf_matmul_packed(enc.packed_t, words, tables=enc.tables_t),
                      TIMED_LAUNCHES)
    moved = (K + M) * width * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"  [{smi}] B1 at the most common width ({rows} x {width} words: "
          f"{widths[(kind, rows, width)]} calls of {kind}), timed as the pool's encode "
          f"({K} -> {M} rows): {times_text(kt)}, bound {bound_ms:.4f} ms "
          f"({moved} B at 3.35 TB/s), share {bound_ms / kt['ms']:.3f}", flush=True)
    del cluster
    return {"launches": sum(c[0] for c in out["launches"].values()), "times": out["times"]}


# -- the device mesh (B8) --------------------------------------------------------

#: phase 19: the north-star batch, 64 objects' (8, 512 KiB) data chunks
MESH_BATCH = (OBJECTS, K, OBJECT_BYTES // K)
#: (name, slot devices) of the meshes B8 runs on: the card alone, and four
#: slots on it, each a launch on the card's current stream
MESHES = (("1x1", ["cuda:0"]), ("2x2", ["cuda:0"] * 4))
B8_LAUNCHES = 20


def b8_check(name: str, got: torch.Tensor, one: torch.Tensor, plain: torch.Tensor) -> int:
    """A sharded output against one B3 launch over the whole batch and
    against the plain version, bit for bit."""
    err = max(check_equal(f"{name} vs one B3 launch", got, one),
              check_equal(f"{name} vs the plain version", got, plain))
    return err


@contextlib.contextmanager
def b8_counted(bp, sh, per_call: dict):
    """`sh._sharded_matmul` with each call's B3 launches appended under its
    mesh's label in `per_call`: a call fails unless it made one launch a
    slot with bytes."""
    inner = sh._sharded_matmul
    labels = {len(devices): label for label, devices in MESHES}

    def counted(mesh, coding, data):
        before = bp.gf_matmul_bitplane.launches
        out = inner(mesh, coding, data)
        made = bp.gf_matmul_bitplane.launches - before
        per_call.setdefault(labels[mesh.size], []).append(made)
        if made != sum(block.numel() > 0 for _idx, block in data.slots):
            raise AssertionError(f"B8 on {mesh.size} slots made {made} B3 launches")
        return out

    sh._sharded_matmul = counted
    try:
        yield
    finally:
        sh._sharded_matmul = inner


def phase_mesh_main(bp, sh, codec, es, objs, encoded) -> tuple[int, int, dict]:
    """Phase 19, the counted part: B8 through its entry points on both
    meshes (sharded_encode/decode at the north-star batch, the planar entry
    points on the burst's (8, 32 MiB) planes) and EncodeService(mesh=2x2) on
    phase 4's burst, each `_sharded_matmul` call's B3 launches counted on
    their own: one a non-empty slot. Returns B3's launches here, the max
    error and each mesh's launches a call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    data = random_bytes(MESH_BATCH, gen)
    enc = codec._encode
    present = [i for i in range(K + M) if i not in ERASED][:K]
    dec = codec.decode_bitmatrix(present, list(ERASED))
    planes = torch.from_numpy(es.pack_objects(K, ((o, OBJECT_BYTES // K) for o in objs))).cuda()
    parity = bp.gf_matmul_bitplane(enc.bits_t, data, tables=enc.tables_t)
    survivors = torch.cat([data, parity], dim=1)[:, present, :]
    planar_parity = bp.gf_matmul_bitplane(enc.bits_t, planes[None], tables=enc.tables_t)[0]
    planar_survivors = torch.cat([planes, planar_parity])[present]
    want = {  # one B3 launch over the whole batch, and the plain version
        "encode": (parity, bp.gf_matmul_bitplane_plain(enc.bits_t, data)),
        "decode": (bp.gf_matmul_bitplane(dec.bits_t, survivors, tables=dec.tables_t),
                   bp.gf_matmul_bitplane_plain(dec.bits_t, survivors)),
        "planar encode": (planar_parity, bp.gf_matmul_bitplane_plain(enc.bits_t, planes[None])[0]),
        "planar decode": (
            bp.gf_matmul_bitplane(dec.bits_t, planar_survivors[None], tables=dec.tables_t)[0],
            bp.gf_matmul_bitplane_plain(dec.bits_t, planar_survivors[None])[0]),
    }
    torch.cuda.synchronize()
    errs, per_call = [], {}
    bp.gf_matmul_bitplane.launches = 0
    with b8_counted(bp, sh, per_call):
        for label, devices in MESHES:
            mesh = sh.ec_mesh(devices=devices)
            got = {
                "encode": sh.sharded_encode(codec, sh.shard_batch(data, mesh), mesh).full("cuda"),
                "decode": sh.sharded_decode(codec, present, list(ERASED),
                                            sh.shard_batch(survivors, mesh), mesh).full("cuda"),
                "planar encode": sh.mesh_encode_planar(codec, planes, mesh),
                "planar decode": sh.mesh_decode_planar(codec, present, list(ERASED),
                                                       planar_survivors, mesh),
            }
            for kind, out in got.items():
                errs.append(b8_check(f"B8 {kind} on the {label} mesh", out, *want[kind]))
    calls_before = len(per_call["2x2"])
    mesh = sh.ec_mesh(devices=MESHES[1][1])
    svc = es.EncodeService(mesh=mesh)

    async def burst():
        t = time.perf_counter()
        chunks = await asyncio.gather(*(svc.encode(codec, o) for o in objs))
        after, enc_s = svc.mesh_launches, time.perf_counter() - t
        survivors = [{i: c for i, c in e.items() if i not in ERASED} for e in chunks]
        t = time.perf_counter()
        rebuilt = await asyncio.gather(*(svc.decode(codec, set(ERASED), s) for s in survivors))
        return chunks, rebuilt, after, enc_s, time.perf_counter() - t

    with b8_counted(bp, sh, per_call):
        chunks, rebuilt, enc_launches, enc_s, dec_s = asyncio.run(burst())
    torch.cuda.synchronize()
    launches = bp.gf_matmul_bitplane.launches
    dec_launches = svc.mesh_launches - enc_launches
    print(f"  EncodeService(mesh=2x2) on phase 4's burst: encode {enc_s * 1e3:.3f} ms, decode "
          f"{dec_s * 1e3:.3f} ms (host clock, first calls at these shapes); mesh launches "
          f"encode {enc_launches}, "
          f"decode {dec_launches}; chunks equal phase 4's {chunks == encoded}, rebuilt "
          f"chunks {sorted(ERASED)} equal {all(r == {i: e[i] for i in ERASED} for r, e in zip(rebuilt, encoded))}",
          flush=True)
    if enc_launches < 1 or dec_launches < 1:
        raise AssertionError("EncodeService(mesh=) did not take the mesh path both ways")
    if chunks != encoded or any(r != {i: e[i] for i in ERASED} for r, e in zip(rebuilt, encoded)):
        raise AssertionError("EncodeService(mesh=) chunks differ from phase 4's")
    if len(per_call["2x2"]) - calls_before != svc.mesh_launches:
        raise AssertionError("EncodeService's mesh calls and B8's calls disagree")
    print(f"  B3 launches a B8 call, call by call: {per_call} (1x1: the four entry points; "
          f"2x2: the four, then EncodeService's {svc.mesh_launches} mesh calls); one a slot, "
          f"so one a card on a mesh of distinct cards", flush=True)
    return launches, max(errs), {label: sorted(set(n)) for label, n in per_call.items()}


def live_children() -> int | None:
    """Child processes of this one alive now (zombies not yet reaped
    included), from /proc/self/task/*/children; None where the kernel has
    no such file."""
    pids, found = set(), False
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                pids.update(f.read().split())
            found = True
        except OSError:
            continue
    return len(pids) if found else None


def phase_mesh_times(bp, sh, codec, smi: str) -> dict:
    """Phase 19, the times (taken after phase 20, when no worker or daemon
    process of the smoke runs beside them): B8's call on each mesh (the
    inputs already laid out, as the entry points hand them on) beside one B3
    launch at the same bytes, the plain version and the bytes bound, with
    B3's launches a call."""
    alive = live_children()
    print(f"  child processes of the smoke alive now (/proc/self/task/*/children): "
          f"{'not readable' if alive is None else alive}", flush=True)
    if alive:
        raise AssertionError(f"{alive} child processes run beside B8's times")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    data = random_bytes(MESH_BATCH, gen)
    enc = codec._encode
    moved = (K + M) * MESH_BATCH[0] * MESH_BATCH[2]
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    one = kernel_times(lambda: bp.gf_matmul_bitplane(enc.bits_t, data, tables=enc.tables_t),
                       B8_LAUNCHES)
    plain_ms = cuda_ms(lambda: bp.gf_matmul_bitplane_plain(enc.bits_t, data), 2)
    print(f"  [{smi}] one B3 launch over {MESH_BATCH} -> ({OBJECTS}, {M}, {MESH_BATCH[2]}): "
          f"{times_text(one)}, bound {bound_ms:.4f} ms ({moved} B at 3.35 TB/s), share "
          f"{bound_ms / one['ms']:.3f}; plain {plain_ms:.3f} ms", flush=True)
    out = {}
    for label, devices in MESHES:
        mesh = sh.ec_mesh(devices=devices)
        laid = sh.shard_batch(data, mesh)
        calls = []

        def call():
            calls.append(1)
            return sh._sharded_matmul(mesh, enc, laid)

        before = bp.gf_matmul_bitplane.launches
        out[label] = kernel_times(call, B8_LAUNCHES)
        out[label]["launches_per_call"] = (bp.gf_matmul_bitplane.launches - before) / len(calls)
        print(f"  [{smi}] B8 on the {label} mesh ({mesh.size} slots on the card, "
              f"{out[label]['launches_per_call']:g} B3 launches a call): "
              f"{times_text(out[label])}, share {bound_ms / out[label]['ms']:.3f} "
              f"(device {bound_ms / out[label]['held_ms']:.3f}), against one B3 launch "
              f"{out[label]['ms'] / one['ms']:.3f}x (device "
              f"{out[label]['held_ms'] / one['held_ms']:.3f}x)", flush=True)
    return {**out["2x2"], "plain_ms": plain_ms, "bound_ms": bound_ms, "one_b3": one,
            "meshes": out}


# -- phase 20: the multi-process cluster --------------------------------------------

MP_MONS, MP_OSDS = 3, 12
#: a cut for the 1200 s limit (each OSD process re-places every PG at each
#: map epoch)
MP_PG_NUM = {EC_POOL: 32, REP_POOL: 16}
#: pool-1 and pool-2 objects, a cut for the 1200 s limit
MP_OBJECTS = {EC_POOL: 64, REP_POOL: 16}
MP_CLIENTS = 4
#: client ops in flight, over all client processes
MP_CONCURRENCY = 32
#: pool-1 objects written while the victims are down
MP_CRASH_WRITES = 16
#: two OSDs, each its own host (initial_osdmap puts every OSD on a host)
MP_VICTIMS = (3, 7)
#: the daemons' config: OSDs on BlockStore (FileDB and a block file in the
#: run dir); a monitor lease of 1 s, so that a peon calls an election after
#: 4 s without one rather than VStart's 1 s while 15 processes boot and
#: place PGs on the host's 8 cores; the victims are marked down by
#: command and the grace outlasts their time down (ROADMAP §C: a revived OSD
#: is otherwise reported failed off its peers' stale heartbeat stamps); PG
#: stats reach the monitors every second, so their health reads what the PGs
#: are now; phase 23's mds beacons every 0.2 s and a grace of 1.5 s
#: (tests/test_mds_live.py's), so that its failover takes seconds
MP_CONFIG = {"osd_objectstore": "blockstore", "mon_lease": 1.0, "mon_election_timeout": 5.0,
             "osd_heartbeat_interval": 0.5, "osd_heartbeat_grace": 120,
             "osd_mon_report_interval": 1.0, "mds_beacon_interval": 0.2,
             "mds_beacon_grace": 1.5}
MP_QUIET_POLLS = 10
MP_RECOVERY_S = 300
#: the health checks that say a PG is not clean
MP_PG_CHECKS = ("PG_AVAILABILITY", "PG_DEGRADED", "PG_UNDERSIZED", "PG_BACKFILLING")
#: daemon_bench --multiprocess at the reference README's hot-set configuration
MP_BENCH_ARGV = ["--multiprocess", "--device", "cuda", "--osds", "6", "--clients", "4",
                 "--k", "2", "--m", "2", "--objects", "64", "--hot-set", "3",
                 "--read-policy", "balance", "--size", "262144"]


def mp_object(pool: int, i: int) -> bytes:
    """Object i of `pool` in phase 20, 4 MiB from the seed (any process
    makes the same bytes)."""
    return np.random.default_rng([SEED + 20, pool, i]).bytes(OBJECT_BYTES)


def _mp_client(job):
    """Worker: one client process of phase 20, on the card, writing its
    share of the objects with `lanes` in flight; returns its window and the
    ops' seconds."""
    from ceph_tpu_torch.vstart import ClusterSpec

    spec_path, worker, keys, lanes = job
    spec = ClusterSpec.load(spec_path)

    async def run():
        from ceph_tpu_torch.rados.client import Rados

        rados = Rados(f"client.mp{worker}", spec.monmap(), config=spec.build_config(),
                      device="cuda")
        await rados.connect()
        io = {pool: rados.io_ctx(pool) for pool in MP_OBJECTS}
        calls = [lambda k=k: io[k[0]].write_full(f"m-{k[0]}-{k[1]}", mp_object(*k))
                 for k in keys]
        t0 = time.time()
        seconds = await daemon_gather(calls, lanes)
        t1 = time.time()
        await rados.shutdown()
        return {"window": (t0, t1), "seconds": seconds}

    return asyncio.run(asyncio.wait_for(run(), 600))


class MPCluster:
    """Phase 20's view of a VStart cluster through its admin client."""

    def __init__(self, v, rados):
        self.v, self.rados = v, rados
        self.total_pgs = sum(MP_PG_NUM.values())

    async def osd_admin(self, cmd: str) -> dict:
        out = {}
        for osd in sorted(self.v.osds):
            out[osd] = await self.rados.objecter.osd_admin(osd, cmd, timeout=30.0)
        return out

    async def counts(self) -> dict:
        """{osd: (EncodeService launches, objects, B1 wrapper launches,
        recovery pushes)} of every running OSD process."""
        status = await self.osd_admin("status")
        perf = await self.osd_admin("perf dump")
        return {osd: (status[osd]["ec_launches"], status[osd]["ec_objects"],
                      perf[osd][f"kernels.osd.{osd}"]["gf_matmul_packed"],
                      perf[osd][f"osd.{osd}"].get("recovery_pushes", 0))
                for osd in status}

    @staticmethod
    def delta(before: dict, after: dict) -> tuple:
        """Per-field sums of after - before; a process that started in
        between counts from zero."""
        return tuple(sum(after[o][f] - before.get(o, (0, 0, 0, 0))[f] for o in after)
                     for f in range(4))

    async def pgs(self, clean: bool) -> tuple[bool, dict]:
        """(every PG active, and with `clean` none degraded, undersized or
        backfilling, in the monitors' health and the OSDs' own counts)."""
        status = await self.osd_admin("status")
        health = await self.rados.mon_command("health")
        active = sum(s["active_pgs"] for s in status.values())
        checks = set(health["checks"]) & set(MP_PG_CHECKS if clean else MP_PG_CHECKS[:1])
        return active >= self.total_pgs and not checks, health

    async def wait_pgs(self, clean: bool, timeout: float, what: str) -> float:
        """Polls until pgs(clean) holds (and, with `clean`, no recovery push
        was made) for MP_QUIET_POLLS polls in a row (2 without `clean`);
        returns the seconds to the first of them."""
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        quiet, since, last, health = 0, t0, None, None
        while quiet < (MP_QUIET_POLLS if clean else 2):
            if loop.time() - t0 > timeout:
                raise AssertionError(f"timed out after {timeout} s waiting for {what}; "
                                     f"health {health}")
            await asyncio.sleep(0.5)
            ok, health = await self.pgs(clean)
            pushes = sum(c[3] for c in (await self.counts()).values()) if clean else None
            if not ok or pushes != last:
                quiet, last = 0, pushes
                continue
            if quiet == 0:
                since = loop.time()
            quiet += 1
        return since - t0


async def mp_quorum_settled(rados, settle_s: float = 5.0, timeout: float = 120.0) -> None:
    """Waits until every monitor is in the quorum and its election epoch has
    held for `settle_s`: a monitor whose boot-time election proposal reaches
    the leader late deposes it (ROADMAP §C), so the first commands wait for
    the boot elections to end."""
    loop = asyncio.get_running_loop()
    end, last, since = loop.time() + timeout, None, loop.time()
    while True:
        st = await rados.mon_command("status")
        now = (st["election_epoch"], tuple(st["quorum"]))
        if now != last or len(st["quorum"]) < MP_MONS:
            last, since = now, loop.time()
        elif loop.time() - since >= settle_s:
            return
        if loop.time() > end:
            raise AssertionError(f"the monitors' quorum did not settle: {st}")
        await asyncio.sleep(0.25)


async def mp_mon_command(rados, cmd: str, args: dict, resent: list) -> dict:
    """A monitor command, sent again (and noted in `resent`) when the
    leader lost its reign while the command was proposed: the monitor
    fails such proposals so that the sender retries against the new
    leader. A pool create whose first proposal committed all the same is
    not sent again."""
    for _ in range(5):
        try:
            return await rados.mon_command(cmd, args)
        except RuntimeError as e:
            if "leadership lost" not in str(e):
                raise
        resent.append(cmd)
        await asyncio.sleep(1.0)
        if cmd == "osd pool create" and args["pool_id"] in (
                await rados.mon_command("status"))["pools"]:
            return {"pool_id": args["pool_id"]}
    raise AssertionError(f"{cmd}: the leader lost its reign five times")


def mp_crush_max_size(rados, decompile_crushmap, size: int) -> str:
    """The committed crush map with rule 0's max_size raised to `size`, as
    crushtool text: what an operator sends with `osd crush set`."""
    import copy

    crush = copy.deepcopy(rados.objecter.osdmap.crush)
    crush.rules[0].max_size = size
    return decompile_crushmap(crush)


def mp_check_stores(run_dir: str, want: dict, factory, parity: dict | None = None) -> int:
    """Phases 20 and 23's offline check: every pool-1 shard in every stopped
    OSD's store, read with the port's objectstore_tool, and its hinfo digest,
    equal what the CPU isa codec makes of the object's bytes (`parity`: the
    parity chunks of some of them, made by that codec in worker processes).
    Returns the shards."""
    from ceph_tpu_torch.common.crc import ceph_crc32c
    from ceph_tpu_torch.osd.ecutil import SEED as HINFO_SEED
    from ceph_tpu_torch.tools.objectstore_tool import open_store

    cpu = factory("isa", {k: v for k, v in DAEMON_EC_PROFILE.items() if k != "plugin"},
                  device="cpu")
    n = cpu.get_chunk_count()
    size = cpu.get_chunk_size(OBJECT_BYTES)
    if size * K != OBJECT_BYTES:
        raise AssertionError("a 4 MiB object must split into k chunks with no padding")
    # the codec's array API over batches of 16 whole objects: data chunk i of
    # an object is its bytes [i*size, (i+1)*size), as encode() cuts them; an
    # object of another size (the journaled image's) through encode() itself
    parity = parity or {}
    chunks = {name: [want[name][i * (len(want[name]) // K):(i + 1) * (len(want[name]) // K)]
                     for i in range(K)] + parity[name] for name in parity}
    for name in set(want) - set(parity):
        if len(want[name]) != OBJECT_BYTES:
            made = cpu.encode(set(range(n)), want[name])
            chunks[name] = [made[i] for i in range(n)]
    names = sorted(set(want) - set(chunks))
    for lo in range(0, len(names), 16):
        batch = names[lo:lo + 16]
        data = torch.from_numpy(np.frombuffer(b"".join(want[m] for m in batch),
                                              np.uint8).reshape(len(batch), K, size).copy())
        made = cpu.encode_array(data).numpy()
        for j, name in enumerate(batch):
            chunks[name] = [want[name][i * size:(i + 1) * size] for i in range(K)] + [
                made[j, i].tobytes() for i in range(M)]
    held: dict[str, set] = {name: set() for name in want}
    checked = 0
    # phase 21's objects share the pool; fsck covers them
    for osd in range(MP_OSDS):
        store, backend = open_store(os.path.join(run_dir, f"osd.{osd}.kv"))
        if backend != "blockstore":
            raise AssertionError(f"osd.{osd}'s store is {backend}, not blockstore")
        try:
            for coll in store.list_collections():
                if not coll.startswith(f"pg_{EC_POOL}_"):
                    continue
                for obj in store.list_objects(coll):
                    base, sep, pos = obj.rpartition(".s")
                    if not (sep and pos.isdigit()):
                        continue
                    if base not in chunks:
                        continue
                    pos = int(pos)
                    chunk = chunks[base][pos]
                    hinfo = store.getattrs(coll, obj)["hinfo"]
                    if store.read(coll, obj) != chunk:
                        raise AssertionError(f"osd.{osd} {obj} differs from the CPU isa "
                                             "codec's chunk")
                    if (hinfo.total_chunk_size != len(chunk) or
                            hinfo.cumulative_shard_hashes[pos] != ceph_crc32c(HINFO_SEED,
                                                                              chunk)):
                        raise AssertionError(f"osd.{osd} {obj}: hinfo differs from the chunk's")
                    held[base].add(pos)
                    checked += 1
        finally:
            store.close()
    short = {name: sorted(set(range(n)) - pos) for name, pos in held.items() if len(pos) < n}
    if short:
        raise AssertionError(f"objects without some shard in any store: "
                             f"{list(short.items())[:4]}")
    return checked


def mp_fsck(run_dir: str) -> list[int]:
    """`python -m ceph_tpu_torch.tools.objectstore_tool --op fsck` on every
    stopped OSD's store, all started together; returns the error counts."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.objectstore_tool", "--data-path",
         os.path.join(run_dir, f"osd.{osd}.kv"), "--op", "fsck"],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for osd in range(MP_OSDS)]
    counts = []
    for osd, proc in enumerate(procs):
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"objectstore_tool --op fsck on osd.{osd} exited "
                                 f"{proc.returncode}: {out[-1000:]}{err[-1000:]}")
        counts.append(json.loads(out)["error_count"])
    return counts


def smi_query(*args: str) -> str:
    return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                          timeout=60).stdout.strip()


async def mp_sequence(v, decompile_crushmap, smi: str) -> dict:
    """Phase 20's drive of a started VStart cluster; returns what the
    offline check needs, the B1 counts per window and the times."""
    out = {"launches": {}, "times": {}}
    started_s = await asyncio.to_thread(v.wait_started, 300)
    t0 = time.perf_counter()
    rados = v.client("client.admin")
    await rados.connect()
    await v.wait_healthy(rados=rados, timeout=300)
    boot_s = started_s + time.perf_counter() - t0
    c = MPCluster(v, rados)
    print(f"  {MP_MONS} mon and {MP_OSDS} OSD processes started (each on its CUDA context) "
          f"{started_s:.3f} s after spawning, every OSD up in the client's map at "
          f"{boot_s:.3f} s", flush=True)
    apps = smi_query("--query-compute-apps=pid,used_memory", "--format=csv,noheader")
    print(f"  nvidia-smi compute apps ({len(apps.splitlines())}; pids may be another "
          f"namespace's): {'; '.join(apps.splitlines())}", flush=True)

    await mp_quorum_settled(rados)
    resent: list[str] = []
    t = time.perf_counter()
    await mp_mon_command(rados, "osd crush set", {
        "crush_text": mp_crush_max_size(rados, decompile_crushmap, K + M)}, resent)
    await mp_mon_command(rados, "osd erasure-code-profile set",
                         {"name": "mp", "profile": dict(DAEMON_EC_PROFILE)}, resent)
    await mp_mon_command(rados, "osd pool create", {
        "pool_id": EC_POOL, "crush_rule": 0, "erasure_code_profile": "mp",
        "pg_num": MP_PG_NUM[EC_POOL]}, resent)
    await mp_mon_command(rados, "osd pool create", {
        "pool_id": REP_POOL, "crush_rule": 1, "size": 3, "pg_num": MP_PG_NUM[REP_POOL]},
        resent)
    for _ in range(60):
        if rados.objecter.osdmap.crush.rules[0].max_size == K + M:
            break
        await asyncio.sleep(0.5)
    else:
        raise AssertionError("osd crush set did not raise rule 0's max_size")
    cmds_s = time.perf_counter() - t
    act_s = cmds_s + await c.wait_pgs(False, 600, "every PG active")
    print(f"  rule 0's max_size set to {K + M} by `osd crush set`; pool {EC_POOL}: isa k={K} "
          f"m={M} cauchy pg_num {MP_PG_NUM[EC_POOL]}, pool {REP_POOL}: replicated size 3 "
          f"pg_num {MP_PG_NUM[REP_POOL]}; every PG active {act_s:.3f} s after the first "
          f"command (the commands took {cmds_s:.3f} s)", flush=True)
    out["times"].update(boot_s=boot_s, activation_s=act_s)

    io = {pool: rados.io_ctx(pool) for pool in MP_OBJECTS}
    keys = [(pool, i) for pool, n in MP_OBJECTS.items() for i in range(n)]

    async def read_all(keys, what):
        async def one(k):
            data = await io[k[0]].read(f"m-{k[0]}-{k[1]}")
            if data != mp_object(*k):
                raise AssertionError(f"{what}: m-{k[0]}-{k[1]} read back other bytes")
        calls = [lambda k=k: one(k) for k in keys]
        t = time.perf_counter()
        await daemon_gather(calls, MP_CONCURRENCY)
        return time.perf_counter() - t

    # write window: 4 client processes, MP_CONCURRENCY ops in flight in all
    before = await c.counts()
    jobs = [(v.spec_path, w, keys[w::MP_CLIENTS], MP_CONCURRENCY // MP_CLIENTS)
            for w in range(MP_CLIENTS)]
    t = time.perf_counter()
    results = await asyncio.to_thread(in_workers, "_mp_client", jobs)
    wall = time.perf_counter() - t
    out["launches"]["write"] = c.delta(before, await c.counts())
    span = max(r["window"][1] for r in results) - min(r["window"][0] for r in results)
    lat = [s for r in results for s in r["seconds"]]
    n_ec = MP_OBJECTS[EC_POOL]
    nbytes = len(keys) * OBJECT_BYTES
    out["times"]["write"] = {"gbps": nbytes / span / 1e9, "s": span,
                             "ms_per_object": span / len(keys) * 1e3,
                             "latency_ms": float(np.mean(lat)) * 1e3}
    print(f"  [{smi}] write of {n_ec} EC objects (4 MiB, isa k={K} m={M}) and "
          f"{MP_OBJECTS[REP_POOL]} replicated by {MP_CLIENTS} client processes at "
          f"{MP_CONCURRENCY} in flight: {span:.3f} s from the first op to the last "
          f"({wall:.3f} s with the processes' start), {out['times']['write']['gbps']:.4f} "
          f"GB/s, {span / len(keys) * 1e3:.3f} ms an object, mean op latency "
          f"{np.mean(lat) * 1e3:.3f} ms (p50 {np.percentile(lat, 50) * 1e3:.3f}, max "
          f"{max(lat) * 1e3:.3f})", flush=True)
    read_s = await read_all(keys, "read")
    out["times"]["read"] = {"gbps": nbytes / read_s / 1e9, "s": read_s}
    print(f"  [{smi}] read of all {len(keys)} objects at {MP_CONCURRENCY} in flight: "
          f"{read_s:.3f} s, {out['times']['read']['gbps']:.4f} GB/s, every read exact",
          flush=True)

    # crash window: two OSD processes SIGKILLed and marked down
    before = await c.counts()
    for victim in MP_VICTIMS:
        v.kill_osd(victim)
        before.pop(victim)
        await mp_mon_command(rados, "osd down", {"osd": victim}, resent)
    repeer_s = await c.wait_pgs(False, 600, "every PG active after the kill")
    ec_keys = [k for k in keys if k[0] == EC_POOL]
    deg_s = await read_all(ec_keys, "degraded read")
    new = [(EC_POOL, n_ec + i) for i in range(MP_CRASH_WRITES)]
    t = time.perf_counter()
    await daemon_gather([lambda k=k: io[EC_POOL].write_full(f"m-{k[0]}-{k[1]}", mp_object(*k))
                         for k in new], MP_CONCURRENCY)
    crash_w_s = time.perf_counter() - t
    out["launches"]["crash"] = c.delta(before, await c.counts())
    out["times"]["degraded read"] = {"gbps": len(ec_keys) * OBJECT_BYTES / deg_s / 1e9,
                                     "s": deg_s}
    print(f"  [{smi}] OSD processes {list(MP_VICTIMS)} SIGKILLed and marked down, every PG "
          f"active again in {repeer_s:.3f} s; degraded read of {len(ec_keys)} EC objects: "
          f"{deg_s:.3f} s, {out['times']['degraded read']['gbps']:.4f} GB/s, every read "
          f"exact; {MP_CRASH_WRITES} EC objects written with them down in {crash_w_s:.3f} s",
          flush=True)
    keys += new

    # restart window: the victims restarted over their surviving BlockStores
    before = await c.counts()
    t = time.perf_counter()
    for victim in MP_VICTIMS:
        v.start_osd(victim)
    await v.wait_healthy(rados=rados, timeout=300)
    up_s = time.perf_counter() - t
    clean_s = up_s + await c.wait_pgs(True, MP_RECOVERY_S, "every PG clean, pushes stopped")
    out["launches"]["restart"] = c.delta(before, await c.counts())
    read2_s = await read_all(keys, "read after the restart")
    out["times"]["restart"] = {"up_s": up_s, "clean_s": clean_s,
                               "pushes": out["launches"]["restart"][3]}
    print(f"  [{smi}] OSDs {list(MP_VICTIMS)} restarted over their stores, up in {up_s:.3f} "
          f"s, every PG clean and no push for {MP_QUIET_POLLS} polls {clean_s:.3f} s after "
          f"the restart ({out['launches']['restart'][3]} objects and shards pushed); read of "
          f"all {len(keys)} objects: {read2_s:.3f} s, every read exact", flush=True)
    print(f"  monitor commands sent again after the leader lost its reign: {len(resent)} "
          f"{resent}", flush=True)
    await rados.shutdown()
    out["want"] = {f"m-{p}-{i}": mp_object(p, i) for p, i in keys if p == EC_POOL}
    return out


def phase_multiprocess(factory, decompile_crushmap, smi: str, parity) -> dict:
    """Phase 20: the port's cluster as its users deploy it, one process per
    daemon on the card, through vstart.VStart; B1 counted in every OSD
    process per window over `osd_admin`; `parity`, a future of
    `offline_parity()`, for the offline check. Returns B1's launches and
    times."""
    import shutil
    import tempfile

    from ceph_tpu_torch.vstart import VStart

    run_dir = tempfile.mkdtemp(prefix="chip-smoke-vstart-")
    try:
        v = VStart(run_dir, n_mons=MP_MONS, n_osds=MP_OSDS, config=MP_CONFIG, device="cuda")
        t = time.perf_counter()
        v.start()
        print(f"  VStart on {v.device}: kernels and native libraries built before the "
              f"spawn, {MP_MONS} mon and {MP_OSDS} OSD processes (BlockStore) spawned in "
              f"{time.perf_counter() - t:.3f} s; run dir {run_dir}", flush=True)
        try:
            out = asyncio.run(asyncio.wait_for(mp_sequence(v, decompile_crushmap, smi), 1200))
            phase("phase 21: the training fleet and the dataset store on this cluster")
            fleet = asyncio.run(asyncio.wait_for(fleet_sequence(v, smi), 900))
            phase("phase 22: the manager daemon on this cluster")
            mgr = asyncio.run(asyncio.wait_for(mgr_sequence(v, smi), 600))
            phase("phase 23: block images, their mirror and CephFS on this cluster")
            rbd = asyncio.run(asyncio.wait_for(rbd_sequence(v, smi), 900))
            phase("phase 24: the object gateway (S3) on this cluster")
            rgw = asyncio.run(asyncio.wait_for(rgw_sequence(v, smi), 600))
        except BaseException:
            for name in v.exited() or ("mon.0", "osd.0"):
                print(f"  {name}'s log ends:\n{v.log_tail(name)}", flush=True)
            raise
        finally:
            rcs = v.stop(signal.SIGTERM)
        print(f"  SIGTERM to every daemon: exit codes {rcs} (at {time.perf_counter() - T0:.1f} s)",
              flush=True)
        # the mgr, the mds that took the rank (its peer was SIGKILLed), the rgw
        if any(rcs.values()) or len(rcs) != MP_MONS + MP_OSDS + 3 or rcs.get("rgw.0") != 0:
            raise AssertionError(f"a daemon did not stop cleanly: {rcs}")
        names = ("EncodeService launches", "objects", "B1 wrapper launches", "pushes")
        for window, counts in out["launches"].items():
            print(f"  {window} window, summed over the OSD processes: "
                  + ", ".join(f"{n} {c}" for n, c in zip(names, counts)), flush=True)
            if counts[0] < 1 or counts[2] < 1:
                raise AssertionError(f"B1 did not launch in the {window} window: {counts}")
        t = time.perf_counter()
        if sorted(out["want"]) != sorted(mp_ec_names()):
            raise AssertionError("phase 20 wrote other pool-1 objects than mp_ec_names()")
        heads = {**rbd_heads(), **rbd.pop("mirror_heads")}
        made = parity.result()
        stored = rgw_stored(rgw["uploads"], rgw["vids"], made["parity"])
        checked = mp_check_stores(run_dir, {**out["want"], **heads, **stored}, factory,
                                  made["parity"])
        errors = mp_fsck(run_dir)
        print(f"  offline, the stopped stores: {checked} pool-{EC_POOL} shards of "
              f"{len(out['want'])} phase-20 objects, {len(heads)} rbd_data head objects and "
              f"{len(stored)} gateway objects (data, parts, manifests, versions) equal the CPU "
              f"isa codec's chunks (the parity of the 4 MiB and larger ones made in "
              f"{PARITY_WORKERS} worker processes from phase 18 on, {made['s']:.2f} s), each "
              f"with its hinfo digest; objectstore_tool --op fsck error counts {errors} "
              f"({time.perf_counter() - t:.2f} s)", flush=True)
        if any(errors):
            raise AssertionError(f"fsck found errors: {errors}")
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    return {"launches": sum(c[2] for c in out["launches"].values()), "times": out["times"],
            "fleet": fleet, "mgr": mgr, "rbd": rbd, "rgw": rgw}


def phase_multiprocess_bench(smi: str) -> None:
    """Phase 20b: `python -m ceph_tpu_torch.tools.daemon_bench --multiprocess`
    at the reference README's hot-set configuration, on the card."""
    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_bench", *MP_BENCH_ARGV]
    t = time.perf_counter()
    proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"daemon_bench --multiprocess exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.splitlines()[-1])
    if line["mode"] != "multiprocess" or line["objects"] < 1:
        raise AssertionError(f"daemon_bench --multiprocess ran nothing: {line}")
    print(f"  [{smi}] daemon_bench {' '.join(MP_BENCH_ARGV)} in "
          f"{time.perf_counter() - t:.2f} s (its processes included):", flush=True)
    print(f"  {json.dumps(line)}", flush=True)


# -- phase 21: the training fleet and the dataset store ------------------------------

#: the dataset: GPT-2-tokenised text as nanoGPT stores it (uint16 tokens, which
#: GPT-2's vocabulary fits), 32,768 records of 1,024 tokens: 64 MiB (from
#: 128 MiB, a cut for the 1200 s limit: ingest and data_tool verify halve)
DS_RECORDS, DS_TOKENS = 32_768, 1024
DS_NAME = "owt-tokens"
#: hosts of the fleet and of the dataset's epoch, at nanoGPT's batch size
FLEET_HOSTS = 4
DS_BATCH = 12
#: the pass without the prefetch pipeline reads this many batches a host, a
#: cut: on the card 4 hosts read 318-363 records/s without prefetch, so a
#: whole epoch would take over 3 minutes
DS_NOPREFETCH_BATCHES = 16
#: the pass with it reads this many batches a host (of the epoch's 683), a
#: cut: the whole epoch took 96 s on the card and 256 batches 18 s, and the
#: smoke's later phases need the time
DS_PREFETCH_BATCHES = 64
FLEET_NAME = "gpt2-fleet"
#: tests/test_fleet_live.py's failover shape: records, steps before and after
#: the committed save, batch, seed and lease
FO_RECORDS, FO_PRE, FO_MID, FO_BATCH, FO_SEED, FO_LEASE = 96, 3, 2, 4, 7, 2.0


def ds_tokens() -> np.ndarray:
    return np.random.default_rng(SEED + 21).integers(0, GPT2["vocab"], (DS_RECORDS, DS_TOKENS),
                                                     dtype=np.uint16)


def ds_host_ids() -> list[np.ndarray]:
    """Each host's record ids in epoch 0, in numpy: the permutation cut by
    host_slice."""
    from ceph_tpu_torch.data import epoch_permutation
    from ceph_tpu_torch.parallel.sharding import host_slice

    perm = epoch_permutation(DS_RECORDS, SEED, 0)
    return [perm[host_slice(DS_RECORDS, FLEET_HOSTS, h)] for h in range(FLEET_HOSTS)]


def _ds_host(job):
    """Worker: one training host of phase 21 reading its share of the
    dataset's epoch twice, every batch checked against the source records
    at the ids ds_host_ids gives: DS_PREFETCH_BATCHES batches with the
    prefetch pipeline, then (once every host has written its marker file
    beside the cluster's spec) DS_NOPREFETCH_BATCHES without it, on a new
    client. Returns each pass's window, records read and store counters."""
    from ceph_tpu_torch.vstart import ClusterSpec

    spec_path, h = job
    spec = ClusterSpec.load(spec_path)
    tokens, want = ds_tokens(), ds_host_ids()[h]
    marker = os.path.join(os.path.dirname(spec_path), "ds-pass-1.{}")

    async def run(prefetch):
        batches = DS_PREFETCH_BATCHES if prefetch else DS_NOPREFETCH_BATCHES
        from ceph_tpu_torch.data import DataStore
        from ceph_tpu_torch.rados.client import Rados

        cfg = spec.build_config()
        if not prefetch:
            cfg.set("data_prefetch_batches", 0)
        rados = Rados(f"client.ds{h}", spec.monmap(), config=cfg, device="cuda")
        await rados.connect()
        st = DataStore(rados.io_ctx(EC_POOL), DS_NAME)
        t0 = time.time()
        it = await st.iterator(seed=SEED, batch_size=DS_BATCH, num_hosts=FLEET_HOSTS, host=h)
        pos = 0
        async for batch in it:
            if not np.array_equal(batch, tokens[want[pos:pos + len(batch)]]):
                raise AssertionError(f"host {h}: batch at position {pos} differs from the "
                                     "source records at its ids")
            pos += len(batch)
            if pos == batches * DS_BATCH:
                break
        t1 = time.time()
        if pos != min(len(want), batches * DS_BATCH):
            raise AssertionError(f"host {h} read {pos} of {len(want)} records")
        await rados.shutdown()
        return {"window": (t0, t1), "records": pos, "perf": st.perf_dump()}

    first = asyncio.run(asyncio.wait_for(run(True), 600))
    open(marker.format(h), "w").close()
    end = time.monotonic() + 300
    while not all(os.path.exists(marker.format(i)) for i in range(FLEET_HOSTS)):
        if time.monotonic() > end:
            raise AssertionError(f"host {h}: the other hosts never finished the first pass")
        time.sleep(0.05)
    return first, asyncio.run(asyncio.wait_for(run(False), 600))


async def port_tool(v, tool: str, *argv: str, stderr=None):
    """`python -m ceph_tpu_torch.tools.<tool>` against the cluster's monitors
    on pool 1, on the card: its stdout; or, given a file for its `stderr`,
    the running process."""
    here = os.path.dirname(os.path.abspath(__file__))
    hosts = ",".join(f"{h}:{p}" for h, p in v.spec.monmap().addrs)
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", f"ceph_tpu_torch.tools.{tool}", "--mon-host", hosts, "--pool",
        str(EC_POOL), "--device", "cuda", *argv, cwd=here, stdout=subprocess.PIPE,
        stderr=stderr or subprocess.PIPE)
    if stderr is not None:
        return proc
    out, err = await asyncio.wait_for(proc.communicate(), 300)
    if proc.returncode != 0:
        raise AssertionError(f"{tool} {' '.join(argv)} exited {proc.returncode}:\n"
                             f"{out.decode()[-2000:]}{err.decode()[-2000:]}")
    return out.decode()


def window_counts(name: str, counts: tuple) -> tuple:
    print(f"  {name} window, summed over the OSD processes: EncodeService launches "
          f"{counts[0]}, objects {counts[1]}, B1 wrapper launches {counts[2]}, pushes "
          f"{counts[3]}", flush=True)
    if counts[0] < 1 or counts[2] < 1:
        raise AssertionError(f"B1 did not launch in the {name} window: {counts}")
    return counts


async def dataset_window(v, c, smi: str) -> dict:
    """Ingest, data_tool verify, and one epoch read as FLEET_HOSTS hosts with
    and without the prefetch pipeline, every record checked."""
    from ceph_tpu_torch.data import DataStore

    t = time.perf_counter()
    tokens = ds_tokens()
    nbytes = tokens.nbytes
    if sorted(np.concatenate(ds_host_ids()).tolist()) != list(range(DS_RECORDS)):
        raise AssertionError("the hosts' record ids do not partition the dataset")
    print(f"  {DS_RECORDS} records of {DS_TOKENS} uint16 tokens ({nbytes} B) made in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    before = await c.counts()
    store = DataStore(c.rados.io_ctx(EC_POOL), DS_NAME)
    t = time.perf_counter()
    await store.ingest(list(tokens), ingest_id="owt-0")
    ingest_s = time.perf_counter() - t
    ingest_counts = c.delta(before, await c.counts())
    perf = store.perf_dump()
    out = {"ingest_gbps": nbytes / ingest_s / 1e9, "ingest_s": ingest_s}
    print(f"  [{smi}] ingest into pool {EC_POOL}: {ingest_s:.3f} s, {out['ingest_gbps']:.4f} "
          f"GB/s, {DS_RECORDS / ingest_s:.1f} records/s, {perf['ingest_shards']} shards; B1 "
          f"over the ingest (EncodeService launches, wrapper launches) "
          f"{ingest_counts[0]}, {ingest_counts[2]}", flush=True)
    t = time.perf_counter()
    verify = json.loads(await port_tool(v, "data_tool", "verify", DS_NAME))
    if verify["record_count"] != DS_RECORDS:
        raise AssertionError(f"data_tool verify counted {verify['record_count']} records")
    print(f"  data_tool verify (its own process): {verify['record_count']} records in "
          f"{len(verify['shards'])} shards crc-clean, {time.perf_counter() - t:.3f} s",
          flush=True)

    # both passes in the same FLEET_HOSTS processes, the second started when
    # every host has ended the first
    t = time.perf_counter()
    passes = await asyncio.to_thread(in_workers, "_ds_host",
                                     [(v.spec_path, h) for h in range(FLEET_HOSTS)])
    wall = time.perf_counter() - t
    for i, (label, prefetch) in enumerate((("with prefetch", True), ("prefetch 0", False))):
        res = [p[i] for p in passes]
        secs = max(r["window"][1] for r in res) - min(r["window"][0] for r in res)
        read = sum(r["records"] for r in res)
        hits = sum(r["perf"]["cache_hit_blocks"] for r in res)
        fetched = sum(r["perf"]["cache_fetch_blocks"] for r in res)
        rate = hits / max(hits + fetched, 1)
        key = "read" if prefetch else "read_noprefetch"
        out[key] = {"gbps": read * DS_TOKENS * 2 / secs / 1e9, "s": secs, "records": read,
                    "records_per_s": read / secs, "hit_rate": rate,
                    "fetch_bytes": sum(r["perf"]["fetch_bytes"] for r in res)}
        cut = f" (cut to {DS_PREFETCH_BATCHES if prefetch else DS_NOPREFETCH_BATCHES} batches a host)"
        whole = (f"{wall:.3f} s for both passes with the processes' start" if prefetch
                 else "the same processes")
        print(f"  [{smi}] epoch read by {FLEET_HOSTS} host processes at batch {DS_BATCH}, "
              f"{label}: {secs:.3f} s from the first batch asked to the last{cut} "
              f"({whole}), {out[key]['gbps']:.4f} GB/s, "
              f"{out[key]['records_per_s']:.1f} records/s, {out[key]['fetch_bytes']} B "
              f"fetched, block cache {hits} hits / {fetched} fetches (hit rate {rate:.4f}); "
              f"every record equal to its source at the ids epoch_permutation and "
              f"host_slice give", flush=True)
    out["prefetch_speedup"] = out["read"]["records_per_s"] / out["read_noprefetch"]["records_per_s"]
    print(f"  prefetch speedup (records/s): {out['prefetch_speedup']:.3f}", flush=True)
    out["launches"] = window_counts("dataset", c.delta(before, await c.counts()))
    return out


def check_mesh_tree(label: str, got: dict, tree: dict, slots: int) -> int:
    """Every restored MeshArray slot equal to its slab of the source; returns
    the leaves laid out in `slots` distinct slabs."""
    if set(got) != set(tree):
        raise AssertionError(f"{label}: the restored tree has other leaves")
    split = 0
    for name, src in tree.items():
        out = got[name]
        if len(out.slots) != slots:
            raise AssertionError(f"{label}: {name} on {len(out.slots)} slots")
        for idx, block in out.slots:
            if not torch.equal(block, src[idx]):
                raise AssertionError(f"{label}: {name} slot {idx} differs")
        slabs = {tuple(sl.indices(n) for sl, n in zip(idx, out.shape)) for idx, _b in out.slots}
        split += len(slabs) == slots
    return split


async def fleet_save_window(v, c, smi: str) -> dict:
    """FLEET_HOSTS in-process Fleet members save GPT-2 small's parameters
    collectively from a fleet mesh on the card; restores onto the mesh, per
    rank, and onto a smaller mesh after a member leaves."""
    from ceph_tpu_torch.ckpt import CkptStore
    from ceph_tpu_torch.coord import Fleet, FleetDriver
    from ceph_tpu_torch.coord import mesh as coord_mesh

    devices = ["cuda:0"] * FLEET_HOSTS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 210)
    tree = {n: torch.randn(s, generator=gen, device="cuda") * 0.02
            for n, s in gpt2_shapes().items()}
    nbytes = sum(4 * t.numel() for t in tree.values())
    if nbytes != 4 * GPT2_PARAMS:
        raise AssertionError(f"the GPT-2 small parameters hold {nbytes} B")
    mesh = coord_mesh.fleet_mesh(FLEET_HOSTS, devices=devices)
    sharded = coord_mesh.shard_tree(tree, mesh)
    torch.cuda.synchronize()
    n_split = sum(bool(a.spec) for a in sharded.values())
    print(f"  GPT-2 small's {len(tree)} float32 tensors ({nbytes} B) on a {FLEET_HOSTS}-slot "
          f"fleet mesh of the card: {n_split} sharded on `fleet`, {len(tree) - n_split} "
          f"replicated (wte's {GPT2['vocab']} rows among them)", flush=True)
    clients = [v.client(f"client.fleet{i}") for i in range(FLEET_HOSTS)]
    fleets, drivers = [], []
    for i, r in enumerate(clients):
        await r.connect()
        for key, value in CKPT_CONFIG.items():
            r.objecter.config.set(key, value)
        io = r.io_ctx(EC_POOL)
        fleets.append(Fleet(io, FLEET_NAME, f"host-{i}"))
        drivers.append(FleetDriver(fleets[-1], ckpt=CkptStore(io, FLEET_NAME), devices=devices))
    for f in fleets:
        await f.join()
    if not await fleets[0].elect():
        raise AssertionError("host-0 did not take the vacant leader seat")
    out = {"bytes": nbytes}
    before = await c.counts()
    t = time.perf_counter()
    handles = [await d.save_async(sharded, save_id="fleet-0", timeout=600) for d in drivers]
    sids = await asyncio.gather(*(h.wait() for h in handles))
    save_s = time.perf_counter() - t
    if set(sids) != {"fleet-0"} or [h.leader for h in handles].count(True) != 1:
        raise AssertionError(f"not one collective save: {sids}")
    save_counts = c.delta(before, await c.counts())
    shares = [d.ckpt.perf_dump()["save_prepared_bytes"] / nbytes for d in drivers]
    out.update(save_gbps=nbytes / save_s / 1e9, save_s=save_s, shares=shares)
    print(f"  [{smi}] collective save_async by {FLEET_HOSTS} ranks: {save_s:.3f} s, "
          f"{out['save_gbps']:.4f} GB/s; each rank's save_prepared_bytes as a share of the "
          f"tree: {[round(x, 4) for x in shares]}; B1 over the save (EncodeService, wrapper) "
          f"{save_counts[0]}, {save_counts[2]}", flush=True)

    t = time.perf_counter()
    back = await drivers[1].restore_mesh()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    split = check_mesh_tree("restore_mesh", back, tree, FLEET_HOSTS)
    del back
    out["restore_mesh_gbps"] = nbytes / secs / 1e9
    msg = [f"restore_mesh on {FLEET_HOSTS} slots {secs:.3f} s "
           f"({out['restore_mesh_gbps']:.4f} GB/s, {split} leaves in {FLEET_HOSTS} slabs)"]
    t = time.perf_counter()
    fetched = 0
    for rank, d in enumerate(drivers):
        shards = await d.restore_rank_shards()
        for key, (block, idx) in shards.items():
            if not torch.equal(torch.from_numpy(block.copy()).cuda(), tree[key][idx]):
                raise AssertionError(f"rank {rank}: {key} slab {idx} differs")
            fetched += block.nbytes
        if set(shards) != set(tree):
            raise AssertionError(f"rank {rank} restored other leaves")
    secs = time.perf_counter() - t
    out["rank_shards_gbps"] = fetched / secs / 1e9
    msg.append(f"restore_rank_shards of the {FLEET_HOSTS} ranks {secs:.3f} s ({fetched} B, "
               f"{out['rank_shards_gbps']:.4f} GB/s)")
    await fleets[-1].leave()
    t = time.perf_counter()
    back = await drivers[0].restore_mesh()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    split = check_mesh_tree("elastic restore_mesh", back, tree, FLEET_HOSTS - 1)
    del back
    out["elastic_gbps"] = nbytes / secs / 1e9
    msg.append(f"after host-{FLEET_HOSTS - 1} left, restore_mesh on {FLEET_HOSTS - 1} slots "
               f"{secs:.3f} s ({out['elastic_gbps']:.4f} GB/s, {split} leaves in "
               f"{FLEET_HOSTS - 1} slabs)")
    print(f"  [{smi}] " + "; ".join(msg) + "; every leaf and slab equal to its source",
          flush=True)
    for f in fleets[:-1]:
        await f.leave()
    for r in clients:
        await r.shutdown()
    out["launches"] = window_counts("fleet-parallel save", c.delta(before, await c.counts()))
    return out


async def failover_window(v, c, smi: str) -> dict:
    """tests/test_fleet_live.py on the card: 3 fleet_tool worker processes,
    the leader SIGKILLed mid-save, the survivors' exact resume."""
    from ceph_tpu_torch.ckpt import CkptStore
    from ceph_tpu_torch.data import DataStore
    from ceph_tpu_torch.tools.fleet_tool import _tree

    records = [f"rec-{i:04d}".encode() for i in range(FO_RECORDS)]
    io = c.rados.io_ctx(EC_POOL)
    before = await c.counts()
    await DataStore(io, "corpus").ingest(records, ingest_id="corpus-0")
    shape = ["--seed", str(FO_SEED), "--batch", str(FO_BATCH), "--pre-steps", str(FO_PRE),
             "--mid-steps", str(FO_MID), "--lease", str(FO_LEASE), "--timeout", "120",
             "--quorum", "3", "worker", "train"]
    t0 = time.perf_counter()
    logs = [open(os.path.join(v.spec.run_dir, f"worker.{h}.log"), "wb+")
            for h in ("host-a", "host-b", "host-c")]
    procs = [await port_tool(v, "fleet_tool", "--host-id", "host-a", "--role", "victim", *shape,
                             stderr=logs[0])]
    procs += [await port_tool(v, "fleet_tool", "--host-id", h, *shape, stderr=log)
              for h, log in (("host-b", logs[1]), ("host-c", logs[2]))]

    def log_tail(i: int) -> str:
        logs[i].seek(0)
        return logs[i].read().decode(errors="replace")[-2000:]
    stamped: dict[int, list] = {1: [], 2: []}

    async def follow(i):
        while True:
            line = await procs[i].stdout.readline()
            if not line:
                return
            stamped[i].append((time.perf_counter(), json.loads(line)))

    try:
        victim_events = []
        while not victim_events or victim_events[-1]["event"] != "mid_save":
            line = await asyncio.wait_for(procs[0].stdout.readline(), 300)
            if not line:
                raise AssertionError(f"the victim exited before mid_save:\n{log_tail(0)}")
            victim_events.append(json.loads(line))
        apps = smi_query("--query-compute-apps=pid,used_memory", "--format=csv,noheader")
        print(f"  3 worker processes on the card, {time.perf_counter() - t0:.3f} s to the "
              f"victim's mid-save; nvidia-smi compute apps ({len(apps.splitlines())}): "
              f"{'; '.join(apps.splitlines())}", flush=True)
        followers = [asyncio.ensure_future(follow(i)) for i in (1, 2)]
        procs[0].send_signal(signal.SIGKILL)
        t_kill = time.perf_counter()
        await procs[0].wait()
        await asyncio.wait_for(asyncio.gather(*followers), 300)
        for i in (1, 2):
            await procs[i].wait()
            if procs[i].returncode != 0:
                raise AssertionError(f"survivor {i} exited {procs[i].returncode}:\n"
                                     f"{log_tail(i)}")
    finally:
        for p in procs:
            if p.returncode is None:
                p.kill()
                await p.wait()
        for log in logs:
            log.close()
    sb, sc = ([e for _t, e in stamped[i]] for i in (1, 2))
    (rb,), (rc,) = ([e for e in ev if e["event"] == "resumed"] for ev in (sb, sc))
    if rb["head"] != rc["head"] or rb["live"] != ["host-b", "host-c"]:
        raise AssertionError(f"the survivors disagree: {rb} {rc}")
    (commit,) = [e for e in victim_events if e["event"] == "commit"]
    acked_steps = FO_PRE if rb["head"] == commit["save_id"] else FO_PRE + FO_MID
    if (rb["position"], rb["base"], rb["w_sum"]) != (0, acked_steps * FO_BATCH * 3,
                                                       32.0 * acked_steps):
        raise AssertionError(f"the resumed cursor or model is not HEAD's: {rb}")
    acked = [i for ev in (victim_events, sb, sc) for e in ev
             if e["event"] == "batch" and e["step"] < acked_steps for i in e["ids"]]
    resumed = [i for ev in (sb, sc) for e in ev if e["event"] == "rbatch" for i in e["ids"]]
    dups = len(acked) + len(resumed) - len(set(acked + resumed))
    missing = len({r.decode() for r in records} - set(acked + resumed))
    if dups or missing:
        raise AssertionError(f"{dups} records twice, {missing} missing after the failover")
    finals = [e for ev in (sb, sc) for e in ev if e["event"] == "final_commit"]
    if len(finals) != 1:
        raise AssertionError(f"{len(finals)} final commits")
    resume_s = min(t for i in (1, 2) for t, e in stamped[i] if e["event"] == "resumed") - t_kill
    head = await CkptStore(io, "model").head()
    restored = await CkptStore(io, "model").restore(device="cuda")
    step = FO_PRE + FO_MID
    want = _tree(step)
    if head["save_id"] != finals[0]["save_id"] or any(
            not np.array_equal(restored[k].cpu().numpy(), want[k]) for k in want):
        raise AssertionError("the final HEAD is not _tree(step)")
    status = json.loads(await port_tool(v, "fleet_tool", "status", "train"))
    print(f"  [{smi}] leader SIGKILLed mid-save; survivors resumed from HEAD {rb['head']} "
          f"(acked steps {acked_steps}) {resume_s:.3f} s after the kill "
          f"({resume_s / FO_LEASE:.2f} lease periods of {FO_LEASE} s): {len(acked)} acked + "
          f"{len(resumed)} resumed records, 0 twice, 0 missing; final commit "
          f"{finals[0]['save_id']} by {finals[0]['host']} equals _tree({step}); whole window "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    print(f"  fleet_tool status train: {json.dumps(status, sort_keys=True)}", flush=True)
    if status["leader"] is not None or status["members"]:
        raise AssertionError(f"the fleet did not end empty: {status}")
    return {"resume_s": resume_s, "lease_periods": resume_s / FO_LEASE,
            "launches": window_counts("failover", c.delta(before, await c.counts()))}


async def fleet_sequence(v, smi: str) -> dict:
    """Phase 21's three windows on phase 20's running cluster."""
    t0 = time.perf_counter()
    rados = v.client("client.fleetadmin")
    await rados.connect()
    c = MPCluster(v, rados)
    out = {}
    try:
        out["dataset"] = await dataset_window(v, c, smi)
        out["save"] = await fleet_save_window(v, c, smi)
        out["failover"] = await failover_window(v, c, smi)
    finally:
        await rados.shutdown()
    out["s"] = time.perf_counter() - t0
    out["launches"] = sum(w["launches"][2] for w in (out["dataset"], out["save"],
                                                    out["failover"]))
    print(f"  phase 21 took {out['s']:.3f} s; B1 wrapper launches in its windows "
          f"{out['launches']}", flush=True)
    return out


# -- phase 22: the manager daemon, the chaos harness and the recovery A/B ------------

#: the `ceph top` write window on phase 20's cluster: objects a pool
MGR_TOP_WRITES = {EC_POOL: 16, REP_POOL: 16}
#: tests/test_mgr_live.py's slack for client-side retries in `ceph top`'s count
MGR_TOP_SLACK = 5
#: a traced op slower than this is kept by the tail sampler and reaches the mgr
MGR_TAIL_SLOW_MS = 20
#: the daemon-free chaos replays (ceph_tpu_torch.sim.run_chaos at its defaults:
#: 16 OSDs, 48 PGs) and the live run (chaos_tool's cluster: 3 mons, 6 OSDs, a
#: tpu k=2 m=2 pool and a size-3 pool, objects of 64-2047 B)
CHAOS_SEEDS = (1, 7)
CHAOS_LIVE_SEED, CHAOS_LIVE_STEPS = 1, 8
#: B1's widths in the chaos pool: a 64-2047 B object is 32-1024 B a chunk
CHAOS_N4 = (1, 7, 64, 257)
#: `daemon_bench --mgr` on the card, at its defaults
MGR_BENCH_ARGV = ["--mgr", "--device", "cuda"]


async def http_get(port: int, path: str) -> tuple[int, str]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n".encode())
    raw = await asyncio.wait_for(reader.read(), 60)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body.decode()


SCRAPED_B1 = re.compile(r'^ceph_tpu_daemon_gf_matmul_packed\{daemon="kernels\.osd\.(\d+)"\} '
                        r'(\d+)$', re.M)


async def mgr_cli(v, module: str, *argv: str, stdin: bytes | None = None) -> str:
    """`python -m ceph_tpu_torch.tools.<module> --mon-host ... argv` on the
    card's cluster: its stdout (it must exit 0)."""
    here = os.path.dirname(os.path.abspath(__file__))
    hosts = ",".join(f"{h}:{p}" for h, p in v.spec.monmap().addrs)
    head = [] if module == "trace_tool" else ["--mon-host", hosts]
    if module == "ceph":
        head += ["--device", "cuda"]
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", f"ceph_tpu_torch.tools.{module}", *head, *argv, cwd=here,
        stdin=subprocess.PIPE if stdin is not None else None, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    out, err = await asyncio.wait_for(proc.communicate(stdin), 120)
    if proc.returncode != 0:
        raise AssertionError(f"{module} {' '.join(argv)} exited {proc.returncode}:\n"
                             f"{out.decode()[-2000:]}{err.decode()[-2000:]}")
    return out.decode()


def top_ops(doc: dict) -> int:
    return sum(r["totals"].get("op_w", 0) for r in doc["daemons"])


async def mgr_sequence(v, smi: str) -> dict:
    """Phase 22's manager window on phase 20's cluster: a mgr process on the
    card, every OSD's report in its Prometheus scrape (each OSD's B1 count
    equal to its perf dump), `ceph top --json` counting a write window's
    client ops, and a tail-captured traced write rendered by trace_tool from
    `ceph trace show`. Returns B1's launches in the write windows and the
    times."""
    from ceph_tpu_torch.rados.client import Rados
    from ceph_tpu_torch.tools.ceph_top import TopClient

    rados = v.client("client.mgr")
    await rados.connect()
    c = MPCluster(v, rados)
    loop = asyncio.get_running_loop()
    t = time.perf_counter()
    v.start_daemon("mgr", 0)
    port = await asyncio.to_thread(v.daemon_port, "mgr", 0, 120)
    end = loop.time() + 120
    while True:
        want = {osd: n[2] for osd, n in (await c.counts()).items()}
        t0 = time.perf_counter()
        status, text = await http_get(port, "/metrics")
        scrape_ms = (time.perf_counter() - t0) * 1e3
        got = {int(osd): int(n) for osd, n in SCRAPED_B1.findall(text)}
        if status == 200 and got == want:
            break
        if loop.time() > end:
            raise AssertionError(f"the mgr's scrape (HTTP {status}) never held every OSD's "
                                 f"B1 count: scraped {got}, perf dump {want}")
        await asyncio.sleep(0.5)
    up_s = time.perf_counter() - t
    mm = (await rados.mon_command("mgr map"))["mgrmap"]
    if mm["active"] != "mgr.0" or len(got) != MP_OSDS:
        raise AssertionError(f"mgr map {mm}; scraped OSDs {sorted(got)}")
    out = {"times": {"up_s": up_s, "scrape_ms": scrape_ms, "series": text.count("\n")}}
    print(f"  [{smi}] mgr.0 spawned by VStart (its own process on the card), active, and its "
          f"/metrics listing every OSD's report {up_s:.3f} s later (at "
          f"{time.perf_counter() - T0:.1f} s); a scrape of "
          f"{text.count(chr(10))} series in {scrape_ms:.3f} ms; each OSD's scraped "
          f"gf_matmul_packed count equals its perf dump: {dict(sorted(got.items()))}",
          flush=True)

    # `ceph top --json` over a write window
    top0 = json.loads(await mgr_cli(v, "ceph_top", "--json"))
    io = {pool: rados.io_ctx(pool) for pool in MGR_TOP_WRITES}
    keys = [(pool, 4096 + i) for pool, n in MGR_TOP_WRITES.items() for i in range(n)]
    before = await c.counts()
    t = time.perf_counter()
    await daemon_gather([lambda k=k: io[k[0]].write_full(f"m-{k[0]}-{k[1]}", mp_object(*k))
                         for k in keys], MP_CONCURRENCY)
    write_s = time.perf_counter() - t
    out["launches"] = window_counts("mgr write", c.delta(before, await c.counts()))[2]
    end = loop.time() + 60
    while True:
        doc = json.loads(await mgr_cli(v, "ceph_top", "--json"))
        ops = top_ops(doc) - top_ops(top0)
        if ops >= len(keys) or loop.time() > end:
            break
        await asyncio.sleep(1.0)
    if not len(keys) <= ops <= len(keys) + MGR_TOP_SLACK or len(doc["daemons"]) != MP_OSDS:
        raise AssertionError(f"ceph top counted {ops} writes of {len(keys)} over "
                             f"{len(doc['daemons'])} daemons")
    print(f"  [{smi}] {len(keys)} writes ({', '.join(f'{n} to pool {p}' for p, n in MGR_TOP_WRITES.items())}) "
          f"in {write_s:.3f} s; `ceph_top --json` (its own process) counts {ops} more op_w over "
          f"its {len(doc['daemons'])} daemon rows (at {time.perf_counter() - T0:.1f} s)",
          flush=True)

    # a traced write: tail-kept at completion, in the mgr's store, rendered
    for name, value in (("tracer_enabled", "true"), ("tracer_sample_rate", "0"),
                        ("tracer_tail_slow_ms", str(MGR_TAIL_SLOW_MS))):
        await rados.mon_command("config set", {"name": name, "value": value})
    cfg = v.spec.build_config()
    for name, value in (("tracer_enabled", True), ("tracer_sample_rate", 0.0),
                        ("tracer_tail_slow_ms", float(MGR_TAIL_SLOW_MS))):
        cfg.set(name, value)
    traced = Rados("client.traced", v.spec.monmap(), config=cfg, device="cuda")
    await traced.connect()
    await asyncio.sleep(2.0)  # the config map reaches every OSD
    key = (EC_POOL, 8192)
    await traced.io_ctx(EC_POOL).write_full(f"m-{key[0]}-{key[1]}", mp_object(*key))
    root = next(sp for sp in reversed(list(traced.objecter.tracer._flight))
                if getattr(sp, "name", None) == "op_submit"
                and sp.tags.get("object") == f"m-{key[0]}-{key[1]}")
    # polled in this process through the client `ceph trace ls` uses (each
    # `ceph` process opens the card); then `ceph trace show`, the CLI
    top = TopClient(v.spec.monmap(), name="client.mgr.trace")
    try:
        end = loop.time() + 60
        while True:
            ls = await top.fetch("trace ls")
            if any(tr["trace_id"] == root.trace_id for tr in ls["traces"]):
                break
            if loop.time() > end:
                raise AssertionError(f"trace {root.trace_id} ({root.duration * 1e3:.3f} ms) "
                                     f"never reached the mgr: {ls}")
            await asyncio.sleep(1.0)
    finally:
        await top.close()
    shown = await mgr_cli(v, "ceph", "trace", "show", root.trace_id)
    tree = await mgr_cli(v, "trace_tool", "-", stdin=shown.encode())
    doc = json.loads(shown)
    if f"trace {root.trace_id}" not in tree or "critical path" not in tree:
        raise AssertionError(f"trace_tool did not render the trace:\n{tree}")
    for name in ("tracer_enabled", "tracer_sample_rate", "tracer_tail_slow_ms"):
        await rados.mon_command("config rm", {"name": name})
    await traced.shutdown()
    print(f"  a traced {OBJECT_BYTES} B write of {root.duration * 1e3:.3f} ms kept by the tail "
          f"sampler: `ceph trace show` gives {doc['num_spans']} spans from "
          f"{doc['daemons']}, and trace_tool renders its tree ({len(tree.splitlines())} lines; "
          f"at {time.perf_counter() - T0:.1f} s):", flush=True)
    for line in tree.splitlines()[:40]:
        print(f"    {line}", flush=True)
    await rados.shutdown()
    return out


# -- phase 23: block images, their mirror and CephFS on this cluster -----------------

#: one thin image a client process, `rbd create --size 10G` at rbd's default
#: order 22 (4 MiB objects), in pool 1 (isa k=8 m=3)
#: a thin 2 GiB image (from 10 GiB, a cut for the 1200 s limit: the first
#: write's object-map sweep and object_map_check stat every object)
RBD_IMAGE_BYTES = 2 << 30
RBD_ORDER = 22
RBD_OBJECT = 1 << RBD_ORDER
#: `rbd bench --io-type write --io-size 4M --io-total 512M --io-threads 16`
#: over the four images: 128 MiB an image in 4 MiB writes, 4 in flight on
#: each on disjoint objects (after a first write alone: ROADMAP §C); from
#: --io-total 1G, a cut for the 1200 s limit
RBD_SPAN = 128 << 20
RBD_IN_FLIGHT = 4
#: 4 KiB writes at seeded offsets, one in each of an image's first 16 data
#: objects (half of them: a cut for the 1200 s limit): each a
#: read-modify-write of its 4 MiB object
RBD_SMALL = 4096
RBD_RMW = RBD_SPAN // RBD_OBJECT // 2
#: image 0's 4 KiB overwrites after its snapshot
RBD_SNAP_WRITES = 16
#: the copy-up write into image 0's clone: 4 KiB inside its object 5
RBD_CLONE_OFF = 5 * RBD_OBJECT + 12345
#: the journaled image in pool 1 replayed into pool 2: its size, its seeded
#: writes of 4 KiB-4 MiB, the size it is cut to
MIRROR_BYTES, MIRROR_WRITES, MIRROR_RESIZE = 64 << 20, 16, 48 << 20
#: CephFS on pool 2 (directories are omap objects: an EC pool refuses them,
#: in both packages): directories (8, from 16: a cut for the 1200 s
#: limit), files in each, two mds processes; directories filled (and files
#: read back) at a time
FS_DIRS, FS_FILES, FS_MDS, FS_IN_FLIGHT = 8, 4, 2, 4


def rbd_patches(worker: int) -> list[tuple[int, bytes]]:
    """Image `worker`'s 4 KiB read-modify-writes: one at a seeded offset in
    each of its first RBD_RMW data objects, in a seeded order."""
    rng = np.random.default_rng([SEED + 23, worker, 1])
    return [(int(o) * RBD_OBJECT + int(rng.integers(0, RBD_OBJECT - RBD_SMALL + 1)),
             rng.bytes(RBD_SMALL)) for o in rng.permutation(RBD_RMW)]


def rbd_snap_patches() -> list[tuple[int, bytes]]:
    """Image 0's 4 KiB overwrites after its snapshot, at seeded offsets."""
    rng = np.random.default_rng([SEED + 23, 0, 2])
    return [(int(rng.integers(0, RBD_SPAN - RBD_SMALL + 1)), rng.bytes(RBD_SMALL))
            for _ in range(RBD_SNAP_WRITES)]


def rbd_clone_patch() -> bytes:
    return np.random.default_rng([SEED + 23, 0, 3]).bytes(RBD_SMALL)


def rbd_image_bytes(worker: int, after_snap: bool = True) -> bytearray:
    """The written span of image `worker` as its client holds it: the seeded
    4 MiB writes, then the read-modify-writes, then (image 0, `after_snap`)
    the overwrites after the snapshot."""
    buf = bytearray(np.random.default_rng([SEED + 23, worker]).bytes(RBD_SPAN))
    patches = rbd_patches(worker) + (rbd_snap_patches() if worker == 0 and after_snap else [])
    for off, data in patches:
        buf[off:off + len(data)] = data
    return buf


def rbd_clone_object() -> bytes:
    """The clone's one object after its copy-up write: image 0's object at
    the snapshot with the 4 KiB patch."""
    lo = RBD_CLONE_OFF - RBD_CLONE_OFF % RBD_OBJECT
    obj = rbd_image_bytes(0, after_snap=False)[lo:lo + RBD_OBJECT]
    at = RBD_CLONE_OFF - lo
    obj[at:at + RBD_SMALL] = rbd_clone_patch()
    return bytes(obj)


def rbd_image_heads(worker: int) -> dict:
    """{rbd_data head object name: bytes} of image `worker`'s data objects
    (and, for image 0, its clone's), as they end the window."""
    buf = rbd_image_bytes(worker)
    out = {f"rbd_data.img{worker}.{o:016x}": bytes(buf[o * RBD_OBJECT:(o + 1) * RBD_OBJECT])
           for o in range(RBD_SPAN // RBD_OBJECT)}
    if worker == 0:
        out[f"rbd_data.img0-clone.{RBD_CLONE_OFF // RBD_OBJECT:016x}"] = rbd_clone_object()
    return out


def rbd_heads() -> dict:
    return {name: data for w in range(MP_CLIENTS) for name, data in rbd_image_heads(w).items()}


def mp_ec_names() -> list[str]:
    """Phase 20's pool-1 objects: its writes, then those made with the
    victims down."""
    return [f"m-{EC_POOL}-{i}" for i in range(MP_OBJECTS[EC_POOL] + MP_CRASH_WRITES)]


def parity_heads(what) -> dict:
    """{object name: bytes} of one share of the offline check: "mp" is
    phase 20's pool-1 objects, an int w image w's head objects (and, for
    image 0, the clone's object), ("rgw", w) phase 24's client w's objects
    and parts (`rgw_heads`). All are known from the seed."""
    if what == "mp":
        return {name: mp_object(*map(int, name.split("-")[1:])) for name in mp_ec_names()}
    if isinstance(what, tuple):
        return rgw_heads(what[1])
    return rbd_image_heads(what)


def _cpu_parity(whats):
    """Worker: the CPU isa codec's parity chunks, for the offline check, of
    `parity_heads(what)` for each of `whats`, on one thread."""
    from ceph_tpu_torch.ec.registry import factory

    torch.set_num_threads(1)
    cpu = factory("isa", {k: v for k, v in DAEMON_EC_PROFILE.items() if k != "plugin"},
                  device="cpu")
    out = {}
    for what in whats:
        heads = parity_heads(what)
        for size in sorted({len(obj) for obj in heads.values()}):
            names = [name for name, obj in heads.items() if len(obj) == size]
            for lo in range(0, len(names), 16):
                data = torch.from_numpy(np.frombuffer(
                    b"".join(heads[n] for n in names[lo:lo + 16]), np.uint8)
                    .reshape(-1, K, size // K).copy())
                parity = cpu.encode_array(data).numpy()
                for j, name in enumerate(names[lo:lo + 16]):
                    out[name] = [parity[j, i].tobytes() for i in range(M)]
    return out


#: the offline check's CPU parity runs in this many single-threaded worker
#: processes beside phases 18-19 (one event loop and the card), so that it
#: takes no wall time of its own
PARITY_WORKERS = 5


def offline_parity() -> dict:
    """The CPU isa codec's parity of every object phases 20, 23 and 24 write
    to pool 1 in 4 MiB or larger pieces, made in PARITY_WORKERS processes;
    returns it with the seconds it took."""
    t = time.perf_counter()
    whats = ["mp", *range(MP_CLIENTS), *(("rgw", w) for w in range(RGW_CLIENTS))]
    parity = {}
    for part in in_workers("_cpu_parity", [whats[i::PARITY_WORKERS]
                                           for i in range(PARITY_WORKERS)]):
        parity.update(part)
    return {"parity": parity, "s": time.perf_counter() - t}


def rbd_marker(spec_path: str, tag: str) -> str:
    """A marker file of phase 23's client processes, in the run dir."""
    return os.path.join(os.path.dirname(spec_path), f"rbd-{tag}")


def wait_markers(paths: list[str], timeout: float = 600.0) -> None:
    end = time.time() + timeout
    while not all(os.path.exists(p) for p in paths):
        if time.time() > end:
            raise AssertionError(f"timed out waiting for {paths}")
        time.sleep(0.05)


def _rbd_client(job):
    """Worker: one client process of phase 23 on the card, through steps 1-4.
    It creates its image, opens it exclusive, writes the span in 4 MiB I/Os
    (the first alone, then RBD_IN_FLIGHT at a time) and the read-modify-
    writes; client 0 then takes image 0's snapshot, overwrites, diff, clone
    and copy-up. Once every client has written, each reads its image back
    (the span in 4 MiB reads and a hole past it, each equal to what it holds)
    and runs `object_map_check`; then, when the parent has killed an OSD,
    reads it back again, degraded."""
    from ceph_tpu_torch.vstart import ClusterSpec

    spec_path, worker = job
    spec = ClusterSpec.load(spec_path)
    name = f"img{worker}"

    async def run():
        from ceph_tpu_torch.rados.client import Rados
        from ceph_tpu_torch.rbd import Image

        rados = Rados(f"client.rbd{worker}", spec.monmap(), config=spec.build_config(),
                      device="cuda")
        await rados.connect()
        io = rados.io_ctx(EC_POOL)
        buf = bytes(np.random.default_rng([SEED + 23, worker]).bytes(RBD_SPAN))
        await Image.create(io, name, RBD_IMAGE_BYTES, order=RBD_ORDER)
        img = await Image.open(io, name, exclusive=True)
        t0 = time.time()
        await img.write(0, buf[:RBD_OBJECT])
        first = time.time()
        seconds = await daemon_gather(
            [lambda off=off: img.write(off, buf[off:off + RBD_OBJECT])
             for off in range(RBD_OBJECT, RBD_SPAN, RBD_OBJECT)], RBD_IN_FLIGHT)
        t1 = time.time()
        rmw = await daemon_gather([lambda p=p: img.write(*p) for p in rbd_patches(worker)],
                                  RBD_IN_FLIGHT)
        out = {"write": (t0, t1), "first_s": first - t0, "seconds": seconds,
               "rmw": (t1, time.time()), "rmw_seconds": rmw}
        del buf
        if worker == 0:
            out["snap"] = await rbd_snapshot_step(io, img)
        await img.close()
        want = rbd_image_bytes(worker)
        img = await Image.open(io, name)

        async def read_back(key):
            async def one(off):
                if await img.read(off, RBD_OBJECT) != want[off:off + RBD_OBJECT]:
                    raise AssertionError(f"{name} [{off}, +4 MiB) read back other bytes")

            t = time.time()
            await daemon_gather([lambda off=off: one(off)
                                 for off in range(0, RBD_SPAN, RBD_OBJECT)], RBD_IN_FLIGHT)
            out[key] = (t, time.time())
            if await img.read(RBD_IMAGE_BYTES - RBD_OBJECT, RBD_OBJECT) != bytes(RBD_OBJECT):
                raise AssertionError(f"{name}'s last 4 MiB, never written, is not a hole")

        open(rbd_marker(spec_path, f"written.{worker}"), "w").close()
        await asyncio.to_thread(wait_markers, [rbd_marker(spec_path, f"written.{w}")
                                               for w in range(MP_CLIENTS)])
        await read_back("read")
        t = time.perf_counter()
        bad = await img.object_map_check()
        out["check_s"] = time.perf_counter() - t
        if bad:
            raise AssertionError(f"{name}: object_map_check found {bad[:8]}")
        open(rbd_marker(spec_path, f"read.{worker}"), "w").close()
        await asyncio.to_thread(wait_markers, [rbd_marker(spec_path, "degraded")])
        await read_back("degraded")
        await rados.shutdown()
        return out

    return asyncio.run(asyncio.wait_for(run(), 900))


async def rbd_snapshot_step(io, img) -> dict:
    """Step 2, on image 0: a snapshot, 4 KiB overwrites, each read at the
    snapshot, `diff` against the objects written, protect, a clone and a
    copy-up write into it, read back."""
    from ceph_tpu_torch.rbd import Image

    t = time.perf_counter()
    await img.snap_create("s0")
    patches = rbd_snap_patches()
    for off, data in patches:
        await img.write(off, data)
    base = rbd_image_bytes(0, after_snap=False)
    for off, _ in patches:
        if await img.read(off, RBD_SMALL, snap_name="s0") != base[off:off + RBD_SMALL]:
            raise AssertionError(f"img0@s0 [{off}, +4 KiB) is not the bytes before the snapshot")
    touched = sorted({o for off, _ in patches
                      for o in (off // RBD_OBJECT, (off + RBD_SMALL - 1) // RBD_OBJECT)})
    diff = await img.diff("s0")
    if diff != touched:
        raise AssertionError(f"diff s0 {diff}, objects written since {touched}")
    await img.snap_protect("s0")
    child = await Image.clone(io, "img0", "s0", io, "img0-clone")
    await child.write(RBD_CLONE_OFF, rbd_clone_patch())
    lo = RBD_CLONE_OFF - RBD_CLONE_OFF % RBD_OBJECT
    if (await child.read(lo, RBD_OBJECT) != rbd_clone_object()
            or await child.read(0, RBD_OBJECT) != base[:RBD_OBJECT]):
        raise AssertionError("the clone reads other bytes than its parent's snapshot and patch")
    return {"diff": diff, "s": time.perf_counter() - t}


def span_of(results: list, key: str) -> float:
    return max(r[key][1] for r in results) - min(r[key][0] for r in results)


async def fs_map(rados) -> dict:
    """The committed FSMap: {"active": name or None, "standbys": [names]}."""
    fm = (await rados.mon_command("fs map"))["fsmap"]
    return {"active": (fm.get("active") or {}).get("name"),
            "standbys": [s["name"] for s in fm.get("standbys", [])]}


async def wait_fs_map(rados, pred, what: str, timeout: float = 120.0) -> dict:
    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while True:
        fm = await fs_map(rados)
        if pred(fm):
            return fm
        if loop.time() > end:
            raise AssertionError(f"{what}: fs map {fm}")
        await asyncio.sleep(0.1)


async def rbd_window(v, c, rados, smi: str) -> dict:
    """Steps 1-4 through MP_CLIENTS client processes (`_rbd_client`): the
    images' writes, image 0's snapshot and clone, the full read-back with the
    object maps checked, and, with an OSD process SIGKILLed, the degraded
    read-back; B1 counted in the OSD processes per window."""
    out = {"launches": {}, "times": {}}
    nbytes = MP_CLIENTS * RBD_SPAN
    loop = asyncio.get_running_loop()

    async def markers(tag: str) -> None:
        paths = [rbd_marker(v.spec_path, f"{tag}.{w}") for w in range(MP_CLIENTS)]
        end = loop.time() + 900
        while not all(os.path.exists(p) for p in paths):
            if clients.done():
                await clients  # a client process failed: raise its error
                raise AssertionError(f"the clients ended before {tag}")
            if loop.time() > end:
                raise AssertionError(f"the clients never reached {tag}")
            await asyncio.sleep(0.1)

    before = await c.counts()
    clients = asyncio.ensure_future(asyncio.to_thread(
        in_workers, "_rbd_client", [(v.spec_path, w) for w in range(MP_CLIENTS)]))
    await markers("read")
    out["launches"]["write"] = window_counts("rbd write", c.delta(before, await c.counts()))

    victim = MP_VICTIMS[0]
    before = await c.counts()
    v.kill_osd(victim)
    before.pop(victim)
    await mp_mon_command(rados, "osd down", {"osd": victim}, [])
    repeer_s = await c.wait_pgs(False, 600, "every PG active after the kill")
    open(rbd_marker(v.spec_path, "degraded"), "w").close()
    res = await clients
    out["launches"]["degraded read"] = window_counts("rbd degraded read",
                                                     c.delta(before, await c.counts()))
    w_s, rmw_s, read_s, deg_s = (span_of(res, k) for k in ("write", "rmw", "read", "degraded"))
    lat = [s for r in res for s in r["seconds"]]
    rmw = [s for r in res for s in r["rmw_seconds"]]
    snap = res[0]["snap"]
    out["times"].update(write_gbps=nbytes / w_s / 1e9, write_s=w_s,
                        rmw_ms=float(np.mean(rmw)) * 1e3,
                        first_write_s=float(np.mean([r["first_s"] for r in res])),
                        snap_s=snap["s"], read_gbps=nbytes / read_s / 1e9,
                        check_s=max(r["check_s"] for r in res),
                        degraded_read_gbps=nbytes / deg_s / 1e9)
    print(f"  [{smi}] {MP_CLIENTS} client processes, each a thin {RBD_IMAGE_BYTES >> 30} GiB "
          f"image of order {RBD_ORDER} in pool {EC_POOL} opened exclusive: {nbytes >> 20} MiB in "
          f"{RBD_OBJECT >> 20} MiB writes ({RBD_IN_FLIGHT} in flight an image) in {w_s:.3f} s, "
          f"{out['times']['write_gbps']:.4f} GB/s (each image's first write alone, with the "
          f"object map's stat sweep: mean {out['times']['first_write_s']:.3f} s), mean write "
          f"{np.mean(lat) * 1e3:.3f} ms; {len(rmw)} 4 KiB read-modify-writes in {rmw_s:.3f} s, "
          f"{out['times']['rmw_ms']:.3f} ms each (p50 {np.percentile(rmw, 50) * 1e3:.3f}, max "
          f"{max(rmw) * 1e3:.3f})", flush=True)
    print(f"  img0: snapshot, {RBD_SNAP_WRITES} 4 KiB overwrites, each read at the snapshot "
          f"equal to the bytes before it, diff {snap['diff']} equal to the objects written; "
          f"protected, cloned, a 4 KiB copy-up write into the clone, which reads its parent's "
          f"snapshot and the patch ({snap['s']:.3f} s)", flush=True)
    print(f"  [{smi}] read-back of the {MP_CLIENTS} images' {nbytes >> 20} MiB and a hole each "
          f"({RBD_IN_FLIGHT} reads in flight an image): {read_s:.3f} s, "
          f"{out['times']['read_gbps']:.4f} GB/s, every read exact; object_map_check empty on "
          f"each ({out['times']['check_s']:.3f} s, a stat of each of the "
          f"{RBD_IMAGE_BYTES // RBD_OBJECT} objects)", flush=True)
    t = time.perf_counter()
    v.start_osd(victim)
    await v.wait_healthy(rados=rados, timeout=300)
    clean_s = time.perf_counter() - t + await c.wait_pgs(True, MP_RECOVERY_S, "every PG clean")
    print(f"  [{smi}] OSD process {victim} SIGKILLed and marked down, every PG active again in "
          f"{repeer_s:.3f} s; degraded read-back of the images: {deg_s:.3f} s, "
          f"{out['times']['degraded_read_gbps']:.4f} GB/s, every read exact; restarted, every "
          f"PG clean {clean_s:.3f} s later", flush=True)
    return out


async def mirror_window(rados, smi: str) -> dict:
    """Step 5: a journaled image in pool 1 replayed into pool 2 by
    ImageReplayer.run_once until it has caught up."""
    from ceph_tpu_torch.journal import ImageReplayer, MirroredImage
    from ceph_tpu_torch.rbd import Image

    src, dst = rados.io_ctx(EC_POOL), rados.io_ctx(REP_POOL)
    t = time.perf_counter()
    img = await MirroredImage.create(src, "mirror0", MIRROR_BYTES, order=RBD_ORDER)
    replayer = ImageReplayer(src, dst, "mirror0")
    want = bytearray(MIRROR_BYTES)
    rng = np.random.default_rng([SEED + 23, 5])
    applied, written = [], 0
    #: objectno -> the source object's length (a write past its end extends
    #: it; a whole-object write makes it 4 MiB)
    lengths: dict[int, int] = {}
    for i in range(MIRROR_WRITES):
        n = RBD_SMALL << int(rng.integers(0, 11))
        off = int(rng.integers(0, MIRROR_BYTES - n + 1))
        data = rng.bytes(n)
        await img.write(off, data)
        want[off:off + n] = data
        written += n
        for o in range(off // RBD_OBJECT, (off + n - 1) // RBD_OBJECT + 1):
            end = min(off + n, (o + 1) * RBD_OBJECT) - o * RBD_OBJECT
            lengths[o] = max(lengths.get(o, 0), end)
        if i == MIRROR_WRITES // 2 - 1:
            applied.append(await replayer.run_once())
    await img.resize(MIRROR_RESIZE)
    del want[MIRROR_RESIZE:]
    applied += [await replayer.run_once(), await replayer.run_once()]
    replica = await Image.open(dst, "mirror0")
    page = await img.journal.read()
    if (applied[2] != 0 or sum(applied) != MIRROR_WRITES + 2 or replica.size != MIRROR_RESIZE
            or await replica.read(0, MIRROR_RESIZE) != want
            or await img.read(0, MIRROR_RESIZE) != want
            or page["entries"] or page["commit"] != page["head"]):
        raise AssertionError(f"the mirror did not converge: applied {applied}, replica size "
                             f"{replica.size}, journal head {page['head']} commit "
                             f"{page['commit']}, {len(page['entries'])} entries left")
    mirror_s = time.perf_counter() - t
    print(f"  [{smi}] mirror0 ({MIRROR_BYTES >> 20} MiB, pool {EC_POOL}, journaled): "
          f"{MIRROR_WRITES} writes of 4 KiB-4 MiB ({written} B) and a resize to "
          f"{MIRROR_RESIZE >> 20} MiB replayed into pool {REP_POOL} in rounds of {applied} "
          f"events; the replica reads equal to the source, the journal trimmed to its head "
          f"{page['head']} ({mirror_s:.3f} s)", flush=True)
    heads = {f"rbd_data.mirror0.{o:016x}": bytes(want[o * RBD_OBJECT:o * RBD_OBJECT + n])
             for o, n in lengths.items() if o < MIRROR_RESIZE // RBD_OBJECT}
    return {"mirror_s": mirror_s}, heads


async def cephfs_window(v, rados, smi: str) -> dict:
    """Step 6: CephFS through the mds processes on pool 2; the active
    SIGKILLed, the standby takes the rank and replays the journal."""
    import itertools

    from ceph_tpu_torch.cephfs import CephFSClient, CephFSError

    fm = await wait_fs_map(rados, lambda m: m["active"] and len(m["standbys"]) == FS_MDS - 1,
                           "the mds processes never took the rank and a standby")
    fs = CephFSClient(rados, REP_POOL)
    await fs.mount()
    await fs.mkfs()
    rng = np.random.default_rng([SEED + 23, 6])
    files = {f"/d{d:02d}/f{f}": rng.bytes((64 << 10) << int(rng.integers(0, 7)))
             for d in range(FS_DIRS) for f in range(FS_FILES)}

    async def fill(d: int) -> None:
        await fs.mkdir(f"/d{d:02d}")
        for f in range(FS_FILES):
            await fs.write_file(f"/d{d:02d}/f{f}", files[f"/d{d:02d}/f{f}"])

    t = time.perf_counter()
    await daemon_gather([lambda d=d: fill(d) for d in range(FS_DIRS)], FS_IN_FLIGHT)
    write_s = time.perf_counter() - t
    tid = next(fs._tids)
    fs._tids = itertools.chain([tid], fs._tids)
    ino = await fs.mkdir("/last")
    active = fm["active"]
    standby = fm["standbys"][0]
    t = time.perf_counter()
    proc = v.extra.pop(("mds", int(active.split(".")[1])))
    proc.kill()
    proc.wait(timeout=30)
    await wait_fs_map(rados, lambda m: m["active"] == standby, "the standby never took the rank")
    rank_s = time.perf_counter() - t
    fs._tids = itertools.chain([tid], fs._tids)
    resent = await fs.mkdir("/last")
    failover_s = time.perf_counter() - t
    if resent != ino:
        raise AssertionError(f"the resent mkdir answered ino {resent}, the first {ino}")
    try:
        await fs.mkdir("/last")
        raise AssertionError("a new mkdir of /last was not refused")
    except CephFSError as e:
        if e.code != "EEXIST":
            raise
    for d in range(FS_DIRS):
        names = set(await fs.listdir(f"/d{d:02d}"))
        if names != {f"f{f}" for f in range(FS_FILES)}:
            raise AssertionError(f"/d{d:02d} lists {sorted(names)}")
    async def check(path: str) -> None:
        if await fs.read_file(path) != files[path]:
            raise AssertionError(f"{path} read back other bytes")

    await daemon_gather([lambda p=p: check(p) for p in files], FS_IN_FLIGHT)
    nbytes = sum(map(len, files.values()))
    print(f"  [{smi}] CephFS on pool {REP_POOL} through {FS_MDS} mds processes ({active} "
          f"active): {FS_DIRS} directories of {FS_FILES} files, {nbytes} B, in {write_s:.3f} s "
          f"({FS_IN_FLIGHT} directories at a time); "
          f"{active} SIGKILLed: {standby} holds the rank in the fs map {rank_s:.3f} s later, "
          f"and the resent mkdir is answered from its journal replay (ino {resent}, not run "
          f"again) {failover_s:.3f} s after the kill; every listing and file reads back equal",
          flush=True)
    return {"fs_write_s": write_s, "failover_rank_s": rank_s, "failover_s": failover_s}


async def rbd_sequence(v, smi: str) -> dict:
    """Phase 23 on phase 20's running cluster: block images, their mirror and
    CephFS. Returns B1's launches in the image windows and the times."""
    t0 = time.perf_counter()
    v.spec.extras["mds_data_pool"] = REP_POOL
    v.spec.extras.update(RGW_EXTRAS)
    v.spec.save(v.spec_path)
    # the mds processes, and phase 24's gateway, boot while the images are
    # written
    for i in range(FS_MDS):
        v.start_daemon("mds", i)
    v.start_daemon("rgw", 0)
    rados = v.client("client.rbdadmin")
    await rados.connect()
    c = MPCluster(v, rados)
    try:
        out = await rbd_window(v, c, rados, smi)
        times, out["mirror_heads"] = await mirror_window(rados, smi)
        out["times"].update(times)
        out["times"].update(await cephfs_window(v, rados, smi))
    finally:
        await rados.shutdown()
    out["s"] = time.perf_counter() - t0
    out["launches_total"] = sum(w[2] for w in out["launches"].values())
    widths = {w: round(n[1] / n[0], 3) for w, n in out["launches"].items()}
    print(f"  [{smi}] phase 23 took {out['s']:.3f} s; B1 wrapper launches in the OSD processes: "
          f"{ {w: n[2] for w, n in out['launches'].items()} }, EncodeService objects a launch "
          f"{widths}", flush=True)
    return out


# -- phase 24: the object gateway (S3) ------------------------------------------------

#: MinIO warp's `put` defaults (--obj.size 10MiB --concurrent 20): 4 client
#: processes of 5 requests in flight; a count of objects a client instead of
#: warp's 5-minute duration (8 a client, from 16: a cut for the 1200 s limit)
RGW_CLIENTS = 4
RGW_IN_FLIGHT = 5
RGW_OBJECT = 10 << 20
RGW_OBJECTS = 8
#: one multipart upload a client, in the AWS CLI's default 8 MiB parts (its
#: multipart_threshold and multipart_chunksize)
RGW_MULTIPART = 64 << 20
RGW_PART = 8 << 20
#: the listing's page (max-keys), and the versioned key's two bodies' size
RGW_PAGE = 5
RGW_VERSION_BYTES = 4096
RGW_AK, RGW_SK, RGW_REGION = "AKSMOKE0000000000000", "smoke/secret/key/0000000000000", "us-east-1"
#: the gateway's spec extras: data in the EC pool, the bucket index (omap,
#: which an EC pool cannot hold) in the replicated one, one S3 user
RGW_EXTRAS = {"rgw_data_pool": EC_POOL, "rgw_index_pool": REP_POOL,
              "rgw_users": {RGW_AK: RGW_SK}}


def rgw_object(worker: int, i: int) -> bytes:
    """Client `worker`'s object i (i = RGW_OBJECTS: its multipart body; above:
    its versioned key's bodies), from the seed."""
    size = (RGW_OBJECT if i < RGW_OBJECTS else RGW_MULTIPART if i == RGW_OBJECTS
            else RGW_VERSION_BYTES)
    return np.random.default_rng([SEED + 24, worker, i]).bytes(size)


def rgw_heads(worker: int) -> dict:
    """Client `worker`'s 10 MiB objects under their data object names, and
    its parts under `<bucket>/big#<n>` (the upload id is the gateway's)."""
    out = {f"smoke{worker}/obj/{i:04d}": rgw_object(worker, i) for i in range(RGW_OBJECTS)}
    body = rgw_object(worker, RGW_OBJECTS)
    for n in range(RGW_MULTIPART // RGW_PART):
        out[f"smoke{worker}/big#{n + 1}"] = body[n * RGW_PART:(n + 1) * RGW_PART]
    return out


def rgw_stored(uploads: list, vids: list, parity: dict) -> dict:
    """Every object phase 24 left in pool 1, by the gateway's layout, with its
    bytes: data objects, parts (their parity in `parity` renamed to the part
    objects' names), each upload's manifest and the versioned key's bodies."""
    out = {}
    n_parts = RGW_MULTIPART // RGW_PART
    for w, upload in enumerate(uploads):
        for name, data in rgw_heads(w).items():
            if "#" in name:
                part = f"smoke{w}/big.__mp_{upload}.{int(name.split('#')[1]):05d}"
                parity[part] = parity.pop(name)
                name = part
            out[name] = data
        out[f"smoke{w}/big"] = json.dumps({"__manifest__": {
            "multipart": upload, "parts": list(range(1, n_parts + 1)),
            "sizes": [RGW_PART] * n_parts}}).encode()
        for n, vid in enumerate(vids[w]):
            out[f"vsmoke{w}/doc.__v_{vid}"] = rgw_object(w, RGW_OBJECTS + 1 + n)
    return out


class S3Client:
    """An S3 client written from the AWS specification, independent of the
    gateway's code: Signature Version 4 in the header flavour, the payload's
    SHA-256 signed, over one HTTP/1.1 keep-alive connection."""

    def __init__(self, port: int):
        self.port, self.host = port, f"127.0.0.1:{port}"
        self.conn = None

    def signed_headers(self, method: str, path: str, query: dict, payload: bytes) -> dict:
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        digest = hashlib.sha256(payload).hexdigest()
        headers = {"host": self.host, "x-amz-content-sha256": digest, "x-amz-date": amz_date}
        names = sorted(headers)
        quote = functools.partial(urllib.parse.quote, safe="-_.~")
        creq = "\n".join([method, urllib.parse.quote(path, safe="/-_.~"),
                          "&".join(f"{quote(k)}={quote(v)}" for k, v in sorted(query.items())),
                          "".join(f"{h}:{headers[h]}\n" for h in names), ";".join(names), digest])
        scope = f"{amz_date[:8]}/{RGW_REGION}/s3/aws4_request"
        sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                         hashlib.sha256(creq.encode()).hexdigest()])
        key = ("AWS4" + RGW_SK).encode()
        for part in (amz_date[:8], RGW_REGION, "s3", "aws4_request"):
            key = hmac.new(key, part.encode(), hashlib.sha256).digest()
        headers["authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={RGW_AK}/{scope}, SignedHeaders={';'.join(names)}, "
            f"Signature={hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()}")
        return headers

    async def request(self, method: str, path: str, query: dict | None = None,
                      payload: bytes = b"", want: int = 200) -> tuple[dict, bytes]:
        """Sends one request; raises unless the status is `want`. Returns the
        response's headers and body."""
        query = dict(query or {})
        headers = self.signed_headers(method, path, query, payload)
        headers["content-length"] = str(len(payload))
        if self.conn is None:
            self.conn = await asyncio.open_connection("127.0.0.1", self.port)
        reader, writer = self.conn
        qs = urllib.parse.urlencode(query)
        lines = [f"{method} {urllib.parse.quote(path, safe='/-_.~')}{'?' + qs if qs else ''} "
                 "HTTP/1.1"] + [f"{k}: {v}" for k, v in headers.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
        writer.write(payload)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        rhdrs = {}
        while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
            name, _, value = line.decode().partition(":")
            rhdrs[name.strip().lower()] = value.strip()
        n = int(rhdrs.get("content-length", "0") or "0")
        body = await reader.readexactly(n) if n and method != "HEAD" else b""
        if status != want:
            raise AssertionError(f"{method} {path} {query}: HTTP {status}, not {want}: "
                                 f"{body[:300]!r}")
        return rhdrs, body

    async def close(self) -> None:
        if self.conn is not None:
            self.conn[1].close()
            await self.conn[1].wait_closed()


def xml_texts(body: bytes, tag: str) -> list[str]:
    from xml.etree import ElementTree

    return [e.text or "" for e in ElementTree.fromstring(body).iter(tag)]


def _rgw_client(job):
    """Worker: one S3 client process of phase 24, RGW_IN_FLIGHT connections to
    the gateway. It creates its bucket, PUTs its objects, uploads and
    completes its multipart object, GETs everything back (bytes and ETag
    exact), pages through the listing, and puts one key twice in a versioned
    bucket and lists the versions. Returns its windows and the requests'
    seconds."""
    from ceph_tpu_torch.common.crc import ceph_crc32c

    port, worker = job
    bucket = f"smoke{worker}"

    def etag(data: bytes) -> str:
        return f'"{ceph_crc32c(0xFFFFFFFF, data):08x}"'

    async def run():
        lanes = [S3Client(port) for _ in range(RGW_IN_FLIGHT)]
        free = asyncio.Queue()
        for lane in lanes:
            free.put_nowait(lane)

        async def call(*args, **kw):
            lane = await free.get()
            try:
                return await lane.request(*args, **kw)
            finally:
                free.put_nowait(lane)

        async def put(path, data, query=None):
            hdrs, _ = await call("PUT", path, query, data)
            if hdrs.get("etag") != etag(data):
                raise AssertionError(f"PUT {path}: ETag {hdrs.get('etag')}, not {etag(data)}")
            return hdrs

        out = {}
        await call("PUT", f"/{bucket}")
        objs = {f"obj/{i:04d}": rgw_object(worker, i) for i in range(RGW_OBJECTS)}
        t0 = time.time()
        out["put_seconds"] = await daemon_gather(
            [lambda k=k: put(f"/{bucket}/{k}", objs[k]) for k in objs], RGW_IN_FLIGHT)
        out["put"] = (t0, time.time())

        body = rgw_object(worker, RGW_OBJECTS)
        parts = [body[n:n + RGW_PART] for n in range(0, RGW_MULTIPART, RGW_PART)]
        t0 = time.time()
        _, xml = await call("POST", f"/{bucket}/big", {"uploads": ""})
        upload = xml_texts(xml, "UploadId")[0]
        await daemon_gather([lambda n=n: put(f"/{bucket}/big", parts[n - 1], {
            "partNumber": str(n), "uploadId": upload}) for n in range(1, len(parts) + 1)],
            RGW_IN_FLIGHT)
        t1 = time.time()
        done = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{etag(p)}</ETag></Part>"
            for n, p in enumerate(parts, start=1)) + "</CompleteMultipartUpload>").encode()
        _, xml = await call("POST", f"/{bucket}/big", {"uploadId": upload}, done)
        out["multipart"] = (t0, t1, time.time())
        whole = (f'"{ceph_crc32c(0xFFFFFFFF, "".join(etag(p)[1:-1] for p in parts).encode()):08x}'
                 f'-{len(parts)}"')
        if xml_texts(xml, "ETag") != [whole]:
            raise AssertionError(f"the multipart ETag {xml_texts(xml, 'ETag')}, not {whole}")
        out["upload"] = upload

        async def get(key, data, tag):
            hdrs, got = await call("GET", f"/{bucket}/{key}")
            if got != data or hdrs.get("etag") != tag:
                raise AssertionError(f"GET {bucket}/{key}: other bytes or ETag {hdrs.get('etag')}")

        t0 = time.time()
        out["get_seconds"] = await daemon_gather(
            [lambda k=k: get(k, objs[k], etag(objs[k])) for k in objs]
            + [lambda: get("big", body, whole)], RGW_IN_FLIGHT)
        out["get"] = (t0, time.time())

        # the bucket's listing, RGW_PAGE keys a page: the gateway serves
        # ListObjects (version 1) paging, the marker being the page's last key
        t0, keys, pages, marker = time.time(), [], 0, ""
        while True:
            _, xml = await call("GET", f"/{bucket}", {"max-keys": str(RGW_PAGE),
                                                      "marker": marker})
            page, sizes = xml_texts(xml, "Key"), list(map(int, xml_texts(xml, "Size")))
            keys += page
            pages += 1
            if sizes != [len(objs.get(k, body)) for k in page]:
                raise AssertionError(f"listing page {pages}: sizes {sizes}")
            if xml_texts(xml, "IsTruncated") != ["true"]:
                break
            marker = page[-1]
        if keys != sorted([*objs, "big"]):
            raise AssertionError(f"the listing's keys {keys}")
        out["list"] = (t0, time.time(), pages)

        vbucket, docs = f"v{bucket}", [rgw_object(worker, RGW_OBJECTS + 1 + n) for n in range(2)]
        await call("PUT", f"/{vbucket}")
        await call("PUT", f"/{vbucket}", {"versioning": ""},
                   b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>")
        vids = [(await put(f"/{vbucket}/doc", d))["x-amz-version-id"] for d in docs]
        _, xml = await call("GET", f"/{vbucket}", {"versions": ""})
        if (xml_texts(xml, "VersionId") != vids[::-1]
                or xml_texts(xml, "Size") != [str(RGW_VERSION_BYTES)] * 2):
            raise AssertionError(f"the versions listing {xml[:500]!r}, not {vids[::-1]}")
        for query, data in (({}, docs[1]), ({"versionId": vids[0]}, docs[0])):
            _, got = await call("GET", f"/{vbucket}/doc", query)
            if got != data:
                raise AssertionError(f"GET {vbucket}/doc {query}: other bytes")
        out["vids"] = vids
        for lane in lanes:
            await lane.close()
        return out

    return asyncio.run(asyncio.wait_for(run(), 600))


async def rgw_sequence(v, smi: str) -> dict:
    """Phase 24 on phase 20's running cluster: the rgw process phase 23
    spawned (RGW_EXTRAS: data in pool 1, the bucket index in pool 2) and
    RGW_CLIENTS S3 client processes; B1 counted in the OSD processes over the
    window. Returns the launches, the upload ids and version ids (for the
    offline check) and the times."""
    t0 = time.perf_counter()
    port = await asyncio.to_thread(v.daemon_port, "rgw", 0, 120)
    boot_s = time.perf_counter() - t0
    rados = v.client("client.rgwadmin")
    await rados.connect()
    c = MPCluster(v, rados)
    try:
        before = await c.counts()
        t = time.perf_counter()
        res = await asyncio.to_thread(in_workers, "_rgw_client",
                                      [(port, w) for w in range(RGW_CLIENTS)])
        wall = time.perf_counter() - t
        counts = window_counts("rgw", c.delta(before, await c.counts()))
    finally:
        await rados.shutdown()
    n_parts = RGW_MULTIPART // RGW_PART
    written = RGW_CLIENTS * (RGW_OBJECTS + n_parts + 1 + 2)
    put_s, get_s = span_of(res, "put"), span_of(res, "get")
    put_bytes = RGW_CLIENTS * RGW_OBJECTS * RGW_OBJECT
    get_bytes = put_bytes + RGW_CLIENTS * RGW_MULTIPART
    lat = np.array([s for r in res for s in r["put_seconds"]]) * 1e3
    mp_s = max(r["multipart"][2] for r in res) - min(r["multipart"][0] for r in res)
    complete_ms = np.array([r["multipart"][2] - r["multipart"][1] for r in res]) * 1e3
    times = {"boot_s": boot_s, "put_gbps": put_bytes / put_s / 1e9, "put_s": put_s,
             "put_p50_ms": float(np.percentile(lat, 50)),
             "put_p99_ms": float(np.percentile(lat, 99)),
             "multipart_gbps": RGW_CLIENTS * RGW_MULTIPART / mp_s / 1e9,
             "complete_ms": float(complete_ms.mean()), "get_gbps": get_bytes / get_s / 1e9,
             "get_s": get_s, "list_s": span_of(res, "list"), "window_s": wall}
    print(f"  rgw.0 (python -m ceph_tpu_torch.rgw, spawned with phase 23's mds processes; data "
          f"in pool {EC_POOL}, the bucket index in pool {REP_POOL}) serving S3 on :{port} "
          f"({boot_s:.3f} s waited for it)", flush=True)
    print(f"  [{smi}] {RGW_CLIENTS} S3 client processes, {RGW_IN_FLIGHT} requests in flight "
          f"each: PUT of {RGW_CLIENTS * RGW_OBJECTS} objects of {RGW_OBJECT >> 20} MiB in "
          f"{put_s:.3f} s, {times['put_gbps']:.4f} GB/s, a PUT p50 {times['put_p50_ms']:.3f} "
          f"ms, p99 {times['put_p99_ms']:.3f} ms; {RGW_CLIENTS} multipart uploads of "
          f"{RGW_MULTIPART >> 20} MiB in {n_parts} parts of {RGW_PART >> 20} MiB: "
          f"{mp_s:.3f} s ({times['multipart_gbps']:.4f} GB/s), CompleteMultipartUpload "
          f"{times['complete_ms']:.3f} ms (mean); every ETag the crc32c of its bytes",
          flush=True)
    print(f"  [{smi}] GET of every object and upload back ({get_bytes >> 20} MiB): "
          f"{get_s:.3f} s, {times['get_gbps']:.4f} GB/s, every body and ETag exact; the "
          f"listing in {res[0]['list'][2]} pages of {RGW_PAGE} keys a client, equal to what it "
          f"wrote ({times['list_s']:.3f} s); a versioned key put twice, both versions listed "
          f"and read back; the window {wall:.3f} s (the client processes' start included)",
          flush=True)
    print(f"  B1 wrapper launches in the OSD processes over the window: {counts[2]}, "
          f"EncodeService objects {counts[1]}, against {written} objects the gateway wrote to "
          f"pool {EC_POOL} (data, parts, manifests, versions); phase 24 took "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return {"launches": counts[2], "times": times, "uploads": [r["upload"] for r in res],
            "vids": [r["vids"] for r in res], "s": time.perf_counter() - t0}


def _chaos_cpu(seed: int) -> tuple[str, float]:
    """Worker: run_chaos(seed) on the CPU, as sorted JSON text, and its
    seconds."""
    torch.set_num_threads(2)
    from ceph_tpu_torch.sim import run_chaos

    t = time.perf_counter()
    report = json.dumps(run_chaos(seed, device="cpu"), sort_keys=True)
    return report, time.perf_counter() - t


def chaos_shards_checker(factory, pool: int, result: dict):
    """on_settled hook for run_chaos_live: every stored shard of `pool` on
    every OSD equals the chunk the CPU tpu codec makes of what the object
    reads back."""
    cpu = factory("tpu", {"k": "2", "m": "2"}, device="cpu")
    n = cpu.get_chunk_count()

    async def check(cluster, rados):
        stored: dict[str, list] = {}
        for osd_id, osd in cluster.osds.items():
            for coll in osd.store.list_collections():
                if not coll.startswith(f"pg_{pool}_"):
                    continue
                for obj in osd.store.list_objects(coll):
                    base, sep, pos = obj.rpartition(".s")
                    if sep and pos.isdigit():
                        stored.setdefault(base, []).append((osd_id, coll, obj, int(pos)))
        io = rados.io_ctx(pool)
        for name, shards in sorted(stored.items()):
            chunks = cpu.encode(range(n), await io.read(name))
            for osd_id, coll, obj, pos in shards:
                if cluster.osds[osd_id].store.read(coll, obj) != chunks[pos]:
                    raise AssertionError(f"osd.{osd_id} {obj} differs from the CPU tpu "
                                         "codec's chunk")
        result["objects"], result["shards"] = len(stored), sum(map(len, stored.values()))

    return check


@contextlib.contextmanager
def raised_calls(cls, names=("encode_words", "decode_words")):
    """Patches `cls`'s codec methods to note every call that raised."""
    raised: list[str] = []
    saved = {name: getattr(cls, name) for name in names}

    def watched(name, fn):
        def call(self, *args):
            try:
                return fn(self, *args)
            except Exception as e:
                raised.append(f"{name}: {e!r}")
                raise
        return call

    for name, fn in saved.items():
        setattr(cls, name, watched(name, fn))
    try:
        yield raised
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def phase_chaos(gc, cc, factory, smi: str) -> dict:
    """Phase 22's chaos harness on the card: run_chaos's replays (B6 maps
    the pools), chaos_tool's live run (B1 in the EC pool; every oracle, and
    every stored shard against the CPU codec), the recovery A/B, and
    `daemon_bench --mgr`. Returns the launches of B1 and B6 in their
    windows and the figures."""
    from ceph_tpu_torch.ec.rs import ErasureCodeRs
    from ceph_tpu_torch.sim import run_chaos
    from ceph_tpu_torch.tools import chaos_tool, daemon_bench

    import concurrent.futures

    out = {}
    cc.crush_choose.launches = 0
    t = time.perf_counter()
    card = [json.dumps(run_chaos(seed, device="cuda"), sort_keys=True) for seed in CHAOS_SEEDS]
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    out["b6"] = cc.crush_choose.launches
    if out["b6"] < 1:
        raise AssertionError("run_chaos never launched crush_choose")
    # the CPU's reports, in worker processes while the live run goes on
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t_cpu = time.perf_counter()
        cpu_runs = pool.submit(in_workers, "_chaos_cpu", list(CHAOS_SEEDS))

        checked: dict = {}
        gc.gf_matmul_packed.launches = 0
        t = time.perf_counter()
        with raised_calls(ErasureCodeRs) as raised:
            report = asyncio.run(asyncio.wait_for(chaos_tool.run_chaos_live(
                CHAOS_LIVE_SEED, steps=CHAOS_LIVE_STEPS, progress=lambda line: print(
                    f"    {line}", flush=True), device="cuda",
                on_settled=chaos_shards_checker(factory, chaos_tool.EC_POOL, checked)), 600))
        torch.cuda.synchronize()
        live_s = time.perf_counter() - t
        out["b1"] = gc.gf_matmul_packed.launches
        out["live"] = {k: report[k] for k in ("p99_s", "client_ops", "acked_keys",
                                              "starved_steps", "scrub_errors", "lost")}
        out["live"]["seconds"] = live_s
        print(f"  [{smi}] chaos_tool seed {CHAOS_LIVE_SEED}, {CHAOS_LIVE_STEPS} steps on the card: "
              f"{live_s:.3f} s; client p99 {report['p99_s']} s (budget {report['p99_budget_s']}), "
              f"{report['client_ops']} client ops, {report['acked_keys']} keys, lost "
              f"{report['lost']}, scrub errors {report['scrub_errors']}, starved steps "
              f"{report['starved_steps']} (report ok {report['ok']}); executed "
              f"{report['executed']}; gf_matmul_packed launches {out['b1']}, calls that raised "
              f"{len(raised)} {raised[:3]}; {checked.get('shards')} stored shards of "
              f"{checked.get('objects')} pool-{chaos_tool.EC_POOL} objects equal the CPU tpu "
              f"codec's chunks", flush=True)
        # step 0 starves in ceph_tpu's run of this seed too (ROADMAP C)
        if (report["lost"] or report["scrub_errors"] or report["p99_s"] > report["p99_budget_s"]
                or not set(report["starved_steps"]) <= {0}):
            raise AssertionError(f"a chaos oracle failed on the card: {report}")
        if out["b1"] < 1 or raised or not checked.get("shards"):
            raise AssertionError(f"B1 launches {out['b1']}, raised {raised}, checked {checked}")
        cpu = [report for report, _s in cpu_runs.result()]
        cpu_s = [round(s, 3) for _r, s in cpu_runs.result()]
        wait_s = time.perf_counter() - t_cpu
    if cpu != card:
        raise AssertionError("run_chaos on the card differs from the CPU's: seeds "
                             f"{[s for s, a, b in zip(CHAOS_SEEDS, card, cpu) if a != b]}")
    print(f"  run_chaos seeds {list(CHAOS_SEEDS)} (16 OSDs, 48 PGs, 11 steps): reports on the "
          f"card equal the CPU's; {card_s:.3f} s on the card, {cpu_s} s on the CPU (a worker "
          f"process each, beside the live run; {wait_s:.3f} s to both results); "
          f"crush_choose launches {out['b6']}",
          flush=True)

    gc.gf_matmul_packed.launches = 0
    t = time.perf_counter()
    rec = daemon_bench.run(["--recovery", "--device", "cuda"])
    torch.cuda.synchronize()
    out["recovery"] = rec
    print(f"  [{smi}] daemon_bench --recovery --device cuda ({rec['objects']} objects of 2 KiB "
          f"in the replicated pool) in {time.perf_counter() - t:.3f} s: serial "
          f"{rec['serial']}, batched {rec['batched']}, speedup {rec['speedup']}; "
          f"gf_matmul_packed launches {gc.gf_matmul_packed.launches} (the pool is "
          f"replicated)", flush=True)
    for leg in ("serial", "batched"):
        if rec[leg]["healed_objects"] < 1:
            raise AssertionError(f"the {leg} leg healed nothing: {rec}")

    here = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_bench", *MGR_BENCH_ARGV]
    t = time.perf_counter()
    proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"daemon_bench --mgr exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.splitlines()[-1])
    if line["mgr"]["daemons_reporting"] != line["osds"] or line["launches"] < 1:
        raise AssertionError(f"daemon_bench --mgr: {line}")
    out["mgr_bench"] = line["mgr"]
    print(f"  [{smi}] daemon_bench {' '.join(MGR_BENCH_ARGV)} in "
          f"{time.perf_counter() - t:.2f} s (its process included): write "
          f"{line['write_gbps']} GB/s, {line['launches']} EncodeService launches, mgr "
          f"{line['mgr']}", flush=True)
    return out


#: when main started, for the phase lines' timestamps
T0 = time.perf_counter()


def phase(text: str) -> None:
    print(f"{text} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def main() -> int:
    global T0
    T0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
              "required", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ceph_tpu_torch.crush import balance
    from ceph_tpu_torch.crush import builder as cb
    from ceph_tpu_torch.crush import torch_mapper as tm
    from ceph_tpu_torch.crush import types as crush_types
    from ceph_tpu_torch.crush.compiler import compile_crushmap, decompile_crushmap
    from ceph_tpu_torch.crush.tester import CrushTester
    from ceph_tpu_torch.ec import bitmatrix as bmx
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.mgr import BalancerModule
    from ceph_tpu_torch.ops import crush_cuda as cc
    from ceph_tpu_torch.ops import cuda_build, gf
    from ceph_tpu_torch.ops import gf_bitplane as bp
    from ceph_tpu_torch.ops import gf_cuda as gc
    from ceph_tpu_torch.ops import upmap_cuda as uc
    from ceph_tpu_torch.osd import encode_service as es
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.parallel import sharding as sh
    from ceph_tpu_torch.sim import build_cluster
    from ceph_tpu_torch.tools import crush_bench, crushtool, ec_bench, psim

    phase("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {kind}, count {count}", flush=True)
    print(smi, flush=True)
    mode = smi_query("--query-gpu=compute_mode", "--format=csv,noheader")
    print(f"  compute mode: {mode} (the multi-process phase opens the card from every "
          "daemon process)", flush=True)

    phase("phase 2: build")
    t0 = time.perf_counter()
    libs = cuda_build.build()
    print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in sorted(cuda_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    phase("phase 3: kernel vs plain on the card")
    codec = factory("isa", dict(PROFILE))
    max_err, packed_variants = phase_kernels(gc, gf, codec, factory)

    phase("phase 4: main path")
    gc.gf_matmul_packed.launches = 0
    objs, encoded = phase_main_path(codec, es.EncodeService, ec_bench)
    torch.cuda.synchronize()
    launches = gc.gf_matmul_packed.launches
    print(f"  gf_matmul_packed launches on the main path: {launches}", flush=True)
    if launches < 1:
        raise AssertionError("the main path never launched gf_matmul_packed")
    check_outputs(codec, gf, objs, encoded[0])

    phase("phase 5: times")
    times = phase_times(gc, codec, es, smi)

    phase("phase 6: crush kernel vs plain on the card")
    big = crush_bench.build_map(CRUSH_OSDS)
    cb.make_simple_rule(big, 1, -1, 1, "indep", 0)
    crush_err = phase_crush_kernels(cc, tm, cb, crush_types, big)

    phase("phase 7: crush main path")
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

    phase("phase 8: crush outputs")
    err, plain_ms = phase_crush_outputs(tm, big, crush_main)
    crush_err = max(crush_err, err)

    phase("phase 9: crush times")
    crush_times = phase_crush_times(cc, tm, big, crush_main, plain_ms, smi)

    phase("phase 10: upmap scoring kernel vs plain on the card")
    upmap_err, round1, spread1 = phase_upmap_kernels(uc, balance, tm, build_cluster,
                                                     crush_bench)

    phase("phase 11: balancer main path")
    cc.crush_choose.launches = 0
    uc.upmap_score.launches = 0
    bal = phase_balancer_main(psim, BalancerModule, build_cluster, compile_crushmap)
    torch.cuda.synchronize()
    bal_crush_launches = cc.crush_choose.launches
    upmap_launches = uc.upmap_score.launches
    print(f"  launches on the balancer path: upmap_score {upmap_launches}, crush_choose "
          f"{bal_crush_launches}", flush=True)
    if upmap_launches < 1 or bal_crush_launches < 1:
        raise AssertionError("the balancer path never launched upmap_score or crush_choose")
    check_balancer_outputs(tm, balance, OSDMap, bal, spread1)

    phase("phase 12: balancer times")
    upmap_times = phase_balancer_times(uc, balance, tm, build_cluster, BalancerModule, OSDMap,
                                       compile_crushmap, round1, bal, big, crush_main[0]["rows"],
                                       smi)

    phase("phase 13: EC family kernels vs plain on the card")
    codecs = family_codecs(factory)
    family_err, bytes_variants = phase_family_kernels(bp, gc, bmx, codecs, codec)

    phase("phase 14: EC families main path")
    new_wrappers = {"gf_matmul_bitplane": bp.gf_matmul_bitplane, "xor_reduce": bp.xor_reduce,
                    "xor_reduce_words": gc.xor_reduce_words,
                    "xor_rowmatmul": bmx.xor_rowmatmul}
    for wrapper in new_wrappers.values():
        wrapper.launches = 0
    phase_family_main(factory, ec_bench, codecs)
    phase_corpus_on_card(factory)
    phase_service_bursts(factory, es.EncodeService, codecs)
    torch.cuda.synchronize()
    family_launches = {name: w.launches for name, w in new_wrappers.items()}
    print(f"  launches on the EC families path: {family_launches}", flush=True)
    if min(family_launches.values()) < 1:
        raise AssertionError(f"the EC families path never launched {family_launches}")

    phase("phase 15: EC family times")
    family_times = phase_family_times(bp, gc, bmx, codecs, codec, smi)

    phase("phase 16: the RADOS data path (MiniCluster) on the card")
    rados = phase_rados_main(bp, factory, smi)
    phase_rados_identity()

    phase("phase 17: the native plugin and the EC tools")
    phase_native_and_tools(factory, smi)

    phase("phase 18: the live daemon path (monitors, OSD daemons, client) on the card")
    # the offline check of phases 20-24 needs the CPU codec's parity of
    # objects known from the seed: made in worker processes from here on
    parity_pool = concurrent.futures.ThreadPoolExecutor(1)
    parity = parity_pool.submit(offline_parity)
    bp.gf_matmul_bitplane.launches = 0
    daemon = phase_daemon_path(gc, factory, smi)
    daemon_b3 = bp.gf_matmul_bitplane.launches
    print(f"  gf_matmul_bitplane launches on the daemon path: {daemon_b3}", flush=True)

    phase("phase 19: the device mesh (B8) on the card")
    b8_launches, b8_err, b8_per_call = phase_mesh_main(bp, sh, codec, es, objs, encoded)
    print(f"  gf_matmul_bitplane launches on the mesh path (one per slot): {b8_launches}",
          flush=True)
    if b8_launches < 1:
        raise AssertionError("the mesh path never launched B3 on a slot")
    del objs, encoded

    phase("phase 20: the multi-process cluster (VStart: a process per daemon) on the card")
    mp = phase_multiprocess(factory, decompile_crushmap, smi, parity)
    parity_pool.shutdown()
    print(f"  B1 launches in the OSD processes (their wrappers' counts): phase 20 "
          f"{mp['launches']}, phase 21 {mp['fleet']['launches']}, phase 22's mgr window "
          f"{mp['mgr']['launches']}, phase 23 {mp['rbd']['launches_total']}, phase 24 "
          f"{mp['rgw']['launches']}", flush=True)

    phase("phase 19 (cont.): B8's times, the daemons and the parity workers gone")
    b8_times = phase_mesh_times(bp, sh, codec, smi)
    phase_multiprocess_bench(smi)

    phase("phase 22 (cont.): the chaos harness, the recovery A/B and daemon_bench --mgr on "
          "the card")
    chaos = phase_chaos(gc, cc, factory, smi)

    phase("phase 25: processes left")

    kernels = [{
        "name": "gf_matmul_packed",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:141",
        "launches": (launches + daemon["launches"] + mp["launches"] + mp["fleet"]["launches"]
                     + mp["mgr"]["launches"] + mp["rbd"]["launches_total"]
                     + mp["rgw"]["launches"] + chaos["b1"]),
        "max_abs_err": max_err,
        "ms": times["ms"],
        "held_ms": times["held_ms"],
        "host_us": times["host_us"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "variants": packed_variants,
        "at_object_width": times["at_object_width"],
    }, {
        "name": "crush_choose",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_choose.cu",
        "replaces": "ceph_tpu/crush/jax_mapper.py:952",
        "launches": crush_launches + bal_crush_launches + chaos["b6"],
        "max_abs_err": crush_err,
        "ms": crush_times[0]["ms"],
        "held_ms": crush_times[0]["held_ms"],
        "host_us": crush_times[0]["host_us"],
        "plain_ms": crush_times[0]["plain_ms"],
        "bound_ms": crush_times[0]["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
    }, {
        "name": "upmap_score",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/upmap_score.cu",
        "replaces": "ceph_tpu/crush/balance.py:130",
        "launches": upmap_launches,
        "max_abs_err": upmap_err,
        "ms": upmap_times["ms"],
        "held_ms": upmap_times["held_ms"],
        "host_us": upmap_times["host_us"],
        "plain_ms": upmap_times["plain_ms"],
        "bound_ms": upmap_times["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
    }]
    sources = {
        "gf_matmul_bitplane": ("ceph_tpu_torch/csrc/gf_matmul.cu", "ceph_tpu/ops/gf_bitplane.py:69"),
        "xor_reduce": ("ceph_tpu_torch/csrc/xor_rowmatmul.cu", "ceph_tpu/ops/gf_bitplane.py:100"),
        "xor_reduce_words": ("ceph_tpu_torch/csrc/xor_rowmatmul.cu",
                             "ceph_tpu/ops/gf_pallas.py:154"),
        "xor_rowmatmul": ("ceph_tpu_torch/csrc/xor_rowmatmul.cu", "ceph_tpu/ec/bitmatrix.py:148"),
    }
    for name, (source, replaces) in sources.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": family_launches[name] + (rados["launches"] + daemon_b3
                                                 if name == "gf_matmul_bitplane" else 0),
            "max_abs_err": family_err[name],
            "ms": family_times[name]["ms"],
            "held_ms": family_times[name]["held_ms"],
            "host_us": family_times[name]["host_us"],
            "plain_ms": family_times[name]["plain_ms"],
            "bound_ms": family_times[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": family_times[name]["library_ms"],
        })
    next(k for k in kernels if k["name"] == "gf_matmul_bitplane").update(
        variants=bytes_variants,
                      at_object_width=family_times["gf_matmul_bitplane"]["at_object_width"])
    kernels.append({
        "name": "sharded_matmul",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_matmul.cu",
        "replaces": "ceph_tpu/parallel/sharding.py:50",
        "launches": b8_launches,
        "launches_per_call": b8_per_call,
        "max_abs_err": b8_err,
        "ms": b8_times["ms"],
        "held_ms": b8_times["held_ms"],
        "host_us": b8_times["host_us"],
        "plain_ms": b8_times["plain_ms"],
        "bound_ms": b8_times["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "meshes": {label: {key: t[key] for key in ("ms", "held_ms", "host_us",
                                                   "launches_per_call")}
                   for label, t in b8_times["meshes"].items()},
        "one_b3": b8_times["one_b3"],
    })
    left = own_children()
    if left:
        raise AssertionError(f"processes still running: {left}")
    print("  none", flush=True)
    phase("phase 26: kernels and the result")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
