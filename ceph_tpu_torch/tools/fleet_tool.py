"""Fleet operator CLI + the multi-host training-harness worker.

    python -m ceph_tpu_torch.tools.fleet_tool --mon-host 127.0.0.1:6789 --pool 1 <cmd>

Commands:

    status <fleet>          roster, per-member lease liveness, leader
                            and its remaining lease — one JSON blob
    worker <fleet>          one training host: join, barrier-per-step
                            data consumption, leader-only checkpoint
                            commits. Emits one JSON line per event
                            (joined/batch/commit/mid_save/resumed/
                            rbatch/final_commit/done) so a harness can
                            reconstruct exactly which records were
                            acked by which committed save. --role
                            victim elects itself leader and parks
                            mid-save for the harness to SIGKILL;
                            survivors self-heal (barrier eviction),
                            restore the committed HEAD, and resume the
                            data stream with zero dup/missing records.
    bench [--hosts N]       in-process fleet bench: barrier round-trip
          [--rounds K]      latency percentiles across N hosts, and
          [--mb M]          per-rank sharded restore aggregate GB/s vs
                            one host restoring the whole tree
    bench --parallel-save   fleet-parallel save bench: N REAL worker
                            processes (separate GILs — serialization
                            and crc run on N cores, as on a real pod)
                            collectively save one mesh-sharded tree vs
                            an N-host SINGLE-COMMITTER baseline (each
                            non-leader's shard travels through the
                            store to the leader, which serializes and
                            puts every byte itself — what one-committer
                            costs on a pod where no host holds remote
                            shards); reports parallel_save_speedup and
                            peak_host_bytes_frac (max per-host
                            save_prepared_bytes / tree bytes)
    psave <fleet>           one parallel-save bench host (spawned by
                            `bench --parallel-save`; --mode single
                            runs the legacy one-committer baseline)

Port of the reference package's `tools/fleet_tool.py`. `--device` (default
cuda, which raises without a card) is where the client's codecs run, where
restores land and, repeated once per host, the fleet mesh a psave host lays
its tree out on; the reference forced its psave hosts' JAX onto the CPU.
The benches boot the tools' bench cluster (`tools/bench_cluster.py`: 3
monitors, 6 OSD daemons on `--device`, a size-3 and a k=2 m=2 pool) in this
process, and the spawned hosts run `python -m ceph_tpu_torch.tools.fleet_tool`.
Output is JSON per command (worker: JSON lines), like tools/ceph.py."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from ceph_tpu_torch.device import resolve_device

#: the directory that holds the package, where spawned hosts start
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(**fields) -> None:
    print(json.dumps(fields, sort_keys=True), flush=True)


async def _connect(args):
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap
    from ceph_tpu_torch.rados.client import Rados

    addrs = []
    for hostport in args.mon_host.split(","):
        host, _, port = hostport.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    cfg = Config()
    if args.lease is not None:
        cfg.set("coord_lease", args.lease)
        cfg.set("coord_barrier_poll", min(0.2, args.lease / 4))
    rados = Rados(args.name_id, MonMap(addrs=addrs), config=cfg,
                  device=args.device)
    await rados.connect()
    return rados


def _tree(step: int):
    """The deterministic 'model': weights are a pure function of the
    step so a harness can recompute what any committed save must hold."""
    import numpy as np

    return {
        "w": np.full((8, 4), float(step), dtype=np.float32),
        "b": np.arange(4, dtype=np.float32) + float(step),
    }


async def _await_quorum(fleet, args) -> None:
    """With --quorum N, wait until N members are live before the
    registration barrier: that barrier completes once every member live
    at the time has arrived, so a host whose process started late would
    otherwise join a fleet that has already partitioned its data or
    staged its save without it."""
    deadline = time.monotonic() + args.timeout
    while len(await fleet.live_members()) < args.quorum:
        if time.monotonic() > deadline:
            raise TimeoutError(f"fewer than {args.quorum} live members after "
                               f"{args.timeout} s")
        await asyncio.sleep(0.05)


async def _status(args) -> int:
    from ceph_tpu_torch.coord import Fleet

    rados = await _connect(args)
    try:
        fleet = Fleet(rados.io_ctx(args.pool), args.fleet_name,
                      args.host_id or "status-probe")
        print(json.dumps(await fleet.status(), indent=2, sort_keys=True))
        return 0
    finally:
        await rados.shutdown()


async def _worker(args) -> int:
    from ceph_tpu_torch.ckpt.store import CkptStore
    from ceph_tpu_torch.coord import Fleet, FleetDriver
    from ceph_tpu_torch.data.store import DataStore

    rados = await _connect(args)
    io = rados.io_ctx(args.pool)
    fleet = Fleet(io, args.fleet_name, args.host_id)
    driver = FleetDriver(
        fleet,
        ckpt=CkptStore(io, args.ckpt_name),
        data=DataStore(io, args.data_name),
    )
    victim = args.role == "victim"
    try:
        rank, hosts = await fleet.join()
        _emit(event="joined", host=args.host_id, rank=rank, hosts=hosts)
        await _await_quorum(fleet, args)
        if victim:
            # the victim is the designated first leader, so the
            # harness knows exactly whose death it is injecting
            _emit(event="elected", host=args.host_id,
                  leader=await fleet.elect())
        await fleet.barrier(timeout=args.timeout)  # registration

        it = await driver.data_iterator(seed=args.seed,
                                        batch_size=args.batch)
        step = 0

        async def consume(tag: str) -> None:
            nonlocal step
            batch = await it.__anext__()
            _emit(event=tag, host=args.host_id, step=step,
                  ids=[r.decode() for r in batch])
            step += 1

        # phase A: synchronized steps, then a COMMITTED save
        for _ in range(args.pre_steps):
            await consume("batch")
            await fleet.barrier(timeout=args.timeout)
        ps = await driver.save(_tree(step), iterator=it)
        if victim:
            assert ps is not None, "victim must be the committer"
            (sid,) = await driver.drain()
            _emit(event="commit", host=args.host_id, save_id=sid,
                  step=step)
        else:
            assert ps is None, "exactly one committer"
        await fleet.barrier(timeout=args.timeout)  # commit visible

        # phase B: more synchronized steps, NOT yet committed
        for _ in range(args.mid_steps):
            await consume("batch")
            await fleet.barrier(timeout=args.timeout)

        if victim:
            # submit (don't drain) and park: the save is in flight
            # when the harness SIGKILLs us — the lease lapses, the
            # commit either lands (valid newer save) or dies with it
            await driver.save(_tree(step), iterator=it)
            _emit(event="mid_save", host=args.host_id, step=step)
            while True:
                await asyncio.sleep(0.25)

        # survivors: the barrier self-heals — a waiter elects once the
        # dead leader's lease lapses, sweeps the roster, and the live
        # set shrinks to us
        await fleet.barrier(timeout=args.timeout)
        head = await driver.ckpt.head()
        cursor = await driver.restore_cursor()
        tree = await driver.restore(device=args.device)
        _emit(event="resumed", host=args.host_id,
              head=head["save_id"], position=cursor["position"],
              base=cursor["base"], w_sum=float(tree["w"].sum()),
              live=await fleet.live_members())

        it2 = await driver.resume_iterator(cursor)
        async for batch in it2:
            _emit(event="rbatch", host=args.host_id,
                  ids=[r.decode() for r in batch])
        await fleet.barrier(timeout=args.timeout)

        ps = await driver.save(_tree(args.pre_steps + args.mid_steps))
        if ps is not None:
            (sid,) = await driver.drain()
            _emit(event="final_commit", host=args.host_id, save_id=sid)
        await fleet.barrier(timeout=args.timeout)
        await fleet.leave()
        _emit(event="done", host=args.host_id)
        return 0
    finally:
        await rados.shutdown()


def _bench_tree(hosts: int, mb: int):
    """The deterministic bench tree — identical bytes in every mode."""
    import numpy as np

    rng = np.random.default_rng(0)
    rows = hosts * max(1, (mb << 20) // hosts // 4096)
    return {"w": rng.integers(0, 256, (rows, 4096), dtype=np.uint8)}


async def _psave_single(args, io, fleet, driver, tree):
    """The honest one-committer baseline on the SAME N-host fleet: a
    real pod host only holds its own shards, so a single committer
    must first GATHER every remote shard through the store (non-leader
    slab put + leader ranged read), reassemble, and serialize + put
    the WHOLE tree itself. Returns (save_id, seconds) spanning
    rendezvous → committed HEAD on every host."""
    import numpy as np

    from ceph_tpu_torch.ckpt import layout as ckpt_layout

    t0 = time.perf_counter()
    is_leader = await fleet.elect()
    hosts = await fleet.live_members()
    rank = hosts.index(args.host_id)
    rows = tree["w"].shape[0]
    if not is_leader:
        sl = ckpt_layout.fleet_slab(rows, len(hosts), rank)
        await io.write_full(
            f"{args.ckpt_name}.gather.{rank:04d}",
            tree["w"][sl].tobytes(),
        )
        await fleet.barrier(tag="gather", members=hosts,
                            timeout=args.timeout)
        await fleet.barrier(tag="gathered", members=hosts,
                            timeout=args.timeout)
        head = await driver.ckpt.head()
        return head["save_id"], time.perf_counter() - t0
    await fleet.barrier(tag="gather", members=hosts,
                        timeout=args.timeout)
    parts = []
    for r in range(len(hosts)):
        sl = ckpt_layout.fleet_slab(rows, len(hosts), r)
        if r == rank:
            parts.append(tree["w"][sl])
            continue
        raw = await io.read(f"{args.ckpt_name}.gather.{r:04d}")
        parts.append(np.frombuffer(raw, dtype=tree["w"].dtype)
                     .reshape(-1, *tree["w"].shape[1:]))
    full = {"w": np.concatenate(parts, axis=0)}
    ps = await driver.save(full)
    assert ps is not None, "baseline leader must hold the seat"
    (sid,) = await driver.drain()
    await fleet.barrier(tag="gathered", members=hosts,
                        timeout=args.timeout)
    return sid, time.perf_counter() - t0


async def _psave_worker(args) -> int:
    """One parallel-save bench host: join, rendezvous, ONE timed save,
    emit the numbers. `--mode single` is the one-committer baseline
    (remote shards gathered through the store, whole-tree serialize +
    every chunk from the leader); `--mode parallel` is this rank's
    share of the collective save_async."""
    from ceph_tpu_torch.ckpt.store import CkptStore
    from ceph_tpu_torch.ckpt.writer import CkptAborted, CkptWriter
    from ceph_tpu_torch.coord import Fleet, FleetDriver
    from ceph_tpu_torch.coord import mesh as coord_mesh

    if args.role == "victim":
        # park mid-put — after this rank's chunks went out but BEFORE
        # its rank record is durable — so the harness can SIGKILL a
        # writer whose share looks in-flight to everyone else (the
        # same park-and-die contract as `worker --role victim`)
        async def _park(self, own):
            _emit(event="parked", host=args.host_id,
                  save_id=self.save_id)
            while True:
                await asyncio.sleep(0.25)
        CkptWriter.put_rank_meta = _park

    rados = await _connect(args)
    io = rados.io_ctx(args.pool)
    fleet = Fleet(io, args.fleet_name, args.host_id)
    driver = FleetDriver(fleet, ckpt=CkptStore(io, args.ckpt_name))
    try:
        await fleet.join()
        await _await_quorum(fleet, args)
        if args.role == "leader":
            # deterministic seat for harnesses that must know whose
            # death they are injecting (the victim stays a follower)
            _emit(event="elected", host=args.host_id,
                  leader=await fleet.elect())
        tree = _bench_tree(args.hosts, args.mb)
        total = tree["w"].nbytes
        await fleet.barrier(timeout=args.timeout)  # registration
        if args.mode == "single":
            sid, secs = await _psave_single(args, io, fleet, driver,
                                            tree)
        else:
            sharded = coord_mesh.shard_tree(
                tree, coord_mesh.fleet_mesh(
                    args.hosts, devices=[args.device] * args.hosts)
            )
            await fleet.barrier(timeout=args.timeout)  # post placement
            t0 = time.perf_counter()
            handle = await driver.save_async(sharded,
                                             timeout=args.timeout)
            try:
                sid = await handle.wait()
            except CkptAborted as e:
                # a writer died before its share was durable: HEAD is
                # untouched; report and exit clean so the harness can
                # re-run the collective over the survivors
                _emit(event="aborted", host=args.host_id,
                      save_id=handle.save_id, error=str(e))
                await fleet.leave()
                return 0
            secs = time.perf_counter() - t0
        _emit(event="psave", host=args.host_id, mode=args.mode,
              save_id=sid, seconds=round(secs, 4), bytes=total,
              prepared_bytes=driver.ckpt.perf_dump()[
                  "save_prepared_bytes"])
        await fleet.leave()
        return 0
    finally:
        await rados.shutdown()


async def _bench_parallel(args) -> dict:
    """`bench --parallel-save`: an N-host single-committer baseline
    (remote shards gathered through the store, the leader serializing
    and putting all the bytes), then N collective writer processes,
    against the same in-process cluster over TCP. Separate processes =
    separate GILs, so the per-host serialization/crc actually runs in
    parallel — the honest analogue of N pod hosts."""
    from ceph_tpu_torch.tools.bench_cluster import REP_POOL, BenchCluster

    cluster = await BenchCluster(args.device).start("client.fleetbench")
    mon_host = cluster.mon_host

    async def spawn(host_id, mode, fleet_name):
        return await asyncio.create_subprocess_exec(
            sys.executable, "-m", "ceph_tpu_torch.tools.fleet_tool",
            "--mon-host", mon_host, "--pool", str(REP_POOL),
            "--device", str(args.device),
            "--host-id", host_id, "--mode", mode,
            "--hosts", str(args.hosts), "--mb", str(args.mb),
            "--quorum", str(args.hosts),
            "--ckpt-name", f"bench-{mode}", "--lease", "2.0",
            "--timeout", str(args.timeout),
            "psave", fleet_name,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE, cwd=_ROOT,
        )

    async def harvest(procs) -> list[dict]:
        outs = await asyncio.gather(*(p.communicate() for p in procs))
        events = []
        for p, (out, err) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"psave worker failed rc={p.returncode}: "
                    f"{err.decode()[-2000:]}"
                )
            events.extend(
                json.loads(ln) for ln in out.decode().splitlines() if ln
            )
        return [e for e in events if e.get("event") == "psave"]

    try:
        single = await harvest(await asyncio.gather(*(
            spawn(f"host-s{i:02d}", "single", "bench-s")
            for i in range(args.hosts)
        )))
        par = await harvest(await asyncio.gather(*(
            spawn(f"host-{i:02d}", "parallel", "bench-p")
            for i in range(args.hosts)
        )))
        t_single = max(e["seconds"] for e in single)
        t_par = max(e["seconds"] for e in par)
        total = single[0]["bytes"]
        return {
            "bench": "fleet_parallel_save",
            "device": str(args.device),
            "hosts": args.hosts,
            "bytes": total,
            "single_save_s": round(t_single, 4),
            "parallel_save_s": round(t_par, 4),
            "parallel_save_speedup": round(
                t_single / max(t_par, 1e-9), 2),
            "peak_host_bytes_frac": round(
                max(e["prepared_bytes"] for e in par) / total, 4),
        }
    finally:
        await cluster.stop()


async def _bench(args) -> dict:
    """Barrier latency + sharded-restore scaling against an in-process
    cluster (no external daemons), the `bench.py --fleet` engine."""
    import numpy as np

    from ceph_tpu_torch.ckpt.store import CkptStore
    from ceph_tpu_torch.coord import Fleet, FleetDriver
    from ceph_tpu_torch.tools.bench_cluster import REP_POOL, BenchCluster

    cluster = await BenchCluster(args.device).start("client.fleetbench")
    handles = []
    try:
        for i in range(args.hosts):
            r = cluster.client(f"client.fb{i}")
            await r.connect()
            f = Fleet(r.io_ctx(REP_POOL), "bench", f"host-{i:02d}")
            await f.join()
            handles.append((r, f))

        # barrier round-trips: all hosts arrive together, K rounds
        waits = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            await asyncio.gather(
                *(f.barrier(timeout=60) for _, f in handles)
            )
            waits.append(time.perf_counter() - t0)
        waits.sort()

        # one committed save, then per-rank sharded restore vs whole
        rng = np.random.default_rng(0)
        rows = args.hosts * max(1, (args.mb << 20) // args.hosts // 4096)
        tree = {"w": rng.integers(0, 256, (rows, 4096), np.uint8)}
        drivers = [
            FleetDriver(f, ckpt=CkptStore(r.io_ctx(REP_POOL), "bench"))
            for r, f in handles
        ]
        await drivers[0].save(tree)
        await drivers[0].drain()

        t0 = time.perf_counter()
        whole = await drivers[0].restore(device=args.device)
        t_whole = time.perf_counter() - t0
        assert np.array_equal(whole["w"].cpu().numpy(), tree["w"])

        t0 = time.perf_counter()
        shards = await asyncio.gather(
            *(d.restore_shard("w") for d in drivers)
        )
        t_shard = time.perf_counter() - t0
        assert np.array_equal(
            np.concatenate([s[0] for s in shards]), tree["w"]
        )
        total = tree["w"].nbytes
        return {
            "bench": "fleet",
            "device": str(args.device),
            "hosts": args.hosts,
            "rounds": args.rounds,
            "barrier_p50_ms": round(waits[len(waits) // 2] * 1e3, 3),
            "barrier_p99_ms": round(
                waits[min(len(waits) - 1,
                          int(len(waits) * 0.99))] * 1e3, 3),
            "bytes": total,
            "restore_whole_gbps": round(total / t_whole / 1e9, 4),
            "restore_sharded_gbps": round(total / t_shard / 1e9, 4),
            "sharded_speedup": round(t_whole / max(t_shard, 1e-9), 2),
        }
    finally:
        for r, f in handles:
            try:
                await f.leave()
            # cephlint: disable=error-taxonomy (teardown: a member that cannot leave goes down with the cluster stopped next)
            except Exception:  # noqa: BLE001
                pass
            await r.shutdown()
        await cluster.stop()


async def _amain(args) -> int:
    if args.command == "status":
        return await _status(args)
    if args.command == "worker":
        return await _worker(args)
    if args.command == "bench":
        bench = _bench_parallel if args.parallel_save else _bench
        print(json.dumps(await bench(args), sort_keys=True))
        return 0
    if args.command == "psave":
        return await _psave_worker(args)
    raise SystemExit(f"unknown command {args.command!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fleet_tool")
    ap.add_argument("--mon-host", default="127.0.0.1:6789")
    ap.add_argument("--pool", type=int, default=1)
    ap.add_argument("--name", dest="name_id", default="client.fleet")
    ap.add_argument("--host-id", default="")
    ap.add_argument("--role", choices=("victim", "survivor", "leader"),
                    default="survivor")
    ap.add_argument("--ckpt-name", default="model")
    ap.add_argument("--data-name", default="corpus")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pre-steps", type=int, default=3)
    ap.add_argument("--mid-steps", type=int, default=2)
    ap.add_argument("--lease", type=float, default=None,
                    help="coord_lease override (short for harnesses)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-barrier timeout for the worker")
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--quorum", type=int, default=0,
                    help="worker/psave: wait for this many live members "
                         "before the registration barrier")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--parallel-save", action="store_true",
                    help="bench: fleet-parallel save vs one committer")
    ap.add_argument("--mode", choices=("single", "parallel"),
                    default="parallel",
                    help="psave: baseline committer or collective rank")
    ap.add_argument("--device", default=None,
                    help="where the client's codecs run and restores land: "
                         "cuda (default; raises without a card) or cpu")
    ap.add_argument("command",
                    choices=("status", "worker", "bench", "psave"))
    ap.add_argument("fleet_name", nargs="?", default="train")
    args = ap.parse_args(argv)
    if args.command in ("worker", "psave") and not args.host_id:
        ap.error(f"{args.command} requires --host-id")
    if args.command in ("worker", "psave") \
            and args.name_id == "client.fleet":
        # each worker process needs its own RADOS identity (fencing,
        # watch registrations) — derive it from the host id
        args.name_id = f"client.{args.host_id}"
    args.device = resolve_device(args.device)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
