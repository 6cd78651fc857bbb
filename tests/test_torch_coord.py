"""Twins of the coordination layer: ceph_tpu_torch.coord against ceph_tpu.coord.

The pure twins hold the fleet mesh, its slabs (`layout.fleet_slab` against
the port's `device_slices` on repeated-CPU-device meshes and jax's on the
virtual CPU devices), `fleet_spec`, `shard_tree`, the slab-aligned parallel
manifest and the rank-record merge equal to ceph_tpu's.

The live twins run tests/test_coord.py's and tests/test_ckpt_parallel.py's
scripts on both packages' in-process clusters (tests/test_torch_live.py's
shape): the cls lease semantics, the Lock wrapper, the roster, elections,
barriers and eviction, the single-committer failover, the data cursor
rebase and the fleet-parallel save with its abort, takeovers and gc pin.
Lease time advances through `cls_clock_offset`, never through sleeps. The
observations must be equal with these fields masked: `expiration`, `ttl`,
`since` and `now` (the OSD's clock, in the lock class's replies),
`lease_age` and `lease_ttl` (the same clock, in `Fleet.members`),
`leader_ttl` (in `Fleet.status`) and `joined` (`time.time()` in the roster
document, masked in the stored roster object too). Save ids are passed;
every other stored object must be byte-identical, and a save by either
package must restore in the other.

The process tests run the port's fleet_tool as worker and psave processes
with `--device cpu` (tests/test_fleet_live.py's and
tests/test_ckpt_parallel_live.py's stories).
"""

import asyncio
import importlib
import json
import os
import signal
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from ceph_tpu.ckpt import layout as ref_ckpt_layout
from ceph_tpu.coord import mesh as ref_mesh
from ceph_tpu_torch.ckpt import layout as port_ckpt_layout
from ceph_tpu_torch.coord import mesh as port_mesh
from ceph_tpu_torch.parallel.sharding import MeshArray
from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, REP_POOL, Cluster, Package, _port_racecheck_clean, run,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = ("host-a", "host-b", "host-c")
MASKED = ("expiration", "ttl", "since", "now", "lease_age", "lease_ttl", "leader_ttl",
          "joined")


def mods(name: str) -> SimpleNamespace:
    def m(x):
        return importlib.import_module(f"{name}.{x}")

    return SimpleNamespace(
        name=name, coord=m("coord"), mesh=m("coord.mesh"), lock=m("coord.lock"),
        CkptStore=m("ckpt.store").CkptStore, writer=m("ckpt.writer"), layout=m("ckpt.layout"),
        gc=m("ckpt.gc"), DataStore=m("data.store").DataStore, dlayout=m("data.layout"))


def fleet_mesh(name: str, n: int):
    if name == REF:
        return ref_mesh.fleet_mesh(n)
    return port_mesh.fleet_mesh(n, devices=["cpu"] * n)


def host(x) -> np.ndarray:
    """Any package's array on the host."""
    if isinstance(x, MeshArray):
        x = x.full("cpu")
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def mask(x):
    if isinstance(x, dict):
        return {k: ("<masked>" if k in MASKED else mask(v)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(mask(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    return x


def masked_stores(cluster) -> dict:
    """cluster.stores() with each roster document's `joined` masked."""
    out = {}
    for osd, rows in cluster.stores().items():
        out[osd] = {}
        for (coll, obj), (data, size, hinfo) in rows.items():
            if obj.endswith(".roster") and data:
                data = json.dumps(mask(json.loads(data)), sort_keys=True).encode()
            out[osd][(coll, obj)] = (data, size, hinfo)
    return out


def coord_twin(script, *args):
    """Run `script(cluster, M, *args)` on both packages (M: the package's
    modules): equal masked observations and equal stores."""
    out = {}
    for name in (REF, PORT):
        async def main(name=name):
            cluster = Cluster(Package(name))
            await cluster.start()
            try:
                rados = cluster.client(name="client.coord")
                await rados.connect()
                await cluster.create_pools(rados)
                obs = await script(cluster, rados, mods(name), *args)
                await rados.shutdown()
                return mask(obs), masked_stores(cluster)
            finally:
                await cluster.stop()

        out[name] = run(main(), timeout=180)
    (ref_obs, ref_stores), (port_obs, port_stores) = out[REF], out[PORT]
    assert port_obs == ref_obs
    assert sum(len(rows) for rows in ref_stores.values()) > 0
    assert port_stores == ref_stores


def jump_clock(cluster, seconds: float) -> None:
    cluster.cfg.set("cls_clock_offset", float(cluster.cfg.get("cls_clock_offset")) + seconds)


async def raised(coro):
    try:
        return await coro
    except Exception as e:  # noqa: BLE001 - the failure is the observation
        return e


async def log_has(admin, text: str, n: int = 30) -> bool:
    out = await admin.mon_command("log last", {"n": n})
    return any(text in ln["message"] for ln in out["lines"])


# -- pure twins -------------------------------------------------------------------


@pytest.mark.parametrize("rows,hosts", [(192, 3), (6, 3), (16, 2), (16, 4), (8, 8), (10, 3),
                                        (3, 8), (0, 2), (7, 8), (5, 2), (9, 4)])
def test_fleet_slab_matches_device_slices(rows, hosts):
    """layout.fleet_slab is the ceil-div convention: the port's rank_slab
    on a mesh of `hosts` repeated CPU devices agrees with it for every rank,
    uneven splits included, and so does jax's on the shapes it accepts."""
    slabs = [port_ckpt_layout.fleet_slab(rows, hosts, r) for r in range(hosts)]
    assert slabs == [ref_ckpt_layout.fleet_slab(rows, hosts, r) for r in range(hosts)]
    assert [i for s in slabs for i in range(s.start, s.stop)] == list(range(rows))
    mesh = fleet_mesh(PORT, hosts)
    spec = (port_ckpt_layout.FLEET_AXIS,)
    assert [port_mesh.rank_slab((rows, 4), spec, mesh, r)[0] for r in range(hosts)] == slabs
    if rows % hosts == 0:
        jm = fleet_mesh(REF, hosts)
        assert [ref_mesh.rank_slab((rows, 4), P(ref_ckpt_layout.FLEET_AXIS), jm, r)[0]
                for r in range(hosts)] == slabs
    for bad in ((8, 0, 0), (8, 2, 2)):
        with pytest.raises(ValueError):
            port_ckpt_layout.fleet_slab(*bad)


def tree_arrays() -> dict:
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((192, 16)).astype(np.float32),
            "b": np.arange(7, dtype=np.float32),
            "v": np.arange(24, dtype=np.int32).reshape(6, 4),
            "s": np.float32(2.5), "none": None,
            "emb": rng.integers(0, 9, (50257 // 100, 8)).astype(np.int16)}


def test_fleet_mesh_spec_and_shard_tree_match_ceph_tpu():
    """fleet_spec per shape; shard_tree's layout (each slot's index and
    bytes) equals jax's on the virtual CPU devices; the mesh raises as the
    reference's does."""
    for shape in ((192, 16), (7,), (6, 4), (), (3, 2), (0, 4), (12,)):
        for n in (1, 2, 3, 4):
            want = ref_mesh.fleet_spec(shape, n)
            assert port_mesh.fleet_spec(shape, n) == tuple(want), (shape, n)
    tree = tree_arrays()
    port = port_mesh.shard_tree(tree, fleet_mesh(PORT, 3))
    ref = ref_mesh.shard_tree(tree, fleet_mesh(REF, 3))
    assert port["none"] is None
    for key in tree:
        if tree[key] is None:
            continue
        by_dev = {s.device: s for s in ref[key].addressable_shards}
        want = [(tuple(by_dev[d].index), np.asarray(by_dev[d].data).tobytes())
                for d in ref[key].sharding.mesh.devices.flat]
        got = [(tuple(idx), t.numpy().tobytes()) for idx, t in port[key].slots]
        norm = [[tuple(sl.indices(n) for sl, n in zip(i, tree[key].shape)) for i, _ in s]
                for s in (want, got)]
        assert norm[1] == norm[0] and [b for _, b in got] == [b for _, b in want], key
    for n, devices in ((0, ["cpu"]), (3, ["cpu"] * 2)):
        with pytest.raises(ValueError):
            port_mesh.fleet_mesh(n, devices=devices)


@pytest.mark.parametrize("chunk_size", [1000, 1 << 20])
@pytest.mark.parametrize("hosts", [2, 3])
def test_parallel_manifest_matches_ceph_tpu(chunk_size, hosts):
    """The slab-aligned writers=N manifest and its writer regions, built
    from each package's shard_tree of one tree, are byte-identical."""
    got = []
    for name, layout, mesh_mod in ((REF, ref_ckpt_layout, ref_mesh),
                                   (PORT, port_ckpt_layout, port_mesh)):
        recs = layout.flatten_tree(mesh_mod.shard_tree(tree_arrays(), fleet_mesh(name, hosts)))
        m = layout.build_manifest("m", "sid", recs, chunk_size=chunk_size, writers=hosts)
        got.append((layout.encode_manifest(m), layout.writer_regions(m["arrays"], hosts)))
    assert got[1] == got[0]
    assert b'"writer"' in got[0][0]


class _Cfg:
    def get(self, key):
        return {"ckpt_compression_algorithm": "", "ckpt_chunk_target_bytes": 512,
                "ckpt_incremental": False}.get(key, 0)


def test_merge_rank_meta_matches_ceph_tpu():
    """Each rank's fingerprinted record, the leader's merge, and the abort
    on a missing record: equal to ceph_tpu's."""
    out = []
    for name in (REF, PORT):
        M = mods(name)
        tree = {"w": np.arange(512, dtype=np.float32), "b": np.ones(3, np.float64)}

        def writer(rank):
            w = M.writer.CkptWriter(None, "m", tree, save_id="sid0", config=_Cfg())
            w.rank = rank
            w._records = M.layout.flatten_tree(tree)
            w.manifest = M.layout.build_manifest("m", "sid0", w._records, chunk_size=512,
                                                 writers=2)
            return w

        def meta(w):
            own = w.owned_chunks()
            w._fingerprint([c for _, c in own])
            return {"save_id": w.save_id, "rank": w.rank,
                    "chunks": {str(i): {f: c[f] for f in w._META_FIELDS} for i, c in own}}

        metas = [meta(writer(r)) for r in range(2)]
        leader = writer(0)
        leader.merge_rank_meta(metas)
        gap = writer(0)
        with pytest.raises(M.writer.CkptAborted) as err:
            gap.merge_rank_meta(metas[:1])
        out.append((metas, M.layout.encode_manifest(leader.manifest), str(err.value)))
    assert out[1] == out[0]


def test_coord_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from ceph_tpu_torch.coord import FleetDriver
    from ceph_tpu_torch.tools import data_tool, fleet_tool

    with pytest.raises(RuntimeError, match="cuda"):
        port_mesh.fleet_mesh(1)
    with pytest.raises(RuntimeError, match="cuda"):
        port_mesh.fleet_mesh(2, devices=["cuda:0"] * 2)
    fleet = SimpleNamespace(rank=lambda: asyncio.sleep(0, (0, 1)))
    with pytest.raises(RuntimeError, match="cuda"):
        asyncio.run(FleetDriver(fleet).mesh())
    assert asyncio.run(FleetDriver(fleet, devices=["cpu"]).mesh())[0].device_type == "cpu"
    for tool, argv in ((data_tool, ["ls", "x"]), (data_tool, ["bench", "--mb", "1"]),
                       (fleet_tool, ["status"]), (fleet_tool, ["bench", "--hosts", "2"])):
        with pytest.raises(RuntimeError, match="cuda"):
            tool.main(argv)


# -- live twins: locks, the roster, barriers ------------------------------------------


async def lock_round(cluster, admin, M) -> dict:
    """tests/test_coord.py's cls lease semantics (leases, conflicts, the
    cookie check, renewal, the renew-vs-break race, shared leases on the EC
    pool) and the Lock wrapper breaking a dead holder."""
    io, ec = admin.io_ctx(REP_POOL), admin.io_ctx(EC_POOL)
    a = {"name": "L", "owner": "host-a", "cookie": "ca"}
    b = {"name": "L", "owner": "host-b", "cookie": "cb"}
    obs = []

    async def do(ctx, obj, method, args):
        obs.append((obj, method, await raised(ctx.exec(obj, "lock", method, args))))
        return obs[-1][2]

    info = lambda ctx, obj, n: do(ctx, obj, "get_info", {"name": n})  # noqa: E731
    await do(io, "obj", "lock", dict(a, duration=5.0))
    (h,) = (await info(io, "obj", "L"))["holders"]
    assert not h["expired"] and 0 < h["ttl"] <= 5.0
    await do(io, "obj", "lock", dict(b, duration=5.0))
    await do(io, "obj", "break_lock", {"name": "L", "owner": "host-a", "if_expired": True})
    await do(io, "obj", "unlock", {"name": "L", "owner": "host-a", "cookie": "WRONG"})
    jump_clock(cluster, 3.0)
    assert (await do(io, "obj", "lock", dict(a, duration=5.0)))["renewed"]
    assert (await info(io, "obj", "L"))["holders"][0]["ttl"] > 4.0
    jump_clock(cluster, 6.0)
    assert (await info(io, "obj", "L"))["holders"][0]["expired"]
    await do(io, "obj", "lock", dict(a, duration=5.0))
    await do(io, "obj", "break_lock", {"name": "L", "owner": "host-a", "if_expired": True})
    jump_clock(cluster, 6.0)
    assert (await do(io, "obj", "break_lock", {"name": "L", "owner": "host-a",
                                               "if_expired": True}))["broken"] == 1
    await do(io, "obj", "lock", dict(b, duration=5.0))
    shared = {"type": "shared", "duration": 5.0, "name": "S"}
    await do(ec, "eobj", "lock", dict(shared, owner="host-a", cookie="ca"))
    await do(ec, "eobj", "lock", dict(shared, owner="host-b", cookie="cb"))
    await do(ec, "eobj", "lock", {"name": "S", "owner": "host-c", "cookie": "cc"})
    assert len((await info(ec, "eobj", "S"))["holders"]) == 2
    jump_clock(cluster, 6.0)
    await do(ec, "eobj", "lock", {"name": "S", "owner": "host-c", "cookie": "cc"})
    await info(ec, "eobj", "S")

    perf = M.lock.make_coord_perf("t2")
    dead = M.coord.Lock(io, "dobj", "D", owner="host-a", cookie="a", lease=30.0)
    await dead.acquire(block=False)
    dead._stop_renew()
    taker = M.coord.Lock(io, "dobj", "D", owner="host-b", cookie="b", lease=30.0, perf=perf)
    obs.append(await raised(taker.acquire(block=False)))
    jump_clock(cluster, 31.0)
    await taker.acquire(block=False)
    obs.append((taker.locked, perf.dump()["lock_breaks"], await log_has(admin, "lock broken")))
    await taker.release()
    return {"calls": obs}


def test_port_lock_leases_match_ceph_tpu():
    coord_twin(lock_round)


async def make_fleet(cluster, M, host_id, pool=REP_POOL, name="train"):
    rados = cluster.client(name=f"client.{host_id}")
    await rados.connect()
    return rados, M.coord.Fleet(rados.io_ctx(pool), name, host_id)


async def fleet_round(cluster, admin, M) -> dict:
    """tests/test_coord.py's roster story: three hosts join, the first
    elects, two epoch barriers, status; then the leader dies without
    leaving, its lease lapses, a survivor's maintenance pass takes the seat
    and evicts it, and the shrunken fleet barriers on."""
    handles = [await make_fleet(cluster, M, h) for h in HOSTS]
    fa, fb, fc = (f for _, f in handles)
    events = []
    fb.on_change(lambda ev, h: events.append((ev, h)))
    obs = {"join": [await f.join() for f in (fa, fb, fc)]}
    obs["ranks"] = [await f.rank() for f in (fa, fb, fc)]
    obs["elect"] = [await fa.elect(), await fb.elect(), [f.is_leader for f in (fa, fb, fc)],
                    await fc.leader()]
    obs["barriers"] = [await asyncio.gather(*(f.barrier(timeout=30) for f in (fa, fb, fc)))
                       for _ in range(2)]
    d = fb.perf.dump()
    obs["barrier_perf"] = (d["barriers"], d["barrier_wait"]["avgcount"])
    obs["status"] = await fa.status()
    assert obs["status"]["leader_ttl"] > 0
    obs["leader_log"] = await log_has(admin, "leader changed")

    await fa.close()
    jump_clock(cluster, float(cluster.cfg.get("coord_lease")) + 1.0)
    await fb._member_lock.acquire(block=False)
    await fc._member_lock.acquire(block=False)
    await fb._maintain()
    obs["after"] = [fb.is_leader, await fb.sweep(), await fb.live_members(),
                    await fb.rank(), await fc.rank(), sorted(await fb.members())]
    obs["evicted"] = [await log_has(admin, "host lease expired"), ("evict", "host-a") in events]
    obs["shrunk"] = await asyncio.gather(fb.barrier(timeout=30), fc.barrier(timeout=30))
    for f in (fb, fc):
        await f.leave()
    obs["final"] = await fb.status()
    for rados, _ in handles:
        await rados.shutdown()
    return obs


def test_port_fleet_roster_election_barriers_eviction_match_ceph_tpu():
    coord_twin(fleet_round)


async def subgroup_round(cluster, admin, M) -> dict:
    """Sub-group barriers under tags: a subset meets without the rest,
    disjoint tags do not interfere, the untagged epochs are untouched, a
    tag steps its own epochs, a listed member that left is ignored."""
    handles = [await make_fleet(cluster, M, h) for h in HOSTS]
    fa, fb, fc = (f for _, f in handles)
    for f in (fa, fb, fc):
        await f.join()
    pair, duo = ["host-a", "host-b"], ["host-b", "host-c"]
    obs = [await asyncio.gather(fa.barrier(members=pair, tag="stage0", timeout=30),
                                fb.barrier(members=pair, tag="stage0", timeout=30)),
           await asyncio.gather(fb.barrier(members=duo, tag="stage1", timeout=30),
                                fc.barrier(members=duo, tag="stage1", timeout=30)),
           await asyncio.gather(*(f.barrier(timeout=30) for f in (fa, fb, fc))),
           await asyncio.gather(fa.barrier(members=pair, tag="stage0", epoch=1, timeout=30),
                                fb.barrier(members=pair, tag="stage0", epoch=1, timeout=30))]
    await fc.leave()
    obs.append(await asyncio.gather(fa.barrier(members=list(HOSTS), tag="s2", timeout=30),
                                    fb.barrier(members=list(HOSTS), tag="s2", timeout=30)))
    for f in (fa, fb):
        await f.leave()
    for rados, _ in handles:
        await rados.shutdown()
    return {"barriers": obs}


async def watch_round(cluster, admin, M) -> dict:
    """A blocked waiter is woken by the holder's release notify: the poll
    interval is far beyond the test's timeout."""
    cluster.cfg.set("coord_barrier_poll", 60.0)
    io = admin.io_ctx(REP_POOL)
    perf = M.lock.make_coord_perf("t")
    holder = M.coord.Lock(io, "wobj", "W", owner="host-a", cookie="a", lease=0, perf=perf)
    waiter = M.coord.Lock(io, "wobj", "W", owner="host-b", cookie="b", lease=0, perf=perf)
    await holder.acquire(block=False)
    obs = [perf.dump()["locks_held"]]
    task = asyncio.ensure_future(waiter.acquire(block=True))
    await cluster.wait_until(lambda: waiter._watching, timeout=20)
    obs.append(task.done())
    await holder.release()
    await asyncio.wait_for(task, 10)
    obs += [waiter.locked, await waiter.info()]
    await waiter.release()
    obs.append(perf.dump()["locks_held"])
    cluster.cfg.set("coord_barrier_poll", 1.0)
    return {"watch": obs}


@pytest.mark.slow
@pytest.mark.parametrize("script", [subgroup_round, watch_round], ids=["subgroups", "watch"])
def test_port_barrier_subgroups_and_lock_wakeups_match_ceph_tpu(script):
    coord_twin(script)


# -- live twins: the driver --------------------------------------------------------


async def committer_round(cluster, admin, M) -> dict:
    """Exactly one committer; per-rank sharded restore; the leader dies
    mid-save, HEAD holds, the survivor breaks the dead committer lease and
    commits."""
    handles = [await make_fleet(cluster, M, h) for h in HOSTS[:2]]
    (ra, fa), (rb, fb) = handles
    await fa.join()
    await fb.join()
    da = M.coord.FleetDriver(fa, ckpt=M.CkptStore(ra.io_ctx(REP_POOL), "model"))
    db = M.coord.FleetDriver(fb, ckpt=M.CkptStore(rb.io_ctx(REP_POOL), "model"))
    tree = {"w": np.arange(32, dtype=np.float32).reshape(8, 4),
            "b": np.ones((4,), dtype=np.float32)}
    ps = await da.save(tree, save_id="c1")
    obs = {"first": [ps is not None, fa.is_leader, await db.save(tree) is None,
                     await da.drain()]}
    obs["shards"] = [await da.restore_shard("w"), await db.restore_shard("w")]
    ps2 = await da.save({"w": tree["w"] + 1.0, "b": tree["b"] * 2}, save_id="c2")
    ps2.cancel()
    da.committer_lock()._stop_renew()
    await fa.close()
    jump_clock(cluster, float(cluster.cfg.get("coord_lease")) + 1.0)
    await fb._member_lock.acquire(block=False)
    obs["held"] = (await db.ckpt.head())["save_id"]
    tree3 = {"w": tree["w"] * 3.0, "b": tree["b"] + 5}
    ps3 = await db.save(tree3, save_id="c3")
    obs["takeover"] = [ps3 is not None, fb.is_leader, await db.drain(),
                       (await db.ckpt.head())["save_id"]]
    kw = {"device": "cpu"} if M.name == PORT else {}
    back = await db.restore(**kw)
    obs["restored"] = {k: host(v) for k, v in back.items()}
    assert all(np.array_equal(obs["restored"][k], tree3[k]) for k in tree3)
    await fb.leave()
    for rados, _ in handles:
        await rados.shutdown()
    return obs


async def cursor_round(cluster, admin, M) -> dict:
    """Three hosts consume a stride-partitioned prefix; the fleet shrinks
    to two; the rebased cursor resumes with zero duplicate and zero missing
    records."""
    store = M.DataStore(admin.io_ctx(REP_POOL), "corpus")
    records = [f"rec-{i:04d}".encode() for i in range(97)]
    await store.ingest(records, ingest_id="corpus0")
    iters = [await store.iterator(seed=7, batch_size=4, num_hosts=3, host=h,
                                  partition="stride") for h in range(3)]
    seen = [[list(await it.__anext__()) for _ in range(3)] for it in iters]
    cursor = iters[0].state()
    rest = []
    for h in range(2):
        cur = M.dlayout.rebase_cursor(cursor, num_hosts=2, host=h)
        rest.append([list(b) async for b in await store.resume(cur)])
    flat = [r for s in seen + rest for b in s for r in b]
    assert sorted(flat) == sorted(records) and len(flat) == len(records)
    return {"seen": seen, "cursor": cursor, "rest": rest}


@pytest.mark.slow
@pytest.mark.parametrize("script", [committer_round, cursor_round], ids=["committer", "cursor"])
def test_port_driver_committer_and_cursor_match_ceph_tpu(script):
    coord_twin(script)


# -- live twins: the fleet-parallel save ------------------------------------------------


async def fleet_drivers(cluster, M, hosts=HOSTS, pool=REP_POOL):
    out = []
    for h in hosts:
        rados, fleet = await make_fleet(cluster, M, h, pool)
        await fleet.join()
        kw = {"devices": ["cpu"] * len(HOSTS)} if M.name == PORT else {}
        out.append((rados, M.coord.FleetDriver(
            fleet, ckpt=M.CkptStore(rados.io_ctx(pool), "model"), **kw)))
    return out


async def parallel_round(cluster, admin, M) -> dict:
    """tests/test_ckpt_parallel.py's round trip: one collective save of a
    fleet-sharded tree by three ranks (each preparing about a third),
    restore_mesh, one rank's shards, a second save that dedups; then the
    OTHER package restores both saves."""
    handles = await fleet_drivers(cluster, M)
    drivers = [d for _, d in handles]
    assert await drivers[0].fleet.elect()
    tree = {"w": np.arange(192 * 16, dtype=np.float32).reshape(192, 16),
            "b": np.arange(16, dtype=np.float32)}
    tree_bytes = sum(a.nbytes for a in tree.values())
    mesh = fleet_mesh(M.name, 3)
    saves = [await d.save_async(M.mesh.shard_tree(tree, mesh), save_id="p0", timeout=60)
             for d in drivers]
    obs = {"sids": await asyncio.gather(*(s.wait() for s in saves)),
           "leaders": [s.leader for s in saves]}
    prepared = [d.ckpt.perf_dump()["save_prepared_bytes"] for d in drivers]
    assert all(0 < p <= 0.6 * tree_bytes for p in prepared), prepared
    obs["prepared"] = prepared
    restored = await drivers[1].restore_mesh()
    obs["mesh"] = {k: host(v) for k, v in restored.items()}
    before = drivers[2].ckpt.perf_dump()["restore_host_bytes"]
    obs["rank2"] = await drivers[2].restore_rank_shards()
    obs["fetched"] = drivers[2].ckpt.perf_dump()["restore_host_bytes"] - before
    tree2 = dict(tree, b=tree["b"] + 1)
    saves = [await d.save_async(M.mesh.shard_tree(tree2, mesh), save_id="p1", timeout=60)
             for d in drivers]
    obs["sids"] += await asyncio.gather(*(s.wait() for s in saves))
    manifest = await drivers[0].ckpt.reader().read_manifest("p1")
    obs["reused"] = [c["reused"] for c in manifest["chunks"]]
    assert any(obs["reused"]) and not all(obs["reused"])
    obs["staging"] = await drivers[0]._read_staging()
    other = mods(REF if M.name == PORT else PORT)
    foreign = cluster.client(Package(other.name), "client.foreign")
    await foreign.connect()
    store = other.CkptStore(foreign.io_ctx(REP_POOL), "model")
    kw = {"device": "cpu"} if other.name == PORT else {}
    for sid, want in (("p0", tree), ("p1", tree2)):
        back = await store.restore(save_id=sid, **kw)
        assert all(np.array_equal(host(back[k]), want[k]) for k in want), sid
    await foreign.shutdown()
    for rados, d in handles:
        await d.fleet.leave()
        await rados.shutdown()
    return obs


def test_port_fleet_parallel_save_matches_ceph_tpu():
    coord_twin(parallel_round)


async def abort_round(cluster, admin, M) -> dict:
    """A non-leader writer dies mid-save: the save aborts, HEAD holds, and
    the survivors' elastic re-save over two hosts commits."""
    handles = await fleet_drivers(cluster, M)
    drivers = [d for _, d in handles]
    assert await drivers[0].fleet.elect()
    tree = {"w": np.arange(192 * 16, dtype=np.float32).reshape(192, 16)}
    sharded = M.mesh.shard_tree(tree, fleet_mesh(M.name, 3))
    saves = [await d.save_async(sharded, save_id="a0", timeout=60) for d in drivers]
    obs = {"first": await asyncio.gather(*(s.wait() for s in saves))}
    h0 = await drivers[0].save_async(sharded, save_id="a1", timeout=60)
    h1 = await drivers[1].save_async(sharded, timeout=60)
    while True:
        doc = await drivers[0]._read_staging()
        if doc and doc["state"] == "staged" and doc["save_id"] == "a1":
            break
        await asyncio.sleep(0)
    obs["staged"] = doc
    await drivers[2].fleet._member_lock.release()
    obs["aborted"] = await asyncio.gather(h0.wait(), h1.wait(), return_exceptions=True)
    assert all(isinstance(e, M.writer.CkptAborted) for e in obs["aborted"])
    obs["head"] = (await drivers[0].ckpt.head())["save_id"]
    obs["staging"] = await drivers[0]._read_staging()
    sharded2 = M.mesh.shard_tree({"w": tree["w"] + 1}, fleet_mesh(M.name, 2))
    h0 = await drivers[0].save_async(sharded2, save_id="a2", timeout=60)
    h1 = await drivers[1].save_async(sharded2, timeout=60)
    obs["resave"] = await asyncio.gather(h0.wait(), h1.wait())
    obs["mesh"] = host((await drivers[1].restore_mesh())["w"])
    assert np.array_equal(obs["mesh"], tree["w"] + 1)
    for rados, d in handles[:2]:
        await d.fleet.leave()
    for rados, _ in handles:
        await rados.shutdown()
    return obs


async def takeover_round(cluster, admin, M, staged: bool) -> dict:
    """The leader dies after staging (the follower commits ITS save) or
    before staging anything (the follower leads its own save)."""
    handles = await fleet_drivers(cluster, M, HOSTS[:2])
    da, db = (d for _, d in handles)
    fa = da.fleet
    assert await fa.elect()
    tree = {"w": np.arange(64, dtype=np.float32).reshape(16, 4)}
    h1 = await db.save_async(tree, save_id="fresh0000000000", timeout=60)
    if staged:
        sid, hosts = "feedc0de00000001", ["host-a", "host-b"]
        wa = da.ckpt.writer(tree, save_id=sid)
        await da._staging_cas({"save_id": sid, "state": "staged", "hosts": hosts,
                               "parent": None})
        wa.prepare_parallel(2, 0)
        await wa.put_rank_meta(await wa.put_rank_chunks())
        await fa.barrier(tag=f"save.{sid}", members=hosts, timeout=60)
    await fa._member_lock.release()
    await fa._leader_lock.release()
    obs = {"sid": await h1.wait(), "leader": h1.leader,
           "head": (await db.ckpt.head())["save_id"], "staging": await db._read_staging()}
    kw = {"device": "cpu"} if M.name == PORT else {}
    obs["restored"] = host((await db.restore(**kw))["w"])
    assert np.array_equal(obs["restored"], tree["w"])
    await db.fleet.leave()
    for rados, _ in handles:
        await rados.shutdown()
    return obs


async def gc_pin_round(cluster, admin, M) -> dict:
    """A staged save's rank output is pinned against gc until the staging
    record settles; once aborted it is debris."""
    io = admin.io_ctx(REP_POOL)
    store = M.CkptStore(io, "model")
    sid0 = await (await store.save_async({"w": np.ones(8, dtype=np.float32)},
                                         save_id="g0")).wait()
    sid = "feed0000feed0000"
    chunk = M.layout.chunk_object_name("model", sid, 0)
    meta = M.layout.rank_meta_object("model", sid, 1)
    await io.write_full(chunk, b"x" * 64)
    await io.write_full(meta, b"{}")
    doc = {"save_id": sid, "state": "staged", "hosts": ["host-a", "host-b"], "parent": None}
    await io.write_full(M.layout.staging_object("model"), json.dumps(doc).encode())
    pinned = await M.gc.collect(io, "model")
    assert chunk in pinned["kept"] and meta in pinned["kept"] and pinned["head"] == sid0
    await io.write_full(M.layout.staging_object("model"),
                        json.dumps(dict(doc, state="aborted")).encode())
    freed = await M.gc.collect(io, "model")
    assert chunk in freed["removed"] and meta in freed["removed"]
    return {"pinned": pinned, "freed": freed}


@pytest.mark.slow
@pytest.mark.parametrize("script,args", [(abort_round, ()), (takeover_round, (True,)),
                                         (takeover_round, (False,)), (gc_pin_round, ())],
                         ids=["abort", "takeover-staged", "takeover-unstaged", "gc-pin"])
def test_port_parallel_save_failures_match_ceph_tpu(script, args):
    coord_twin(script, *args)


# -- the port's fleet_tool processes ---------------------------------------------------


async def spawn_tool(mon_host: str, *argv: str):
    return await asyncio.create_subprocess_exec(
        sys.executable, "-m", "ceph_tpu_torch.tools.fleet_tool", "--mon-host", mon_host,
        "--pool", str(REP_POOL), "--device", "cpu", "--lease", "2.0", "--timeout", "120",
        *argv, stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def events(raw: bytes) -> list[dict]:
    return [json.loads(ln) for ln in raw.decode().splitlines() if ln]


async def harvest(procs) -> list[list[dict]]:
    outs = await asyncio.gather(*(p.communicate() for p in procs))
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    return [events(out) for out, _ in outs]


async def read_until(proc, event: str) -> list[dict]:
    seen = []
    while not seen or seen[-1].get("event") != event:
        line = await asyncio.wait_for(proc.stdout.readline(), timeout=120)
        assert line, f"the process exited before {event}"
        seen.append(json.loads(line))
    return seen


@pytest.mark.slow
def test_port_fleet_tool_workers_survive_the_leader_killed_mid_save():
    """tests/test_fleet_live.py with the port's fleet_tool workers: SIGKILL
    the leader mid-save; the survivors re-elect, restore the committed
    HEAD and resume with zero duplicate and zero missing acked records."""
    pre, mid, batch, records = 3, 2, 4, [f"rec-{i:04d}".encode() for i in range(96)]

    async def main():
        from ceph_tpu_torch.data.store import DataStore

        cluster = Cluster(Package(PORT))
        await cluster.start()
        admin = cluster.client(name="client.fleetadmin")
        await admin.connect()
        await cluster.create_pools(admin)
        mon = ",".join(f"{h}:{p}" for h, p in cluster.monmap.addrs)
        try:
            await DataStore(admin.io_ctx(REP_POOL), "corpus").ingest(records)
            shape = ["--seed", "7", "--batch", str(batch), "--pre-steps", str(pre),
                     "--mid-steps", str(mid), "--quorum", "3", "worker", "train"]
            victim = await spawn_tool(mon, "--host-id", "host-a", "--role", "victim", *shape)
            survivors = [await spawn_tool(mon, "--host-id", h, *shape)
                         for h in ("host-b", "host-c")]
            victim_events = await read_until(victim, "mid_save")
            victim.send_signal(signal.SIGKILL)
            await victim.wait()
            sb, sc = await harvest(survivors)
            (rb,), (rc,) = ([e for e in ev if e["event"] == "resumed"] for ev in (sb, sc))
            assert rb["head"] == rc["head"] and rb["live"] == ["host-b", "host-c"]
            (commit,) = [e for e in victim_events if e["event"] == "commit"]
            acked_steps = pre if rb["head"] == commit["save_id"] else pre + mid
            assert rb["position"] == 0 and rb["base"] == acked_steps * batch * 3
            assert rb["w_sum"] == 32.0 * acked_steps
            acked = [i for ev in (victim_events, sb, sc) for e in ev
                     if e["event"] == "batch" and e["step"] < acked_steps for i in e["ids"]]
            resumed = [i for ev in (sb, sc) for e in ev if e["event"] == "rbatch"
                       for i in e["ids"]]
            assert sorted(acked + resumed) == sorted(r.decode() for r in records)
            assert len(acked) + len(resumed) == len(records)
            assert len([e for ev in (sb, sc) for e in ev if e["event"] == "final_commit"]) == 1
            for text in ("host lease expired", "leader changed", "lock broken"):
                assert await log_has(admin, text, 100), text
            proc = await spawn_tool(mon, "status", "train")
            out, err = await proc.communicate()
            assert proc.returncode == 0, err.decode()
            status = json.loads(out.decode())
            assert status["leader"] is None and status["members"] == {}
        finally:
            await admin.shutdown()
            await cluster.stop()

    run(main(), timeout=300)


@pytest.mark.slow
def test_port_fleet_tool_psave_aborts_on_a_killed_writer_then_commits():
    """tests/test_ckpt_parallel_live.py with the port's psave hosts: a
    collective save commits; a non-leader writer SIGKILLed mid-put aborts
    the next, HEAD holds; the two survivors commit the same tree."""
    hosts, mb = 3, 8
    rng = np.random.default_rng(0)
    rows = hosts * max(1, (mb << 20) // hosts // 4096)
    w = rng.integers(0, 256, (rows, 4096), dtype=np.uint8)

    async def main():
        from ceph_tpu_torch.ckpt.store import CkptStore

        cluster = Cluster(Package(PORT))
        await cluster.start()
        admin = cluster.client(name="client.fleetadmin")
        await admin.connect()
        await cluster.create_pools(admin)
        mon = ",".join(f"{h}:{p}" for h, p in cluster.monmap.addrs)
        store = CkptStore(admin.io_ctx(REP_POOL), "model")

        def psave(host_id, role, fleet, quorum):
            return spawn_tool(mon, "--host-id", host_id, "--role", role, "--hosts", str(hosts),
                              "--mb", str(mb), "--ckpt-name", "model", "--quorum", str(quorum),
                              "psave", fleet)

        async def restored():
            return (await store.restore(device="cpu"))["w"].numpy()

        try:
            outs = await harvest([await psave("host-a", "leader", "p1", 3),
                                  await psave("host-b", "survivor", "p1", 3),
                                  await psave("host-c", "survivor", "p1", 3)])
            (sid0,) = {e["save_id"] for ev in outs for e in ev if e["event"] == "psave"}
            assert np.array_equal(await restored(), w)
            leader = await psave("host-a", "leader", "p2", 3)
            surv = await psave("host-b", "survivor", "p2", 3)
            victim = await psave("host-c", "victim", "p2", 3)
            await read_until(victim, "parked")
            victim.send_signal(signal.SIGKILL)
            await victim.wait()
            outs = await harvest([leader, surv])
            assert len([e for ev in outs for e in ev if e["event"] == "aborted"]) == 2
            assert (await store.head())["save_id"] == sid0
            staging = json.loads((await admin.io_ctx(REP_POOL).read("model.ckpt-staging")).decode())
            assert staging["state"] == "aborted" and np.array_equal(await restored(), w)
            outs = await harvest([await psave("host-a", "leader", "p3", 2),
                                  await psave("host-b", "survivor", "p3", 2)])
            (sid2,) = {e["save_id"] for ev in outs for e in ev if e["event"] == "psave"}
            assert sid2 != sid0 and (await store.head())["save_id"] == sid2
            assert np.array_equal(await restored(), w)
        finally:
            await admin.shutdown()
            await cluster.stop()

    run(main(), timeout=300)
