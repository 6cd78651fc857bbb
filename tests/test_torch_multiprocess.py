"""The port's multi-process cluster: `vstart.VStart`, the daemon mains
(`python -m ceph_tpu_torch.{mon,osd}`) and `daemon_bench --multiprocess`,
held against ceph_tpu's codec; and the revival twin of the live tier.

A cluster twin boots the port's daemons as real processes on the CPU
(`device="cpu"`, one intra-op thread a child), writes seeded objects into
an EC k=2 m=2 pool, SIGKILLs one OSD, reads every object degraded, restarts
the OSD over its surviving store and reads again; then it stops every
daemon with SIGTERM (each must exit 0) and reads the stores offline with the
port's `objectstore_tool`: every EC shard and its hinfo digest must equal
what ceph_tpu's codec makes of the object's bytes (tolerance 0). The tier-1
case has one monitor (a quorum of one, out of reach of the reference's
election flake); the 3-monitor and blockstore cases are `slow`.

The revival twin (`slow`) runs the live smoke's revival sequence in one
process, in both packages: isa k=8 m=3 over 12 OSDs, two members of one
PG stopped and marked down, revived on empty stores, recovered; it counts
the acting positions each package leaves without their shard.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every daemon child on the CPU with one intra-op thread: five torch
#: processes under `-n 6` would otherwise oversubscribe the cores
CHILD_ENV = {"OMP_NUM_THREADS": "1"}
EC_POOL = 2
PROFILE = {"plugin": "tpu", "k": "2", "m": "2"}


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def wait_until(pred, timeout=90.0):
    """Re-checks `pred` at each message this process's messengers dispatch."""
    from ceph_tpu_torch.msg.messenger import next_dispatch_event

    loop = asyncio.get_running_loop()
    end = loop.time() + timeout
    while not pred():
        remaining = end - loop.time()
        if remaining <= 0:
            raise TimeoutError
        try:
            await asyncio.wait_for(next_dispatch_event(), min(0.25, remaining))
        except asyncio.TimeoutError:
            pass


def expected_shards(objects: dict) -> dict:
    """{(name, position): (chunk bytes, hinfo digest)} by ceph_tpu's codec."""
    from ceph_tpu.common.crc import ceph_crc32c
    from ceph_tpu.ec.registry import factory
    from ceph_tpu.osd.ecutil import SEED

    codec = factory(PROFILE["plugin"], {k: v for k, v in PROFILE.items() if k != "plugin"})
    n = codec.get_chunk_count()
    out = {}
    for name, data in objects.items():
        for pos, chunk in codec.encode(range(n), data).items():
            out[(name, pos)] = (bytes(chunk), ceph_crc32c(SEED, bytes(chunk)))
    return out


def offline_shards(run_dir: str, n_osds: int) -> dict:
    """{(name, position): [(osd, bytes, total_chunk_size, digest)]} of every
    EC shard in the stopped OSDs' stores, read with the port's tool."""
    from ceph_tpu_torch.tools.objectstore_tool import open_store

    found: dict = {}
    for osd in range(n_osds):
        store, _backend = open_store(os.path.join(run_dir, f"osd.{osd}.kv"))
        try:
            for coll in store.list_collections():
                if not coll.startswith(f"pg_{EC_POOL}_"):
                    continue
                for obj in store.list_objects(coll):
                    base, sep, pos = obj.rpartition(".s")
                    if not (sep and pos.isdigit()):
                        continue
                    hinfo = store.getattrs(coll, obj)["hinfo"]
                    found.setdefault((base, int(pos)), []).append(
                        (osd, store.read(coll, obj), hinfo.total_chunk_size,
                         hinfo.cumulative_shard_hashes[int(pos)]))
        finally:
            if hasattr(store, "close"):
                store.close()
            else:
                store.db.close()
    return found


async def crash_and_revive(v, objects: dict) -> None:
    """Writes, reads, SIGKILL of one OSD marked down by command, degraded
    reads, the OSD restarted over its store, reads again."""
    await asyncio.to_thread(v.wait_started, 120)
    r = v.client()
    await r.connect()
    await v.wait_healthy(rados=r, timeout=120)
    await r.mon_command("osd erasure-code-profile set", {"name": "k2m2", "profile": PROFILE})
    await r.mon_command("osd pool create", {"pool_id": EC_POOL, "crush_rule": 0,
                                            "erasure_code_profile": "k2m2", "pg_num": 8})
    io = r.io_ctx(EC_POOL)
    await asyncio.gather(*(io.write_full(name, data) for name, data in objects.items()))
    for name, data in objects.items():
        assert await io.read(name) == data
    victim = r.objecter._calc_target(EC_POOL, next(iter(objects)))
    v.kill_osd(victim, sig=signal.SIGKILL)
    await r.mon_command("osd down", {"osd": victim})
    await wait_until(lambda: not r.objecter.osdmap.osd_up[victim])
    for name, data in objects.items():
        assert await io.read(name) == data, f"degraded read of {name}"
    v.start_osd(victim)
    await v.wait_healthy(rados=r, timeout=120)
    for name, data in objects.items():
        assert await io.read(name) == data, f"read of {name} after the restart"
    await r.shutdown()


def seeded_objects(seed: int, count: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"mp-{i}": rng.bytes(int(rng.integers(1, 48 << 10))) for i in range(count)}


@pytest.mark.parametrize("mons,objectstore", [
    (1, "kstore-file"),
    pytest.param(3, "kstore-file", marks=pytest.mark.slow),
    pytest.param(1, "blockstore", marks=pytest.mark.slow),
    pytest.param(3, "blockstore", marks=pytest.mark.slow),
])
def test_multiprocess_crash_revival_against_ceph_tpu_codec(mons, objectstore, tmp_path):
    from ceph_tpu_torch.vstart import VStart

    n_osds = 5
    v = VStart(str(tmp_path), n_mons=mons, n_osds=n_osds, device="cpu", env=CHILD_ENV,
               config={"osd_objectstore": objectstore, "osd_heartbeat_grace": 60})
    objects = seeded_objects(9, 12)
    v.start()
    try:
        pids = {p.pid for p in v.mons.values()} | {p.pid for p in v.osds.values()}
        assert len(pids) == mons + n_osds and os.getpid() not in pids
        run(crash_and_revive(v, objects))
    finally:
        rcs = v.stop(signal.SIGTERM)
    assert rcs == {name: 0 for name in rcs} and len(rcs) == mons + n_osds
    want = expected_shards(objects)
    found = offline_shards(str(tmp_path), n_osds)
    assert set(found) == set(want)
    for key, copies in found.items():
        chunk, digest = want[key]
        for osd, data, size, crc in copies:
            assert (data, size, crc) == (chunk, len(chunk), digest), (key, osd)


def test_entry_points_need_a_device(tmp_path, monkeypatch):
    """Without a device a daemon main exits non-zero with resolve_device's
    message, and VStart and `daemon_bench --multiprocess` raise; with
    device="cpu" VStart builds nothing before it spawns."""
    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.native import build as native_build
    from ceph_tpu_torch.ops import cuda_build
    from ceph_tpu_torch.tools import daemon_bench

    spec = vstart.ClusterSpec(mon_addrs=[("127.0.0.1", 1)], n_osds=1, run_dir=str(tmp_path))
    spec.save(str(tmp_path / "spec.json"))
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.osd", "--id", "0", "--spec",
         str(tmp_path / "spec.json")], cwd=REPO_ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, **CHILD_ENV})
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    with pytest.raises(RuntimeError, match="cuda"):
        vstart.VStart(str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="cuda"):
        daemon_bench.run(["--multiprocess"])
    with pytest.raises(ValueError, match="no daemon kind"):
        vstart.VStart(str(tmp_path / "y"), device="cpu").start_daemon("rbd", 0)

    builds = []
    monkeypatch.setattr(cuda_build, "build", lambda *a: builds.append("cuda"))
    monkeypatch.setattr(native_build, "build_plugin", lambda *a: builds.append("plugin"))
    monkeypatch.setattr(vstart.VStart, "_spawn", lambda self, kind, ident: (kind, ident))
    v = vstart.VStart(str(tmp_path / "z"), n_mons=1, n_osds=2, device="cpu")
    v.start()
    for kind in ("mgr", "mds", "rgw"):
        v.start_daemon(kind, 0)
    assert v.extra == {(k, 0): (k, 0) for k in ("mgr", "mds", "rgw")}
    assert builds == [] and v.spec.extras == {"device": "cpu"}
    assert vstart.ClusterSpec.load(v.spec_path).device == "cpu"
    assert vstart.VStart(str(tmp_path / "w"), device="cpu").client().objecter.device.type == "cpu"


def test_mds_main_needs_a_device_and_rgw_stays_refused(tmp_path):
    """`python -m ceph_tpu_torch.cephfs` (the mds daemon main) and `python
    -m ceph_tpu_torch.rgw` (the rgw daemon main): with no device in the
    spec each opens cuda through init_device, as every kind does, and exits
    non-zero without a card: neither falls back to the CPU. The daemon main
    refuses a kind it does not know."""
    from ceph_tpu_torch import vstart

    spec = vstart.ClusterSpec(mon_addrs=[("127.0.0.1", 1)], n_osds=1, run_dir=str(tmp_path))
    spec.save(str(tmp_path / "spec.json"))
    for module in ("ceph_tpu_torch.cephfs", "ceph_tpu_torch.rgw"):
        proc = subprocess.run(
            [sys.executable, "-m", module, "--id", "0", "--spec",
             str(tmp_path / "spec.json")], cwd=REPO_ROOT, capture_output=True, text=True,
            timeout=120, env={**os.environ, **CHILD_ENV})
        assert proc.returncode != 0, module
        assert "torch.cuda.is_available() is false" in proc.stderr, module
        assert not (tmp_path / "rgw.0.port").exists()
    with pytest.raises(SystemExit, match="unknown daemon kind 'rbd'"):
        vstart.daemon_main("rbd", 0, str(tmp_path / "spec.json"))


async def http_get(port: int, path: str) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n".encode())
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


@pytest.mark.slow
def test_vstart_mgr_process_scrapes_every_osd(tmp_path):
    """A mgr spawned by VStart (`python -m ceph_tpu_torch.mgr`) goes active,
    every OSD process reports to it, and its /metrics lists every OSD's
    counters, its `kernels.osd.N` block among them (0 launches on the CPU);
    SIGTERM stops it with the rest, exit code 0."""
    from ceph_tpu_torch.vstart import VStart

    n_osds = 3
    v = VStart(str(tmp_path), n_mons=1, n_osds=n_osds, device="cpu", env=CHILD_ENV,
               config={"mgr_report_interval": 0.5})

    async def main():
        await asyncio.to_thread(v.wait_started, 120)
        r = v.client()
        await r.connect()
        await v.wait_healthy(rados=r, timeout=120)
        v.start_daemon("mgr", 0)
        port = await asyncio.to_thread(v.daemon_port, "mgr", 0, 120)
        want = [f'ceph_tpu_daemon_gf_matmul_packed{{daemon="kernels.osd.{i}"}} 0'
                for i in range(n_osds)]
        want += [f'ceph_tpu_daemon_op_w{{daemon="osd.{i}"}}' for i in range(n_osds)]
        loop = asyncio.get_running_loop()
        end = loop.time() + 120
        while True:
            status, body = await http_get(port, "/metrics")
            text = body.decode()
            if status == 200 and all(w in text for w in want):
                break
            assert loop.time() < end, (status, [w for w in want if w not in text])
            await asyncio.sleep(0.5)
        mm = (await r.mon_command("mgr map"))["mgrmap"]
        assert mm["active"] == "mgr.0"
        await r.shutdown()

    v.start()
    try:
        run(main(), 180)
    finally:
        rcs = v.stop(signal.SIGTERM)
    assert rcs == {**{"mon.0": 0, "mgr.0": 0}, **{f"osd.{i}": 0 for i in range(n_osds)}}


@pytest.mark.slow
def test_vstart_mds_processes_fail_over(tmp_path):
    """Two mds processes spawned by VStart (`python -m ceph_tpu_torch.cephfs`)
    on the replicated pool: the OSD mains registered the fs and journal
    classes, the first mds takes the rank, a client mounts and writes; the
    active is SIGKILLed, the standby takes the rank in the mon's FSMap and
    replays the journal, every file reads back and the new active serves a
    mkdir; SIGTERM stops the rest, exit code 0."""
    from ceph_tpu_torch.cephfs import CephFSClient
    from ceph_tpu_torch.vstart import VStart

    v = VStart(str(tmp_path), n_mons=1, n_osds=3, device="cpu", env=CHILD_ENV,
               config={"mds_beacon_interval": 0.2, "mds_beacon_grace": 1.5})
    v.spec.extras["mds_data_pool"] = 1
    v.spec.save(v.spec_path)

    async def fsmap(r) -> dict:
        return (await r.mon_command("fs map"))["fsmap"]

    async def until(r, pred, what):
        loop = asyncio.get_running_loop()
        end = loop.time() + 120
        while not pred(await fsmap(r)):
            assert loop.time() < end, what
            await asyncio.sleep(0.3)

    async def main():
        await asyncio.to_thread(v.wait_started, 120)
        r = v.client()
        await r.connect()
        await v.wait_healthy(rados=r, timeout=120)
        await r.mon_command("osd pool create", {
            "pool_id": 1, "crush_rule": 1, "size": 3, "pg_num": 8})
        v.start_daemon("mds", 0)
        await until(r, lambda fm: "mds.0" in str(fm.get("active")), "mds.0 never active")
        v.start_daemon("mds", 1)
        await until(r, lambda fm: "mds.1" in str(fm.get("standbys")), "no standby")
        fs = CephFSClient(r, 1)
        await fs.mount()
        await fs.mkfs()
        await fs.mkdir("/docs")
        files = {f"/docs/f{i}": bytes([i]) * (1000 * i + 1) for i in range(4)}
        for path, data in files.items():
            await fs.write_file(path, data)
        proc = v.extra.pop(("mds", 0))
        proc.kill()
        proc.wait(timeout=30)
        await until(r, lambda fm: "mds.1" in str(fm.get("active")), "no failover")
        assert set(await fs.listdir("/docs")) == {p.rsplit("/", 1)[1] for p in files}
        for path, data in files.items():
            assert await fs.read_file(path) == data
        await fs.mkdir("/docs/after")
        assert "after" in await fs.listdir("/docs")
        await r.shutdown()

    v.start()
    try:
        run(main(), 240)
    finally:
        rcs = v.stop(signal.SIGTERM)
    assert rcs == {"mon.0": 0, "mds.1": 0, **{f"osd.{i}": 0 for i in range(3)}}


@pytest.mark.slow
def test_vstart_full_stack_mds_rgw_mgr(tmp_path):
    """Twin of tests/test_multiprocess.py::test_multiprocess_full_stack_mds_rgw_mgr:
    mds, rgw and mgr processes spawned by VStart on one cluster on the CPU,
    a client in this process driving all three: CephFS through the mds, S3
    with SigV4 over HTTP through the rgw (data in the EC pool, the bucket
    index in the replicated one), the dashboard through the mgr. Each service
    is its own process, and SIGTERM stops every one with exit code 0."""
    from ceph_tpu.common.crc import ceph_crc32c
    from ceph_tpu_torch.cephfs import CephFSClient
    from ceph_tpu_torch.vstart import VStart
    from tests.test_s3_auth_ext import raw_http
    from tests.test_s3_rest import MiniS3Client

    v = VStart(str(tmp_path), n_mons=1, n_osds=5, device="cpu", env=CHILD_ENV)
    v.spec.extras.update({"mds_data_pool": 1, "rgw_data_pool": EC_POOL, "rgw_index_pool": 1,
                          "rgw_users": {"AKMP": "multiprocess-secret"}})
    v.spec.save(v.spec_path)

    async def main():
        await asyncio.to_thread(v.wait_started, 120)
        r = v.client()
        await r.connect()
        await v.wait_healthy(rados=r, timeout=120)
        await r.mon_command("osd erasure-code-profile set", {"name": "k2m2", "profile": PROFILE})
        await r.mon_command("osd pool create", {"pool_id": 1, "crush_rule": 1, "size": 3,
                                                "pg_num": 8})
        await r.mon_command("osd pool create", {"pool_id": EC_POOL, "crush_rule": 0,
                                                "erasure_code_profile": "k2m2", "pg_num": 8})
        for kind in ("mds", "rgw", "mgr"):
            v.start_daemon(kind, 0)
        loop = asyncio.get_running_loop()
        end = loop.time() + 120
        while (await r.mon_command("fs map"))["fsmap"].get("active") is None:
            assert loop.time() < end, "no active mds"
            await asyncio.sleep(0.5)
        fs = CephFSClient(r, 1)
        await fs.mount()
        await fs.mkfs()
        await fs.mkdir("/docs")
        await fs.write_file("/docs/hello", b"multi-process fs")
        assert await fs.read_file("/docs/hello") == b"multi-process fs"

        c = MiniS3Client("127.0.0.1", await asyncio.to_thread(v.daemon_port, "rgw", 0, 120),
                         "AKMP", "multiprocess-secret")
        body = np.random.default_rng(24).bytes(100_000)
        assert (await c.request("PUT", "/bucket"))[0] == 200
        st, hd, _ = await c.request("PUT", "/bucket/obj", payload=body)
        assert st == 200 and hd["etag"].strip('"') == f"{ceph_crc32c(0xFFFFFFFF, body):08x}"
        st, _, got = await c.request("GET", "/bucket/obj")
        assert st == 200 and got == body
        assert (await c.request("GET", "/bucket/obj", tamper=True))[0] == 403
        assert await r.io_ctx(EC_POOL).read("bucket/obj") == body
        assert list(await r.io_ctx(1).omap_get(".bucket.index.bucket")) == [b"obj"]

        st, _, doc = await raw_http("127.0.0.1",
                                    await asyncio.to_thread(v.daemon_port, "mgr", 0, 120),
                                    "GET", "/api/status")
        assert st == 200
        doc = json.loads(doc)
        assert doc["cluster"]["num_osds"] == 5 and doc["mgrmap"]["active"] == "mgr.0"
        assert len(v.extra) == 3 and all(p.poll() is None for p in v.extra.values())
        await r.shutdown()

    v.start()
    try:
        run(main(), 240)
    finally:
        rcs = v.stop(signal.SIGTERM)
    assert rcs == {"mon.0": 0, "mds.0": 0, "rgw.0": 0, "mgr.0": 0,
                   **{f"osd.{i}": 0 for i in range(5)}}


@pytest.mark.slow
def test_daemon_bench_multiprocess_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_bench", "--multiprocess",
         "--device", "cpu", "--osds", "4", "--clients", "2", "--k", "2", "--m", "2",
         "--objects", "8", "--size", "65536", "--concurrency", "4",
         "--run-dir", str(tmp_path)],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, **CHILD_ENV})
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json

    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["mode"] == "multiprocess" and line["objects"] == 8 and line["clients"] == 2
    assert line["write_gbps"] > 0 and line["read_gbps"] > 0


# -- the revival twin -----------------------------------------------------------

#: the live smoke's revival window (its phase 18), objects cut from 4 MiB
REVIVAL_OSDS = 12
REVIVAL_POOLS = {1: 64, 2: 32}  # pool id -> pg_num: isa k=8 m=3, replicated size 3
REVIVAL_OBJECTS = {1: 128, 2: 16}
REVIVAL_BYTES = 256 << 10
REVIVAL_PARTIAL = 8
REVIVAL_VICTIMS = (3, 7)
REVIVAL_PROFILE = {"plugin": "isa", "k": "8", "m": "3", "technique": "cauchy"}


async def revival_sequence(name: str, objects: dict, patches: list,
                           unresolved_once: bool = False) -> dict:
    """Phase 18's sequence in one package, in one process: writes, partial
    overwrites, rewrites, 2 OSDs stopped and marked down, degraded reads, the
    2 back on empty stores, recovery until every PG is clean and the pushes
    stop. With `unresolved_once`, the first recovery payload asked for one
    object (written first in a PG that a victim serves and that is written
    again later) finds its sources unavailable, as a fetch that timed out
    does. Returns the object so picked ("target") and (object, position,
    OSD) of every live acting position that holds no copy or shard of the
    object at its newest version ("unfilled")."""
    import importlib

    from ceph_tpu.osd.osdmap import encode_osdmap
    from ceph_tpu.vstart import initial_osdmap

    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    kw = {"device": "cpu"} if name == "ceph_tpu_torch" else {}
    base = initial_osdmap(REVIVAL_OSDS)
    base.crush.rules[0].max_size = 11
    if kw:
        base = mod("osd.osdmap").decode_osdmap(encode_osdmap(base), device="cpu")
    cfg = mod("common.config").Config()
    cfg.set("osd_heartbeat_interval", 0.5)
    cfg.set("osd_heartbeat_grace", 120)
    monmap = mod("mon").MonMap(addrs=[("127.0.0.1", 0)] * 3)
    mons = [mod("mon").Monitor(r, monmap, base, config=cfg, **kw) for r in range(3)]
    for m in mons:
        await m.bind()
    for m in mons:
        m.go()
    osds = {}

    async def start_osd(i):
        osds[i] = mod("osd.daemon").OSDService(i, monmap, config=cfg, **kw)
        await osds[i].start()

    for i in range(REVIVAL_OSDS):
        await start_osd(i)
    rados = mod("rados.client").Rados("client.rev", monmap, config=cfg, **kw)
    await rados.connect()
    shard_name, pg_coll = mod("osd.daemon").shard_name, mod("osd.daemon").pg_coll

    def leader_map():
        leader = next((m for m in mons if m.is_leader), None)
        return None if leader is None else leader.osdmap

    def clean(backfill_too=True):
        m = leader_map()
        for pool, pg_num in REVIVAL_POOLS.items():
            for ps in range(pg_num if m is not None else 0):
                primary = m.pg_to_up_acting_osds(pool, ps)[3]
                pg = osds[primary].pgs.get((pool, ps)) if primary in osds else None
                if pg is None or not pg.active or backfill_too and (
                        pg.backfill_targets or pg.self_backfill):
                    return False
        return m is not None

    def unfilled():
        some = next(iter(osds.values()))
        out = []
        for pool, obj in objects:
            ps = some.object_pg(pool, obj)
            acting, _ = some.acting_of(pool, ps)
            held = {}
            for pos, osd in enumerate(acting):
                store = osds[osd].store if osd in osds else None
                key = (pg_coll(pool, ps), shard_name(obj, pos if pool == 1 else None))
                if store is not None and store.exists(*key):
                    held[(pos, osd)] = store.getattrs(*key).get("ver")
            newest = max(held.values(), default=None)
            out += [(obj, pos, osd) for pos, osd in enumerate(acting)
                    if osd in osds and held.get((pos, osd), "absent") != newest]
        return out

    async def gather(calls):
        sem = asyncio.Semaphore(32)

        async def one(call):
            async with sem:
                await call()
        await asyncio.gather(*(one(c) for c in calls))

    osd_cls, target, plain = mod("osd.daemon").OSDService, None, None
    try:
        await rados.mon_command("osd erasure-code-profile set",
                                {"name": "rev", "profile": REVIVAL_PROFILE})
        await rados.mon_command("osd pool create", {"pool_id": 1, "crush_rule": 0,
                                                    "erasure_code_profile": "rev",
                                                    "pg_num": REVIVAL_POOLS[1]})
        await rados.mon_command("osd pool create", {"pool_id": 2, "crush_rule": 1, "size": 3,
                                                    "pg_num": REVIVAL_POOLS[2]})
        await wait_until(clean, 1200)
        io = {pool: rados.io_ctx(pool) for pool in REVIVAL_POOLS}
        want = dict(objects)
        await gather([lambda k=k: io[k[0]].write_full(k[1], want[k]) for k in want])
        for key, off, patch in patches:
            await io[1].write(key[1], patch, off)
            want[key] = want[key][:off] + patch + want[key][off + len(patch):]
        # the smoke's traced and profiled rewrites: the next 16 objects twice
        window = [(1, f"d-1-{i}") for i in range(REVIVAL_PARTIAL, REVIVAL_PARTIAL + 16)]
        for _ in range(2):
            await gather([lambda k=k: io[1].write_full(k[1], want[k]) for k in window])
        if unresolved_once:  # picked while every OSD is up and in the acting sets
            later = [k[1] for k, _o, _p in patches] + [k[1] for k in window]
            pg_of = {o: osds[0].object_pg(1, o) for pool, o in want if pool == 1}
            target = next(o for o in sorted(pg_of, key=lambda o: int(o.split("-")[2]))
                          if o not in later and any(pg_of[x] == pg_of[o] for x in later)
                          and set(REVIVAL_VICTIMS) & set(osds[0].acting_of(1, pg_of[o])[0]))
        for victim in REVIVAL_VICTIMS:
            await osds.pop(victim).stop()
            await rados.mon_command("osd down", {"osd": victim})
        await wait_until(lambda: leader_map() is not None
                         and all(leader_map().is_down(v) for v in REVIVAL_VICTIMS), 60)
        await wait_until(lambda: clean(backfill_too=False), 1200)

        async def check(key):
            assert await io[key[0]].read(key[1]) == want[key], f"{name}: read of {key}"
        await gather([lambda k=k: check(k) for k in want if k[0] == 1])
        if unresolved_once:
            fired = []
            plain = osd_cls._object_for_push

            async def flaky(self, pg, entry, shard, acting):
                if entry["name"] == target and not fired:
                    fired.append(self.id)
                    return None
                return await plain(self, pg, entry, shard, acting)

            osd_cls._object_for_push = flaky
        for victim in REVIVAL_VICTIMS:
            await start_osd(victim)
        await wait_until(lambda: leader_map() is not None
                         and not any(leader_map().is_down(v) for v in REVIVAL_VICTIMS), 120)
        quiet, last = 0, None
        while quiet < 25:
            await asyncio.sleep(0.2)  # cephlint: disable=clock-discipline (no push for 5 s: a quiet window is a time)
            pushes = sum(o.perf.dump().get("recovery_pushes", 0) for o in osds.values())
            quiet = quiet + 1 if pushes == last and clean() else 0
            last = pushes
        await gather([lambda k=k: check(k) for k in want])
        return {"target": target, "unfilled": unfilled()}
    finally:
        if plain is not None:
            osd_cls._object_for_push = plain
        await rados.shutdown()
        for o in osds.values():
            await o.stop()
        for m in mons:
            await m.stop()


def revival_inputs(seed: int, size: int = REVIVAL_BYTES, counts: dict = REVIVAL_OBJECTS):
    rng = np.random.default_rng(seed)
    objects = {(pool, f"d-{pool}-{i}"): rng.bytes(size)
               for pool, n in counts.items() for i in range(n)}
    patches = [((1, f"d-1-{i}"), int(rng.integers(0, size - 8192)), rng.bytes(4096))
               for i in range(REVIVAL_PARTIAL)]
    return objects, patches


@pytest.mark.slow
def test_revival_on_empty_stores_twin():
    """Both packages through the same revival, every read exact. Positions
    left without their shard are printed, not compared: a recovery fetch
    that times out under load leaves one in either package (ROADMAP §C; the
    next test makes the mechanism deterministic)."""
    objects, patches = revival_inputs(18)
    ref = run(revival_sequence("ceph_tpu", objects, patches), 2400)
    port = run(revival_sequence("ceph_tpu_torch", objects, patches), 2400)
    print(f"unfilled positions: ceph_tpu {ref}, ceph_tpu_torch {port}")
    assert ref["target"] is port["target"] is None



def test_rados_and_ceph_tools_against_reference_tools(tmp_path, capsysbinary):
    """The port's `rados` and `ceph` CLIs and ceph_tpu's, against one
    multi-process port cluster: the same commands print the same bytes."""
    import importlib

    from ceph_tpu_torch.vstart import VStart

    v = VStart(str(tmp_path), n_mons=1, n_osds=4, device="cpu", env=CHILD_ENV)
    mains = {name: (importlib.import_module(f"{base}.ceph").main,
                    importlib.import_module(f"{base}.rados").main, dev)
             for name, base, dev in (("ref", "tools", []),
                                     ("port", "ceph_tpu_torch.tools", ["--device", "cpu"]))}
    payload = tmp_path / "payload"
    payload.write_bytes(np.random.default_rng(4).bytes(70000))
    v.start()
    try:
        v.wait_started(120)
        host = [f"--mon-host=127.0.0.1:{v.spec.mon_addrs[0][1]}"]
        ceph, rados, dev = mains["port"]
        assert ceph(host + dev + ["osd", "erasure-code-profile", "set", "p", "k=2", "m=2",
                                  "plugin=tpu"]) == 0
        assert ceph(host + dev + ["--profile", "p", "--pg-num", "8", "osd", "pool", "create",
                                  "1", "0"]) == 0
        for name, (ceph, rados, dev) in mains.items():
            assert rados(host + dev + ["-p", "1", "put", f"obj-{name}", str(payload)]) == 0
        capsysbinary.readouterr()
        outs = {}
        for name, (ceph, rados, dev) in mains.items():
            got = []
            for cmd in (["osd", "tree"], ["pg", "dump", "--pool", "1"],
                        ["daemon", "osd.0", "status"]):
                got += [ceph(host + dev + cmd), capsysbinary.readouterr()]
            for cmd in (["ls"], ["get", "obj-port", "-"], ["df"]):
                got += [rados(host + dev + ["-p", "1"] + cmd), capsysbinary.readouterr()]
            outs[name] = got
    finally:
        v.stop()
    assert outs["port"] == outs["ref"]
    assert outs["ref"][7].out == b"obj-port\nobj-ref\n"
    assert outs["ref"][9].out == payload.read_bytes()


@pytest.mark.slow
def test_revival_unresolved_push_leaves_hole_twin():
    """The mechanism behind the revival's holes, made deterministic: one
    recovery payload whose sources are unavailable is skipped, the later
    entries of the push advance the revived member's log past it, and no
    later pass pushes it again. Both packages leave that object's hole (a
    fetch that times out under load may leave more)."""
    objects, patches = revival_inputs(18, 64 << 10)
    out = {name: run(revival_sequence(name, objects, patches, unresolved_once=True), 2400)
           for name in ("ceph_tpu", "ceph_tpu_torch")}
    print(f"picked and unfilled: {out}")
    assert out["ceph_tpu"]["target"] == out["ceph_tpu_torch"]["target"]
    for got in out.values():
        assert any(h[0] == got["target"] for h in got["unfilled"]), got
