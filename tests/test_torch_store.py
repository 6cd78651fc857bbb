"""Twins of the store stack: the port's Throttle, ExtentAllocator and
BlockStore, and its offline tools (objectstore_tool, monstore_tool,
dencoder), against ceph_tpu's.

A store twin runs one seeded script through both packages' BlockStore, over
MemDB with the in-memory device and over FileDB with a block file in
`tmp_path`, and compares at tolerance 0 what the script observed (reads,
errors, perf counters without the time-valued ones) and the store it left:
every KV row, the block bytes, the allocator's free map and size, and deep
`fsck`. The scripts mirror the cases of `tests/test_{objectstore,blockstore,
blockstore_cache,blockstore_faults}.py`. A tool twin runs the reference's
tool and the port's on copies of one store (or on the same bytes) and
compares their output.
"""

import importlib
import io
import json
import random
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

REF, PORT = "ceph_tpu", "ceph_tpu_torch"


def package(name: str) -> SimpleNamespace:
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    ost = mod("osd.objectstore")
    return SimpleNamespace(
        name=name, Config=mod("common.config").Config, kv=mod("common.kv"),
        DEFER=mod("osd.blockstore")._DEFER, Transaction=ost.Transaction,
        create_store=ost.create_store,
        ExtentAllocator=mod("osd.allocator").ExtentAllocator,
        Throttle=mod("common.throttle").Throttle,
    )


def cfg_of(P, **settings):
    cfg = P.Config()
    for k, v in settings.items():
        cfg.set(k, v)
    return cfg


UNCACHED = {"blockstore_onode_cache_size": 0, "blockstore_buffer_cache_bytes": 0,
            "blockstore_deferred_max_age_ms": 0}
CACHED = {"blockstore_deferred_max_age_ms": 0}


class Obs(list):
    """What a script saw: call results, and errors as (type, code, text)."""

    def call(self, fn, *args):
        try:
            out = fn(*args)
        except Exception as e:  # noqa: BLE001 - the error is the observation
            self.append(("raised", type(e).__name__, getattr(e, "code", None), str(e)))
            return None
        self.append(out)
        return out


def perf(st) -> dict:
    """The store's counters, time-valued ones reduced to their counts."""
    d = st.perf.dump()
    d.pop("deferred_age_ms")
    d["l_flush"] = d["l_flush"]["avgcount"]
    return d


# -- scripts: each takes (package, store factory, obs) and returns its store --

def s_surface(P, make, obs):
    """test_objectstore's transaction surface, restart and write_at cases."""
    st = make()
    T = P.Transaction
    st.queue_transaction(T().create_collection("c").write("c", "o", b"hello", attrs={"v": 1})
                         .omap_setkeys("c", "o", {b"k1": b"a", b"k2": b"b"}))
    obs.call(st.read, "c", "o")
    obs.call(st.getattrs, "c", "o")
    obs.call(st.omap_get, "c", "o")
    st.queue_transaction(T().write_at("c", "o", 3, b"XYZ!").touch("c", "o").touch("c", "new"))
    st.queue_transaction(T().write_at("c", "o", 20000, b"far").omap_rmkeys("c", "o", [b"k1"]))
    obs.call(st.read, "c", "o")
    obs.call(st.read, "c", "new")
    st.queue_transaction(T().create_collection("d").write("d", "x", b"y" * 9000)
                         .remove("c", "new"))
    obs.call(st.list_collections)
    obs.call(st.list_objects, "c")
    st.queue_transaction(T().remove_collection("d"))
    obs.call(st.list_collections)
    obs.call(st.read, "d", "x")
    obs.call(st.read, "c", "missing")
    return st


def s_cache(P, make, obs, mode="cached"):
    """test_blockstore_cache's coherency battery, LRU eviction and hits."""
    st = make(**(CACHED if mode == "cached" else UNCACHED)) if mode == "uncached" else make(
        **CACHED, blockstore_buffer_cache_bytes=20000)
    T = P.Transaction
    st.queue_transaction(T().create_collection("c"))
    for i in range(5):
        st.queue_transaction(T().write("c", f"o{i}", bytes([i]) * 8192))
    for i in range(5):
        obs.call(st.read, "c", f"o{i}")
    st.queue_transaction(T().write("c", "o1", b"Z" * 12000).write_at("c", "o2", 100, b"patch"))
    st.queue_transaction(T().remove("c", "o3").touch("c", "o4"))
    obs.append(perf(st))
    st.drop_caches()
    for i in range(5):
        obs.call(st.read, "c", f"o{i}")
        obs.call(st.read_verify, "c", f"o{i}")
    # an aborted transaction (write then an op that fails) pollutes nothing
    obs.call(st.queue_transaction, T().write("c", "o0", b"never" * 2000).remove("nocoll", "x"))
    obs.call(st.read, "c", "o0")
    obs.append(perf(st))
    return st


def s_deferred(P, make, obs):
    """Deferred sub-min_alloc writes: threshold, tick by age, remove of a
    deferred object, then the background flusher, drained before compare."""
    st = make(blockstore_deferred_batch_bytes=1000, blockstore_deferred_max_age_ms=10_000)
    T = P.Transaction
    st.queue_transaction(T().create_collection("c"))
    for i in range(12):
        st.queue_transaction(T().write("c", f"s{i}", bytes([i + 1]) * 97))
        obs.append(len(list(st.db.iterate(P.DEFER))))
    st.queue_transaction(T().write("c", "gone", b"g" * 50).remove("c", "gone"))
    obs.append(st.tick())
    st._deferred_since -= 11.0
    obs.append(st.tick())
    obs.append(perf(st))
    st2 = make(blockstore_deferred_max_age_ms=40, blockstore_deferred_batch_bytes=1 << 30,
               sub="aged")
    st2.queue_transaction(T().create_collection("c"))
    for i in range(4):
        st2.queue_transaction(T().write("c", f"a{i}", bytes([i + 7]) * 100))
    obs.append(st2.wait_deferred_drained(10))
    obs.append(len(list(st2.db.iterate(P.DEFER))))
    for i in range(4):
        obs.call(st2.read, "c", f"a{i}")
    obs.append(st2.fsck(deep=True))
    st2.umount()
    return st


def s_compression(P, make, obs):
    st = make(blockstore_compression_mode="force", blockstore_compression_min_blob_size=4096)
    T = P.Transaction
    rng = np.random.default_rng(5)
    st.queue_transaction(T().create_collection("c")
                         .write("c", "zeros", bytes(65536))
                         .write("c", "text", b"the quick brown fox " * 3000)
                         .write("c", "noise", rng.integers(0, 256, 40000, dtype=np.uint8).tobytes())
                         .write("c", "tiny", b"t" * 100))
    for name in ("zeros", "text", "noise", "tiny"):
        obs.call(st.read, "c", name)
    obs.append(st.compression_stats())
    st.drop_caches()
    obs.call(st.read_verify, "c", "text")
    st.queue_transaction(T().write_at("c", "text", 10, b"PATCHED"))
    obs.call(st.read, "c", "text")
    obs.append(st.compression_stats())
    return st


def s_bitrot(P, make, obs):
    """An at-rest flipped bit: read_verify sees it, a plain read only after
    drop_caches, deep fsck names it, a rewrite heals it."""
    st = make()
    T = P.Transaction
    st.queue_transaction(T().create_collection("c").write("c", "o", b"A" * 8192))
    st.device.pwrite(4100, bytes([st.device.pread(4100, 1)[0] ^ 1]))
    obs.call(st.read, "c", "o")
    obs.call(st.read_verify, "c", "o")
    st.drop_caches()
    obs.call(st.read, "c", "o")
    obs.append(st.fsck())
    obs.append(st.fsck(deep=True))
    st.queue_transaction(T().write("c", "o", b"A" * 8192))
    obs.call(st.read, "c", "o")
    return st


def s_faults(P, make, obs):
    """test_blockstore_faults: injectdataerr, a seeded 1-in-3 read rate,
    write and fsync fencing; both packages' injection RNGs seeded alike."""
    st = make()
    st._inj_rng.seed(1234)
    T = P.Transaction
    st.queue_transaction(T().create_collection("c"))
    for i in range(6):
        st.queue_transaction(T().write("c", f"o{i}", bytes([i]) * 8192))
    st.queue_transaction(T().write("c", "small", b"s" * 100))
    st.inject_data_error("c", "o1")
    st.inject_data_error("c", "small")
    for name in ("o1", "small", "o2"):
        obs.call(st.read, "c", name)
    obs.append(st.fsck(deep=True))
    st.queue_transaction(T().write("c", "o1", b"z" * 8192))
    obs.call(st.read, "c", "o1")
    st.config_for_test.set("blockstore_inject_read_eio", 3)
    st.drop_caches()
    for _ in range(3):
        for i in range(6):
            obs.call(st.read_verify, "c", f"o{i}")
    st.config_for_test.set("blockstore_inject_read_eio", 0)
    fatal = []
    st.on_fatal = fatal.append
    st.config_for_test.set("blockstore_inject_fsync_fail", 1)
    obs.call(st.queue_transaction, T().write("c", "doomed", b"d" * 8192))
    obs.call(st.queue_transaction, T().write("c", "later", b"l" * 8192))
    obs.append((st.fenced, fatal))
    obs.call(st.read, "c", "o4")
    obs.append(perf(st))
    return st


def s_enospc(P, make, obs):
    st = make(blockstore_block_size=32768)
    T = P.Transaction
    st.queue_transaction(T().create_collection("c"))
    for i in range(5):
        obs.call(st.queue_transaction, T().write("c", f"o{i}", bytes([i]) * 8192))
    obs.append((st.fenced, st.alloc.free_bytes(), st.alloc.size))
    st.queue_transaction(T().remove("c", "o0"))
    obs.call(st.queue_transaction, T().write("c", "o4", b"4" * 8192))
    obs.call(st.read, "c", "o4")
    return st


def s_random(P, make, obs, seed=7):
    """test_blockstore_cache's seeded random op stream."""
    rng = random.Random(seed)
    st = make(blockstore_deferred_batch_bytes=8192)
    T = P.Transaction
    st.queue_transaction(T().create_collection("c"))
    names = [f"o{i}" for i in range(10)]
    for _step in range(150):
        name = rng.choice(names)
        kind = rng.choice(["write", "write", "write_at", "remove", "read", "flush"])
        if kind == "write":
            data = bytes([rng.randrange(256)]) * rng.randint(1, 12000)
            st.queue_transaction(T().write("c", name, data))
        elif kind == "write_at":
            off = rng.randint(0, 6000)
            data = rng.randbytes(rng.randint(1, 500))
            st.queue_transaction(T().write_at("c", name, off, data))
        elif kind == "remove":
            st.queue_transaction(T().remove("c", name))
        elif kind == "flush":
            obs.append(st.flush_deferred())
        else:
            obs.call(st.read, "c", name)
    return st


SCRIPTS = {
    "surface": s_surface, "cache_hits": s_cache,
    "cache_off": lambda P, make, obs: s_cache(P, make, obs, "uncached"),
    "deferred": s_deferred, "compression": s_compression, "bitrot_read_verify": s_bitrot,
    "fault_injection": s_faults, "enospc": s_enospc, "seeded_random": s_random,
}


def run_script(name, script, backing, tmp):
    P = package(name)
    made = []

    def make(sub="main", **settings):
        db = P.kv.MemDB() if backing == "mem" else P.kv.FileDB(str(tmp / name / sub))
        cfg = cfg_of(P, osd_objectstore="blockstore", **settings)
        st = P.create_store(db, cfg)
        st.config_for_test = cfg  # the store observes the rate knobs on it
        made.append(st)
        return st

    obs = Obs()
    st = script(P, make, obs)
    if not st.fenced:
        st.flush_deferred()
        assert st.wait_deferred_drained(10)
    state = {
        "obs": obs, "perf": perf(st), "fsck": st.fsck(deep=True),
        "kv": sorted(st.db.table.items()),
        "block": st.device.pread(0, st.alloc.size),
        "free": (dict(st.alloc.free), st.alloc.size),
    }
    for s in made:
        if s.fenced:
            s.close()
        else:
            s.umount()
    if backing == "file":
        reopened = P.kv.FileDB(str(tmp / name / "main"))
        state["replayed_kv"] = sorted(reopened.table.items())
        reopened.close()
    return state


@pytest.mark.parametrize("backing", ["mem", "file"])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_blockstore_twin(script, backing, tmp_path):
    ref = run_script(REF, SCRIPTS[script], backing, tmp_path)
    port = run_script(PORT, SCRIPTS[script], backing, tmp_path)
    assert port["obs"] == ref["obs"]
    for key in ref:
        assert port[key] == ref[key], key
    assert len(ref["kv"]) > 1 and len(ref["obs"]) > 1


@pytest.mark.parametrize("case", ["first_fit", "coalesce", "check", "deltas", "many", "capacity"])
def test_allocator_twin(case):
    out = {}
    for name in (REF, PORT):
        P = package(name)
        a = P.ExtentAllocator(4096, capacity=65536 if case == "capacity" else 0)
        obs = Obs()
        if case == "first_fit":
            obs += [a.allocate(100), a.allocate(5000), a.size]
            a.release([(0, 4096)])
            obs += [a.allocate(3000), a.free_bytes()]
        elif case == "coalesce":
            e = [a.allocate(4096) for _ in range(3)]
            a.release(e[0])
            a.release(e[2])
            obs += [dict(a.free), a.allocate(8192)]
            a.release(e[1])
            obs += [dict(a.free), a.check([])]
        elif case == "check":
            a.init({}, 16384)
            obs += [a.check([]), a.check([(0, 8192), (4096, 12288)])]
            a.init({8192: 8192}, 16384)
            obs.append(a.check([(0, 8192)]))
        elif case == "deltas":
            db = P.kv.MemDB()
            for step in ("alloc", "release", "none"):
                if step == "alloc":
                    ext = a.allocate(8192)
                elif step == "release":
                    a.release(ext)
                kv = P.kv.KVTransaction()
                a.flush(kv, b"fre", b"bmt")
                obs.append(list(kv.ops))
                db.submit_transaction(kv)
            obs.append(sorted(db.table.items()))
        elif case == "many":
            obs.append(a.allocate_many([100, 9000, 4096, 20000]))
            a.release([(4096, 4096)])
            obs += [a.allocate_many([4096, 4096]), dict(a.free), a.size]
        else:
            obs += [a.allocate(40000), dict(a.free)]
            obs.call(a.allocate, 40000)
            obs += [dict(a.free), a.size, a.allocated_bytes()]
        out[name] = obs
    assert out[PORT] == out[REF]


def test_throttle_twin():
    out = {}
    for name in (REF, PORT):
        t = package(name).Throttle(10, name="t")
        obs = Obs()
        obs += [t.get_or_fail(6), t.get_or_fail(5), t.get(4, timeout=0.01), t.current]
        obs += [t.get(1, timeout=0.01), t.put(5), t.get_or_fail(20), t.put(5)]
        obs += [t.get_or_fail(20), t.current, t.put(20)]
        obs.call(t.put, 1)
        t.reset_max(2)
        with t:
            obs += [t.current, t.max, t.get_or_fail(2)]
        obs.call(package(name).Throttle, -1)
        out[name] = obs
    assert out[PORT] == out[REF]


# -- tool twins -----------------------------------------------------------------

def run_tool(main, argv, capsysbinary, stdin: bytes | None = None):
    if stdin is not None:
        saved = sys.stdin
        sys.stdin = SimpleNamespace(buffer=io.BytesIO(stdin))
    try:
        rc = main(argv)
    finally:
        if stdin is not None:
            sys.stdin = saved
    cap = capsysbinary.readouterr()
    return rc, cap.out, cap.err


def norm(got, d):
    """Tool outputs with the package's own scratch directory masked."""
    def one(x):
        return x.replace(str(d).encode(), b"{d}") if isinstance(x, bytes) else x

    return [one(g) if isinstance(g, bytes) else tuple(one(x) for x in g) for g in got]


def tools_of(name):
    """(objectstore_tool, monstore_tool, dencoder) of one package."""
    base = "tools" if name == REF else f"{PORT}.tools"
    return [importlib.import_module(f"{base}.{m}")
            for m in ("objectstore_tool", "monstore_tool", "dencoder")]


def build_osd_store(path, backend):
    """A stopped OSD's store as the port's daemon leaves it: PG collections
    with EC shards, hinfo, attrs, omap and a pg-meta log."""
    from ceph_tpu_torch.common.kv import FileDB
    from ceph_tpu_torch.osd.ecutil import HashInfo
    from ceph_tpu_torch.osd.objectstore import Transaction, create_store
    from ceph_tpu_torch.common.config import Config

    cfg = Config()
    cfg.set("osd_objectstore", backend)
    st = create_store(FileDB(str(path)), cfg)
    rng = np.random.default_rng(3)
    for ps in range(2):
        coll = f"pg_2_{ps}"
        txn = Transaction().create_collection(coll)
        for j in range(3):
            data = rng.integers(0, 256, 5000 + 3000 * j, dtype=np.uint8).tobytes()
            hinfo = HashInfo(len(data), [j, j + 1, j + 2])
            txn.write(coll, f"obj{j}.s{ps}", data, attrs={"ver": j + 1, "hinfo": hinfo,
                                                         "raw": b"\x00\x01"})
            txn.omap_setkeys(coll, f"obj{j}.s{ps}", {b"k": bytes([j])})
        txn.write(coll, ".pgmeta", b"")
        txn.omap_setkeys(coll, ".pgmeta", {
            f"log/{i:08d}".encode(): json.dumps({"v": i, "op": "modify"}).encode()
            for i in range(3)})
        st.queue_transaction(txn)
    st.umount() if hasattr(st, "umount") else st.db.close()


@pytest.mark.parametrize("backend", ["kstore-file", "blockstore"])
def test_objectstore_tool_twin(backend, tmp_path, capsysbinary):
    build_osd_store(tmp_path / "osd", backend)
    cases = [["--op", "list"], ["--op", "list", "--pgid", "2.1"],
             ["--op", "info", "--pgid", "2.0", "--obj", "obj1.s0"],
             ["--op", "get", "--pgid", "2.1", "--obj", "obj2.s1", "--out", "-"],
             ["--op", "log", "--pgid", "2.0"], ["--op", "fsck"], ["--op", "fsck", "--deep"],
             ["--op", "export", "--pgid", "2.1", "--out", "{d}/exp"],
             ["--op", "import", "--file", "{d}/exp"], ["--op", "list"]]
    outs = {}
    for name in (REF, PORT):
        ost = tools_of(name)[0]
        d = tmp_path / name
        shutil.copytree(tmp_path / "osd", d / "osd")
        dst = d / "fresh"
        got = []
        for i, argv in enumerate(cases):
            argv = [a.replace("{d}", str(d)) for a in argv]
            target = dst if i >= 8 else d / "osd"
            got.append(run_tool(ost.main, ["--data-path", str(target), *argv], capsysbinary))
        got.append(open(d / "exp", "rb").read())
        outs[name] = norm(got, d)
    assert outs[PORT] == outs[REF]
    assert b"obj2.s1" in outs[REF][0][1] and outs[REF][5][0] == 0


def test_monstore_tool_twin(tmp_path, capsysbinary):
    """A port mon persists to FileDB in a live in-process cluster; stopped,
    its store goes through both packages' monstore_tool."""
    import asyncio

    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.common.kv import FileDB
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.rados.client import Rados
    from ceph_tpu_torch.vstart import ClusterSpec, initial_osdmap, pick_ports

    spec = ClusterSpec(mon_addrs=[("127.0.0.1", p) for p in pick_ports(1)], n_osds=4,
                       run_dir=str(tmp_path))

    async def build():
        cfg = Config()
        cfg.set("mon_lease", 0.1)
        cfg.set("mon_election_timeout", 0.4)
        cfg.set("osd_heartbeat_interval", 0.15)
        monmap = spec.monmap()
        mon = Monitor(0, monmap, initial_osdmap(4), db=FileDB(str(tmp_path / "mon.0.kv")),
                      config=cfg, device="cpu")
        await mon.start()
        osds = [OSDService(i, monmap, config=cfg, device="cpu") for i in range(4)]
        for o in osds:
            await o.start()
        rados = Rados("client.m", monmap, config=cfg, device="cpu")
        await rados.connect()
        await rados.mon_command("osd pool create", {"pool_id": 1, "crush_rule": 1, "size": 3,
                                                    "pg_num": 8})
        await rados.mon_command("osd blocklist", {"op": "add", "entity": "client.evil"})
        await rados.io_ctx(1).write_full("obj", b"x" * 1000)
        await rados.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()

    asyncio.run(asyncio.wait_for(build(), 120))
    capsysbinary.readouterr()  # the mon's cluster log, not a tool's output
    spec.save(str(tmp_path / "spec.json"))
    outs = {}
    for name in (REF, PORT):
        mst = tools_of(name)[1]
        d = tmp_path / name
        shutil.copytree(tmp_path / "mon.0.kv", d / "mon")
        store = ["--store-path", str(d / "mon")]
        got = [run_tool(mst.main, store + argv, capsysbinary) for argv in (
            ["--op", "dump"], ["--op", "get-osdmap", "--spec", str(tmp_path / "spec.json"),
                               "--out", str(d / "map")],
            ["--op", "export", "--out", str(d / "exp")])]
        got.append(run_tool(mst.main, ["--store-path", str(d / "copy"), "--op", "import",
                                       "--file", str(d / "exp")], capsysbinary))
        last = json.loads(got[0][1])["last_committed"]
        got += [run_tool(mst.main, ["--store-path", str(d / "copy"), *argv], capsysbinary) for argv in (
            ["--op", "dump"], ["--op", "remove-version", "--version", str(last)],
            ["--op", "remove-version", "--version", str(last), "--force"], ["--op", "dump"])]
        got += [open(d / "map", "rb").read(), open(d / "exp", "rb").read()]
        outs[name] = norm(got, d)
    assert outs[PORT] == outs[REF]
    assert json.loads(outs[REF][1][1])["blocklist"] == ["client.evil"]


def test_dencoder_twin(capsysbinary):
    from ceph_tpu.common.kv import KVTransaction
    from ceph_tpu.msg.frames import Message
    from ceph_tpu.osd.osdmap import Incremental
    from ceph_tpu.vstart import initial_osdmap

    m = initial_osdmap(6)
    inc = Incremental(epoch=2, new_down=[3], new_weight={1: 0x8000})
    m.apply_incremental(inc)
    kv = KVTransaction()
    kv.set(b"p", b"k", b"v" * 9)
    kv.rm(b"p", b"gone")
    blobs = {"osdmap": m.encode(), "osdmap_incremental": inc.encode(),
             "kv_transaction": kv.encode(),
             "message": Message(type="osd_op", tid=7, epoch=3, data=b"payload").encode()}
    outs = {}
    for name in (REF, PORT):
        den = tools_of(name)[2]
        got = [run_tool(den.main, ["list_types"], capsysbinary), run_tool(den.main, [], capsysbinary)[0]]
        for tname, raw in sorted(blobs.items()):
            got.append(run_tool(den.main, ["decode", tname], capsysbinary, raw))
            got.append(run_tool(den.main, ["round_trip", tname], capsysbinary, raw))
        got.append(run_tool(den.main, ["decode", "nope"], capsysbinary, b""))
        got.append(run_tool(den.main, ["round_trip", "kv_transaction"], capsysbinary,
                            blobs["kv_transaction"] + b"\x00"))
        outs[name] = got
    assert outs[PORT] == outs[REF]
    assert json.loads(outs[REF][0][1]) == sorted(blobs)
