"""Twins of the block-image layer: ceph_tpu_torch.rbd against ceph_tpu.rbd,
and of the OSD's self-managed snapshots it rides.

Each twin runs one seeded script on a ceph_tpu cluster and on a port
cluster (`device="cpu"`) of tests/test_torch_live.py's shape: 3 monitors,
6 OSDs, a k2m2 `tpu` pool (EC_POOL) and a size-3 pool (REP_POOL). The
scripts are tests/test_rbd.py's, tests/test_rbd_clone.py's,
tests/test_snapshots.py's, tests/test_rbd_lock_live.py's and
tests/test_rbd_migration_live.py's stories. A twin compares, with
tolerance 0, what the client read, the `diff` lists, the object-map and
clean-map bytes, `lock_holders` and the errors raised, and per OSD every
stored object and EC shard (snapshot clones included) with its size and
`hinfo`. Masked: a lock holder's messenger nonce (random per instance) and
the cls lock's clock fields (`expiration`, `since`).

The cross-package case writes an image with a client of one package on a
cluster of the other and reads it back with the cluster's own package,
both ways: the image format is shared.
"""

import importlib
import re
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, REP_POOL, Cluster, Package, _port_racecheck_clean, run,
)

#: a second replicated pool: the migration target's, the mirror's replica's
DST_POOL = 5
MASKED = ("expiration", "since")
NONCE = re.compile(r"(client\.[\w.-]+)/\d+")


def mods(name: str) -> SimpleNamespace:
    def m(x):
        return importlib.import_module(f"{name}.{x}")

    return SimpleNamespace(
        name=name, Image=m("rbd").Image, ImageNotFound=m("rbd").ImageNotFound,
        RadosError=m("rados.client").RadosError, journal=m("journal"),
        register_journal_classes=m("journal.journal").register_journal_classes,
        cephfs=m("cephfs"), register_fs_classes=m("cephfs.fs").register_fs_classes,
        MDSService=m("cephfs").MDSService, kw=Package(name).kw)


def mask(x):
    if isinstance(x, dict):
        return {k: ("<masked>" if k in MASKED else mask(v)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(mask(v) for v in x)
    if isinstance(x, str):
        return NONCE.sub(r"\1/<nonce>", x)
    if isinstance(x, BaseException):
        return (type(x).__name__, mask(str(x)))
    return x


async def raised(coro):
    try:
        return await coro
    except Exception as e:  # noqa: BLE001 - the failure is the observation
        return e


def register_classes(cluster, M) -> None:
    """The cephfs and journal object classes on every OSD, as a daemon-main
    OSD registers them."""
    for osd in cluster.osds.values():
        M.register_fs_classes(osd)
        M.register_journal_classes(osd)


async def create_dst_pool(rados) -> None:
    await rados.mon_command("osd pool create", {
        "pool_id": DST_POOL, "crush_rule": 1, "size": 3, "pg_num": 8})


def twin(script, *args, classes=False, cfg=None, timeout=180):
    """Run `script(cluster, admin, M, *args)` on both packages (M: the
    package's modules): equal masked observations and equal stores."""
    out = {}
    for name in (REF, PORT):
        async def main(name=name):
            cluster = Cluster(Package(name))
            for key, val in (cfg or {}).items():
                cluster.cfg.set(key, val)
            await cluster.start()
            try:
                M = mods(name)
                if classes:
                    register_classes(cluster, M)
                admin = cluster.client(name="client.admin")
                await admin.connect()
                await cluster.create_pools(admin)
                obs = await script(cluster, admin, M, *args)
                await admin.shutdown()
                return mask(obs), cluster.stores()
            finally:
                await cluster.stop()

        out[name] = run(main(), timeout=timeout)
    (ref_obs, ref_stores), (port_obs, port_stores) = out[REF], out[PORT]
    assert port_obs == ref_obs
    assert sum(len(rows) for rows in ref_stores.values()) > 0
    assert port_stores == ref_stores


async def maps(img) -> tuple:
    """The image's stored object-map and clean-map bytes."""
    out = []
    for oname in (img._map_name(), img._map_name() + ".clean"):
        saved, img.ioctx.snapc = img.ioctx.snapc, None
        try:
            out.append(await raised(img.ioctx.read(oname)))
        finally:
            img.ioctx.snapc = saved
    return tuple(out)


def seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


# -- tier 1: EC block semantics with snapshot, clone and object map ----------------


async def ec_block_round(cluster, admin, M) -> dict:
    """tests/test_rbd.py's block semantics and test_rbd_clone.py's
    object-map-exact story on the EC pool, with a snapshot, a protected
    clone, its copy-up and fast diff; the exclusive lock's holders."""
    io = admin.io_ctx(EC_POOL)
    obs = []
    img = await M.Image.create(io, "vol0", size=64 * 1024, order=12)
    obs.append(await img.read(0, 8192))
    payload = seeded(1, 10240)
    await img.write(3000, payload)
    obs += [await img.read(3000, len(payload)), await img.read(2990, len(payload) + 20)]
    await img.write(4096 + 100, b"X" * 50)
    obs += [await img.read(4096, 4096), await maps(img), await img.object_map_check()]
    reopened = await M.Image.open(io, "vol0", exclusive=True)
    second = cluster.client(name="client.b")
    await second.connect()
    obs += [(reopened.size, reopened.order), await reopened.lock_holders(),
            await raised(M.Image.open(second.io_ctx(EC_POOL), "vol0", exclusive=True))]
    await second.shutdown()
    obs.append(await raised(img.read(64 * 1024 - 10, 20)))
    await img.snap_create("s")
    await img.write(0, b"z" * 4096)
    await img.write(20000, seeded(2, 6000))
    obs += [await img.diff("s"), await maps(img), await img.object_map_check(),
            await img.read(0, 16384, snap_name="s"), await img.read(0, 32768)]
    await img.snap_protect("s")
    child = await M.Image.clone(io, "vol0", "s", io, "child")
    await child.write(5000, b"copy-up" * 10)
    obs += [await child.read(0, 16384), await maps(child), await child.object_map_check(),
            await raised(img.snap_unprotect("s"))]
    await img.resize(8 * 1024)
    obs += [await maps(img), await img.object_map_check()]
    await img.resize(64 * 1024)
    await img.snap_rollback("s")
    obs += [await img.read(0, 32768), await maps(img), await img.object_map_check()]
    again = await M.Image.open(io, "vol0")
    await again.object_map_rebuild()
    obs += [await maps(again), await again.object_map_check(), await child.read(0, 16384)]
    await child.flatten()
    obs += [child.parent, await child.read(0, 16384), await child.object_map_check()]
    await reopened.close()
    obs.append(await reopened.lock_holders())
    await child.remove()
    obs.append(await raised(M.Image.open(io, "child")))
    rimg = await M.Image.create(admin.io_ctx(REP_POOL), "rvol", size=16 * 1024, order=12)
    await rimg.write(5000, b"rep-data" * 100)
    obs.append(await rimg.read(5000, 800))
    return {"obs": obs}


def test_port_rbd_ec_block_snapshot_clone_object_map_match_ceph_tpu():
    twin(ec_block_round)


# -- tests/test_snapshots.py's five cases -----------------------------------------


def snap_objects(cluster, pool: int) -> int:
    """Clone objects (storage names with the snap separator) in `pool`."""
    total = 0
    for osd in cluster.osds.values():
        for coll in osd.store.list_collections():
            if coll.startswith(f"pg_{pool}_"):
                total += sum(1 for o in osd.store.list_objects(coll) if "\x1f" in o)
    return total


async def snap_read_round(cluster, admin, M) -> dict:
    obs = []
    for pool in (REP_POOL, EC_POOL):
        io = admin.io_ctx(pool)
        await io.write_full("obj", b"version-1")
        snap1 = await io.selfmanaged_snap_create()
        io.set_selfmanaged_snap_context(snap1, [snap1])
        await io.write_full("obj", b"version-2 bytes")
        snap2 = await io.selfmanaged_snap_create()
        io.set_selfmanaged_snap_context(snap2, [snap2, snap1])
        await io.write("obj", b"PATCH", off=0)
        obs += [await io.read("obj"), await io.read("obj", snapid=snap1),
                await io.read("obj", snapid=snap2), (snap1, snap2)]
        io.snapc = None
    return {"obs": obs, "clones": [snap_objects(cluster, p) for p in (REP_POOL, EC_POOL)]}


async def snap_delete_trim_round(cluster, admin, M) -> dict:
    io = admin.io_ctx(REP_POOL)
    await io.write_full("doc", b"precious")
    snap = await io.selfmanaged_snap_create()
    io.set_selfmanaged_snap_context(snap, [snap])
    await io.remove("doc")
    obs = [await raised(io.read("doc")), await io.read("doc", snapid=snap),
           snap_objects(cluster, REP_POOL)]
    await io.selfmanaged_snap_remove(snap)
    await cluster.wait_until(lambda: snap_objects(cluster, REP_POOL) == 0)
    io.snapc = None
    await io.write_full("doc", b"after the trim")
    obs.append(await io.read("doc"))
    return {"obs": obs}


async def snap_trim_ec_round(cluster, admin, M) -> dict:
    io = admin.io_ctx(EC_POOL)
    base = bytes(range(256)) * 16
    await io.write_full("eobj", base)
    snap = await io.selfmanaged_snap_create()
    io.set_selfmanaged_snap_context(snap, [snap])
    await io.write_full("eobj", b"new content")
    obs = [await io.read("eobj", snapid=snap) == base, snap_objects(cluster, EC_POOL),
           cluster.stores()]
    await io.selfmanaged_snap_remove(snap)
    await cluster.wait_until(lambda: snap_objects(cluster, EC_POOL) == 0)
    obs.append(await io.read("eobj"))
    return {"obs": obs}


async def rbd_snap_rollback_round(cluster, admin, M) -> dict:
    io = admin.io_ctx(EC_POOL)
    img = await M.Image.create(io, "snapvol", size=16 * 1024, order=12)
    await img.write(0, b"\x11" * 16 * 1024)
    await img.snap_create("s1")
    await img.write(4096, b"\x22" * 4096)
    obs = [await img.read(4096, 4096), await img.read(4096, 4096, snap_name="s1"),
           snap_objects(cluster, EC_POOL)]
    img2 = await M.Image.open(io, "snapvol")
    obs += [img2.snap_list(), await img2.read(0, 16 * 1024, snap_name="s1")]
    await img2.snap_rollback("s1")
    obs += [await img2.read(0, 16 * 1024), await maps(img2)]
    await img2.snap_remove("s1")
    obs.append(img2.snap_list())
    await cluster.wait_until(lambda: snap_objects(cluster, EC_POOL) == 0)
    return {"obs": obs}


async def snap_failover_round(cluster, admin, M) -> dict:
    io = admin.io_ctx(REP_POOL)
    await io.write_full("hist", b"old-state")
    snap = await io.selfmanaged_snap_create()
    io.set_selfmanaged_snap_context(snap, [snap])
    await io.write_full("hist", b"new-state")
    some = next(iter(cluster.osds.values()))
    _acting, primary = some.acting_of(REP_POOL, some.object_pg(REP_POOL, "hist"))
    await cluster.kill_osd(primary)
    await admin.mon_command("osd down", {"osd": primary})
    await cluster.wait_down(primary)
    return {"obs": [primary, await io.read("hist"), await io.read("hist", snapid=snap)]}


@pytest.mark.parametrize("script", [
    pytest.param(snap_read_round, marks=pytest.mark.slow, id="read_at_snap_both_pools"),
    pytest.param(snap_delete_trim_round, marks=pytest.mark.slow, id="survives_delete_and_trim"),
    pytest.param(snap_trim_ec_round, id="trim_ec_pool"),
    pytest.param(rbd_snap_rollback_round, id="rbd_create_rollback_remove"),
    pytest.param(snap_failover_round, marks=pytest.mark.slow, id="replicate_through_failover"),
])
def test_port_osd_snapshots_match_ceph_tpu(script):
    twin(script)


# -- the image format across packages ---------------------------------------------


@pytest.mark.parametrize("client_pkg,cluster_pkg", [(REF, PORT), (PORT, REF)])
def test_image_written_by_one_package_reads_in_the_other(client_pkg, cluster_pkg):
    """A client of one package makes an image on the EC pool of the other
    package's cluster (writes, a snapshot, a protected clone with copy-up);
    a client of the cluster's package opens and reads all of it, with equal
    object maps and diffs, and its own write reads back in the first."""

    async def main():
        cluster = Cluster(Package(cluster_pkg))
        await cluster.start()
        try:
            foreign = cluster.client(Package(client_pkg), "client.foreign")
            native = cluster.client(name="client.native")
            await foreign.connect()
            await native.connect()
            await cluster.create_pools(foreign)
            F, N = mods(client_pkg), mods(cluster_pkg)
            fio, nio = foreign.io_ctx(EC_POOL), native.io_ctx(EC_POOL)
            data = seeded(7, 40000)
            img = await F.Image.create(fio, "x", size=64 * 1024, order=12)
            await img.write(1000, data)
            await img.snap_create("s")
            await img.write(0, b"after" * 100)
            await img.snap_protect("s")
            child = await F.Image.clone(fio, "x", "s", fio, "xc")
            await child.write(8192, b"child" * 10)
            theirs = await N.Image.open(nio, "x", exclusive=True)
            assert await theirs.read(1000, len(data), snap_name="s") == data
            assert await theirs.read(0, 41000) == await img.read(0, 41000)
            assert await theirs.diff("s") == await img.diff("s") == [0]
            assert await maps(theirs) == await maps(img)
            assert await theirs.object_map_check() == []
            kid = await N.Image.open(nio, "xc")
            assert await kid.read(0, 41000) == await child.read(0, 41000)
            assert kid.parent == child.parent
            await theirs.write(30000, b"native" * 50)
            assert await img.read(30000, 300) == b"native" * 50
            assert [h["cookie"] for h in await img.lock_holders()] == ["client.native"]
            await theirs.close()
            await foreign.shutdown()
            await native.shutdown()
        finally:
            await cluster.stop()

    run(main())


# -- slow twins: locks, migration, the clone lifecycle, thrash, fast diff ------------


async def lock_round(cluster, admin, M) -> dict:
    """tests/test_rbd_lock_live.py: concurrent clones serialize on the
    cluster lock; EBUSY, break-lock with blocklisting, the fenced zombie's
    write refused; forced exclusive open."""
    ra, rb = cluster.client(name="client.a"), cluster.client(name="client.b")
    await ra.connect()
    await rb.connect()
    obs = []
    parent = await M.Image.create(admin.io_ctx(REP_POOL), "parent", 1 << 22, order=20)
    await parent.write(0, b"P" * 4096)
    await parent.snap_create("base")
    await parent.snap_protect("base")
    for rados, child in ((ra, "child-a"), (rb, "child-b")):
        io = rados.io_ctx(REP_POOL)
        await M.Image.clone(io, "parent", "base", io, child)
    fresh = await M.Image.open(admin.io_ctx(REP_POOL), "parent")
    obs += [fresh.children, await raised(fresh.snap_unprotect("base"))]
    for rados, child in ((ra, "child-a"), (rb, "child-b")):
        await (await M.Image.open(rados.io_ctx(REP_POOL), child)).flatten()
    obs.append((await M.Image.open(admin.io_ctx(REP_POOL), "parent")).children)

    img = await M.Image.create(admin.io_ctx(REP_POOL), "vol", 1 << 22, order=20)
    await img.write(0, b"X" * 8192)
    a = await M.Image.open(ra.io_ctx(REP_POOL), "vol", exclusive=True)
    await a.write(4096, b"A" * 100)
    b = await M.Image.open(rb.io_ctx(REP_POOL), "vol")
    obs.append(await raised(b.lock_acquire(timeout=0.3)))
    holders = await b.lock_holders()
    obs.append(holders)
    await b.break_lock(holders[0]["owner"])
    await b.lock_acquire()
    epoch = admin.objecter.osdmap.epoch
    await cluster.wait_until(lambda: all(o.osdmap.epoch >= epoch for o in cluster.osds.values()))
    obs.append(await raised(a.write(0, b"stale" * 100)))
    await b.write(1 << 20, b"B" * 4096)
    obs += [await b.object_map_check(), await b.read(0, 8192), await b.read(1 << 20, 4096),
            await maps(b)]
    rc = cluster.client(name="client.c")
    await rc.connect()
    c = await M.Image.open(rc.io_ctx(REP_POOL), "vol", exclusive=True, force=True)
    obs.append([h["cookie"] for h in await c.lock_holders()])
    epoch = admin.objecter.osdmap.epoch
    await cluster.wait_until(lambda: all(o.osdmap.epoch >= epoch for o in cluster.osds.values()))
    obs.append(await raised(b.write(0, b"stale" * 16)))
    for rados in (ra, rb, rc):
        await rados.shutdown()
    return {"obs": obs}


async def migration_round(cluster, admin, M) -> dict:
    """tests/test_rbd_migration_live.py: prepare, fenced source, read
    through, copy-up, execute, commit; then a second migration aborted."""
    await create_dst_pool(admin)
    src_io, dst_io = admin.io_ctx(REP_POOL), admin.io_ctx(DST_POOL)
    obs = []
    src = await M.Image.create(src_io, "vol", 1 << 22, order=20)
    await src.write(0, b"head" * 1000)
    await src.write(1 << 21, b"tail" * 500)
    dst = await M.Image.migration_prepare(src_io, "vol", dst_io, "vol-moved")
    other = await M.Image.open(src_io, "vol")
    obs.append(await raised(other.lock_acquire(timeout=0.3)))
    obs.append(await dst.read(0, 4000))
    await dst.write(0, b"NEW!")
    obs += [await dst.read(0, 8), await src.read(0, 4), await dst.migration_execute(),
            await dst.read(1 << 21, 2000)]
    await dst.migration_commit()
    obs += [dst.migration, await raised(M.Image.open(src_io, "vol"))]
    fresh = await M.Image.open(dst_io, "vol-moved")
    obs += [await fresh.read(0, 8), await fresh.object_map_check(), await maps(fresh)]
    keep = await M.Image.create(src_io, "keepme", 1 << 21, order=20)
    await keep.write(0, b"precious data")
    doomed = await M.Image.migration_prepare(src_io, "keepme", dst_io, "doomed")
    await doomed.write(4096, b"target-only bytes")
    await doomed.migration_abort()
    obs.append(await raised(M.Image.open(dst_io, "doomed")))
    back = await M.Image.open(src_io, "keepme")
    obs.append(await back.read(0, 13))
    await back.lock_acquire()
    await back.lock_release()
    return {"obs": obs}


async def clone_lifecycle_round(cluster, admin, M) -> dict:
    """tests/test_rbd_clone.py: protection, copy-up, flatten, unprotect,
    and a chained clone read through two parents."""
    io = admin.io_ctx(REP_POOL)
    obs = []
    parent = await M.Image.create(io, "base", size=32 * 1024, order=12)
    await parent.write(1000, bytes([7]) * 10000)
    await parent.snap_create("golden")
    obs.append(await raised(M.Image.clone(io, "base", "golden", io, "child")))
    await parent.snap_protect("golden")
    child = await M.Image.clone(io, "base", "golden", io, "child")
    obs += [await child.read(1000, 10000), await child.read(20000, 4096)]
    await parent.write(1000, bytes([9]) * 10000)
    await child.write(1500, b"X" * 10)
    obs += [await child.read(1000, 1000), await raised(parent.snap_unprotect("golden")),
            await raised(parent.snap_remove("golden"))]
    await child.flatten()
    obs += [child.parent, await child.object_map_check(), await maps(child)]
    parent = await M.Image.open(io, "base")
    await parent.snap_unprotect("golden")
    await parent.snap_remove("golden")
    obs += [parent.children, await child.read(0, 32 * 1024)]
    a = await M.Image.create(io, "a", size=16 * 1024, order=12)
    await a.write(0, b"A" * 6000)
    await a.snap_create("s1")
    await a.snap_protect("s1")
    b = await M.Image.clone(io, "a", "s1", io, "b")
    await b.write(6000, b"B" * 2000)
    await b.snap_create("s2")
    await b.snap_protect("s2")
    c = await M.Image.clone(io, "b", "s2", io, "c")
    await c.resize(24 * 1024)
    obs += [await c.read(0, 24 * 1024), await c.object_map_check()]
    return {"obs": obs}


async def thrash_round(cluster, admin, M) -> dict:
    """test_rbd_clone.py's object map under thrash: seeded writes and a
    snapshot while an OSD is marked down and back, then a clone."""
    io = admin.io_ctx(REP_POOL)
    rng = np.random.default_rng(79)
    img = await M.Image.create(io, "tvol", size=128 * 1024, order=12)
    victim = 1
    db = cluster.osds[victim].store.db
    for step in range(24):
        off = int(rng.integers(0, 120 * 1024))
        n = int(rng.integers(1, 6000))
        await img.write(off, bytes([step % 251]) * n)
        if step == 6:
            await img.snap_create(f"s{step}")
            await img.snap_protect(f"s{step}")
        if step == 8:
            await cluster.kill_osd(victim)
            await admin.mon_command("osd down", {"osd": victim})
            await cluster.wait_down(victim)
        if step == 16:
            await cluster.start_osd(victim, db=db)
            await cluster.wait_up(victim)
    child = await M.Image.clone(io, "tvol", "s6", io, "tchild")
    await child.write(3000, b"childbits")
    names = [(REP_POOL, f"rbd_data.tvol.{i:016x}") for i in range(32)]
    await cluster.wait_until(lambda: cluster.settled(names), timeout=60)
    return {"obs": [await child.object_map_check(), await img.object_map_check(),
                    await img.read(0, 128 * 1024), await child.read(0, 128 * 1024),
                    await maps(img), await img.diff("s6")]}


async def fast_diff_round(cluster, admin, M) -> dict:
    """test_rbd_clone.py's fast diff: exists XOR and the clean bits, and
    the pessimistic diff against an older snapshot."""
    img = await M.Image.create(admin.io_ctx(REP_POOL), "dv", size=64 * 1024, order=12)
    await img.write(0, b"a" * 4096)
    await img.write(8192, b"b" * 4096)
    await img.snap_create("s1")
    obs = [await img.diff("s1")]
    await img.write(8192, b"B" * 10)
    await img.write(16384, b"c" * 100)
    obs += [await img.diff("s1"), await maps(img)]
    await img.snap_create("s2")
    obs += [await img.diff("s2"), await img.diff("s1"), await maps(img)]
    return {"obs": obs}


@pytest.mark.slow
@pytest.mark.parametrize("script", [lock_round, migration_round, clone_lifecycle_round,
                                    thrash_round, fast_diff_round],
                         ids=["lock", "migration", "clone_lifecycle", "thrash", "fast_diff"])
def test_port_rbd_stories_match_ceph_tpu(script):
    twin(script, timeout=240)
