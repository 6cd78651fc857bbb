"""Twins of the file layer: ceph_tpu_torch.cephfs against ceph_tpu.cephfs.

The scripts are tests/test_mds_live.py's (sessions, caps with their revoke
round trip, the namespace, and the standby's journal replay after the
active dies) and, marked slow, tests/test_cephfs_snap_live.py's,
tests/test_mds_multiactive_live.py's and tests/test_dirfrags_live.py's.
Each runs on a ceph_tpu cluster and a port cluster (`device="cpu"`) of
tests/test_torch_live.py's shape, with the cephfs and journal classes on
every OSD and the MDS daemons in the test's process (the port's on
`device="cpu"`), beacons every 0.2 s and a grace of 1.5 s. Compared with
tolerance 0: the directory listings, stats, file bytes, the errors'
codes, the failover's roles, a resent request's answer, and per OSD every
stored object with its size.

Also here: both packages refuse CephFS on the EC pool (no omap there).
"""

import itertools

import pytest

from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, REP_POOL, Cluster, Package, _port_racecheck_clean, run,
)
from tests.test_torch_rbd import mask, mods, raised, register_classes

MDS_CFG = {"mds_beacon_interval": 0.2, "mds_beacon_grace": 1.5}


def fs_twin(script, *args, n_mds=2, actives=1, cfg=None, timeout=240):
    """Run `script(cluster, admin, M, mdss, *args)` on both packages with
    `n_mds` MDS daemons, `actives` of them active: equal masked
    observations and equal stores."""
    out = {}
    for name in (REF, PORT):
        async def main(name=name):
            cluster = Cluster(Package(name))
            for key, val in {**MDS_CFG, **(cfg or {})}.items():
                cluster.cfg.set(key, val)
            await cluster.start()
            mdss = []
            try:
                M = mods(name)
                register_classes(cluster, M)
                admin = cluster.client(name="client.fsadmin")
                await admin.connect()
                await cluster.create_pools(admin)
                for i in range(n_mds):
                    mds = M.MDSService(f"mds.{chr(97 + i)}", cluster.monmap, REP_POOL,
                                       config=cluster.cfg, **M.kw)
                    await mds.start()
                    mdss.append(mds)
                await cluster.wait_until(lambda: sum(m.active for m in mdss) == actives)
                obs = await script(cluster, admin, M, mdss, *args)
                await admin.shutdown()
                return mask(obs), cluster.stores()
            finally:
                for m in mdss:
                    if not m._stopped:
                        await m.stop()
                await cluster.stop()

        out[name] = run(main(), timeout=timeout)
    (ref_obs, ref_stores), (port_obs, port_stores) = out[REF], out[PORT]
    assert port_obs == ref_obs
    assert sum(len(rows) for rows in ref_stores.values()) > 0
    assert port_stores == ref_stores


def roles(mdss) -> list:
    return [(m.name, m.active, m.rank) for m in mdss]


async def sessions_caps_round(cluster, admin, M, mdss) -> dict:
    """Sessions against the active, the namespace, EEXIST through the
    session, a second client's cached read revoked by a writer, rename,
    unlink and rmdir."""
    fs1 = M.cephfs.CephFSClient(admin, REP_POOL)
    await fs1.mount()
    await fs1.mkfs()
    obs = [roles(mdss), await fs1.mkdir("/a"), await fs1.mkdir("/a/b"),
           await fs1.write_file("/a/b/hello.txt", b"hi there"),
           await fs1.read_file("/a/b/hello.txt"), await fs1.listdir("/a"),
           await fs1.stat("/a/b/hello.txt")]
    err = await raised(fs1.mkdir("/a"))
    obs.append((type(err).__name__, err.code))
    rados2 = cluster.client(name="client.fs2")
    await rados2.connect()
    fs2 = M.cephfs.CephFSClient(rados2, REP_POOL)
    await fs2.mount()
    obs.append(await fs2.read_file("/a/b/hello.txt"))
    await fs1.write_file("/a/b/hello.txt", b"rewritten!")
    await cluster.wait_until(lambda: fs2.revokes_seen >= 1)
    obs += [fs2.revokes_seen, await fs2.read_file("/a/b/hello.txt")]
    await fs1.rename("/a/b/hello.txt", "/a/moved.txt")
    obs.append(await fs1.listdir("/a"))
    await fs1.unlink("/a/moved.txt")
    await fs1.rmdir("/a/b")
    obs += [await fs1.listdir("/a"), await fs1.listdir("/")]
    await rados2.shutdown()
    return {"obs": obs}


async def failover_round(cluster, admin, M, mdss) -> dict:
    """The active dies without a goodbye; the standby takes the rank by
    beacon-grace expiry and replays the journal. A resend of the last
    mutation the dead active completed is answered from the replay, not
    executed again; the namespace and the files survive; the new active
    serves mutations."""
    fs = M.cephfs.CephFSClient(admin, REP_POOL)
    await fs.mount()
    await fs.mkfs()
    await fs.mkdir("/docs")
    for i in range(6):
        await fs.write_file(f"/docs/f{i}", bytes([i]) * (100 + 4000 * i))
    tid = next(fs._tids)
    fs._tids = itertools.chain([tid], fs._tids)
    obs = [await fs.mkdir("/docs/last"), roles(mdss)]
    active = next(m for m in mdss if m.active)
    standby = next(m for m in mdss if not m.active)
    await active.stop()
    await cluster.wait_until(lambda: standby.active, timeout=30)
    fs._tids = itertools.chain([tid], fs._tids)
    obs += [roles(mdss), await fs.mkdir("/docs/last"), len(standby._replayed),
            await fs.listdir("/docs")]
    obs += [await fs.read_file(f"/docs/f{i}") for i in range(6)]
    err = await raised(fs.mkdir("/docs/last"))
    obs += [(type(err).__name__, err.code), await fs.mkdir("/docs/after"),
            await fs.listdir("/docs"), standby._applied_pos]
    return {"obs": obs}


@pytest.mark.parametrize("script", [sessions_caps_round, failover_round],
                         ids=["sessions_caps", "failover_replay"])
def test_port_mds_matches_ceph_tpu(script):
    fs_twin(script)


def test_cephfs_on_the_ec_pool_is_refused_in_both_packages():
    """Directories are omap objects, and an EC pool has no omap: the
    direct library's first mkdir and the MDS's fail with EOPNOTSUPP in
    both packages, and nothing is left behind but what each wrote."""

    async def script(cluster, admin, M, mdss):
        direct = M.cephfs.FileSystem(admin.io_ctx(EC_POOL))
        obs = [await raised(direct.mkfs()), await raised(direct.mkdir("/a"))]
        fs = M.cephfs.CephFSClient(admin, EC_POOL)
        await fs.mount()
        await fs.mkfs()
        err = await raised(fs.mkdir("/a"))
        obs.append((type(err).__name__, getattr(err, "code", None), str(err)))
        return {"obs": obs}

    out = {}
    for name in (REF, PORT):
        async def main(name=name):
            cluster = Cluster(Package(name))
            for key, val in MDS_CFG.items():
                cluster.cfg.set(key, val)
            await cluster.start()
            mdss = []
            try:
                M = mods(name)
                register_classes(cluster, M)
                admin = cluster.client(name="client.fsadmin")
                await admin.connect()
                await cluster.create_pools(admin)
                mds = M.MDSService("mds.a", cluster.monmap, EC_POOL, config=cluster.cfg, **M.kw)
                await mds.start()
                mdss.append(mds)
                await cluster.wait_until(lambda: mds.active)
                obs = await script(cluster, admin, M, mdss)
                await admin.shutdown()
                return mask(obs)
            finally:
                for m in mdss:
                    await m.stop()
                await cluster.stop()

        out[name] = run(main())
    assert out[PORT] == out[REF]
    assert "EOPNOTSUPP" in str(out[PORT]["obs"][1])
    assert "EOPNOTSUPP" in out[PORT]["obs"][2][2]


# -- slow twins: snapshots, multi-active, dirfrags -----------------------------------


async def snapshots_round(cluster, admin, M, mdss) -> dict:
    """tests/test_cephfs_snap_live.py: snapshots of a directory, reads at
    them after overwrites and an unlink, both surviving a failover, then
    rmsnap."""
    r = cluster.client(name="client.fs")
    await r.connect()
    fs = M.cephfs.CephFSClient(r, REP_POOL)
    await fs.mount()
    await fs.mkfs()
    await fs.mkdir("/proj")
    await fs.write_file("/proj/report", b"version one")
    await fs.write_file("/proj/const", b"never rewritten")
    obs = [await fs.mksnap("/proj", "s1")]
    await fs.write_file("/proj/report", b"version TWO, longer")
    obs += [await fs.read_file("/proj/report"), await fs.read_file("/proj/.snap/s1/report"),
            await fs.read_file("/proj/.snap/s1/const"), await fs.listdir("/proj/.snap"),
            await fs.listdir("/proj/.snap/s1"), await raised(fs.open("/proj/.snap/s1/report", "w"))]
    await fs.unlink("/proj/const")
    obs += [await fs.listdir("/proj"), await fs.read_file("/proj/.snap/s1/const"),
            await fs.mksnap("/proj", "s2")]
    await fs.write_file("/proj/report", b"v3")
    active = next(m for m in mdss if m.active)
    standby = next(m for m in mdss if not m.active)
    await active.stop()
    await cluster.wait_until(lambda: standby.active, timeout=30)
    obs += [await fs.read_file("/proj/.snap/s1/report"),
            await fs.read_file("/proj/.snap/s2/report"), await fs.read_file("/proj/report"),
            await fs.listdir("/proj/.snap")]
    await fs.rmsnap("/proj", "s1")
    obs += [await fs.listdir("/proj/.snap"), await raised(fs.read_file("/proj/.snap/s1/report"))]
    await r.shutdown()
    return {"obs": obs}


def rank_dirs(hash_fn) -> tuple:
    """Two top-level directory names, owned by rank 0 and by rank 1."""
    return tuple(next(f"zone{i}" for i in range(64) if hash_fn(f"zone{i}") % 2 == r)
                 for r in (0, 1))


async def multiactive_round(cluster, admin, M, mdss) -> dict:
    """tests/test_mds_multiactive_live.py: two active ranks partition the
    namespace by top-level hash, each with its journal; the standby takes
    rank 1 when its holder dies and replays that journal."""
    from ceph_tpu_torch.common.hash import ceph_str_hash_rjenkins

    by_rank = {m.rank: m for m in mdss if m.active}
    standby = next(m for m in mdss if not m.active)
    r = cluster.client(name="client.ma")
    await r.connect()
    fs = M.cephfs.CephFSClient(r, REP_POOL)
    await fs.mount()
    await fs.mkfs()
    d0, d1 = rank_dirs(ceph_str_hash_rjenkins)
    await fs.mkdir(f"/{d0}")
    await fs.mkdir(f"/{d1}")
    for i in range(4):
        await fs.write_file(f"/{d0}/a{i}", f"rank0 {i}".encode())
        await fs.write_file(f"/{d1}/b{i}", f"rank1 {i}".encode())
    obs = [roles(mdss), len(fs._mds_conns), by_rank[0]._applied_pos, by_rank[1]._applied_pos,
           by_rank[0]._owns({"path": f"/{d1}/b0"}), await fs.listdir("/")]
    await by_rank[1].stop()
    await cluster.wait_until(lambda: standby.active and standby.rank == 1, timeout=30)
    obs += [await fs.read_file(f"/{d1}/b2"), await fs.read_file(f"/{d0}/a2")]
    await fs.write_file(f"/{d1}/post-failover", b"new rank1")
    obs += [await fs.read_file(f"/{d1}/post-failover"), standby._applied_pos, roles(mdss)]
    await r.shutdown()
    return {"obs": obs}


async def dirfrags_round(cluster, admin, M, mdss) -> dict:
    """tests/test_dirfrags_live.py: a directory past the split size
    fragments, lists, stats, renames and unlinks across its fragments,
    and survives a failover."""
    active = next(m for m in mdss if m.active)
    standby = next(m for m in mdss if not m.active)
    r = cluster.client(name="client.frag")
    await r.connect()
    fs = M.cephfs.CephFSClient(r, REP_POOL)
    await fs.mount()
    await fs.mkfs()
    await fs.mkdir("/big")
    big_ino = (await fs.stat("/big"))["ino"]
    names = [f"file-{i:03d}" for i in range(20)]
    for n in names:
        await fs.write_file(f"/big/{n}", f"data {n}".encode())
    obs = [await active._dir_bits(big_ino), await fs.listdir("/big"),
           await fs.stat("/big/file-007")]
    await fs.rename("/big/file-003", "/big/renamed")
    await fs.unlink("/big/file-004")
    await active.stop()
    await cluster.wait_until(lambda: standby.active, timeout=30)
    obs += [await fs.listdir("/big"), await fs.read_file("/big/renamed"),
            await standby._dir_bits(big_ino)]
    for i in range(20, 30):
        await fs.write_file(f"/big/file-{i:03d}", b"more")
    obs += [await standby._dir_bits(big_ino), sorted(await fs.listdir("/big"))]
    await r.shutdown()
    return {"obs": obs}


@pytest.mark.slow
@pytest.mark.parametrize("script,kw", [
    (snapshots_round, {}),
    (multiactive_round, {"n_mds": 3, "actives": 2, "cfg": {"mds_max_active": 2}}),
    (dirfrags_round, {"cfg": {"mds_bal_split_size": 6}}),
], ids=["snapshots", "multi_active", "dirfrags"])
def test_port_cephfs_stories_match_ceph_tpu(script, kw):
    fs_twin(script, **kw)

