"""Twins of the journal layer: ceph_tpu_torch.journal against ceph_tpu.journal.

The scripts are tests/test_mirror_live.py's: the `Journaler`'s append,
read, commit and trim, and a journaled `MirroredImage` replayed by an
`ImageReplayer`, here on one cluster from the EC pool into a replicated
pool, and (slow) between two clusters as the reference test runs it. Each
runs on a ceph_tpu cluster and a port cluster (`device="cpu"`) of
tests/test_torch_live.py's shape, with the journal class registered on
every OSD. Compared with tolerance 0: the journal entries, head and commit
positions, the replica's reads, and per OSD every stored object and EC
shard with its size and `hinfo`.
"""

import numpy as np
import pytest

from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, REP_POOL, Cluster, Package, _port_racecheck_clean, run,
)
from tests.test_torch_rbd import DST_POOL, create_dst_pool, mask, mods, twin


async def journal_round(cluster, admin, M) -> dict:
    """Append, read, commit and trim on both pools; commit never outruns
    the head; a reader of a journal that does not exist sees it empty."""
    obs = []
    for pool in (REP_POOL, EC_POOL):
        j = M.journal.Journaler(admin.io_ctx(pool), "t")
        obs.append(await j.read())
        obs.append([await j.append({"n": n, "blob": "ab" * n}) for n in (1, 2, 3)])
        obs.append(await j.read())
        obs.append(await j.read(from_pos=2, limit=1))
        obs.append(await j.commit_and_trim(2))
        obs.append(await j.read())
        obs.append(await j.commit_and_trim(99))
        obs.append(await j.append({"n": 4}))
        obs.append(await j.read())
    return {"obs": obs}


async def mirror_replay_round(cluster, admin, M) -> dict:
    """A journaled image on the EC pool, replayed into DST_POOL in two
    rounds (writes across objects, an overwrite, a resize); the replica
    reads equal to the source and the journal ends trimmed."""
    await create_dst_pool(admin)
    src, dst = admin.io_ctx(EC_POOL), admin.io_ctx(DST_POOL)
    rng = np.random.default_rng(14)
    img = await M.journal.MirroredImage.create(src, "mirrored", 32 * 1024, order=12)
    obs = []
    replayer = M.journal.ImageReplayer(src, dst, "mirrored")
    for rnd in range(2):
        for _ in range(5):
            n = int(rng.integers(1, 9000))
            off = int(rng.integers(0, 32 * 1024 - n))
            await img.write(off, rng.bytes(n))
        if rnd:
            await img.resize(20 * 1024)
        obs.append((await img.journal.read())["head"])
        obs.append(await replayer.run_once(batch=4))
        remote = await M.Image.open(dst, "mirrored")
        obs += [(remote.size, remote.order), await remote.read(0, remote.size)
                == await img.read(0, img.image.size)]
    obs += [await replayer.run_once(), await img.journal.read(),
            await (await M.Image.open(dst, "mirrored")).object_map_check()]
    return {"obs": obs}


@pytest.mark.parametrize("script", [journal_round, mirror_replay_round],
                         ids=["journaler", "mirror_replay"])
def test_port_journal_matches_ceph_tpu(script):
    twin(script, classes=True)


async def two_site_round(site_a, site_b, M) -> dict:
    """tests/test_mirror_live.py's two-cluster mirror: create and two
    writes replayed, then an overwrite and a resize incrementally."""
    ra, rb = site_a.client(name="client.site_a"), site_b.client(name="client.site_b")
    await ra.connect()
    await rb.connect()
    await site_a.create_pools(ra)
    await site_b.create_pools(rb)
    io_a, io_b = ra.io_ctx(REP_POOL), rb.io_ctx(REP_POOL)
    img = await M.journal.MirroredImage.create(io_a, "mirrored", 32 * 1024, order=12)
    await img.write(1000, b"alpha" * 100)
    await img.write(5000, b"beta" * 200)
    replayer = M.journal.ImageReplayer(io_a, io_b, "mirrored")
    obs = [await replayer.run_once()]
    remote = await M.Image.open(io_b, "mirrored")
    obs += [(remote.size, remote.order), await remote.read(0, 32 * 1024)]
    await img.write(1000, b"ALPHA" * 100)
    await img.resize(16 * 1024)
    obs += [await replayer.run_once(), await (await M.Image.open(io_b, "mirrored")).read(
        0, 16 * 1024), await replayer.run_once(),
        await M.journal.Journaler(io_a, "img.mirrored").read()]
    await ra.shutdown()
    await rb.shutdown()
    return {"obs": obs}


@pytest.mark.slow
def test_port_two_cluster_mirror_matches_ceph_tpu():
    out = {}
    for name in (REF, PORT):
        async def main(name=name):
            sites = [Cluster(Package(name)), Cluster(Package(name))]
            for site in sites:
                await site.start()
            try:
                M = mods(name)
                for osd in sites[0].osds.values():
                    M.register_journal_classes(osd)
                obs = await two_site_round(*sites, M)
                return mask(obs), [site.stores() for site in sites]
            finally:
                for site in sites:
                    await site.stop()

        out[name] = run(main(), timeout=240)
    assert out[PORT] == out[REF]
    assert all(sum(len(rows) for rows in s.values()) > 0 for s in out[REF][1])
