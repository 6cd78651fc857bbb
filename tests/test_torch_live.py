"""Twins of the live tier: the port's monitors, OSD daemons and client
against ceph_tpu's.

Each twin runs the same seeded script on a ceph_tpu cluster (JAX on the
CPU) and on a port cluster (`device="cpu"`): 3 monitors, 6 OSDs, a k2m2
`tpu` pool and a size-3 pool, in `tests/test_cluster_live.py`'s shape, over
real sockets in one process. The port's genesis map is ceph_tpu's, carried
across as `encode_osdmap` bytes. A twin compares what the client read and,
per OSD, every stored object and EC shard with its size and `hinfo`. It
leaves out object versions, map epochs, PG logs and launch counts: they
follow the order in which heartbeats, peering and recovery interleave on
the loop, which no seed fixes.

The cross-package test runs a client of one package against a cluster of
the other, both ways: the proof that the port speaks ceph_tpu's wire.

The port's messenger reports into the port's own race detector, so this
file installs it beside the one `conftest.py` installs and asserts it clean.
"""

import asyncio
import importlib
import os

import numpy as np
import pytest

from ceph_tpu.osd.osdmap import encode_osdmap
from ceph_tpu.vstart import initial_osdmap

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
N_OSDS = 6
REP_POOL = 1
EC_POOL = 2


@pytest.fixture(autouse=True, scope="module")
def _port_racecheck_clean():
    from ceph_tpu_torch.lint import racecheck

    if os.environ.get("CEPH_TPU_RACECHECK", "1") in ("", "0"):
        yield
        return
    racecheck.install()
    try:
        yield
        racecheck.assert_clean()
    finally:
        racecheck.uninstall()
        racecheck.reset()


class Package:
    """The live-tier classes of one package; the port's run on the CPU."""

    def __init__(self, name: str):
        def mod(m):
            return importlib.import_module(f"{name}.{m}")

        self.name = name
        self.Config = mod("common.config").Config
        self.FileDB = mod("common.kv").FileDB
        self.MonMap = mod("mon").MonMap
        self.Monitor = mod("mon").Monitor
        self.OSDService = mod("osd.daemon").OSDService
        self.Rados = mod("rados.client").Rados
        self.next_dispatch_event = mod("msg.messenger").next_dispatch_event
        self.shard_name = mod("osd.daemon").shard_name
        self.kw = {"device": "cpu"} if name == PORT else {}

    def genesis(self):
        base = initial_osdmap(N_OSDS)
        if self.name == REF:
            return base
        from ceph_tpu_torch.osd.osdmap import decode_osdmap

        return decode_osdmap(encode_osdmap(base), device="cpu")


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class Cluster:
    """3 mons + N_OSDS OSDs of one package (test_cluster_live's shape)."""

    def __init__(self, pkg: Package):
        self.pkg = pkg
        cfg = pkg.Config()
        cfg.set("mon_lease", 0.1)
        cfg.set("mon_election_timeout", 0.4)
        cfg.set("osd_heartbeat_interval", 0.15)
        # the scripts mark their victims down themselves; a grace that
        # outlasts a victim's time down keeps peers from reporting it failed
        # on revival off its stale heartbeat stamp (ROADMAP §C)
        cfg.set("osd_heartbeat_grace", 60)
        self.cfg = cfg
        self.monmap = pkg.MonMap(addrs=[("127.0.0.1", 0)] * 3)
        self.mons = []
        self.osds = {}

    async def start(self, n_osds=N_OSDS):
        self.mons = [self.pkg.Monitor(r, self.monmap, self.pkg.genesis(), config=self.cfg,
                                      **self.pkg.kw) for r in range(3)]
        for m in self.mons:
            await m.bind()
        for m in self.mons:
            m.go()
        for osd_id in range(n_osds):
            await self.start_osd(osd_id)

    async def start_osd(self, osd_id, db=None, **kw):
        osd = self.pkg.OSDService(osd_id, self.monmap, db=db, config=self.cfg, **kw,
                                  **self.pkg.kw)
        await osd.start()
        self.osds[osd_id] = osd
        return osd

    async def kill_osd(self, osd_id):
        await self.osds.pop(osd_id).stop()

    def client(self, pkg=None, name="client.twin"):
        pkg = pkg or self.pkg
        return pkg.Rados(name, self.monmap, config=self.cfg, **pkg.kw)

    @staticmethod
    async def create_pools(rados):
        await rados.mon_command("osd erasure-code-profile set", {
            "name": "k2m2", "profile": {"plugin": "tpu", "k": "2", "m": "2"}})
        await rados.mon_command("osd pool create", {
            "pool_id": REP_POOL, "crush_rule": 1, "size": 3, "pg_num": 8})
        await rados.mon_command("osd pool create", {
            "pool_id": EC_POOL, "crush_rule": 0, "erasure_code_profile": "k2m2", "pg_num": 8})

    def is_down(self, osd_id) -> bool | None:
        """The quorum leader's view of `osd_id`; None during an election."""
        leader = next((m for m in self.mons if m.is_leader), None)
        return None if leader is None else leader.osdmap.is_down(osd_id)

    async def wait_until(self, pred, timeout=30.0):
        loop = asyncio.get_running_loop()
        end = loop.time() + timeout
        while not pred():
            remaining = end - loop.time()
            if remaining <= 0:
                raise TimeoutError
            try:
                await asyncio.wait_for(self.pkg.next_dispatch_event(), min(0.25, remaining))
            except asyncio.TimeoutError:
                pass

    async def wait_down(self, osd_id):
        await self.wait_until(lambda: self.is_down(osd_id) is True)

    async def wait_up(self, osd_id):
        await self.wait_until(lambda: self.is_down(osd_id) is False)

    def unfilled(self, objects, on=None) -> list:
        """(pool, name, position) of every live acting member (of those in
        `on`, if given) lacking the object's copy or shard, or holding it at
        another version than the other members."""
        some = next(iter(self.osds.values()))
        out = []
        for (pool, name) in objects:
            acting, _primary = some.acting_of(pool, some.object_pg(pool, name))
            coll = f"pg_{pool}_{some.object_pg(pool, name)}"
            vers = {}
            for pos, osd in enumerate(acting):
                if on is not None and osd not in on or osd not in self.osds:
                    continue
                store = self.osds[osd].store
                obj = self.pkg.shard_name(name, pos if pool == EC_POOL else None)
                vers[pos] = store.getattrs(coll, obj).get("ver") if store.exists(coll, obj) else None
            newest = max((v for v in vers.values() if v is not None), default=None)
            out += [(pool, name, pos) for pos, v in vers.items() if v is None or v != newest]
        return out

    def complete(self, objects, on=None) -> bool:
        """Recovery has converged for `objects`: every live acting member
        (of those in `on`) holds its copy or shard at one version."""
        return not self.unfilled(objects, on)

    def settled(self, objects) -> bool:
        """Every PG holding one of `objects` is active on its primary with
        nothing to backfill: the daemons' own view that recovery is done."""
        some = next(iter(self.osds.values()))
        for pool, name in objects:
            ps = some.object_pg(pool, name)
            _acting, primary = some.acting_of(pool, ps)
            pg = self.osds[primary].pgs.get((pool, ps)) if primary in self.osds else None
            if pg is None or not pg.active or pg.backfill_targets or pg.self_backfill:
                return False
        return True

    def stores(self, on=None) -> dict:
        """Per OSD (of those in `on`, if given): (collection, object) ->
        (bytes, size, hinfo), PG metadata objects and versions left out."""
        view = {}
        for osd_id, osd in sorted(self.osds.items()):
            if on is not None and osd_id not in on:
                continue
            rows = {}
            for coll in osd.store.list_collections():
                if not coll.startswith("pg_"):
                    continue
                for obj in osd.store.list_objects(coll):
                    if obj.startswith("."):
                        continue
                    attrs = osd.store.getattrs(coll, obj)
                    hinfo = attrs.get("hinfo")
                    rows[(coll, obj)] = (
                        osd.store.read(coll, obj), attrs.get("size"),
                        None if hinfo is None else
                        (hinfo.total_chunk_size, list(hinfo.cumulative_shard_hashes)))
            view[osd_id] = rows
        return view

    async def stop(self):
        for osd in list(self.osds.values()):
            await osd.stop()
        for m in self.mons:
            await m.stop()


def payloads(seed: int, prefix: str, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {f"{prefix}{i}": rng.integers(0, 256, int(rng.integers(300, 5000)),
                                         dtype=np.uint8).tobytes() for i in range(n)}


async def write_all(rados, objects: dict) -> None:
    for (pool, name), data in objects.items():
        await rados.io_ctx(pool).write_full(name, data)


async def read_all(rados, names) -> list:
    return [await rados.io_ctx(pool).read(name) for pool, name in names]


def seeded_objects(seed: int, n: int) -> dict:
    objects = {}
    for pool in (REP_POOL, EC_POOL):
        for name, data in payloads(seed + pool, f"p{pool}-", n).items():
            objects[(pool, name)] = data
    return objects


async def kill_degraded_revive(cluster: Cluster, seed: int, *, keep_store: bool) -> dict:
    """Write, read, kill one OSD, degraded reads and writes, revive it
    (on its own store, or on an empty one) and wait for recovery."""
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    objects = seeded_objects(seed, 6)
    await write_all(rados, objects)
    obs = {"first": await read_all(rados, objects)}
    victim = 1
    db = cluster.osds[victim].store.db
    await cluster.kill_osd(victim)
    await rados.mon_command("osd down", {"osd": victim})
    await cluster.wait_down(victim)
    obs["degraded"] = await read_all(rados, objects)
    later = seeded_objects(seed + 10, 2)
    for pool in (REP_POOL, EC_POOL):  # overwrites and new objects while down
        later[(pool, f"p{pool}-0")] = later.pop((pool, f"p{pool}-1"))
    await write_all(rados, later)
    objects.update(later)
    await cluster.start_osd(victim, db=db if keep_store else None)
    await cluster.wait_up(victim)
    await cluster.wait_until(lambda: cluster.complete(objects), timeout=60)
    obs["recovered"] = await read_all(rados, objects)
    assert obs["recovered"] == list(objects.values())
    await rados.shutdown()
    return obs


async def mark_out_remap(cluster: Cluster, seed: int) -> dict:
    """Kill one OSD and mark it out: the PGs remap and recover. Reads that
    fail are observations too, and the unfilled acting positions are
    returned: the daemons rebuild no EC shard whose member moved position
    (in both packages), so a twin must show the same gap."""
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    objects = seeded_objects(seed, 8)
    await write_all(rados, objects)
    await cluster.kill_osd(1)
    await rados.mon_command("osd down", {"osd": 1})
    await cluster.wait_down(1)
    await rados.mon_command("osd out", {"osd": 1})
    await cluster.wait_until(lambda: cluster.settled(objects), timeout=60)
    reads = []
    for (pool, name), data in objects.items():
        try:
            reads.append(await rados.io_ctx(pool).read(name) == data)
        except Exception as e:  # noqa: BLE001 - the failure is the observation
            reads.append(type(e).__name__)
    await rados.shutdown()
    return {"reads": reads, "unfilled": cluster.unfilled(objects)}


async def restart_on_file_store(cluster: Cluster, seed: int, tmp: str) -> dict:
    """An OSD restarts on its durable FileDB store with its shards intact."""
    await cluster.kill_osd(2)
    path = os.path.join(tmp, cluster.pkg.name)
    db = cluster.pkg.FileDB(path)
    await cluster.start_osd(2, db=db)
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    objects = seeded_objects(seed, 4)
    await write_all(rados, objects)
    await cluster.kill_osd(2)
    db.close()
    await cluster.start_osd(2, db=cluster.pkg.FileDB(path))
    await cluster.wait_until(lambda: cluster.complete(objects), timeout=60)
    obs = {"read": await read_all(rados, objects)}
    await rados.shutdown()
    cluster.osds[2].store.db.close()
    return obs


async def expansion(cluster: Cluster, seed: int) -> dict:
    """A new OSD id boots with a crush location and recovery fills it.
    Only the new OSD's store is compared: in both packages an EC PG whose
    surviving members change position under the new map (an indep rule)
    leaves those members' new shards unfilled, so the old members' stores
    never settle."""
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    objects = seeded_objects(seed, 8)
    await write_all(rados, objects)
    await cluster.start_osd(N_OSDS, crush_location={"host": f"host{N_OSDS}"})
    await cluster.wait_until(
        lambda: all(N_OSDS < o.osdmap.max_osd and not o.osdmap.is_down(N_OSDS)
                    for o in cluster.osds.values()))
    await cluster.wait_until(lambda: cluster.complete(objects, on={N_OSDS}), timeout=60)
    obs = {"read": await read_all(rados, objects)}
    await rados.shutdown()
    return obs


def twin(script, *args, on=None, **kw):
    """Run `script(cluster, *args)` on both packages: equal reads, equal
    stores (of the OSDs in `on`, if given)."""
    out = {}
    for name in (REF, PORT):
        async def main(name=name):
            cluster = Cluster(Package(name))
            await cluster.start()
            try:
                obs = await script(cluster, *args, **kw)
                return obs, cluster.stores(on=on)
            finally:
                await cluster.stop()

        out[name] = run(main())
    (ref_obs, ref_stores), (port_obs, port_stores) = out[REF], out[PORT]
    assert port_obs == ref_obs
    assert sum(len(rows) for rows in ref_stores.values()) > 0
    assert port_stores == ref_stores


def test_port_daemons_match_ceph_tpu_through_kill_and_recovery():
    twin(kill_degraded_revive, 1, keep_store=True)


@pytest.mark.slow
def test_port_daemons_match_ceph_tpu_through_amnesiac_revival():
    twin(kill_degraded_revive, 2, keep_store=False)


@pytest.mark.slow
def test_port_daemons_match_ceph_tpu_through_mark_out():
    twin(mark_out_remap, 6)


@pytest.mark.slow
def test_port_daemons_match_ceph_tpu_restarting_on_a_file_store(tmp_path):
    twin(restart_on_file_store, 3, str(tmp_path))


@pytest.mark.slow
def test_port_daemons_match_ceph_tpu_through_expansion():
    twin(expansion, 4, on={N_OSDS})


@pytest.mark.parametrize("client_pkg,cluster_pkg", [(REF, PORT), (PORT, REF)])
def test_client_and_cluster_of_different_packages(client_pkg, cluster_pkg):
    """A client of one package writes to a cluster of the other and reads
    back, EC direct-shard reads included; a client of the cluster's own
    package then reads what it stored. One event loop carries both."""

    async def main():
        cluster = Cluster(Package(cluster_pkg))
        await cluster.start()
        try:
            foreign = cluster.client(Package(client_pkg), "client.foreign")
            native = cluster.client(name="client.native")
            await foreign.connect()
            await native.connect()
            await cluster.create_pools(foreign)
            objects = seeded_objects(5, 6)
            await write_all(foreign, objects)
            assert await read_all(foreign, objects) == list(objects.values())
            assert await read_all(native, objects) == list(objects.values())
            ec = foreign.io_ctx(EC_POOL)
            ec.read_policy = "balance"
            for (pool, name), data in objects.items():
                if pool == EC_POOL:
                    assert await ec.read(name) == data
            direct = sum(o.perf.dump().get("read_shard_direct", 0)
                         for o in cluster.osds.values())
            assert direct > 0
            if cluster_pkg == PORT:
                # `perf dump` carries the codec's block beside the OSD's
                for o in cluster.osds.values():
                    codec = o.perf_collection.dump()["ec_codec"]
                    assert {"decode_table_hits", "decode_table_misses",
                            "decode_table_evictions", "gf_matmul_packed_launches",
                            "gf_matmul_bitplane_launches"} <= set(codec)
            await foreign.shutdown()
            await native.shutdown()
        finally:
            await cluster.stop()

    run(main())
