"""The port's MiniCluster (ceph_tpu_torch/rados/cluster.py) against the JAX
package's, on the CPU, tolerance 0.

Each scenario of tests/test_data_path.py (all but the C-oracle hash test)
runs on a `ceph_tpu` MiniCluster and on its port twin. The map is built once,
in `ceph_tpu`, and carried across in one way only: `encode_osdmap` bytes,
read by the port's `decode_osdmap(raw, device="cpu")`. Both clusters then
run the same seeded operations, each with the original test's assertions.
Compared, exactly: everything a scenario observed (bytes read back, recover
counts, scrub error lists, errors raised), and afterwards every store (keys,
bytes, `hinfo`, `ver`, fault state, read/write counts), the object registry,
the non-time perf counters and the map's encoded bytes.

The helpers here (`port_twin`, `run_twin`) serve test_torch_thrash.py and
test_torch_scrub.py too.
"""

import dataclasses

import numpy as np
import pytest

from ceph_tpu.osd.osdmap import encode_osdmap as jax_encode_osdmap
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, decode_osdmap, encode_osdmap
from ceph_tpu_torch.rados import MiniCluster
from tests.test_data_path import CLAY_POOL, EC_POOL, REP_POOL
from tests.test_data_path import build_cluster as jax_build_cluster


def port_twin(jc) -> MiniCluster:
    """A port MiniCluster on the CPU over `jc`'s map, carried as bytes."""
    osdmap = decode_osdmap(jax_encode_osdmap(jc.osdmap), device="cpu")
    profiles = {p: None if v is None else dict(v) for p, v in jc.profiles.items()}
    return MiniCluster(osdmap=osdmap, profiles=profiles, device="cpu")


def _attr(value):
    if hasattr(value, "cumulative_shard_hashes"):  # either package's HashInfo
        return ("hinfo", value.total_chunk_size, list(value.cumulative_shard_hashes))
    return value


def cluster_state(c) -> dict:
    """Everything a twin must hold equal after a scenario."""
    stores = {
        osd: {
            "objects": dict(st.objects),
            "attrs": {k: {n: _attr(v) for n, v in a.items()} for k, a in st.attrs.items()},
            "alive": st.alive,
            "eio_keys": set(st.eio_keys),
            "inject_transient_every": st.inject_transient_every,
            "rng": st._rng.getstate(),
            "counts": (st.reads, st.bytes_read, st.writes),
        }
        for osd, st in c.stores.items()
    }
    perf = {
        k: v for k, v in c.admin.handle("perf dump")["mini_cluster"].items()
        if not k.endswith("_latency")
    }
    registry = {key: (info.size, info.version) for key, info in c.registry.items()}
    return {"stores": stores, "perf": perf, "registry": registry}


def observed(value):
    """A scenario observation in a form both packages share."""
    if isinstance(value, list):
        return [observed(v) for v in value]
    if dataclasses.is_dataclass(value):  # ScrubError
        return dataclasses.astuple(value)
    return value


def run_twin(build, scenario, *args):
    """Run `scenario(cluster, obs, *args)` on the JAX package's cluster and
    on its port twin; every observation and the final state must agree."""
    jc = build()
    pc = port_twin(jc)
    assert pc.osdmap.device.type == "cpu"
    j_obs, p_obs = [], []
    scenario(jc, j_obs, *args)
    scenario(pc, p_obs, *args)
    assert observed(p_obs) == observed(j_obs)
    assert cluster_state(pc) == cluster_state(jc)
    assert encode_osdmap(pc.osdmap) == jax_encode_osdmap(jc.osdmap)
    return pc, p_obs


def error_of(fn):
    """(type name, errno) of what `fn` raises; fails if it returns."""
    with pytest.raises(Exception) as e:
        fn()
    return (type(e.value).__name__, getattr(e.value, "code", None))


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


# -- the scenarios of tests/test_data_path.py --------------------------------


def put_get_roundtrip(c, obs):
    for pool in (EC_POOL, REP_POOL):
        for i in range(8):
            data = payload(3000 + 517 * i, seed=i)
            c.put(pool, f"obj-{i}", data)
            got = c.get(pool, f"obj-{i}")
            assert got == data
            obs.append(got)


def shards_land_where_crush_says(c, obs):
    c.put(EC_POOL, "placed", payload(4096, seed=1))
    pg, acting = c.acting(EC_POOL, "placed")
    obs.append((pg, acting))
    assert len(acting) == 6
    for shard, osd in enumerate(acting):
        assert osd != CRUSH_ITEM_NONE
        assert (EC_POOL, pg, "placed", shard) in c.stores[osd].objects
    for osd, store in c.stores.items():
        if osd not in acting:
            assert not any("placed" in k for k in store.objects)


def degraded_read_after_killing_m_osds(c, obs):
    data = payload(5000, seed=2)
    c.put(EC_POOL, "victim", data)
    _, acting = c.acting(EC_POOL, "victim")
    for osd in acting[:2]:  # m = 2 losses, incl. shard 0
        c.kill_osd(osd)
    got = c.get(EC_POOL, "victim")
    assert got == data
    obs.append(got)
    c.kill_osd(acting[2])  # a third loss: an error, not garbage
    obs.append(error_of(lambda: c.get(EC_POOL, "victim")))


def degraded_read_uses_minimum_shards(c, obs):
    data = payload(8192, seed=3)
    c.put(EC_POOL, "minread", data)
    _, acting = c.acting(EC_POOL, "minread")
    for kill in (None, acting[1]):
        if kill is not None:
            c.kill_osd(kill)
        for s in c.stores.values():
            s.reads = 0
        got = c.get(EC_POOL, "minread")
        assert got == data
        reads = {o: s.reads for o, s in c.stores.items() if s.reads}
        assert sum(reads.values()) == 4  # k, not k+m
        obs.append((got, reads))


def eio_injection_recovers(c, obs):
    data = payload(6000, seed=4)
    c.put(EC_POOL, "eio-obj", data)
    pg, acting = c.acting(EC_POOL, "eio-obj")
    c.stores[acting[0]].eio_keys.add((EC_POOL, pg, "eio-obj", 0))
    got = c.get(EC_POOL, "eio-obj")
    assert got == data
    obs.append(got)


def transient_failures_are_retried(c, obs):
    data = payload(4000, seed=5)
    c.put(EC_POOL, "flaky", data)
    for s in c.stores.values():
        s.inject_transient_every = 4  # 1-in-4 ops fail once
    for _ in range(10):
        got = c.get(EC_POOL, "flaky")
        assert got == data
        obs.append(got)


def thrash_kill_revive_recover(c, obs):
    objs = {f"t-{i}": payload(2048 + 777 * i, seed=10 + i) for i in range(6)}
    for name, data in objs.items():
        c.put(EC_POOL, name, data)
    victim = c.acting(EC_POOL, "t-0")[1][0]
    c.kill_osd(victim)
    for name, data in objs.items():
        assert c.get(EC_POOL, name) == data
    c.revive_osd(victim)
    rebuilt = c.recover(EC_POOL)
    assert rebuilt > 0
    obs.append(rebuilt)
    for name in objs:
        pg, acting = c.acting(EC_POOL, name)
        for shard, osd in enumerate(acting):
            if osd != CRUSH_ITEM_NONE:
                assert (EC_POOL, pg, name, shard) in c.stores[osd].objects
    for s in c.stores.values():
        s.inject_transient_every = 0
    for name, data in objs.items():
        got = c.get(EC_POOL, name)
        assert got == data
        obs.append(got)


def clay_recovery_reads_subchunk_fraction(c, obs):
    ec = c.codec(CLAY_POOL)
    chunk = ec.get_chunk_size(1)
    data = payload(chunk * 4, seed=20)
    c.put(CLAY_POOL, "msr", data)
    pg, acting = c.acting(CLAY_POOL, "msr")
    del c.stores[acting[3]].objects[(CLAY_POOL, pg, "msr", 3)]
    for s in c.stores.values():
        s.reads = s.bytes_read = 0
    assert c.recover(CLAY_POOL) == 1
    total_read = sum(s.bytes_read for s in c.stores.values())
    frac = ec.get_sub_chunk_count() // ec.q
    assert total_read == ec.d * frac * (chunk // ec.get_sub_chunk_count())
    assert total_read < 4 * chunk  # less than a naive k-chunk read
    obs.append(total_read)
    got = c.get(CLAY_POOL, "msr")
    assert got == data
    obs.append(got)


def remap_after_permanent_loss(c, obs):
    data = payload(9000, seed=30)
    c.put(EC_POOL, "migrate", data)
    old_acting = c.acting(EC_POOL, "migrate")[1]
    victim = old_acting[2]
    c.kill_osd(victim)
    assert c.acting(EC_POOL, "migrate")[1][2] == CRUSH_ITEM_NONE
    c.osdmap.mark_out(victim)
    new_acting = c.acting(EC_POOL, "migrate")[1]
    assert new_acting != old_acting
    assert victim not in new_acting and CRUSH_ITEM_NONE not in new_acting
    rebuilt = c.recover(EC_POOL)
    assert rebuilt > 0
    got = c.get(EC_POOL, "migrate")
    assert got == data
    obs.extend([new_acting, rebuilt, got])


def recover_plans_around_eio_shards(c, obs):
    data = payload(4096, seed=40)
    c.put(EC_POOL, "eio-rec", data)
    pg, acting = c.acting(EC_POOL, "eio-rec")
    del c.stores[acting[0]].objects[(EC_POOL, pg, "eio-rec", 0)]
    c.stores[acting[1]].eio_keys.add((EC_POOL, pg, "eio-rec", 1))
    assert c.recover(EC_POOL) == 2
    got = c.get(EC_POOL, "eio-rec")
    assert got == data
    obs.append(got)


def replicated_recovery_uses_stray_copies(c, obs):
    data = payload(2222, seed=41)
    c.put(REP_POOL, "stray", data)
    old_acting = c.acting(REP_POOL, "stray")[1]
    for osd in old_acting:
        c.osdmap.mark_out(osd)  # alive + up, just weightless
    new_acting = c.acting(REP_POOL, "stray")[1]
    assert not set(new_acting) & set(old_acting)
    got = c.get(REP_POOL, "stray")
    assert got == data  # stray fallback read
    assert c.recover(REP_POOL) == len(new_acting)
    pg = c.object_pg(REP_POOL, "stray")
    for osd in new_acting:
        assert (REP_POOL, pg, "stray") in c.stores[osd].objects
    obs.extend([new_acting, got])


SCENARIOS = [
    put_get_roundtrip,
    shards_land_where_crush_says,
    degraded_read_after_killing_m_osds,
    degraded_read_uses_minimum_shards,
    eio_injection_recovers,
    transient_failures_are_retried,
    thrash_kill_revive_recover,
    clay_recovery_reads_subchunk_fraction,
    remap_after_permanent_loss,
    recover_plans_around_eio_shards,
    replicated_recovery_uses_stray_copies,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_data_path_scenario_matches_jax_package(scenario):
    run_twin(jax_build_cluster, scenario)


def test_cluster_runs_its_codecs_on_its_device():
    """`MiniCluster.device` reaches every pool's codec and the map; the
    byte API hands the stores host bytes."""
    c = port_twin(jax_build_cluster())
    for pool in (EC_POOL, CLAY_POOL):
        assert c.codec(pool).device.type == "cpu"
    assert c.codec(REP_POOL) is None
    c.put(EC_POOL, "o", payload(777))
    pg, acting = c.acting(EC_POOL, "o")
    assert all(
        type(c.stores[o].objects[(EC_POOL, pg, "o", s)]) is bytes
        for s, o in enumerate(acting)
    )
