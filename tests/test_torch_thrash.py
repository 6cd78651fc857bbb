"""The thrasher tier of tests/test_thrash.py on the port's MiniCluster, twinned
with the JAX package's (tests/test_torch_data_path.py's `run_twin`: the map
carried as `encode_osdmap` bytes, the same seeded operations on both, every
read-back, recover count and scrub report compared exactly, then every
store, the registry, the perf counters and the map's bytes).

Seeds 1 and 7 of the randomized schedule (put/overwrite/get/kill/revive/
recover/scrub with a plain dict as the consistency oracle), and the
stale-stray test on each pool.
"""

import numpy as np
import pytest

from tests.test_thrash import MAX_DEAD, POOLS
from tests.test_thrash import build_cluster as jax_build_cluster
from tests.test_torch_data_path import run_twin

NONE = 0x7FFFFFFF


def thrash(cluster, obs, seed):
    """test_thrash_with_consistency_oracle's schedule; `obs` gets every
    read-back, recover count and scrub report."""
    rng = np.random.default_rng(seed)
    model: dict[tuple[int, str], bytes] = {}
    dead: list[int] = []

    def payload() -> bytes:
        n = int(rng.integers(1, 6000))
        return rng.integers(0, 256, n, np.uint8).tobytes()

    def check_all():
        for (pool, name), want in model.items():
            got = cluster.get(pool, name)
            assert got == want, (pool, name)
            obs.append(got)

    ops = 0
    for step in range(220):
        op = rng.choice(
            ["put", "put", "put", "get", "get", "overwrite", "kill",
             "revive", "recover", "scrub"],
        )
        pool = int(rng.choice(list(POOLS.values())))
        if op == "put":
            ops += 1
            name = f"o{int(rng.integers(0, 40))}"
            data = payload()
            cluster.put(pool, name, data)
            model[(pool, name)] = data
        elif op == "overwrite" and model:
            ops += 1
            keys = sorted(model)
            pool, name = keys[int(rng.integers(0, len(keys)))]
            data = payload()
            cluster.put(pool, name, data)
            model[(pool, name)] = data
        elif op == "get" and model:
            ops += 1
            keys = sorted(model)
            key = keys[int(rng.integers(0, len(keys)))]
            got = cluster.get(*key)
            assert got == model[key], key
            obs.append(got)
        elif op == "kill" and len(dead) < MAX_DEAD:
            alive = [o for o in range(cluster.osdmap.max_osd) if o not in dead]
            victim = int(rng.choice(alive))
            cluster.kill_osd(victim)
            dead.append(victim)
        elif op == "revive" and dead:
            osd = dead.pop(int(rng.integers(0, len(dead))))
            cluster.revive_osd(osd)
            for pid in POOLS.values():
                obs.append(cluster.recover(pid))
        elif op == "recover":
            obs.append(cluster.recover(pool))
        elif op == "scrub":
            errors = cluster.scrub(pool, deep=True)
            for e in errors:
                assert e.error in ("missing", "stale"), e
            obs.append(errors)
            ops += 1
        if step % 60 == 59:
            check_all()

    while dead:
        cluster.revive_osd(dead.pop())
    for pid in POOLS.values():
        obs.append(cluster.recover(pid))
        obs.append(cluster.repair(pid))
        assert cluster.scrub(pid, deep=True) == []
    check_all()
    assert ops > 100
    dump = cluster.admin.handle("perf dump")["mini_cluster"]
    assert dump["put_ops"] + dump["get_ops"] > 0


@pytest.mark.parametrize("seed", [1, 7])
def test_thrash_with_consistency_oracle_matches_jax_package(seed):
    run_twin(jax_build_cluster, thrash, seed)


def stale_stray(cluster, obs, pool):
    """test_stale_stray_never_resurrected: kill+out -> write -> revive+in
    -> overwrite -> re-kill+out must not serve the old version."""
    name = "resurrect-me"
    a0 = cluster.acting(pool, name)[1]
    victim = next(o for o in a0 if o != NONE)

    def fail(osd):
        cluster.kill_osd(osd)
        cluster.osdmap.mark_out(osd)

    def rejoin(osd):
        cluster.revive_osd(osd)
        cluster.osdmap.reweight(osd, 0x10000)

    fail(victim)
    a1 = cluster.acting(pool, name)[1]
    assert victim not in a1
    assert [o for o in a1 if o not in a0 and o != NONE]
    v1 = b"\x01" * 4096
    cluster.put(pool, name, v1)

    rejoin(victim)
    obs.append(cluster.recover(pool))
    assert cluster.acting(pool, name)[1] == a0

    v2 = b"\x02" * 4100
    cluster.put(pool, name, v2)

    fail(victim)
    assert cluster.acting(pool, name)[1] == a1
    got = cluster.get(pool, name)
    assert got == v2
    obs.append(got)

    errors = cluster.scrub(pool, deep=True)
    assert [e for e in errors if e.error == "stale"]
    obs.append(errors)
    obs.append(cluster.repair(pool))
    assert cluster.scrub(pool, deep=True) == []
    assert cluster.get(pool, name) == v2


@pytest.mark.parametrize("pool", sorted(POOLS.values()))
def test_stale_stray_never_resurrected_matches_jax_package(pool):
    run_twin(jax_build_cluster, stale_stray, pool)
