"""Scrub machinery of the port against the JAX package's, on the CPU,
tolerance 0: the port's ceph_crc32c on random buffers, through its C path
(native/crc32c.c built into `_build/`) and its numpy path, against
`ceph_tpu`'s; HashInfo's cumulative hashes; and the scrub, repair and
auto-repair scenarios of tests/test_scrub.py on twin MiniClusters
(tests/test_torch_data_path.py's `run_twin`)."""

import numpy as np
import pytest

from ceph_tpu.common.crc import ceph_crc32c as jax_crc32c
from ceph_tpu.osd.ecutil import HashInfo as JaxHashInfo
from ceph_tpu_torch.common import crc
from ceph_tpu_torch.osd.ecutil import SEED, HashInfo
from tests.test_torch_data_path import run_twin

LENGTHS = (0, 1, 7, 8, 9, 63, 1024, 65537)
SEEDS = (0xFFFFFFFF, 0, 0xDEADBEEF)


def test_c_path_is_loaded():
    """The C slicing-by-8 builds here (a C compiler is on every host that
    runs the port) and is what ceph_crc32c calls."""
    assert crc.HAVE_NATIVE
    assert crc._NATIVE is not None


@pytest.mark.parametrize("path", ["c", "numpy"])
def test_crc32c_matches_jax_package(path):
    fn = crc.ceph_crc32c if path == "c" else crc.crc32c_numpy
    rng = np.random.default_rng(0)
    for n in LENGTHS:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in SEEDS:
            assert fn(seed, data) == jax_crc32c(seed, data), (n, seed)
        # a prefix through `length`, and chaining: crc(AB) == crc(crc(A), B)
        cut = n // 3
        assert fn(SEED, data, cut) == jax_crc32c(SEED, data[:cut])
        assert fn(fn(SEED, data[:cut]), data[cut:]) == fn(SEED, data)


def test_crc32c_inputs_and_check_value():
    data = np.random.default_rng(1).integers(0, 256, 4099, np.uint8)
    want = jax_crc32c(SEED, data.tobytes())
    assert crc.ceph_crc32c(SEED, data) == want
    assert crc.ceph_crc32c(SEED, memoryview(bytearray(data.tobytes()))) == want
    assert crc.ceph_crc32c(SEED, bytearray(data.tobytes())) == want
    assert crc.crc32c_numpy(SEED, data) == want
    # the textbook CRC-32C check value (init -1, final xor -1)
    assert crc.ceph_crc32c(SEED, b"123456789") ^ 0xFFFFFFFF == 0xE3069283


def test_hashinfo_append_equals_whole_and_jax_package():
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 256, 512, dtype=np.uint8).tobytes() for _ in range(3)]
    hi, jhi = HashInfo(0, [SEED, SEED]), JaxHashInfo(0, [SEED, SEED])
    for p in parts:
        hi.append({0: p, 1: p[::-1]}, 512)
        jhi.append({0: p, 1: p[::-1]}, 512)
    assert hi.get_chunk_hash(0) == crc.ceph_crc32c(SEED, b"".join(parts))
    assert hi.get_chunk_hash(1) == crc.ceph_crc32c(
        SEED, b"".join(p[::-1] for p in parts)
    )
    assert hi.total_chunk_size == 1536
    assert (hi.total_chunk_size, hi.cumulative_shard_hashes) == (
        jhi.total_chunk_size, jhi.cumulative_shard_hashes
    )
    shards = {i: rng.integers(0, 256, 96, np.uint8).tobytes() for i in range(6)}
    a, b = HashInfo.from_shards(shards, 6), JaxHashInfo.from_shards(shards, 6)
    assert (a.total_chunk_size, a.cumulative_shard_hashes) == (
        b.total_chunk_size, b.cumulative_shard_hashes
    )


# -- the scrub scenarios of tests/test_scrub.py, twinned ----------------------


def jax_cluster():
    from tests.conftest import make_mini_cluster

    return make_mini_cluster()


def jax_cluster_with_replicated_pool():
    """test_replicated_deep_scrub_majority_vote's map: a firstn rule and a
    size-3 replicated pool 2, added in the JAX package before the map is
    carried across."""
    from ceph_tpu.crush import builder as cb
    from ceph_tpu.osd import PgPool
    from ceph_tpu.osd.types import TYPE_REPLICATED

    c = jax_cluster()
    cb.make_simple_rule(c.osdmap.crush, 1, -1, 1, "firstn", 0)
    c.osdmap.pools[2] = PgPool(pg_num=8, size=3, type=TYPE_REPLICATED, crush_rule=1)
    c.profiles[2] = None
    return c


def payload(n, seed=5):
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def flip(store, key, at, bit):
    blob = bytearray(store.objects[key])
    blob[at] ^= bit
    store.objects[key] = bytes(blob)


def clean_scrub_is_clean(c, obs):
    for i in range(4):
        c.put(1, f"o{i}", payload(4000, i))
    assert c.scrub(1) == []
    assert c.scrub(1, deep=True) == []


def deep_scrub_catches_bit_rot_and_repair_heals(c, obs):
    data = payload(6000)
    c.put(1, "obj", data)
    pg, acting = c.acting(1, "obj")
    key = (1, pg, "obj", 1)
    store = c.stores[acting[1]]
    flip(store, key, 100, 0x40)
    assert c.scrub(1) == []  # shallow: size unchanged -> clean
    errors = c.scrub(1, deep=True)
    assert [(e.name, e.shard, e.error) for e in errors] == [("obj", 1, "digest_mismatch")]
    repaired = c.repair(1)
    assert repaired >= 1
    assert c.scrub(1, deep=True) == []
    got = c.get(1, "obj")
    assert got == data
    hinfo = store.getattrs(key)["hinfo"]
    assert hinfo.get_chunk_hash(1) == crc.ceph_crc32c(SEED, store.objects[key])
    obs.extend([errors, repaired, got])


def deep_scrub_flags_eio_and_missing(c, obs):
    c.put(1, "obj", payload(3000))
    pg, acting = c.acting(1, "obj")
    c.stores[acting[0]].eio_keys.add((1, pg, "obj", 0))
    del c.stores[acting[2]].objects[(1, pg, "obj", 2)]
    errors = c.scrub(1, deep=True)
    kinds = {(e.shard, e.error) for e in errors}
    assert (0, "read_error") in kinds
    assert (2, "missing") in kinds
    repaired = c.repair(1)
    assert repaired >= 2
    assert c.scrub(1, deep=True) == []
    obs.extend([errors, repaired])


def deep_scrub_auto_repair_knob(c, obs):
    data = payload(6000)
    c.put(1, "obj", data)
    pg, acting = c.acting(1, "obj")
    key = (1, pg, "obj", 1)
    store = c.stores[acting[1]]
    flip(store, key, 5, 1)
    assert not c.config.get("osd_scrub_auto_repair")
    assert [e.error for e in c.scrub(1, deep=True)] == ["digest_mismatch"]
    assert c.scrub(1, deep=True) != []
    c.config.set("osd_scrub_auto_repair", True)
    assert [e.error for e in c.scrub(1, deep=True)] == ["digest_mismatch"]
    assert c.scrub(1, deep=True) == []
    assert c.get(1, "obj") == data
    c.stores[acting[0]].eio_keys.add((1, pg, "obj", 0))
    assert [e.error for e in c.scrub(1, deep=True)] == ["read_error"]
    assert c.scrub(1, deep=True) == []
    assert c.get(1, "obj") == data
    del store.objects[key]
    del store.attrs[key]
    assert [e.error for e in c.scrub(1, deep=True)] == ["missing"]
    assert [e.error for e in c.scrub(1, deep=True)] == ["missing"]
    rebuilt = c.recover(1)
    assert rebuilt >= 1
    assert c.scrub(1, deep=True) == []
    obs.append(rebuilt)


def recover_rejects_corrupt_stray_copy(c, obs):
    data = payload(5000)
    c.put(1, "obj", data)
    pg, acting = c.acting(1, "obj")
    home = acting[1]
    key = (1, pg, "obj", 1)
    stray = next(o for o in c.stores if o not in acting)
    blob = bytearray(c.stores[home].objects[key])
    blob[7] ^= 0x80
    c.stores[stray].objects[key] = bytes(blob)
    c.stores[stray].attrs[key] = dict(c.stores[home].attrs[key])
    del c.stores[home].objects[key]
    del c.stores[home].attrs[key]
    rebuilt = c.recover(1)
    assert rebuilt >= 1
    assert c.scrub(1, deep=True) == []
    assert c.get(1, "obj") == data
    assert c.stores[home].objects[key] != bytes(blob)
    obs.append(rebuilt)


def replicated_deep_scrub_majority_vote(c, obs):
    data = payload(2000)
    c.put(2, "rob", data)
    pg, acting = c.acting(2, "rob")
    flip(c.stores[acting[1]], (2, pg, "rob"), 0, 1)
    errors = c.scrub(2, deep=True)
    assert [(e.osd, e.error) for e in errors] == [(acting[1], "digest_mismatch")]
    obs.extend([errors, c.repair(2)])
    assert c.scrub(2, deep=True) == []
    assert c.get(2, "rob") == data


@pytest.mark.parametrize("scenario", [
    clean_scrub_is_clean,
    deep_scrub_catches_bit_rot_and_repair_heals,
    deep_scrub_flags_eio_and_missing,
    deep_scrub_auto_repair_knob,
    recover_rejects_corrupt_stray_copy,
], ids=lambda f: f.__name__)
def test_scrub_scenario_matches_jax_package(scenario):
    run_twin(jax_cluster, scenario)


def test_replicated_deep_scrub_majority_vote_matches_jax_package():
    run_twin(jax_cluster_with_replicated_pool, replicated_deep_scrub_majority_vote)
