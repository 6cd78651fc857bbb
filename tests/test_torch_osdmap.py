"""The port's OSDMap (ceph_tpu_torch/osd/osdmap.py) against the JAX
package's, on the CPU, tolerance 0.

* `pool_mappings(return_raw=True)` gives the same up rows and raw CRUSH rows
  on both pool kinds, on plain maps and with pg_upmap and pg_upmap_items,
  pg_temp/primary_temp, primary affinity, down, out and nonexistent OSDs,
  choose_args, and run-time weight-sets;
* `encode()` gives the same bytes, and a map encoded by either package
  decodes in the other; Incremental encodes are the same, and applying them
  gives the same map;
* the run-time overlay of the crush-compat balancer holds the installed
  weight-sets row for row, though the compiled map is a copy taken before
  they were installed.
"""

import numpy as np
import pytest

from ceph_tpu.crush import jax_mapper
from ceph_tpu.crush.types import ChooseArg as JChooseArg
from ceph_tpu.osd.osdmap import Incremental as JIncremental
from ceph_tpu.osd.osdmap import OSDMap as JOSDMap
from ceph_tpu.osd.types import TYPE_ERASURE as J_ERASURE
from ceph_tpu.osd.types import PgPool as JPgPool
from ceph_tpu.sim import build_cluster as jbuild
from ceph_tpu_torch.crush import torch_mapper
from ceph_tpu_torch.crush.types import ChooseArg
from ceph_tpu_torch.osd.osdmap import CRUSH_ITEM_NONE, Incremental, OSDMap
from ceph_tpu_torch.osd.types import TYPE_ERASURE, PgPool
from ceph_tpu_torch.sim import build_cluster

#: one map shape for the whole file (the JAX side compiles per shape):
#: 8 hosts of 4 OSDs, a replicated pool of 128 PGs and an EC(4,2) pool of 64
SHAPE = dict(n_osd=32, rep_pg_num=128, ec_pg_num=64, osds_per_host=4)


def choose_args(m, arg_type, seed=11, positions=1):
    rng = np.random.default_rng(seed)
    out = {}
    for bid, b in sorted(m.crush.buckets.items()):
        out[bid] = arg_type(weight_set=[
            [int(rng.integers(0x8000, 2 * 0x10000)) for _ in range(b.size)]
            for _ in range(positions)])
    return out


def prepare(m, case, arg_type):
    """Apply one case's state to a map of either package, identically."""
    if case == "upmap":
        m.pg_upmap[(1, 3)] = [5, 9, 14]
        m.pg_upmap[(2, 7)] = [1, 5, 9, 13, 17, CRUSH_ITEM_NONE]
        m.pg_upmap[(1, 4)] = [0, 8, 16]
        m.osd_weight[16] = 0  # an out target rejects (1, 4)'s whole entry
        rows = np.asarray(m.pool_mappings(1))
        for ps in (10, 11, 12, 40):
            m.pg_upmap_items[(1, ps)] = [(int(rows[ps][0]), 31 - ps % 4)]
        m.pg_upmap_items[(2, 5)] = [(int(np.asarray(m.pool_mappings(2))[5][1]), 30)]
        m.pg_upmap_items[(1, 500)] = [(1, 2)]  # stale: past pg_num
    elif case == "temp-and-affinity":
        m.pg_temp[(1, 9)] = [3, 7, 11]
        m.pg_temp[(2, 2)] = [0, 4, 8, 12, 16, 20]
        m.primary_temp[(1, 9)] = 7
        m.osd_primary_affinity = np.full(m.max_osd, 0x10000, np.int64)
        m.osd_primary_affinity[[2, 6, 19]] = [0, 0x4000, 0x8000]
    elif case == "down-out-gone":
        m.osd_up[[3, 12, 25]] = False
        m.osd_weight[[4, 13]] = 0
        m.osd_weight[[7, 21]] = [0x8000, 0x3000]
        m.osd_exists[30] = False
    elif case == "choose-args":
        m.crush.choose_args = choose_args(m, arg_type, positions=2)
        m.crush.choose_args_maps = {-1: m.crush.choose_args}
        m.invalidate_compiled()


CASES = ["plain", "upmap", "temp-and-affinity", "down-out-gone", "choose-args"]


def pair(case):
    port = build_cluster(device="cpu", **SHAPE)
    ref = jbuild(**SHAPE)
    prepare(port, case, ChooseArg)
    prepare(ref, case, JChooseArg)
    return port, ref


@pytest.mark.parametrize("pool", [1, 2], ids=["replicated", "erasure"])
@pytest.mark.parametrize("case", CASES)
def test_pool_mappings_match_jax(case, pool):
    port, ref = pair(case)
    up, raw = port.pool_mappings(pool, return_raw=True)
    jup, jraw = ref.pool_mappings(pool, return_raw=True)
    assert up.dtype == np.int32 and raw.dtype == np.int32
    assert np.array_equal(up, np.asarray(jup))
    assert np.array_equal(raw, np.asarray(jraw))
    # and the scalar pipeline of both agrees row by row on a sample
    for ps in range(0, port.pools[pool].pg_num, 9):
        assert port.pg_to_up_acting_osds(pool, ps) == ref.pg_to_up_acting_osds(pool, ps)


@pytest.mark.parametrize("pool", [1, 2], ids=["replicated", "erasure"])
def test_runtime_weights_match_jax(pool):
    port, ref = pair("choose-args")
    sets = {bid: [[w // 2 + 1 + (i % 5) * 0x1000 for i, w in enumerate(row)]
                  for row in ca.weight_set]
            for bid, ca in port.crush.choose_args.items()}
    for m, arg_type in ((port, ChooseArg), (ref, JChooseArg)):
        # callers keep choose_args in sync with the overlay (the sparse
        # scalar re-runs read the map)
        m.crush.choose_args = {bid: arg_type(weight_set=[list(r) for r in rows])
                               for bid, rows in sets.items()}
    rt = torch_mapper.runtime_weight_arrays(port._compile(), sets)
    jrt = jax_mapper.runtime_weight_arrays(ref._compile(), sets)
    port.pg_upmap_items[(pool, 3)] = [(int(port.pool_mappings(pool, runtime_weights=rt)[3][0]), 31)]
    ref.pg_upmap_items[(pool, 3)] = list(port.pg_upmap_items[(pool, 3)])
    up, raw = port.pool_mappings(pool, runtime_weights=rt, return_raw=True)
    jup, jraw = ref.pool_mappings(pool, runtime_weights=jrt, return_raw=True)
    assert np.array_equal(up, np.asarray(jup))
    assert np.array_equal(raw, np.asarray(jraw))


def test_overlay_rows_are_the_installed_weight_sets():
    """crush-compat compiles once, then installs new weight-sets into the
    live map; the compiled copy's layout still places each bucket's rows."""
    m = build_cluster(device="cpu", **SHAPE)
    compiled = m._compile()
    assert compiled.source is not m.crush
    installed = choose_args(m, ChooseArg, seed=3, positions=3)
    m.crush.choose_args = installed
    rt = torch_mapper.runtime_weight_arrays(
        compiled, {bid: a.weight_set for bid, a in m.crush.choose_args.items()})
    assert rt.shape == (3, compiled.items.shape[0])
    offsets = compiled.offsets.numpy()
    for row, bid in enumerate(sorted(compiled.source.buckets)):
        b = m.crush.buckets[bid]
        assert compiled.source.buckets[bid].items == b.items
        off = int(offsets[row])
        for pos in range(3):
            assert rt[pos, off:off + b.size].tolist() == installed[bid].weight_set[pos]


def rich(m, pool_type, erasure, arg_type, paff=True):
    """Every encoded field set, identically in either package."""
    m.epoch = 17
    m.pools[3] = pool_type(pg_num=16, size=6, min_size=5, type=erasure, crush_rule=1,
                           erasure_code_profile="ec42")
    m.pools[3].snap_seq = 4
    m.pools[3].removed_snaps = [2, 3]
    m.erasure_code_profiles["ec42"] = {"k": "4", "m": "2", "plugin": "isa"}
    m.pg_upmap[(1, 2)] = [1, 5, 9]
    m.pg_upmap_items[(2, 4)] = [(3, 7), (8, 12)]
    m.pg_temp[(1, 6)] = [2, 6, 10]
    m.primary_temp[(1, 6)] = 6
    m.osd_addrs[0] = ("10.0.0.1", 6800)
    m.osd_local_addrs[0] = "uds:///tmp/osd.0"
    m.blocklist["client.x/7"] = 1234.5
    m.osd_up_thru[:] = np.arange(m.max_osd)
    m.osd_up[5] = False
    m.osd_weight[6] = 0x8000
    if paff:
        m.osd_primary_affinity = np.full(m.max_osd, 0x10000, np.int64)
        m.osd_primary_affinity[4] = 0x2000
    m.crush.choose_args = choose_args(m, arg_type)
    return m


@pytest.mark.parametrize("paff", [True, False], ids=["affinity", "no-affinity"])
def test_encode_bytes_match_and_cross_decode(paff):
    port = rich(build_cluster(device="cpu", **SHAPE), PgPool, TYPE_ERASURE, ChooseArg, paff)
    ref = rich(jbuild(**SHAPE), JPgPool, J_ERASURE, JChooseArg, paff)
    raw = port.encode()
    assert raw == ref.encode()
    back = OSDMap.decode(raw, device="cpu")
    assert back.device == "cpu"
    assert not OSDMap.__dataclass_fields__["device"].compare
    assert back.encode() == raw
    assert JOSDMap.decode(raw).encode() == raw
    assert OSDMap.decode(ref.encode(), device="cpu").encode() == raw
    # the decoded map places PGs as the JAX package's decoded map does
    assert np.array_equal(back.pool_mappings(3), np.asarray(JOSDMap.decode(raw).pool_mappings(3)))


def incrementals(inc_type, pool_type, erasure):
    return [
        inc_type(epoch=2, new_down=[3], new_weight={4: 0, 5: 0x8000},
                 new_primary_affinity={6: 0x4000}),
        inc_type(epoch=3, new_max_osd=36, new_up=[3],
                 new_pools={4: pool_type(pg_num=8, size=4, type=erasure, crush_rule=1)},
                 new_erasure_code_profiles={"p": {"k": "2", "m": "2"}},
                 new_pg_upmap={(1, 2): [1, 5, 9]},
                 new_pg_upmap_items={(4, 3): [(1, 2)]},
                 new_pg_temp={(4, 4): [0, 1, 2, 3]}, new_primary_temp={(4, 4): 1},
                 new_osd_addrs={1: ("h", 6801)}, new_osd_local_addrs={1: "uds://x"},
                 new_pool_snap_seq={4: 3}, new_removed_snaps={4: [1, 2]},
                 new_blocklist={"client.y": 99.0}, new_up_thru={2: 3}),
        inc_type(epoch=4, old_pools=[4], old_pg_upmap=[(1, 2)], old_pg_upmap_items=[(4, 3)],
                 new_pg_temp={(4, 4): []}, new_primary_temp={(4, 4): -1},
                 old_blocklist=["client.y"], old_erasure_code_profiles=["p"]),
    ]


def test_incrementals_encode_and_apply_alike():
    port = build_cluster(device="cpu", **SHAPE)
    ref = jbuild(**SHAPE)
    for inc, jinc in zip(incrementals(Incremental, PgPool, TYPE_ERASURE),
                         incrementals(JIncremental, JPgPool, J_ERASURE)):
        raw = inc.encode()
        assert raw == jinc.encode()
        assert Incremental.decode(raw).encode() == raw
        assert JIncremental.decode(raw).encode() == raw
        port.apply_incremental(Incremental.decode(raw))
        ref.apply_incremental(jinc)
        assert port.encode() == ref.encode()
    assert port.max_osd == 36 and port.epoch == 4


def test_crush_text_replacement_recompiles():
    port = build_cluster(device="cpu", **SHAPE)
    ref = jbuild(**SHAPE)
    rows_before = port.pool_mappings(1)
    text = port.encode()  # compile once, then swap in a reweighted crush
    from ceph_tpu_torch.crush.compiler import decompile_crushmap

    port.crush.buckets[-1].item_weights[0] //= 4
    new_text = decompile_crushmap(port.crush)
    port = OSDMap.decode(text, device="cpu")
    port.apply_incremental(Incremental(epoch=port.epoch + 1, new_crush_text=new_text))
    ref.apply_incremental(JIncremental(epoch=ref.epoch + 1, new_crush_text=new_text))
    assert np.array_equal(port.pool_mappings(1), np.asarray(ref.pool_mappings(1)))
    assert not np.array_equal(port.pool_mappings(1), rows_before)
