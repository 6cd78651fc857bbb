"""The port's batched mapper (ceph_tpu_torch.crush.torch_mapper) on a CPU map,
where each choose stage runs the plain torch version, against the JAX
package's jax_mapper.map_rule (on the CPU, as tests/test_jax_mapper.py runs
it) and the scalar do_rule, for x = 0..511 on every map shape of
tests/test_jax_mapper.py. Tolerance 0: placements are integers. The CUDA
kernel's own procedure is checked in tests/test_torch_crush_cuda.py."""

import numpy as np
import pytest

from ceph_tpu.crush import builder as cb
from ceph_tpu.crush import jax_mapper as jm
from ceph_tpu.crush import mapper as cm
from ceph_tpu.crush.types import (
    CRUSH_ITEM_NONE,
    BucketAlg,
    ChooseArg,
    CrushMap,
    RuleOp,
    RuleStep,
    Tunables,
)
from ceph_tpu_torch.crush import torch_mapper as tm
from tests.test_crush_mapper import build_two_level_map
from tests.test_torch_crush import _three_level, to_port

N_X = 512


def port_map_rule(cmap, ruleno, xs, weight, result_max, **kw):
    compiled = tm.compile_map(to_port(cmap), device="cpu")
    return tm.map_rule(compiled, ruleno, xs, weight, result_max, **kw)


def compare(cmap, ruleno, weight, result_max):
    """jax_mapper's compare contract (tests/test_jax_mapper.py:26-40): equal
    to the JAX package's rows exactly, and to the scalar result (firstn rows
    compacted, indep rows cut to the result's length)."""
    got = port_map_rule(cmap, ruleno, np.arange(N_X), weight, result_max)
    want_jax = np.asarray(
        jm.map_rule(jm.compile_map(cmap), ruleno, np.arange(N_X), weight, result_max))
    assert got.dtype == np.int32 and got.shape == (N_X, result_max)
    assert np.array_equal(got, want_jax)
    for x in range(N_X):
        want = cm.do_rule(cmap, ruleno, x, weight, result_max, cm.Workspace())
        row = [int(v) for v in got[x]]
        if CRUSH_ITEM_NONE not in want:
            row = [v for v in row if v != CRUSH_ITEM_NONE]
        else:
            row = row[: len(want)]
        assert row == want, (x, row, want)


def _rack_map(seed, racks, hosts_per_rack, osds_per_host=2):
    cmap = _three_level(Tunables.jewel(), seed, hosts_per_rack, osds_per_host, racks)
    return cmap


def _choose_args_map(seed_map, seed_args, n_hosts=6):
    cmap = build_two_level_map(BucketAlg.STRAW2, n_hosts=n_hosts, seed=seed_map)
    cb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
    local = np.random.default_rng(seed_args)
    root = cmap.buckets[-1]
    cmap.choose_args[-1] = ChooseArg(
        ids=[i + 100 for i in range(root.size)],
        weight_set=[[int(local.integers(1, 8 * 0x10000)) for _ in range(root.size)]
                    for _ in range(2)])
    for h in range(n_hosts):
        b = cmap.buckets[-(h + 2)]
        cmap.choose_args[b.id] = ChooseArg(
            weight_set=[[int(local.integers(1, 8 * 0x10000)) for _ in range(b.size)]])
    return cmap


def _case(name):
    """(map, weight, result_max) of each shape of tests/test_jax_mapper.py."""
    if name == "chooseleaf-firstn":
        cmap = build_two_level_map(BucketAlg.STRAW2, seed=41)
        cb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        return cmap, None, 3
    if name == "chooseleaf-indep":
        cmap = build_two_level_map(BucketAlg.STRAW2, seed=43)
        cb.make_simple_rule(cmap, 0, -1, 1, "indep", 0)
        return cmap, None, 6
    if name == "reweighted-and-out":
        cmap = build_two_level_map(BucketAlg.STRAW2, seed=47)
        cb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        weight = [0x10000] * cmap.max_devices
        weight[2], weight[7], weight[11] = 0, 0x4000, 0xC000
        return cmap, weight, 3
    if name == "indep-out-domain":
        cmap = build_two_level_map(BucketAlg.STRAW2, n_hosts=4, seed=53)
        cb.make_simple_rule(cmap, 0, -1, 1, "indep", 0)
        weight = [0x10000] * cmap.max_devices
        weight[:4] = [0] * 4
        return cmap, weight, 6
    if name == "choose-device-directly":
        cmap = CrushMap(tunables=Tunables.jewel())
        rng = np.random.default_rng(59)
        weights = [int(rng.integers(1, 10 * 0x10000)) for _ in range(24)]
        cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 1, list(range(24)), weights)
        cb.make_rule(cmap, 0, [RuleStep(RuleOp.TAKE, -1),
                               RuleStep(RuleOp.CHOOSE_FIRSTN, 0, 0),
                               RuleStep(RuleOp.EMIT)])
        return cmap, None, 4
    if name == "three-level-chained":
        return _rack_map(61, 4, 3), None, 4
    if name == "firefly-tunables":
        cmap = build_two_level_map(BucketAlg.STRAW2, tunables=Tunables.firefly(), seed=67)
        cb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        return cmap, None, 3
    if name == "choose-args":
        return _choose_args_map(71, 73), None, 3
    if name == "result-max-pressure":
        cmap = _rack_map(83, 3, 2)
        weight = [0x10000] * cmap.max_devices
        weight[0] = weight[1] = 0  # host -2 entirely out
        return cmap, weight, 3
    if name == "set-tries-steps":
        cmap = build_two_level_map(BucketAlg.STRAW2, seed=79)
        cb.make_rule(cmap, 0, [
            RuleStep(RuleOp.SET_CHOOSELEAF_TRIES, 5),
            RuleStep(RuleOp.SET_CHOOSE_TRIES, 100),
            RuleStep(RuleOp.TAKE, -1),
            RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 0, 1),
            RuleStep(RuleOp.EMIT),
        ])
        return cmap, None, 3
    if name == "mixed-mode-multi-emit":
        cmap = build_two_level_map(BucketAlg.STRAW2, n_hosts=4, seed=89)
        cb.make_rule(cmap, 0, [
            RuleStep(RuleOp.TAKE, -1),
            RuleStep(RuleOp.CHOOSELEAF_INDEP, 4, 1),
            RuleStep(RuleOp.EMIT),
            RuleStep(RuleOp.TAKE, -1),
            RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 2, 1),
            RuleStep(RuleOp.EMIT),
        ])
        weight = [0x10000] * cmap.max_devices
        weight[:4] = [0] * 4  # a whole host out: every indep block has a hole
        return cmap, weight, 6
    if name == "firstn-multi-emit":
        cmap = build_two_level_map(BucketAlg.STRAW2, seed=97)
        cb.make_rule(cmap, 0, [
            RuleStep(RuleOp.TAKE, -1),
            RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 2, 1),
            RuleStep(RuleOp.EMIT),
            RuleStep(RuleOp.TAKE, -1),
            RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 2, 1),
            RuleStep(RuleOp.EMIT),
        ])
        return cmap, None, 4
    assert name == "per-rule-scope-gating"
    cmap = build_two_level_map(BucketAlg.STRAW2, seed=3)
    cb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
    legacy = cb.make_bucket(cmap, -90, BucketAlg.LIST, 1, [100, 101], [0x10000] * 2)
    cb.make_bucket(cmap, -91, BucketAlg.STRAW2, 10, [legacy.id], [legacy.weight])
    cb.make_simple_rule(cmap, 1, -91, 1, "firstn", 0)
    cmap.max_devices = max(cmap.max_devices, 102)
    return cmap, None, 3


#: the firstn-family shapes run here; the indep-family ones, with holes and
#: lengths, in tests/test_torch_crush_mapper_indep.py (two files run on two
#: test workers)
CASES = [
    "chooseleaf-firstn", "reweighted-and-out", "choose-device-directly",
    "three-level-chained", "firefly-tunables", "choose-args",
    "result-max-pressure", "set-tries-steps", "firstn-multi-emit",
    "per-rule-scope-gating",
]
INDEP_CASES = ["chooseleaf-indep", "indep-out-domain", "mixed-mode-multi-emit"]


@pytest.mark.parametrize("name", CASES)
def test_map_rule_matches_jax_and_scalar(name):
    cmap, weight, result_max = _case(name)
    compare(cmap, 0, weight or [0x10000] * cmap.max_devices, result_max)


def test_scope_gate_and_positions_match_jax():
    cmap, _, _ = _case("per-rule-scope-gating")
    port = to_port(cmap)
    for rule in (None, 0, 1, 7):
        assert tm.supports(port, rule) == jm.supports(cmap, rule)
    compiled = tm.compile_map(port, device="cpu")
    assert compiled.supported_rules == jm.compile_map(cmap).supported_rules
    with pytest.raises(ValueError):
        tm.map_rule(compiled, 1, np.arange(8), [0x10000] * cmap.max_devices, 2)
    with pytest.raises(ValueError):
        tm.compile_map(to_port(build_two_level_map(BucketAlg.TREE, seed=1)), device="cpu")
    choose_args = _choose_args_map(71, 73)
    assert tm.compile_map(to_port(choose_args), device="cpu").n_positions == 2
    assert tm.compile_map(to_port(choose_args), positions=3, device="cpu").n_positions == 3


@pytest.mark.parametrize(
    "op", [RuleOp.SET_CHOOSE_LOCAL_TRIES, RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES])
def test_local_tries_steps_rejected_in_both(op):
    cmap = build_two_level_map(BucketAlg.STRAW2, seed=83)
    cb.make_rule(cmap, 0, [
        RuleStep(op, 2),
        RuleStep(RuleOp.TAKE, -1),
        RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 0, 1),
        RuleStep(RuleOp.EMIT),
    ])
    assert not tm.supports(to_port(cmap)) and not jm.supports(cmap)
    with pytest.raises(ValueError):
        tm.compile_map(to_port(cmap), device="cpu")
    with pytest.raises(ValueError):
        jm.compile_map(cmap)
    cmap.rules[0].steps[0] = RuleStep(op, 0)  # a zero arg is inert: still maps
    weight = [0x10000] * cmap.max_devices
    got = port_map_rule(cmap, 0, np.arange(8), weight, 3)
    assert np.array_equal(got, np.asarray(
        jm.map_rule(jm.compile_map(cmap), 0, np.arange(8), weight, 3)))


def test_compile_map_cached_and_device_rules():
    cmap, _, _ = _case("chooseleaf-firstn")
    port = to_port(cmap)
    first = tm.compile_map_cached(port, device="cpu")
    assert tm.compile_map_cached(to_port(cmap), device="cpu") is first
    assert first.source is not port  # a deep copy: caller edits cannot skew it
    port.buckets[-2].item_weights[0] += 1
    assert tm.compile_map_cached(port, device="cpu") is not first
    weight = [0x10000] * cmap.max_devices
    with pytest.raises(ValueError, match="meta"):
        tm.map_rule(first, 0, tm.torch.arange(4, device="meta"), weight, 3)
    # a stage wider than the kernel's per-thread arrays is refused on any device
    wide = build_two_level_map(BucketAlg.STRAW2, n_hosts=40, osds_per_host=1, seed=5)
    cb.make_rule(wide, 0, [RuleStep(RuleOp.TAKE, -1),
                           RuleStep(RuleOp.CHOOSE_FIRSTN, 0, 0),
                           RuleStep(RuleOp.EMIT)])
    wide_map = tm.compile_map(to_port(wide), device="cpu")
    assert tm.map_rule(wide_map, 0, np.arange(4), [0x10000] * 40, 32).shape == (4, 32)
    with pytest.raises(ValueError, match="CRUSH_MAX_SLOTS"):
        tm.map_rule(wide_map, 0, np.arange(4), [0x10000] * 40, 33)
