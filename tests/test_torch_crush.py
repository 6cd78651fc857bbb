"""The port's copies of the framework-free CRUSH modules (ceph_tpu_torch.crush:
types, hash, ln_tables, mapper, builder, compiler, tree) against the JAX
package's originals, and the tensor hash and crush_ln of torch_mapper.
Every comparison is integer equality (tolerance 0).

`to_port` converts a map built with the JAX package's builder into the
port's types, so both packages see the very same map; the other
test_torch_crush* files use it too."""

import dataclasses

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as jb
from ceph_tpu.crush import compiler as jc
from ceph_tpu.crush import hash as jh
from ceph_tpu.crush import ln_tables as jl
from ceph_tpu.crush import mapper as jmap
from ceph_tpu.crush import tree as jt
from ceph_tpu.crush.types import BucketAlg, ChooseArg, CrushMap, RuleOp, RuleStep, Tunables
from ceph_tpu_torch.crush import builder as pb
from ceph_tpu_torch.crush import compiler as pc
from ceph_tpu_torch.crush import hash as ph
from ceph_tpu_torch.crush import ln_tables as pl
from ceph_tpu_torch.crush import mapper as pmap
from ceph_tpu_torch.crush import torch_mapper as tm
from ceph_tpu_torch.crush import tree as pt
from ceph_tpu_torch.crush import types as ptypes
from tests.test_crush_mapper import build_two_level_map
from tests.test_device_classes import CLASSED_MAP


def to_port(cmap: CrushMap) -> ptypes.CrushMap:
    """The same map in the port's types (a deep copy)."""
    out = ptypes.CrushMap(
        max_devices=cmap.max_devices,
        tunables=ptypes.Tunables(**dataclasses.asdict(cmap.tunables)),
        type_names=dict(cmap.type_names),
        item_names=dict(cmap.item_names),
        rule_names=dict(cmap.rule_names),
        device_classes=dict(cmap.device_classes),
        class_bucket=dict(cmap.class_bucket),
    )
    for bid, b in cmap.buckets.items():
        fields = dataclasses.asdict(b)
        fields["alg"] = ptypes.BucketAlg(int(b.alg))
        out.buckets[bid] = ptypes.Bucket(**fields)
    for rid, r in cmap.rules.items():
        out.rules[rid] = ptypes.Rule(
            r.rule_id, r.ruleset, r.type, r.min_size, r.max_size,
            [ptypes.RuleStep(ptypes.RuleOp(int(s.op)), s.arg1, s.arg2)
             for s in r.steps])

    def args(table):
        return {bid: ptypes.ChooseArg(**dataclasses.asdict(ca))
                for bid, ca in table.items()}

    out.choose_args = args(cmap.choose_args)
    out.choose_args_maps = {k: args(v) for k, v in cmap.choose_args_maps.items()}
    return out


def as_plain(cmap) -> dict:
    """Field-by-field form of either package's map (enums as ints)."""
    d = dataclasses.asdict(cmap)
    for b in d["buckets"].values():
        b["alg"] = int(b["alg"])
    for r in d["rules"].values():
        for s in r["steps"]:
            s["op"] = int(s["op"])
    return d


def test_hash_copies_and_tensor_forms():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.integers(0, 2**32, 400, dtype=np.uint64) for _ in range(4))
    for i in range(0, 400, 7):
        ai, bi, ci, di = int(a[i]), int(b[i]), int(c[i]), int(d[i])
        assert ph.crush_hash32_2(ai, bi) == jh.crush_hash32_2(ai, bi)
        assert ph.crush_hash32_3(ai, bi, ci) == jh.crush_hash32_3(ai, bi, ci)
        assert ph.crush_hash32_4(ai, bi, ci, di) == jh.crush_hash32_4(ai, bi, ci, di)
    assert np.array_equal(ph.crush_hash32_3_np(a, b, c), jh.crush_hash32_3_np(a, b, c))
    assert np.array_equal(ph.crush_hash32_2_np(a, b), jh.crush_hash32_2_np(a, b))
    ta, tb, tc = (torch.from_numpy(v.astype(np.int64)) for v in (a, b, c))
    assert np.array_equal(tm.hash32_3(ta, tb, tc).numpy(), jh.crush_hash32_3_np(a, b, c))
    assert np.array_equal(tm.hash32_2(ta, tb).numpy(), jh.crush_hash32_2_np(a, b))
    # negative ids (buckets) hash as their uint32 bits
    neg = torch.tensor([-1, -2, -200], dtype=torch.int32)
    assert tm.hash32_3(5, neg, 3).tolist() == [
        jh.crush_hash32_3(5, v, 3) for v in (-1, -2, -200)]


def test_crush_ln_over_every_16_bit_input():
    assert np.array_equal(pl.RH_LH_TBL, jl.RH_LH_TBL)
    assert np.array_equal(pl.LL_TBL, jl.LL_TBL)
    want = np.array([jl.crush_ln(u) for u in range(0x10000)], dtype=np.int64)
    assert [pl.crush_ln(u) for u in range(0, 0x10000, 97)] == want[::97].tolist()
    got = tm.crush_ln(torch.arange(0x10000, dtype=torch.int32)).numpy()
    assert np.array_equal(got, want)


def test_straw2_draws_and_argmax():
    """Tensor draws against the scalar draw_straw2, zero weights included."""
    rng = np.random.default_rng(2)
    ids = rng.integers(-50, 5000, 64)
    ws = rng.integers(0, 8 * 0x10000, 64)
    ws[::9] = 0
    for x, r in ((0, 0), (12345, 3), (2**31 + 7, 49)):
        draws = tm.straw2_draws(
            torch.tensor(x), torch.from_numpy(ids), torch.tensor(r),
            torch.from_numpy(ws), torch.ones(64, dtype=torch.bool))
        want = [jmap.draw_straw2(x, int(i), r, int(w)) if w else jmap.S64_MIN
                for i, w in zip(ids, ws)]
        assert draws.tolist() == want
        assert int(tm.argmax_draws(draws)) == int(np.argmax(want))
    assert int(tm.argmax_draws(torch.full((5,), tm._S64_MIN))) == 0


def _builder_map(b, types):
    """One map with every bucket algorithm, through a package's builder."""
    cmap = types.CrushMap(tunables=types.Tunables.jewel())
    ids = []
    for k, alg in enumerate(types.BucketAlg):
        items = [3 * k, 3 * k + 1, 3 * k + 2]
        weights = [0x10000] * 3 if alg == types.BucketAlg.UNIFORM else [
            0x10000, 0x18000, 0x30000]
        ids.append(b.make_bucket(cmap, -2 - k, alg, 1, items, weights))
    b.make_bucket(cmap, -1, types.BucketAlg.STRAW2, 10,
                  [x.id for x in ids], [x.weight for x in ids])
    b.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
    b.make_simple_rule(cmap, 1, -1, 1, "indep", 0)
    return cmap


def test_builder_maps_field_by_field():
    from ceph_tpu.crush import types as jtypes

    assert as_plain(_builder_map(pb, ptypes)) == as_plain(_builder_map(jb, jtypes))
    assert as_plain(to_port(_builder_map(jb, jtypes))) == as_plain(_builder_map(jb, jtypes))


def test_compiler_round_trip_matches():
    for text in (CLASSED_MAP, jc.decompile_crushmap(jc.compile_crushmap(CLASSED_MAP))):
        port_map = pc.compile_crushmap(text)
        assert as_plain(port_map) == as_plain(jc.compile_crushmap(text))
        port_text = pc.decompile_crushmap(port_map)
        assert port_text == jc.decompile_crushmap(jc.compile_crushmap(text))
        assert pc.decompile_crushmap(pc.compile_crushmap(port_text)) == port_text
    with pytest.raises(pc.CompileError):
        pc.compile_crushmap("device 0 osd.0\nrule r {\n\tid 0\n\tstep take nowhere\n}\n")


def test_tree_dump_items_matches():
    cmap = jc.compile_crushmap(CLASSED_MAP)
    assert pt.dump_items(to_port(cmap)) == jt.dump_items(cmap)
    assert pt.validate(to_port(cmap)) == jt.validate(cmap) == []


def _three_level(tunables, seed, hosts_per_rack=3, osds_per_host=2, racks=4):
    cmap = CrushMap(tunables=tunables)
    local = np.random.default_rng(seed)
    osd, bid = 0, -2
    rack_ids, rack_weights = [], []
    for _ in range(racks):
        host_ids, host_weights = [], []
        for _ in range(hosts_per_rack):
            items = list(range(osd, osd + osds_per_host))
            osd += osds_per_host
            ws = [int(local.integers(1, 6 * 0x10000)) for _ in items]
            b = jb.make_bucket(cmap, bid, BucketAlg.STRAW2, 1, items, ws)
            bid -= 1
            host_ids.append(b.id)
            host_weights.append(b.weight)
        rb = jb.make_bucket(cmap, bid, BucketAlg.STRAW2, 2, host_ids, host_weights)
        bid -= 1
        rack_ids.append(rb.id)
        rack_weights.append(rb.weight)
    jb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, rack_ids, rack_weights)
    jb.make_rule(cmap, 0, [
        RuleStep(RuleOp.TAKE, -1),
        RuleStep(RuleOp.CHOOSE_FIRSTN, 2, 2),
        RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 2, 1),
        RuleStep(RuleOp.EMIT),
    ])
    return cmap


def _scalar_case(name):
    """(map, result_max, weight) of each map shape of tests/test_crush_mapper.py."""
    if name.startswith("firstn-"):
        alg = BucketAlg[name[len("firstn-"):]]
        cmap = build_two_level_map(alg, seed=int(alg))
        jb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        return cmap, 3, None
    if name.startswith("indep-"):
        alg = BucketAlg[name[len("indep-"):]]
        cmap = build_two_level_map(alg, seed=7 + int(alg))
        jb.make_simple_rule(cmap, 0, -1, 1, "indep", 0)
        return cmap, 6, None
    if name.startswith("profile-"):
        profile = getattr(Tunables, name[len("profile-"):])()
        cmap = build_two_level_map(BucketAlg.STRAW2, tunables=profile, seed=11)
        jb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        return cmap, 3, None
    if name == "reweighted":
        cmap = build_two_level_map(BucketAlg.STRAW2, seed=13)
        jb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        weight = [0x10000] * cmap.max_devices
        weight[0], weight[5], weight[9] = 0, 0x8000, 0x0100
        return cmap, 3, weight
    if name == "choose-device":
        cmap = CrushMap(tunables=Tunables.jewel())
        local = np.random.default_rng(3)
        weights = [int(local.integers(1, 10 * 0x10000)) for _ in range(24)]
        jb.make_bucket(cmap, -1, BucketAlg.STRAW2, 1, list(range(24)), weights)
        jb.make_rule(cmap, 0, [RuleStep(RuleOp.TAKE, -1),
                               RuleStep(RuleOp.CHOOSE_FIRSTN, 0, 0),
                               RuleStep(RuleOp.EMIT)])
        return cmap, 4, None
    if name == "three-level":
        return _three_level(Tunables.jewel(), 17), 4, None
    if name == "out-host-indep":
        cmap = build_two_level_map(BucketAlg.STRAW2, n_hosts=4, seed=23)
        jb.make_simple_rule(cmap, 0, -1, 1, "indep", 0)
        weight = [0x10000] * cmap.max_devices
        weight[:4] = [0] * 4
        return cmap, 6, weight
    if name == "choose-args":
        cmap = build_two_level_map(BucketAlg.STRAW2, n_hosts=6, seed=31)
        jb.make_simple_rule(cmap, 0, -1, 1, "firstn", 0)
        local = np.random.default_rng(5)
        root = cmap.buckets[-1]
        cmap.choose_args[-1] = ChooseArg(
            ids=[i + 100 for i in range(root.size)],
            weight_set=[[int(local.integers(1, 8 * 0x10000)) for _ in range(root.size)]
                        for _ in range(2)])
        for h in range(6):
            b = cmap.buckets[-(h + 2)]
            cmap.choose_args[b.id] = ChooseArg(weight_set=[
                [int(local.integers(1, 8 * 0x10000)) for _ in range(b.size)]])
        return cmap, 3, None
    if name.startswith("multi-take-"):
        profile = getattr(Tunables, name[len("multi-take-"):])()
        return _three_level(profile, 37, hosts_per_rack=3, osds_per_host=3,
                            racks=3), 6, None
    assert name == "set-tries"
    cmap = build_two_level_map(BucketAlg.STRAW2, seed=29)
    jb.make_rule(cmap, 0, [
        RuleStep(RuleOp.SET_CHOOSELEAF_TRIES, 5),
        RuleStep(RuleOp.SET_CHOOSE_TRIES, 100),
        RuleStep(RuleOp.TAKE, -1),
        RuleStep(RuleOp.CHOOSELEAF_FIRSTN, 0, 1),
        RuleStep(RuleOp.EMIT),
    ])
    return cmap, 3, None


SCALAR_CASES = (
    [f"firstn-{a.name}" for a in BucketAlg]
    + [f"indep-{a}" for a in ("STRAW2", "STRAW", "LIST")]
    + [f"profile-{p}" for p in ("argonaut", "bobtail", "firefly", "jewel")]
    + ["reweighted", "choose-device", "three-level", "out-host-indep",
       "choose-args"]
    + [f"multi-take-{p}" for p in ("argonaut", "bobtail", "firefly")]
    + ["set-tries"]
)


@pytest.mark.parametrize("name", SCALAR_CASES)
def test_scalar_do_rule_matches(name):
    """The port's scalar mapper (the tester's path for unsupported rules and
    the oracle of the batched one) against the JAX package's, x = 0..199."""
    cmap, result_max, weight = _scalar_case(name)
    port_map = to_port(cmap)
    weight = weight or [0x10000] * cmap.max_devices
    jw, pw = jmap.Workspace(), pmap.Workspace()
    for x in range(200):
        want = jmap.do_rule(cmap, 0, x, weight, result_max, jw)
        assert pmap.do_rule(port_map, 0, x, weight, result_max, pw) == want, x
