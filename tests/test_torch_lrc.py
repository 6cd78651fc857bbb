"""The port's LRC codec (ceph_tpu_torch.ec.lrc) against the JAX package's
(ceph_tpu.ec.lrc) on the cases of tests/test_lrc.py, on the CPU: kml
parsing and the generated layers, explicit layers, the locality-aware
minimum_to_decode, layered recovery, crush-steps and create_rule, the
errnos of invalid profiles, and that the physical tensor stays on the
codec's device from layer to layer. Tolerance 0 everywhere."""

import itertools
import json

import numpy as np
import pytest
import torch

from ceph_tpu.ec.interface import ErasureCodeError as JaxErasureCodeError
from ceph_tpu.ec.registry import factory as jax_factory
from ceph_tpu_torch.crush import builder as cb
from ceph_tpu_torch.crush import torch_mapper as tm
from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory

KML = {"k": "4", "m": "2", "l": "3"}
EXPLICIT = {
    "mapping": "__DD__DD",
    "layers": json.dumps([["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]]),
}


def pair(prof):
    return factory("lrc", dict(prof), device="cpu"), jax_factory("lrc", dict(prof))


def outcome(fn, *args):
    try:
        return fn(*args)
    except (ErasureCodeError, JaxErasureCodeError) as e:
        return ("errno", e.code)


def test_kml_generated_layers_match_reference():
    profile = dict(KML)
    ec = factory("lrc", profile, device="cpu")
    ref = jax_factory("lrc", dict(KML))
    assert [layer.chunks_map for layer in ec.layers] == \
        [layer.chunks_map for layer in ref.layers] == ["DDc_DDc_", "DDDc____", "____DDDc"]
    assert [layer.profile for layer in ec.layers] == [layer.profile for layer in ref.layers]
    assert (ec.get_chunk_count(), ec.get_data_chunk_count()) == (8, 4)
    assert "mapping" not in ec.profile and "layers" not in ec.profile
    # the global layer is RS(4,2); the local layers are k=3 m=1 XOR codes
    assert not ec.layers[0].erasure_code._xor_ok
    assert all(layer.erasure_code._xor_ok for layer in ec.layers[1:])
    for size in (1, 4096, 1 << 20, 4 << 20):
        assert ec.get_chunk_size(size) == ref.get_chunk_size(size)


@pytest.mark.parametrize("prof", [
    {"k": "4", "m": "2", "l": "5"}, {"k": "4", "m": "2"},
    {"k": "4", "m": "2", "l": "3", "layers": "[]"}, {"k": "5", "m": "3", "l": "4"},
    {"k": "4", "m": "2", "l": "0"}, {"k": "x", "m": "2", "l": "3"},
    {"mapping": "DD_"}, {"layers": "[]", "mapping": "DD_"},
    {"mapping": "DD_", "layers": "not json"},
    {"mapping": "DD_", "layers": json.dumps([["DDc_", ""]])},
    {"k": "4", "m": "2", "l": "3", "crush-steps": "[[1, 2, 3]]"},
], ids=lambda p: "-".join(p.values())[:40])
def test_invalid_profiles_raise_same_errno(prof):
    with pytest.raises(ErasureCodeError) as ported:
        factory("lrc", dict(prof), device="cpu")
    with pytest.raises(JaxErasureCodeError) as ref:
        jax_factory("lrc", dict(prof))
    assert ported.value.code == ref.value.code


@pytest.mark.parametrize("prof", [KML, EXPLICIT], ids=["kml", "explicit"])
def test_byte_api_and_every_pair_match_reference(prof):
    """Encode, then every single and pair erasure: the same chunks, or the
    same errno, as the JAX codec."""
    ec, ref = pair(prof)
    obj = np.random.default_rng(3).integers(0, 256, 4000, np.uint8).tobytes()
    chunks = ec.encode(range(8), obj)
    assert chunks == ref.encode(range(8), obj)
    for lost in [(i,) for i in range(8)] + list(itertools.combinations(range(8), 2)):
        surv = {i: v for i, v in chunks.items() if i not in lost}
        got = outcome(ec.decode, set(lost), surv)
        assert got == outcome(ref.decode, set(lost), surv), lost
        if not isinstance(got, tuple):
            assert all(got[i] == chunks[i] for i in lost)
    assert ec.decode_concat(chunks)[: len(obj)] == obj


def test_minimum_to_decode_matches_reference():
    ec, ref = pair(KML)
    n = 8
    for want in [{0}, {1, 2}, {4}, {0, 5}, set(range(4))]:
        for lost in [()] + [(i,) for i in range(n)] + list(itertools.combinations(range(n), 2)):
            available = set(range(n)) - set(lost)
            assert outcome(ec.minimum_to_decode, want, available) == \
                outcome(ref.minimum_to_decode, want, available), (want, lost)
    # a single loss reads only its local group
    assert len(ec.minimum_to_decode({0}, set(range(1, 8)))) == 3
    assert outcome(ec.minimum_to_decode, {0}, {3, 6, 7}) == \
        outcome(ref.minimum_to_decode, {0}, {3, 6, 7}) == ("errno", 5)


def test_array_api_matches_reference():
    ec, ref = pair(KML)
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (3, 4, 512), np.uint8)
    parity = ec.encode_array(data)
    assert isinstance(parity, torch.Tensor)
    assert np.array_equal(parity.numpy(), np.asarray(ref.encode_array(data)))
    full = np.concatenate([data, parity.numpy()], axis=1)
    for lost in ([0], [0, 1], [2, 5], [4], [6, 7]):
        present = [i for i in range(8) if i not in lost]
        got = outcome(ec.decode_array, present, lost, full[:, present])
        want = outcome(ref.decode_array, present, lost, full[:, present])
        if isinstance(want, tuple):  # layer by layer, [6, 7] is not recoverable
            assert got == want == ("errno", 5) and lost == [6, 7]
            continue
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(), full[:, lost])


def test_crush_steps_match_reference():
    for prof in (dict(KML, **{"crush-locality": "rack"}),
                 dict(EXPLICIT, **{"crush-steps": json.dumps([["choose", "rack", 2],
                                                               ["chooseleaf", "host", 4]])}),
                 dict(KML, **{"crush-failure-domain": "osd"})):
        ec, ref = pair(prof)
        assert [(s.op, s.type, s.n) for s in ec.rule_steps] == \
            [(s.op, s.type, s.n) for s in ref.rule_steps]
        assert (ec.rule_root, ec.rule_device_class) == (ref.rule_root, ref.rule_device_class)


def racks_map():
    cmap = CrushMap(tunables=Tunables.jewel())
    cmap.type_names = {0: "osd", 1: "host", 2: "rack", 10: "root"}
    osd, bid, rack_ids, rack_ws = 0, -2, [], []
    for _ in range(3):
        host_ids, host_ws = [], []
        for _ in range(4):
            b = cb.make_bucket(cmap, bid, BucketAlg.STRAW2, 1, [osd, osd + 1], [0x10000] * 2)
            bid, osd = bid - 1, osd + 2
            host_ids.append(b.id)
            host_ws.append(b.weight)
        rb = cb.make_bucket(cmap, bid, BucketAlg.STRAW2, 2, host_ids, host_ws)
        bid -= 1
        rack_ids.append(rb.id)
        rack_ws.append(rb.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, rack_ids, rack_ws)
    return cmap, osd


def test_create_rule_places_groups():
    """The generated locality rule, built with the port's crush builder, has
    the JAX codec's steps and maps every shard to a distinct OSD with the
    port's mapper."""
    from ceph_tpu.crush import builder as jcb
    from ceph_tpu.crush.types import BucketAlg as JAlg
    from ceph_tpu.crush.types import CrushMap as JMap
    from ceph_tpu.crush.types import Tunables as JTunables

    prof = dict(KML, **{"crush-locality": "rack"})
    ec, ref = pair(prof)
    cmap, n_osd = racks_map()
    rule = ec.create_rule(cmap, 0, -1)
    jmap = JMap(tunables=JTunables.jewel())
    jmap.type_names = dict(cmap.type_names)
    for b in sorted(cmap.buckets.values(), key=lambda b: -b.id):
        jcb.make_bucket(jmap, b.id, JAlg.STRAW2, b.type, list(b.items), list(b.item_weights))
    jrule = ref.create_rule(jmap, 0, -1)
    assert [(int(s.op), s.arg1, s.arg2) for s in rule.steps] == \
        [(int(s.op), s.arg1, s.arg2) for s in jrule.steps]
    compiled = tm.compile_map(cmap, device="cpu")
    out = tm.map_rule(compiled, 0, np.arange(64), [0x10000] * n_osd, 8)
    for row in np.asarray(out):
        placed = [v for v in row if v >= 0]
        assert len(placed) == 8 and len(set(placed)) == 8


def test_layers_run_on_the_codec_device_without_host_copies(monkeypatch):
    """Every inner codec is built on the LRC codec's device, and the layer
    walk of encode_array / decode_array keeps the physical tensor there: no
    tensor is brought to the host and no numpy array is handed to a layer
    between the first layer and the last."""
    ec = factory("lrc", dict(KML), device="cpu")
    assert all(layer.erasure_code.device == ec.device for layer in ec.layers)
    data = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 4, 256), np.uint8))
    want = ec.encode_array(data)
    full = torch.cat([data, want], dim=1)

    seen = []
    for layer in ec.layers:
        inner = layer.erasure_code
        for name in ("encode_array", "decode_array"):
            orig = getattr(inner, name)

            def recorder(*args, _orig=orig):
                arr = args[-1]
                seen.append(isinstance(arr, torch.Tensor) and arr.device == ec.device)
                out = _orig(*args)
                seen.append(isinstance(out, torch.Tensor) and out.device == ec.device)
                return out

            monkeypatch.setattr(inner, name, recorder)

    def no_host(*_args, **_kwargs):
        raise AssertionError("a layer's tensor was brought to the host")

    monkeypatch.setattr(torch.Tensor, "numpy", no_host)
    monkeypatch.setattr(torch.Tensor, "cpu", no_host)
    monkeypatch.setattr(torch.Tensor, "tolist", no_host)
    got = ec.encode_array(data)
    rebuilt = ec.decode_array([2, 3, 4, 5, 6, 7], [0, 1], full[:, 2:])
    local = ec.decode_array([1, 2, 3, 4, 5, 6, 7], [0], full[:, 1:])
    monkeypatch.undo()
    assert seen and all(seen)
    assert torch.equal(got, want)
    assert torch.equal(rebuilt, full[:, :2]) and torch.equal(local, full[:, :1])


def test_inner_codecs_follow_the_device(monkeypatch):
    """factory(..., device=) reaches every layer's inner codec: a device the
    codec cannot use raises for the LRC codec as for its layers."""
    with pytest.raises(ValueError):
        factory("lrc", dict(KML), device="meta")
    seen = []
    from ceph_tpu_torch.ec import registry as reg

    orig = reg.registry.factory

    def spy(plugin, profile, device=None):
        seen.append((plugin, str(device)))
        return orig(plugin, profile, device)

    monkeypatch.setattr(reg.registry, "factory", spy)
    factory("lrc", dict(KML), device="cpu")
    assert seen[1:] == [("jerasure", "cpu")] * 3
