"""The port's SHEC codec (ceph_tpu_torch.ec.shec) against the JAX package's
(ceph_tpu.ec.shec) on the cases of tests/test_shec.py, on the CPU: the
shingled matrices, every <= c erasure set, minimum_to_decode, the byte API,
the errnos of unrecoverable sets and invalid profiles, and state carried
over from the JAX codec's `_matrix`. Tolerance 0 everywhere."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import shec as jshec
from ceph_tpu.ec.interface import ErasureCodeError as JaxErasureCodeError
from ceph_tpu.ec.registry import factory as jax_factory
from ceph_tpu_torch.ec import shec
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory


def pair(k, m, c, technique="multiple"):
    prof = {"k": str(k), "m": str(m), "c": str(c), "technique": technique}
    return factory("shec", dict(prof), device="cpu"), jax_factory("shec", dict(prof))


@pytest.mark.parametrize("k,m,c,tech", [
    (4, 3, 2, shec.MULTIPLE), (4, 3, 2, shec.SINGLE), (6, 4, 3, shec.MULTIPLE),
    (8, 4, 2, shec.SINGLE), (10, 6, 3, shec.MULTIPLE), (12, 8, 4, shec.MULTIPLE),
])
def test_coding_matrix_matches_reference(k, m, c, tech):
    assert np.array_equal(shec.shec_coding_matrix(k, m, c, tech),
                          jshec.shec_coding_matrix(k, m, c, tech))
    for split in [(1, 2, 1, 1), (2, 1, 1, 1), (1, 2, 2, 1), (0, 3, 1, 1)]:
        assert shec.calc_recovery_efficiency1(k, *split) == \
            jshec.calc_recovery_efficiency1(k, *split)


@pytest.mark.parametrize("k,m,c,tech", [
    (4, 3, 2, "multiple"), (4, 3, 2, "single"), (6, 4, 3, "multiple"),
])
def test_every_c_erasure_set_matches_reference(k, m, c, tech):
    """SHEC(k,m,c) recovers ANY <= c erasures: the port's decode_array gives
    the stripe back for every such set, from the same parity as the JAX
    codec, and assembles its result as a tensor."""
    ec, ref = pair(k, m, c, tech)
    rng = np.random.default_rng(k * 100 + m)
    data = rng.integers(0, 256, (2, k, ec.get_chunk_size(1000)), np.uint8)
    parity = ec.encode_array(data)
    assert isinstance(parity, torch.Tensor)
    assert np.array_equal(parity.numpy(), np.asarray(ref.encode_array(data)))
    full = np.concatenate([data, parity.numpy()], axis=1)
    n = k + m
    for r in range(1, c + 1):
        for lost in itertools.combinations(range(n), r):
            present = [i for i in range(n) if i not in lost]
            out = ec.decode_array(present, list(lost), full[:, present, :])
            assert isinstance(out, torch.Tensor)
            assert np.array_equal(out.numpy(), full[:, list(lost), :]), lost


def test_minimum_to_decode_matches_reference():
    """Single losses (the locally repairable case, fewer than k reads) and
    every pair: the same chunk sets as the JAX codec, each sufficient."""
    ec, ref = pair(6, 4, 3)
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (1, 6, ec.get_chunk_size(1000)), np.uint8)
    full = np.concatenate([data, ec.encode_array(data).numpy()], axis=1)
    n = 10
    sizes = []
    for lost in [(i,) for i in range(n)] + list(itertools.combinations(range(n), 2)):
        available = set(range(n)) - set(lost)
        got = ec.minimum_to_decode(set(lost), available)
        assert got == ref.minimum_to_decode(set(lost), available)
        chosen = sorted(got)
        out = ec.decode_array(chosen, list(lost), full[:, chosen, :])
        assert np.array_equal(out.numpy(), full[:, list(lost)])
        if len(lost) == 1:
            sizes.append(len(chosen))
    assert sum(sizes) / len(sizes) < 6
    # short survivor sets: the same answer, or the same errno
    for want, avail in [({0}, {1, 2, 3}), ({0, 1, 2, 3}, {4, 5, 9}), ({4}, {0, 1, 5, 6})]:
        assert outcome(ec.minimum_to_decode, want, avail) == \
            outcome(ref.minimum_to_decode, want, avail)


def outcome(fn, *args):
    try:
        return fn(*args)
    except (ErasureCodeError, JaxErasureCodeError) as e:
        return ("errno", e.code)


def test_byte_api_matches_reference():
    ec, ref = pair(6, 4, 3)
    obj = np.random.default_rng(11).integers(0, 256, 9000, np.uint8).tobytes()
    chunks = ec.encode(range(10), obj)
    assert chunks == ref.encode(range(10), obj)
    surv = {i: v for i, v in chunks.items() if i not in (0, 5, 7)}
    assert ec.decode({0, 5, 7}, surv) == ref.decode({0, 5, 7}, surv)
    assert ec.decode_concat(surv)[: len(obj)] == obj
    # fewer than k chunks: the base class's k gate does not apply
    minimum = ec.minimum_to_decode({2}, set(range(10)) - {2})
    assert len(minimum) < 6
    assert ec.decode({2}, {i: chunks[i] for i in minimum}) == {2: chunks[2]}


def test_unrecoverable_and_invalid_raise_same_errno():
    ec, ref = pair(4, 3, 2, "single")
    chunks = ec.encode(range(7), bytes(1024))
    covering = {4 + i for i in range(3) if ec._matrix[i, 0]}
    surv = {i: chunks[i] for i in range(7) if i not in {0} | covering}
    with pytest.raises(ErasureCodeError) as ported:
        ec.decode({0}, surv)
    with pytest.raises(JaxErasureCodeError) as jax_err:
        ref.decode({0}, surv)
    assert ported.value.code == jax_err.value.code
    with pytest.raises(ErasureCodeError) as ported:
        ec.decode({0}, {})
    with pytest.raises(JaxErasureCodeError) as jax_err:
        ref.decode({0}, {})
    assert ported.value.code == jax_err.value.code


@pytest.mark.parametrize("prof", [
    {"k": "3", "m": "4", "c": "2"}, {"k": "4", "m": "2", "c": "3"},
    {"k": "13", "m": "4", "c": "2"}, {"k": "12", "m": "9", "c": "2"},
    {"k": "4", "m": "3"}, {"k": "4", "m": "3", "c": "2", "technique": "bogus"},
    {"k": "4", "m": "3", "c": "2", "w": "16"}, {"k": "x", "m": "3", "c": "2"},
    {"k": "4", "m": "3", "c": "2", "mapping": "DD_DD__"},
], ids=lambda p: "-".join(p.values()))
def test_invalid_profiles_raise_same_errno(prof):
    with pytest.raises(ErasureCodeError) as ported:
        factory("shec", dict(prof), device="cpu")
    with pytest.raises(JaxErasureCodeError) as ref:
        jax_factory("shec", dict(prof))
    assert ported.value.code == ref.value.code


def test_defaults_and_chunk_sizes_match():
    ec = factory("shec", {}, device="cpu")
    assert (ec.k, ec.m, ec.c) == (4, 3, 2)
    ec, ref = pair(4, 3, 2)
    for size in (1, 129, 4096, 1 << 20, 4 << 20, 12345679):
        assert ec.get_chunk_size(size) == ref.get_chunk_size(size)


@pytest.mark.parametrize("k,m,c", [(4, 3, 2), (6, 4, 3)])
def test_state_carried_from_reference_matrix(k, m, c):
    """A codec built from the JAX codec's `_matrix` (the corpus profiles)
    equals the port's own construction and decodes as the JAX codec does."""
    ec, ref = pair(k, m, c)
    prof = {"k": str(k), "m": str(m), "c": str(c)}
    carried = shec.from_reference_arrays(ref._matrix, prof, device="cpu")
    assert np.array_equal(carried._matrix, ec._matrix)
    assert np.array_equal(carried._encode.bits, ec._encode.bits)
    obj = np.random.default_rng(c).integers(0, 256, 5000, np.uint8).tobytes()
    chunks = carried.encode(range(k + m), obj)
    assert chunks == ref.encode(range(k + m), obj)
    surv = {i: v for i, v in chunks.items() if i not in (1, k)}
    assert carried.decode({1, k}, surv) == ref.decode({1, k}, surv)
    with pytest.raises(ValueError):
        shec.from_reference_arrays(ref._matrix[:, :-1], prof, device="cpu")


def test_decode_tables_live_on_the_codec_device():
    ec, _ = pair(4, 3, 2)
    want = [1, 0, 0, 0, 0, 1, 0]
    avails = [0, 1, 1, 1, 1, 0, 1]
    entry = ec._make_decoding_matrix(want, avails)
    for tables in (entry[4], entry[6]):
        if tables is not None:
            assert tables.bits_t.device == ec.device == tables.tables_t.device
    assert ec._make_decoding_matrix(want, avails) is entry
