"""The port's CLAY codec (ceph_tpu_torch.ec.clay) against the JAX package's
(ceph_tpu.ec.clay) on the cases of tests/test_clay.py, on the CPU:
geometry, the errnos of invalid profiles, encode and every erasure set up
to m, the MSR single-node repair (minimum_to_decode, get_repair_subchunks,
is_repair, repair_array) with and without aloof nodes and chunk mappings,
and the inner codecs' device. Tolerance 0 everywhere."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec.interface import ErasureCodeError as JaxErasureCodeError
from ceph_tpu.ec.registry import factory as jax_factory
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory


def pair(k, m, d, **extra):
    prof = {"k": str(k), "m": str(m), "d": str(d)}
    prof.update({key: str(v) for key, v in extra.items()})
    return factory("clay", dict(prof), device="cpu"), jax_factory("clay", dict(prof))


def encoded_pair(ec, ref, seed):
    data = np.random.default_rng(seed).integers(
        0, 256, ec.get_chunk_size(1) * ec.k, np.uint8).tobytes()
    encoded = ec.encode(range(ec.k + ec.m), data)
    assert encoded == ref.encode(range(ec.k + ec.m), data)
    return data, encoded


def repair_reads(ec, encoded, minimum, chunk_size):
    sc = chunk_size // ec.sub_chunk_no
    return {c: b"".join(encoded[c][off * sc:(off + count) * sc] for off, count in runs)
            for c, runs in minimum.items()}


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (5, 2, 6), (8, 4, 11), (6, 3, 7), (8, 3, 9)])
def test_geometry_matches_reference(k, m, d):
    ec, ref = pair(k, m, d)
    assert (ec.q, ec.t, ec.nu, ec.sub_chunk_no) == (ref.q, ref.t, ref.nu, ref.sub_chunk_no)
    assert ec.get_sub_chunk_count() == ref.get_sub_chunk_count()
    assert ec.get_chunk_count() == ref.get_chunk_count()
    for size in (1, 4096, 98304, 4 << 20):
        assert ec.get_chunk_size(size) == ref.get_chunk_size(size)
    for node in range(ec.q * ec.t):
        assert ec.get_repair_subchunks(node) == ref.get_repair_subchunks(node)
    assert np.array_equal(ec._G4, ref._G4)
    assert ec.mds.device == ec.pft.device == ec.device


@pytest.mark.parametrize("prof", [
    {"k": "4", "m": "2", "d": "7"}, {"k": "4", "m": "2", "d": "3"},
    {"k": "4", "m": "2", "scalar_mds": "nope"}, {"k": "4", "m": "2", "d": "5", "scalar_mds": "shec"},
    {"k": "4", "m": "3", "d": "6", "technique": "reed_sol_r6_op"},
    {"k": "4", "m": "2", "d": "5", "technique": "liber8tion"},
    {"k": "1", "m": "2"}, {"k": "4", "m": "2", "d": "5", "scalar_mds": "isa", "technique": "cauchy_good"},
], ids=lambda p: "-".join(p.values()))
def test_invalid_profiles_raise_same_errno(prof):
    with pytest.raises(ErasureCodeError) as ported:
        factory("clay", dict(prof), device="cpu")
    with pytest.raises(JaxErasureCodeError) as ref:
        jax_factory("clay", dict(prof))
    assert ported.value.code == ref.value.code


@pytest.mark.parametrize("k,m,d,extra", [
    (4, 2, 5, {}), (5, 2, 6, {}), (4, 2, 5, {"technique": "reed_sol_r6_op"}),
    (4, 2, 5, {"scalar_mds": "isa", "technique": "cauchy"}),
])
def test_encode_and_every_erasure_set_match_reference(k, m, d, extra):
    ec, ref = pair(k, m, d, **extra)
    _, encoded = encoded_pair(ec, ref, k * 100 + m * 10 + d)
    for n_erase in range(1, m + 1):
        for lost in itertools.combinations(range(k + m), n_erase):
            avail = {i: encoded[i] for i in range(k + m) if i not in lost}
            out = ec.decode(set(lost), avail)
            assert all(out[i] == encoded[i] for i in lost), lost


def test_array_api_matches_reference_and_returns_tensors():
    ec, ref = pair(4, 2, 5)
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (3, 4, ec.sub_chunk_no * 20), np.uint8)
    parity = ec.encode_array(data)
    assert isinstance(parity, torch.Tensor) and parity.device == ec.device
    assert np.array_equal(parity.numpy(), np.asarray(ref.encode_array(data)))
    full = np.concatenate([data, parity.numpy()], axis=1)
    for lost in ([0], [1, 4], [5]):
        present = [i for i in range(6) if i not in lost]
        got = ec.decode_array(present, lost, torch.from_numpy(full[:, present]))
        assert np.array_equal(got.numpy(), full[:, lost])
    with pytest.raises(ErasureCodeError):
        ec.encode_array(data[:, :, :13])


@pytest.mark.parametrize("k,m,d,lost", [
    (4, 2, 5, 0), (4, 2, 5, 5), (5, 2, 6, 2), (8, 4, 11, 7),
    (6, 3, 7, 5), (8, 3, 9, 4),          # aloof nodes (d < k+m-1), nu = 1
])
def test_msr_repair_matches_reference(k, m, d, lost):
    """The single-node repair reads 1/q of d helpers (the same plan as the
    JAX codec) and rebuilds the chunk through repair_array, bit-exact."""
    ec, ref = pair(k, m, d)
    _, encoded = encoded_pair(ec, ref, lost + 1)
    chunk_size = ec.get_chunk_size(1)
    available = set(range(k + m)) - {lost}
    assert ec.is_repair({lost}, available) == ref.is_repair({lost}, available)
    minimum = ec.minimum_to_decode({lost}, available)
    assert minimum == ref.minimum_to_decode({lost}, available)
    assert len(minimum) == d
    partial = repair_reads(ec, encoded, minimum, chunk_size)
    out = ec.decode({lost}, partial, chunk_size=chunk_size)
    assert out[lost] == encoded[lost] == ref.decode({lost}, partial, chunk_size=chunk_size)[lost]
    # repair_array directly: (S/q, cols) helpers -> (S, cols) tensor
    sc = chunk_size // ec.sub_chunk_no
    helpers = {c: np.frombuffer(b, np.uint8).reshape(-1, sc) for c, b in partial.items()}
    rebuilt = ec.repair_array(lost, helpers, sc)
    assert isinstance(rebuilt, torch.Tensor) and rebuilt.shape == (ec.sub_chunk_no, sc)
    assert rebuilt.numpy().tobytes() == encoded[lost]
    assert ec.get_repair_sub_chunk_count({lost}) == ref.get_repair_sub_chunk_count({lost})


def test_is_repair_and_fallback_minimum_match_reference():
    ec, ref = pair(4, 2, 5)
    cases = [({0}, {1, 2, 3, 4, 5}), ({0}, {2, 3, 4, 5}), ({0, 2}, {1, 3, 4, 5}),
             ({0}, {0, 1, 2, 3, 4, 5}), ({3}, {0, 1, 2, 4, 5})]
    for want, avail in cases:
        assert ec.is_repair(want, avail) == ref.is_repair(want, avail)
        assert ec.minimum_to_decode(want, avail) == ref.minimum_to_decode(want, avail)


def test_repair_with_chunk_mapping_matches_reference():
    ec, ref = pair(4, 2, 5, mapping="DDCCDD")
    _, encoded = encoded_pair(ec, ref, 11)
    chunk_size = ec.get_chunk_size(1)
    for lost in range(6):
        available = set(range(6)) - {lost}
        assert ec.is_repair({lost}, available) == ref.is_repair({lost}, available)
        if not ec.is_repair({lost}, available):
            continue
        minimum = ec.minimum_to_decode({lost}, available)
        assert minimum == ref.minimum_to_decode({lost}, available)
        partial = repair_reads(ec, encoded, minimum, chunk_size)
        assert ec.decode({lost}, partial, chunk_size=chunk_size)[lost] == encoded[lost]


def test_too_many_erasures_raise_same_errno():
    ec, ref = pair(4, 2, 5)
    _, encoded = encoded_pair(ec, ref, 3)
    avail = {i: encoded[i] for i in (0, 1, 2)}
    with pytest.raises(ErasureCodeError) as ported:
        ec.decode({3, 4, 5}, avail)
    with pytest.raises(JaxErasureCodeError) as jax_err:
        ref.decode({3, 4, 5}, avail)
    assert ported.value.code == jax_err.value.code
