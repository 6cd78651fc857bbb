"""The port's RS codec and plugin registry (ceph_tpu_torch.ec) against the
golden chunks of tests/corpus/ and against the JAX package's codec, on the
CPU. Every comparison is bit-exact (tolerance 0)."""

import errno
import itertools
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import factory as jax_factory
from ceph_tpu.ops import gf_pallas as gp
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.ec.rs import from_reference_arrays
from ceph_tpu_torch.ops import gf_cuda as gc

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")

#: every RS-family profile of the corpus, the native plugin's (a host codec
#: over the same matrices) among them: (plugin, profile, stripe width)
RS_PROFILES = [
    ("isa", {"k": "8", "m": "3", "technique": "cauchy"}, 4096),
    ("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}, 4096),
    ("jerasure", {"k": "7", "m": "3", "technique": "reed_sol_van"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_r6_op"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_orig"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}, 4096),
    ("tpu", {"k": "8", "m": "3"}, 4096),
    ("native", {"k": "6", "m": "3", "technique": "cauchy"}, 4096),
]


def profile_id(case):
    plugin, profile, _sw = case
    return "-".join([plugin] + [profile[k] for k in sorted(profile)])


def load_corpus(plugin, profile, stripe_width):
    """(content, {chunk id: golden bytes}) — the layout of
    tools/ec_non_regression.py's --create."""
    parts = [f"plugin={plugin}", f"stripe-width={stripe_width}"]
    parts += [f"{k}={v}" for k, v in profile.items()]
    d = os.path.join(CORPUS, " ".join(parts))
    with open(os.path.join(d, "content"), "rb") as f:
        content = f.read()
    golden = {}
    for name in os.listdir(d):
        if name.startswith("chunk."):
            with open(os.path.join(d, name), "rb") as f:
                golden[int(name.split(".")[1])] = f.read()
    return content, golden


@pytest.mark.parametrize("case", RS_PROFILES, ids=profile_id)
def test_corpus_profile_encodes_and_recovers(case):
    """tools/ec_non_regression.py's check (re-encode to the golden chunks,
    recover every erasure), over every erasure set up to m, and the same
    bytes as the JAX package's codec."""
    plugin, profile, stripe_width = case
    content, golden = load_corpus(plugin, profile, stripe_width)
    ec = factory(plugin, dict(profile), device="cpu")
    ref = jax_factory(plugin, dict(profile))
    n = ec.get_chunk_count()
    assert sorted(golden) == list(range(n))
    encoded = ec.encode(range(n), content)
    assert encoded == golden
    assert ref.encode(range(n), content) == encoded
    for lost_count in range(1, ec.m + 1):
        for lost in itertools.combinations(range(n), lost_count):
            avail = {i: golden[i] for i in range(n) if i not in lost}
            decoded = ec.decode(set(lost), avail)
            for i in lost:
                assert decoded[i] == golden[i], (lost, i)
            if lost_count == ec.m:
                assert ref.decode(set(lost), avail) == decoded
    assert ec.decode_concat(golden)[: len(content)] == content


#: the corpus profiles of the other families: (plugin, profile, stripe width)
OTHER_PROFILES = [
    ("jerasure", {"k": "4", "m": "2", "w": "5", "technique": "liberation",
                  "packetsize": "32"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "w": "6", "technique": "blaum_roth",
                  "packetsize": "32"}, 4096),
    ("jerasure", {"k": "6", "m": "2", "technique": "liber8tion", "packetsize": "32"}, 4096),
    ("shec", {"k": "4", "m": "3", "c": "2"}, 4096),
    ("shec", {"k": "6", "m": "4", "c": "3"}, 4096),
    ("lrc", {"k": "4", "m": "2", "l": "3"}, 4096),
    ("clay", {"k": "4", "m": "2", "d": "5"}, 4096),
    ("clay", {"k": "8", "m": "4", "d": "11"}, 98304),
]


def decode_outcome(codec, lost, avail):
    """The rebuilt chunks, or ("errno", code) when the codec refuses."""
    try:
        out = codec.decode(set(lost), avail)
    except Exception as e:  # either package's ErasureCodeError
        if not hasattr(e, "code"):
            raise
        return ("errno", e.code)
    return {i: out[i] for i in lost}


@pytest.mark.parametrize("case", OTHER_PROFILES, ids=profile_id)
def test_other_family_corpus_profile(case):
    """The other EC families (bitmatrix, shec, lrc, clay) against their
    golden chunks: re-encode to them, and every erasure set up to the
    codec's m is rebuilt, or refused with the same errno, as the JAX
    package's codec does (clay, an MDS code, must rebuild every one; its
    refusals are compared only where the port refuses, to bound the run)."""
    plugin, profile, stripe_width = case
    content, golden = load_corpus(plugin, profile, stripe_width)
    ec = factory(plugin, dict(profile), device="cpu")
    ref = jax_factory(plugin, dict(profile))
    n = ec.get_chunk_count()
    assert sorted(golden) == list(range(n))
    encoded = ec.encode(range(n), content)
    assert encoded == golden
    m = n - ec.get_data_chunk_count()
    for lost_count in range(1, m + 1):
        for lost in itertools.combinations(range(n), lost_count):
            avail = {i: golden[i] for i in range(n) if i not in lost}
            got = decode_outcome(ec, lost, avail)
            if isinstance(got, dict):
                assert got == {i: golden[i] for i in lost}, lost
            if plugin != "clay" or isinstance(got, tuple):
                assert got == decode_outcome(ref, lost, avail), lost
    assert ec.decode_concat(golden)[: len(content)] == content


@pytest.mark.parametrize("case", [
    ("isa", {"k": "8", "m": "3", "technique": "cauchy"}),
    ("isa", {"k": "5", "m": "2"}),
    ("jerasure", {"k": "7", "m": "3"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van",
                  "jerasure-per-chunk-alignment": "true"}),
    ("jerasure", {"k": "5", "m": "2", "technique": "cauchy_orig",
                  "packetsize": "64", "jerasure-per-chunk-alignment": "true"}),
    ("tpu", {"k": "8", "m": "3"}),
], ids=lambda c: c[0] + "-" + "-".join(c[1].values()))
def test_chunk_size_matches(case):
    plugin, profile = case
    ec = factory(plugin, dict(profile), device="cpu")
    ref = jax_factory(plugin, dict(profile))
    for size in [0, 1, 31, 32, 100, 4095, 4096, 4097, 65536, 1 << 20, 4 << 20, 12345679]:
        assert ec.get_chunk_size(size) == ref.get_chunk_size(size), size


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"technique": "bogus"}),
    ("jerasure", {"technique": "bogus"}),
    ("tpu", {"technique": "bogus"}),
    ("isa", {"k": "33", "m": "2", "technique": "reed_sol_van"}),
    ("isa", {"k": "22", "m": "4", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "4", "m": "2", "w": "16"}),
    ("isa", {"k": "4", "m": "2", "mapping": "DD_D"}),
    ("isa", {"k": "4", "m": "2", "mapping": "DDDDD_"}),
    ("isa", {"k": "1", "m": "2"}),
    ("isa", {"k": "x"}),
    ("isa", {"k": "200", "m": "100"}),
])
def test_invalid_profiles_raise_same_errno(plugin, profile):
    with pytest.raises(ErasureCodeError) as ported:
        factory(plugin, dict(profile), device="cpu")
    with pytest.raises(Exception) as ref:
        jax_factory(plugin, dict(profile))
    assert ported.value.code == ref.value.code


def test_profile_plugin_mismatch_and_unknown_plugin():
    with pytest.raises(ErasureCodeError) as e:
        factory("isa", {"plugin": "jerasure"}, device="cpu")
    assert e.value.code == errno.EINVAL
    with pytest.raises(ErasureCodeError) as e:
        factory("nope", {}, device="cpu")
    assert e.value.code == errno.ENOENT


@pytest.mark.parametrize("plugin,profile", [
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}),
    ("jerasure", {"k": "4", "m": "2", "w": "5", "technique": "liberation"}),
    ("jerasure", {"k": "4", "m": "2", "w": "6", "technique": "blaum_roth"}),
    ("jerasure", {"k": "6", "m": "2", "technique": "liber8tion"}),
])
def test_other_family_geometry_matches_reference(plugin, profile):
    """The codecs that were stubs until the other families were ported
    build on the CPU with the JAX codec's geometry: chunk counts, the chunk
    size of a 4 MiB object, the chunk mapping and the sub-chunk count."""
    ec = factory(plugin, dict(profile), device="cpu")
    ref = jax_factory(plugin, dict(profile))
    assert ec.device.type == "cpu"
    assert (ec.get_chunk_count(), ec.get_data_chunk_count(), ec.get_coding_chunk_count()) == \
        (ref.get_chunk_count(), ref.get_data_chunk_count(), ref.get_coding_chunk_count())
    assert ec.get_chunk_size(4 << 20) == ref.get_chunk_size(4 << 20)
    assert ec.get_chunk_mapping() == ref.get_chunk_mapping()
    assert ec.get_sub_chunk_count() == ref.get_sub_chunk_count()


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"k": "8", "m": "3", "technique": "cauchy"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("tpu", {"k": "6", "m": "4"}),
])
def test_words_api_matches_reference(plugin, profile):
    """encode_words/decode_words equal the JAX package's (its words path
    on the CPU) and the port's own byte-array path."""
    ec = factory(plugin, dict(profile), device="cpu")
    ref = jax_factory(plugin, dict(profile))
    k, m = ec.k, ec.m
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (k, 1024), np.uint8)
    words = gc.bytes_to_words(data)
    parity = ec.encode_words(words)
    assert isinstance(parity, torch.Tensor) and parity.dtype == torch.int32
    assert np.array_equal(parity.numpy(), np.asarray(ref.encode_words(gp.bytes_to_words(data))))
    parity_arr = ec.encode_array(data[None]).numpy()[0]
    assert np.array_equal(gc.words_to_bytes(parity.numpy()), parity_arr)

    full = np.concatenate([data, parity_arr], axis=0)
    lost = [0, k - 1, k][:m]
    present = [i for i in range(k + m) if i not in lost][:k]
    targets = sorted(lost)
    got = ec.decode_words(present, targets, gc.bytes_to_words(full[present]))
    want = ref.decode_words(present, targets, gp.bytes_to_words(full[present]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gc.words_to_bytes(got.numpy()), full[targets])
    arr = ec.decode_array(present, targets, full[None, present])
    assert np.array_equal(arr.numpy()[0], full[targets])


def test_decode_tables_cached_per_signature():
    ec = factory("isa", {"k": "4", "m": "2"}, device="cpu")
    ref = jax_factory("isa", {"k": "4", "m": "2"})
    first = ec.decode_bitmatrix([1, 2, 3, 4], [0])
    assert ec.decode_bitmatrix([1, 2, 3, 4, 5], [0]) is first
    bits, packed = ref.decode_bitmatrix([1, 2, 3, 4], [0])
    assert np.array_equal(first.bits, bits)
    assert np.array_equal(first.packed, packed)
    assert np.array_equal(first.packed_t.numpy(), packed)
    assert np.array_equal(first.tables_t.numpy(), gc.kernel_tables(bits))
    with pytest.raises(ErasureCodeError):
        ec.decode_words([1, 2, 3], [0], np.zeros((3, 4), np.int32))


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {"k": "4", "m": "1"}),
    ("isa", {"k": "5", "m": "1", "technique": "cauchy"}),
    ("tpu", {"k": "4", "m": "1", "technique": "cauchy_good"}),
])
def test_single_parity_paths_match(plugin, profile):
    ec = factory(plugin, dict(profile), device="cpu")
    ref = jax_factory(plugin, dict(profile))
    assert ec._xor_ok == ref._xor_ok
    data = np.random.default_rng(5).integers(0, 256, (ec.k, 512), np.uint8)
    got = ec.encode_words(gc.bytes_to_words(data)).numpy()
    assert np.array_equal(got, np.asarray(ref.encode_words(gp.bytes_to_words(data))))
    arr = ec.encode_array(data[None]).numpy()
    assert np.array_equal(arr, np.asarray(ref.encode_array(data[None])))


def test_state_carried_from_reference_arrays():
    """A codec built from the JAX codec's own arrays (not from the port's
    matrix constructions) computes what the JAX codec computes."""
    ref = jax_factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    ec = from_reference_arrays(
        ref._gen, np.asarray(ref._encode_bits), np.asarray(ref._encode_packed),
        family="isa", device="cpu",
    )
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (2, 8, 256), np.uint8)
    assert np.array_equal(ec.encode_array(data).numpy(), np.asarray(ref.encode_array(data)))
    words = gc.bytes_to_words(data[0])
    assert np.array_equal(
        ec.encode_words(words).numpy(), np.asarray(ref.encode_words(words))
    )
    present, targets = [2, 3, 4, 5, 6, 7, 8, 9], [0, 1, 10]
    full = np.concatenate([data[0], np.asarray(ref.encode_array(data[:1]))[0]])
    surv = gc.bytes_to_words(full[present])
    assert np.array_equal(
        ec.decode_words(present, targets, surv).numpy(),
        np.asarray(ref.decode_words(present, targets, surv)),
    )
    payload = rng.integers(0, 256, 3000, np.uint8).tobytes()
    assert ec.encode(range(11), payload) == ref.encode(range(11), payload)


def test_reference_arrays_are_checked():
    ref = jax_factory("isa", {"k": "4", "m": "2"})
    bits, packed = np.asarray(ref._encode_bits), np.asarray(ref._encode_packed)
    with pytest.raises(ValueError):
        from_reference_arrays(ref._gen, bits[:8], packed, device="cpu")
    with pytest.raises(ValueError):
        from_reference_arrays(ref._gen, bits, packed[:, ::-1], device="cpu")
    with pytest.raises(ValueError):
        from_reference_arrays(ref._gen[::-1], bits, packed, device="cpu")


@pytest.mark.parametrize("call", ["encode_array", "encode_words", "decode_words"])
def test_cpu_codec_refuses_tensor_on_another_device(call):
    """A tensor on another kind of device than the codec's raises: the codec
    never copies it to its own device to compute there. (A `meta` tensor
    stands in for a card tensor on a host without one.)"""
    ec = factory("isa", {"k": "4", "m": "2"}, device="cpu")
    if call == "encode_array":
        args = (torch.empty((1, 4, 64), dtype=torch.uint8, device="meta"),)
    elif call == "encode_words":
        args = (torch.empty((4, 16), dtype=torch.int32, device="meta"),)
    else:
        args = ([1, 2, 3, 4], [0], torch.empty((4, 16), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="move it"):
        getattr(ec, call)(*args)
    # host input still goes to the codec's device
    host = torch.zeros(args[-1].shape, dtype=args[-1].dtype)
    assert getattr(ec, call)(*args[:-1], host).device.type == "cpu"
