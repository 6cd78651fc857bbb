"""The plain reference against Ceph's golden chunks, and its decode of every
lost-chunk signature."""

import itertools
import os

import numpy as np
import pytest
import torch

import reference

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PROFILES = {
    "isa_k8m3": ("isa", {"k": "8", "m": "3", "technique": "cauchy"}),
    "jerasure_k4m2": ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
}


def golden(name):
    folder = os.path.join(GOLDEN, name)
    with open(os.path.join(folder, "content"), "rb") as f:
        content = f.read()
    chunks = {}
    for fname in os.listdir(folder):
        if fname.startswith("chunk."):
            with open(os.path.join(folder, fname), "rb") as f:
                chunks[int(fname.split(".")[1])] = f.read()
    return content, chunks


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_reference_encode_equals_golden_chunks(name):
    plugin, profile = PROFILES[name]
    codec = reference.Codec(plugin, profile)
    content, chunks = golden(name)
    k, m = codec.k, codec.m
    assert sorted(chunks) == list(range(k + m))
    data = torch.frombuffer(bytearray(content), dtype=torch.uint8).reshape(k, -1)
    parity = codec.encode(data)
    for j in range(k):
        assert bytes(data[j].numpy()) == chunks[j]
    for i in range(m):
        assert bytes(parity[i].numpy()) == chunks[k + i]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_reference_decodes_every_signature_from_golden(name):
    plugin, profile = PROFILES[name]
    codec = reference.Codec(plugin, profile)
    _, chunks = golden(name)
    n = codec.k + codec.m
    word = torch.stack([torch.frombuffer(bytearray(chunks[i]), dtype=torch.uint8)
                        for i in range(n)])
    for lost in range(1, codec.m + 1):
        for targets in itertools.combinations(range(n), lost):
            present = [i for i in range(n) if i not in targets]
            got = codec.decode(present, list(targets), word[present])
            assert torch.equal(got, word[list(targets)]), targets


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_reference_round_trips_batched_random_stripes(name):
    plugin, profile = PROFILES[name]
    codec = reference.Codec(plugin, profile)
    k, m = codec.k, codec.m
    gen = torch.Generator().manual_seed(7)
    data = torch.randint(0, 256, (3, k, 40), generator=gen, dtype=torch.uint8)
    word = torch.cat([data, codec.encode(data)], dim=1)
    for lost in range(1, m + 1):
        for targets in itertools.combinations(range(k + m), lost):
            present = [i for i in range(k + m) if i not in targets]
            got = codec.decode(present, list(targets), word[:, present])
            assert torch.equal(got, word[:, list(targets)]), targets


def test_field_tables_are_a_field():
    gf = reference.GF(*reference.CEPH_FIELD)
    a = np.arange(1, 256)
    inv = np.array([gf.inv(int(x)) for x in a])
    assert (gf.table[a, inv] == 1).all()
    assert gf.mul(2, 0x80) == 0x1D  # x * x^7 reduced by 0x11d
    assert (gf.table[0] == 0).all() and (gf.table[:, 0] == 0).all()


def test_a_non_primitive_generator_is_refused():
    with pytest.raises(ValueError):
        reference.GF(0x11B, 2)


def test_control_field_gives_another_code():
    plugin, profile = PROFILES["isa_k8m3"]
    ceph = reference.Codec(plugin, profile)
    control = reference.Codec(plugin, profile, reference.CONTROL_FIELD)
    assert not np.array_equal(ceph.gen, control.gen)


def test_unknown_technique_is_refused():
    with pytest.raises(ValueError):
        reference.Codec("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"})
