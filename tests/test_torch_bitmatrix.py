"""The port's liberation-family codecs (ceph_tpu_torch.ec.bitmatrix) against
the JAX package's (ceph_tpu.ec.bitmatrix), on the CPU: the row product
`xor_rowmatmul` (plain version against the jitted JAX function, and a numpy
emulation of csrc/xor_rowmatmul.cu's per-thread procedure against the plain
version), encode and the decode of every erasure pair for the three
techniques, the errno of the non-MDS blaum_roth w=7 geometry, and state
carried over from the JAX package's matrices. The `gpu` test at the end,
which imports no JAX, holds the kernel against the plain version on a card:

    python -m pytest --noconftest -m gpu tests/test_torch_bitmatrix.py -q

Tolerance 0 everywhere."""

import errno
import itertools
import os
import re

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec import bitmatrix as bmx
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory

try:  # the reference of the CPU tests; a card host without JAX runs `-m gpu` only
    import jax.numpy as jnp

    from ceph_tpu.ec import bitmatrix as jbm
    from ceph_tpu.ec.interface import ErasureCodeError as JaxErasureCodeError
    from ceph_tpu.ec.registry import factory as jax_factory
except ImportError:
    jnp = jbm = JaxErasureCodeError = jax_factory = None

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "ceph_tpu_torch", "csrc", "xor_rowmatmul.cu")

#: (technique, k, w) of the three techniques, at the corpus's geometries
TECHNIQUES = [("liberation", 4, 5), ("blaum_roth", 4, 6), ("liber8tion", 6, 8)]


def profile(technique, k, w, packetsize):
    return {"technique": technique, "k": str(k), "w": str(w), "packetsize": str(packetsize)}


@pytest.mark.parametrize("rows,cols,batch,length", [(14, 28, 2, 96), (3, 5, 1, 7), (16, 64, 3, 40)])
def test_plain_row_product_matches_jax(rows, cols, batch, length):
    rng = np.random.default_rng(rows * cols)
    bm = (rng.random((rows, cols)) < 0.4).astype(np.uint8)
    data = rng.integers(0, 256, (batch, cols, length), np.uint8)
    got = bmx.xor_rowmatmul(torch.from_numpy(bm), torch.from_numpy(data),
                            lists=torch.from_numpy(bmx.row_lists(bm)))
    want = np.asarray(jbm.xor_rowmatmul(jnp.asarray(bm), jnp.asarray(data)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("technique,k,w", TECHNIQUES)
def test_constructions_equal_the_reference(technique, k, w):
    assert np.array_equal(bmx.BUILDERS[technique](k, w), jbm.BUILDERS[technique](k, w))
    bm = bmx.BUILDERS[technique](k, w)
    rows = np.concatenate([np.eye(k * w, dtype=np.uint8), bm])[w : w + k * w]
    assert np.array_equal(bmx.gf2_invert(rows), jbm.gf2_invert(rows))


@pytest.mark.parametrize("packetsize", [32, 2048])
@pytest.mark.parametrize("technique,k,w", TECHNIQUES)
def test_encode_and_every_pair_decode_equal_reference(technique, k, w, packetsize):
    prof = profile(technique, k, w, packetsize)
    ec = factory("jerasure", dict(prof), device="cpu")
    ref = jax_factory("jerasure", dict(prof))
    assert isinstance(ec, bmx.ErasureCodeBitmatrix)
    rng = np.random.default_rng(packetsize + k)
    data = rng.integers(0, 256, (2, k, 2 * w * packetsize), np.uint8)
    parity = ec.encode_array(data)
    assert isinstance(parity, torch.Tensor)
    want = np.asarray(ref.encode_array(data))
    assert np.array_equal(parity.numpy(), want)
    full = np.concatenate([data, want], axis=1)
    for lost in itertools.combinations(range(k + 2), 2):
        present = [i for i in range(k + 2) if i not in lost]
        got = ec.decode_array(present, list(lost), full[:, present])
        assert np.array_equal(got.numpy(), full[:, list(lost)]), lost
    # the byte API over the packet-group layout, against the reference's bytes
    payload = rng.integers(0, 256, 3 * w * packetsize + 5, np.uint8).tobytes()
    chunks = ec.encode(range(k + 2), payload)
    assert chunks == ref.encode(range(k + 2), payload)
    assert ec.decode({0, k + 1}, {i: c for i, c in chunks.items() if i not in (0, k + 1)}) \
        == {0: chunks[0], k + 1: chunks[k + 1]}


def test_blaum_roth_w7_is_not_mds_in_both():
    prof = profile("blaum_roth", 2, 7, 4)
    ec = factory("jerasure", dict(prof), device="cpu")
    ref = jax_factory("jerasure", dict(prof))
    data = bytes(range(256)) * 2
    chunks = ec.encode(range(4), data)
    assert chunks == ref.encode(range(4), data)
    avail = {2: chunks[2], 3: chunks[3]}
    with pytest.raises(ErasureCodeError) as ported:
        ec.decode({0, 1}, avail)
    with pytest.raises(JaxErasureCodeError) as jax_err:
        ref.decode({0, 1}, avail)
    assert ported.value.code == jax_err.value.code == errno.EIO


@pytest.mark.parametrize("prof", [
    {"technique": "liberation", "k": "4", "w": "6", "packetsize": "4"},
    {"technique": "liberation", "k": "8", "w": "7", "packetsize": "4"},
    {"technique": "liberation", "k": "4", "w": "5", "m": "3", "packetsize": "4"},
    {"technique": "liberation", "k": "4", "w": "5", "packetsize": "6"},
    {"technique": "blaum_roth", "k": "4", "w": "8", "packetsize": "4"},
    {"technique": "liberation", "k": "4", "w": "5", "packetsize": "0"},
], ids=lambda p: "-".join(p.values()))
def test_invalid_profiles_raise_same_errno(prof):
    with pytest.raises(ErasureCodeError) as ported:
        factory("jerasure", dict(prof), device="cpu")
    with pytest.raises(JaxErasureCodeError) as ref:
        jax_factory("jerasure", dict(prof))
    assert ported.value.code == ref.value.code


def test_envelope_coercions_and_chunk_sizes_match():
    for prof in ({"technique": "liber8tion", "k": "5", "m": "9", "w": "3", "packetsize": "4"},
                 {"technique": "liberation", "packetsize": "4"},
                 {"technique": "liberation", "k": "3", "w": "5", "packetsize": "8",
                  "jerasure-per-chunk-alignment": "true"}):
        ec = factory("jerasure", dict(prof), device="cpu")
        ref = jax_factory("jerasure", dict(prof))
        assert (ec.k, ec.m, ec.w) == (ref.k, ref.m, ref.w)
        for size in (1, 4095, 4096, 1 << 20, 4 << 20):
            assert ec.get_chunk_size(size) == ref.get_chunk_size(size)
    ec = factory("jerasure", profile("liberation", 2, 3, 4) | {"mapping": "_DD_"},
                 device="cpu")
    out = ec.encode(range(4), b"liberation mapping")
    assert ec.decode_concat(out)[:18] == b"liberation mapping"
    with pytest.raises(ErasureCodeError) as e:
        ec.encode_array(np.zeros((1, 2, 13), np.uint8))
    assert e.value.code == errno.EINVAL


@pytest.mark.parametrize("technique,k,w", TECHNIQUES)
def test_state_carried_from_reference_matrix(technique, k, w):
    """A codec built from the JAX codec's `_bitmat` equals the port's own
    construction and computes what the JAX codec computes."""
    prof = profile(technique, k, w, 32)
    ref = jax_factory("jerasure", dict(prof))
    ec = bmx.from_reference_arrays(ref._bitmat, technique, dict(prof), device="cpu")
    own = factory("jerasure", dict(prof), device="cpu")
    assert np.array_equal(ec._bitmat, own._bitmat)
    data = np.random.default_rng(k).integers(0, 256, (1, k, w * 64), np.uint8)
    assert np.array_equal(ec.encode_array(data).numpy(), np.asarray(ref.encode_array(data)))
    with pytest.raises(ValueError):
        bmx.from_reference_arrays(ref._bitmat[:-1], technique, dict(prof), device="cpu")


# -- the kernel's per-thread procedure, emulated in numpy ----------------------

def emulate_row_kernel(lists, rows_out, buf, batch, length, sb, sc):
    """csrc/xor_rowmatmul.cu: each thread owns 16 bytes of one batch item,
    loads them (zero past `length`, as the masked byte loads leave them) from
    each input row its output row's list selects, XORs them and stores the
    first `length` bytes of each output row."""
    offsets, cols = lists[: rows_out + 1], lists[rows_out + 1 :]
    groups = -(-length // 16)
    out = np.zeros((batch, rows_out, length), np.uint8)
    for b in range(batch):
        for g in range(groups):
            c0 = g * 16
            nb = min(16, length - c0)
            for i in range(rows_out):
                acc = np.zeros(16, np.uint8)
                for e in range(offsets[i], offsets[i + 1]):
                    start = b * sb + int(cols[e]) * sc + c0
                    v = np.zeros(16, np.uint8)
                    v[:nb] = buf[start : start + nb]
                    acc ^= v
                out[b, i, c0 : c0 + nb] = acc[:nb]
    return out


@pytest.mark.parametrize("technique,k,w,packetsize,groups,strided", [
    ("liberation", 4, 7, 32, 1, False),    # whole 16-byte vectors
    ("blaum_roth", 4, 6, 4, 3, True),      # ragged ends, strided rows
    ("liber8tion", 3, 8, 12, 2, True),
])
def test_row_kernel_emulation_matches_plain(technique, k, w, packetsize, groups, strided):
    bm = bmx.BUILDERS[technique](k, w)
    lists = bmx.row_lists(bm)
    assert lists[0] == 0 and lists[bm.shape[0]] == bm.sum()
    rng = np.random.default_rng(packetsize)
    length = groups * packetsize
    base = rng.integers(0, 256, (2, k * w + 3, length + 7), np.uint8)
    view = (torch.from_numpy(base)[:, 2 : 2 + k * w, 5 : 5 + length] if strided
            else torch.from_numpy(base[:, : k * w, :length].copy()))
    flat = (torch.from_numpy(base).numpy().reshape(-1)[view.storage_offset():]
            if strided else view.numpy().reshape(-1))
    got = emulate_row_kernel(lists, bm.shape[0], flat, 2, length, view.stride(0), view.stride(1))
    assert np.array_equal(got, bmx.xor_rowmatmul_plain(torch.from_numpy(bm), view).numpy())
    # the decode matrices (dense inverses) go through the same lists
    ec = factory("jerasure", profile(technique, k, w, 4), device="cpu")
    dm = ec._decode_rows([i for i in range(k + 2) if i not in (0, 1)], [0, 1])
    assert np.array_equal(dm.lists_t.numpy(), bmx.row_lists(dm.bits))
    dm_rows = torch.from_numpy(base[:, : k * w, :length].copy())
    got = emulate_row_kernel(bmx.row_lists(dm.bits), dm.bits.shape[0],
                             dm_rows.numpy().reshape(-1), 2, length, *dm_rows.stride()[:2])
    assert np.array_equal(got, bmx.xor_rowmatmul_plain(dm.bits_t, dm_rows).numpy())


def test_list_limit_is_refused_on_either_device():
    """C is not capped, but a matrix whose row lists exceed the kernel's
    shared memory is refused on the CPU as on a card."""
    wide = torch.ones((1, bmx.MAX_LIST_WORDS), dtype=torch.uint8)
    rows = torch.zeros((1, bmx.MAX_LIST_WORDS, 4), dtype=torch.uint8)
    too_long = torch.zeros(bmx.MAX_LIST_WORDS + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="row-list words"):
        bmx.xor_rowmatmul(wide, rows, lists=too_long)
    with pytest.raises(ValueError, match="row-list words"):
        bmx.row_lists(wide.numpy())
    fits = torch.ones((2, 4000), dtype=torch.uint8)  # C = 4000, far above 64
    data = np.random.default_rng(0).integers(0, 256, (1, 4000, 4), np.uint8)
    lists = torch.from_numpy(bmx.row_lists(fits.numpy()))
    got = bmx.xor_rowmatmul(fits, torch.from_numpy(data), lists=lists).numpy()
    assert np.array_equal(got[0, 1], np.bitwise_xor.reduce(data[0], axis=0))


def test_kernel_source_and_binding_agree():
    """The binding refuses lists past the words the source's kernel stages
    (its ctypes signature is checked in test_torch_bitplane_cuda.py)."""
    with open(SOURCE) as f:
        src = f.read()
    assert int(re.search(r"kMaxListWords = (\d+) / 4", src).group(1)) // 4 == bmx.MAX_LIST_WORDS


def test_wrapper_refusals_and_cpu_counts_no_launch():
    mat = bmx.RowMatrix(bmx.liberation_bitmatrix(2, 3), torch.device("cpu"))
    bm, lists = mat.bits_t, mat.lists_t
    rows = torch.zeros((1, 6, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        bmx.xor_rowmatmul(bm, rows.to(torch.int32), lists=lists)
    with pytest.raises(ValueError, match="does not take"):
        bmx.xor_rowmatmul(bm, rows[:, :5], lists=lists)
    with pytest.raises(TypeError):
        bmx.xor_rowmatmul(bm.numpy(), rows, lists=lists)
    with pytest.raises(ValueError, match="unsupported device"):
        bmx.xor_rowmatmul(bm, rows.to("meta"), lists=lists)
    before = bmx.xor_rowmatmul.launches
    bmx.xor_rowmatmul(bm, rows, lists=lists)
    assert bmx.xor_rowmatmul.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """The row-product kernel against its plain version on the card: the
    three techniques' encode matrices and a decode matrix, strided rows and
    a ragged width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    gen = torch.Generator(device="cuda").manual_seed(12)
    before = bmx.xor_rowmatmul.launches
    cases = 0
    for technique, k, w in TECHNIQUES:
        ec = factory("jerasure", profile(technique, k, w, 36), device="cuda")
        for mat in (ec._encode, ec._decode_rows([i for i in range(k + 2) if i not in (0, k)], [0, k])):
            rows = torch.randint(0, 256, (3, k * w + 1, 3 * 36 + 5), dtype=torch.uint8,
                                 device="cuda", generator=gen)[:, 1:, :]
            got = bmx.xor_rowmatmul(mat.bits_t, rows, lists=mat.lists_t)
            torch.cuda.synchronize()
            assert torch.equal(got, bmx.xor_rowmatmul_plain(mat.bits_t, rows))
            cases += 1
    assert bmx.xor_rowmatmul.launches == before + cases
