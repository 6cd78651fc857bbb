"""The packed-word GF(2^8) matmul (ceph_tpu_torch.ops.gf_cuda) against the
JAX package's Pallas kernel (ceph_tpu.ops.gf_pallas), which runs here in
interpret mode as tests/test_gf_pallas.py runs it. On the CPU the wrapper runs
the plain torch version; the CUDA kernel's own arithmetic (tables of a
byte's three bit fields looked up with byte permutes) is emulated in numpy below, and the
kernel itself is compared with the plain version on a card by
tests/test_torch_gpu.py. Tolerance 0 everywhere: the data are integers."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ops import gf_pallas as gp
from ceph_tpu_torch.ops import cuda_build, gf
from ceph_tpu_torch.ops import gf_cuda as gc


def pallas(packed, words):
    return np.asarray(
        gp.gf_matmul_packed(jnp.asarray(packed), jnp.asarray(words), interpret=True)
    )


def port(packed, words):
    return gc.gf_matmul_packed(
        torch.from_numpy(packed), torch.from_numpy(np.array(words))
    ).numpy()


@pytest.mark.parametrize("k,r", [(4, 2), (8, 3), (6, 4)])
def test_pack_matrix_identical_and_invertible(k, r):
    bitmat = (np.random.default_rng(k).random((8 * r, 8 * k)) < 0.4).astype(np.int8)
    packed = gc.pack_matrix(bitmat)
    assert np.array_equal(packed, gp.pack_matrix(bitmat))
    assert np.array_equal(gc.unpack_matrix(packed), bitmat)


def test_unpack_matrix_rejects_foreign_matrix():
    packed = gc.pack_matrix(np.ones((8, 16), np.int8))
    packed[1, 0] = 1  # couples byte lanes 1 and 0: not a pack_matrix form
    with pytest.raises(ValueError):
        gc.unpack_matrix(packed)


def test_bytes_words_roundtrip():
    chunks = np.random.default_rng(1).integers(0, 256, (4, 256), np.uint8)
    words = gc.bytes_to_words(chunks)
    assert np.array_equal(words, gp.bytes_to_words(chunks))
    assert np.array_equal(gc.words_to_bytes(words), chunks)
    with pytest.raises(ValueError):
        gc.bytes_to_words(chunks[:, :6])


@pytest.mark.parametrize("k,r", [(4, 2), (8, 3), (6, 4)])
def test_plain_matches_pallas_interpret(k, r):
    rng = np.random.default_rng(2)
    mat = rng.integers(0, 256, (r, k), np.uint8)
    packed = gc.pack_matrix(gf.matrix_to_bitmatrix(mat))
    data = rng.integers(0, 256, (k, 512), np.uint8)
    words = gc.bytes_to_words(data)
    got = port(packed, words)
    assert got.dtype == np.int32 and got.shape == (r, 128)
    assert np.array_equal(got, pallas(packed, words))
    assert np.array_equal(gc.words_to_bytes(got), gf.gf_matmul(mat, data))


def test_plain_matches_pallas_on_non_gf_bitmatrix():
    rng = np.random.default_rng(3)
    bitmat = (rng.random((24, 40)) < 0.5).astype(np.int8)  # r=3, k=5, not GF-derived
    packed = gc.pack_matrix(bitmat)
    words = gc.bytes_to_words(rng.integers(0, 256, (5, 1024), np.uint8))
    assert np.array_equal(port(packed, words), pallas(packed, words))


def test_plain_matches_pallas_on_ragged_width():
    rng = np.random.default_rng(4)
    mat = rng.integers(0, 256, (3, 8), np.uint8)
    packed = gc.pack_matrix(gf.matrix_to_bitmatrix(mat))
    data = rng.integers(0, 256, (8, 4 * (128 + 37)), np.uint8)
    words = gc.bytes_to_words(data)
    got = port(packed, words)
    assert np.array_equal(got, pallas(packed, words))
    assert np.array_equal(gc.words_to_bytes(got), gf.gf_matmul(mat, data))


def test_plain_steps_over_columns(monkeypatch):
    """The plain version bounds its temporaries by walking column steps;
    a step boundary inside the data changes nothing."""
    rng = np.random.default_rng(5)
    packed = gc.pack_matrix(gf.matrix_to_bitmatrix(rng.integers(0, 256, (2, 4), np.uint8)))
    words = gc.bytes_to_words(rng.integers(0, 256, (4, 4 * 300), np.uint8))
    whole = port(packed, words)
    monkeypatch.setattr(gc, "PLAIN_STEP_WORDS", 128)
    assert np.array_equal(port(packed, words), whole)


def test_xor_reduce_words_matches():
    data = np.random.default_rng(6).integers(0, 256, (5, 128), np.uint8)
    words = gc.bytes_to_words(data)
    got = gc.xor_reduce_words(torch.from_numpy(np.array(words))).numpy()
    assert np.array_equal(got, np.asarray(gp.xor_reduce_words(jnp.asarray(words))))
    assert np.array_equal(
        gc.words_to_bytes(got)[0], np.bitwise_xor.reduce(data, axis=0)
    )


@pytest.mark.parametrize("k,r", [(4, 2), (8, 3)])
def test_nibble_tables_reproduce_products(k, r):
    """The kernel's tables (`kernel_tables`) give every GF(2^8) product as
    the XOR of the lookups of a byte's fields: bits 0-2, 3-5 and 6-7."""
    mat = np.random.default_rng(7).integers(0, 256, (r, k), np.uint8)
    tables = gc.kernel_tables(gf.matrix_to_bitmatrix(mat))
    assert tables.shape == (r, k, 32) and tables.dtype == np.uint8
    assert not tables[..., 20:].any()
    x = np.arange(256)
    for i in range(r):
        for j in range(k):
            f = np.zeros(256, np.uint8)
            for start, first, width in gc.TABLE_FIELDS:
                f ^= tables[i, j, start + ((x >> first) & ((1 << width) - 1))]
            assert np.array_equal(f, gf.gf_mul(mat[i, j], x.astype(np.uint8)))


def test_nibble_tables_reject_non_binary():
    with pytest.raises(ValueError):
        gc.kernel_tables(np.full((8, 8), 2, np.int8))


# -- numpy emulation of the kernel's per-word arithmetic (csrc/gf_matmul.cu) --

def kernel_constants() -> dict:
    """kRowGroup, kLoadGroup and kParamTables of csrc/gf_matmul.cu."""
    with open(os.path.join(os.path.dirname(cuda_build.CSRC_DIR), "csrc", "gf_matmul.cu")) as f:
        src = f.read()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kRowGroup", "kLoadGroup", "kParamTables")}


def prmt(a, b, sel):
    """PTX prmt.b32 in its default mode: byte n of the result is byte
    sel_n & 7 of the 8-byte value b:a, or, where bit 3 of the selector
    nibble sel_n is set, that byte's bit 7 replicated over the byte."""
    pool = (np.asarray(b, np.uint64) << np.uint64(32)) | np.asarray(a, np.uint64)
    pool, sel = np.broadcast_arrays(pool, np.asarray(sel, np.uint64))
    out = np.zeros(pool.shape, dtype=np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        byte = (pool >> ((nib & np.uint64(7)) * np.uint64(8))) & np.uint64(0xFF)
        signed = np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0))
        byte = np.where(nib & np.uint64(8), signed, byte)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def selector(field):
    """A field (a value below 8 in each byte) as a prmt selector."""
    return prmt(field | (field >> np.uint32(4)), 0, 0x0020)


def selectors(w):
    return (selector(w & np.uint32(0x07070707)),
            selector((w >> np.uint32(3)) & np.uint32(0x07070707)),
            selector((w >> np.uint32(6)) & np.uint32(0x03030303)))


def product(t, t67, sels):
    low, mid, high = sels
    return prmt(t[0], t[1], low) ^ prmt(t[2], t[3], mid) ^ prmt(t67, 0, high)


def emulate_kernel(tables, words, row_group=None, load_group=None):
    """The kernel body on every column at once, in its order: per group of
    `row_group` output rows, the input rows in groups of `load_group` (all
    loaded, then looked up), block (i, j)'s tables read as the 16-byte
    entry 2 (i k + j) and the first word of entry 2 (i k + j) + 1 of the
    flat tables (the parameter block and the device copy hold the same
    layout). The constants default to the source's."""
    consts = kernel_constants()
    row_group = row_group or consts["kRowGroup"]
    load_group = load_group or consts["kLoadGroup"]
    r, k = tables.shape[:2]
    flat = np.ascontiguousarray(tables).reshape(-1, 16).view("<u4")  # (2 r k, 4) words
    w = words.view(np.uint32)
    out = np.zeros((r, w.shape[1]), np.uint32)
    for i0 in range(0, r, row_group):
        acc = np.zeros((row_group, w.shape[1]), np.uint32)
        for j0 in range(0, k, load_group):
            loaded = [w[j] for j in range(j0, min(j0 + load_group, k))]
            for jj, v in enumerate(loaded):
                sels = selectors(v)
                for a in range(min(row_group, r - i0)):
                    b = (i0 + a) * k + j0 + jj
                    acc[a] ^= product(flat[2 * b], flat[2 * b + 1][0], sels)
        out[i0:i0 + row_group] = acc[:min(row_group, r - i0)]
    return out.view(np.int32)


def test_prmt_emulation_follows_the_ptx_modes():
    a, b = np.uint32(0x8001FF7F), np.uint32(0x04030280)
    assert prmt(a, b, 0x3210) == a and prmt(a, b, 0x7654) == b
    assert prmt(a, b, 0x0020) == 0x7F7F017F
    assert prmt(a, b, 0xBA98) == 0xFF00FF00  # bit 7 of each byte of a, replicated
    # the kernel's selectors never set bit 3 of a nibble: copy mode only
    w = np.random.default_rng(0).integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    for sel in selectors(w):
        assert not (sel & np.uint32(0x8888)).any()


@pytest.mark.parametrize("gf_derived", [True, False])
def test_kernel_arithmetic_matches_plain(gf_derived):
    rng = np.random.default_rng(8)
    if gf_derived:
        bitmat = gf.matrix_to_bitmatrix(rng.integers(0, 256, (3, 8), np.uint8))
    else:
        bitmat = (rng.random((24, 64)) < 0.5).astype(np.int8)
    words = gc.bytes_to_words(rng.integers(0, 256, (8, 1024), np.uint8))
    got = emulate_kernel(gc.kernel_tables(bitmat), words)
    assert np.array_equal(got, port(gc.pack_matrix(bitmat), words))


@pytest.mark.parametrize("k,r,row_group,load_group", [
    (10, 6, None, None),  # two load groups and two row groups at the source's constants
    (7, 5, 2, 3),         # ragged groups of both kinds
    (1, 1, None, None),   # k = 1, r = 1
])
def test_kernel_groups_match_plain(k, r, row_group, load_group):
    rng = np.random.default_rng(k * 10 + r)
    bitmat = gf.matrix_to_bitmatrix(rng.integers(0, 256, (r, k), np.uint8))
    words = gc.bytes_to_words(rng.integers(0, 256, (k, 256), np.uint8))
    got = emulate_kernel(gc.kernel_tables(bitmat), words, row_group, load_group)
    assert np.array_equal(got, port(gc.pack_matrix(bitmat), words))


def test_parameter_block_fits_a_launch():
    """The tables the launcher carries in the kernel parameter, with the
    kernel's other arguments, fit the 4 KiB a launch's parameters may take."""
    assert kernel_constants()["kParamTables"] * 32 + 64 <= 4096


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(gc.pack_matrix(gf.matrix_to_bitmatrix(
        rng.integers(0, 256, (2, 4), np.uint8))))
    words = torch.from_numpy(gc.bytes_to_words(rng.integers(0, 256, (4, 64), np.uint8)).copy())
    before = gc.gf_matmul_packed.launches
    got = gc.gf_matmul_packed(packed, words)
    assert torch.equal(got, gc.gf_matmul_packed_plain(packed, words))
    assert gc.gf_matmul_packed.launches == before


def test_tables_derived_once_per_packed_matrix():
    """Without `tables=`, the wrapper's kernel tables come from the packed
    matrix once and are memoised on it until it changes in place."""
    bitmat = gf.matrix_to_bitmatrix(np.random.default_rng(3).integers(0, 256, (3, 5), np.uint8))
    packed = torch.from_numpy(gc.pack_matrix(bitmat))
    cpu = torch.device("cpu")
    first = gc._tables_for(packed, cpu)
    assert np.array_equal(first.numpy(), gc.kernel_tables(bitmat))
    assert gc._tables_for(packed, cpu) is first
    other = gf.matrix_to_bitmatrix(np.full((3, 5), 7, np.uint8))
    packed.copy_(torch.from_numpy(gc.pack_matrix(other)))
    assert np.array_equal(gc._tables_for(packed, cpu).numpy(), gc.kernel_tables(other))


def test_wrapper_rejects_bad_inputs():
    packed = torch.from_numpy(gc.pack_matrix(np.ones((16, 32), np.int8)))  # r=2, k=4
    with pytest.raises(ValueError):
        gc.gf_matmul_packed(packed, torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        gc.gf_matmul_packed(packed, torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        gc.gf_matmul_packed(packed[:30], torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        gc.gf_matmul_packed(packed.numpy(), torch.zeros((4, 8), dtype=torch.int32))


def test_kernel_build_is_named_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    """Libraries are named by a hash of source and flags inside the build
    directory; without nvcc a build raises a clear error (nothing builds at
    import, which this CPU-only run shows by getting here)."""
    assert "gf_matmul" in cuda_build.sources()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    path = cuda_build.library_path("gf_matmul")
    assert os.path.dirname(path) == str(tmp_path / "build")
    assert path == cuda_build.library_path("gf_matmul")
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here: the missing-compiler path is not reachable")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build(["gf_matmul"])
    assert not os.path.exists(tmp_path / "build") or not os.listdir(tmp_path / "build")


def test_gf_kernel_times_needs_a_card(capsys):
    """The kernels' timing tool measures on a card only: without one it
    exits 2 and prints no result."""
    from ceph_tpu_torch.tools import gf_kernel_times

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not reachable")
    assert gf_kernel_times.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA card" in captured.err
