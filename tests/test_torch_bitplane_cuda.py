"""The byte-layout GF(2^8) matmul and the XOR reduction of the port
(ceph_tpu_torch.ops.gf_bitplane.gf_matmul_bitplane / xor_reduce and
ceph_tpu_torch.ops.gf_cuda.xor_reduce_words) against the JAX package's XLA
functions, on the CPU. The CUDA kernels' per-thread procedures
(csrc/gf_matmul.cu's byte entry point: 16 bytes of one batch item per
thread; csrc/xor_rowmatmul.cu's xor_rows_launch: one 16-byte group per
thread, the batch item from the block row, the loads of several rows
issued before the XORs; both with masked byte loads at a ragged end or on
unaligned rows, and strided rows) are emulated in numpy and held against
the plain versions; the kernels
themselves are held against the plain versions on a card by the `gpu` test
at the end, which imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bitplane_cuda.py -q

Tolerance 0 everywhere: the data are integers."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ops import cuda_build, gf
from ceph_tpu_torch.ops import gf_bitplane as bp
from ceph_tpu_torch.ops import gf_cuda as gc

try:  # the reference of the CPU tests; a card host without JAX runs `-m gpu` only
    import jax.numpy as jnp

    from ceph_tpu.ops import gf_bitplane as jbp
    from ceph_tpu.ops import gf_pallas as gp
except ImportError:
    jnp = jbp = gp = None

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "ceph_tpu_torch", "csrc")


def bitmatrix(rng, r, k, gf_derived):
    if gf_derived:
        return gf.matrix_to_bitmatrix(rng.integers(0, 256, (r, k), np.uint8)).astype(np.int8)
    return (rng.random((8 * r, 8 * k)) < 0.5).astype(np.int8)


def matmul(bm, data):
    """gf_matmul_bitplane with bm's kernel tables, as the codecs call it."""
    bm = bm if isinstance(bm, torch.Tensor) else torch.from_numpy(bm)
    tables = torch.from_numpy(gc.kernel_tables(bm.cpu().numpy())).to(data.device)
    return bp.gf_matmul_bitplane(bm, data, tables=tables)


def strided(rng, batch, k, length, pad_rows=2, pad_cols=5):
    """A (batch, k, length) view into a larger buffer: batch and row strides
    differ from a contiguous tensor's, as survivors[:, :k, :] does."""
    base = rng.integers(0, 256, (batch, k + pad_rows, length + pad_cols), np.uint8)
    return torch.from_numpy(base)[:, 1 : 1 + k, 3 : 3 + length]


# -- plain versions against the JAX package ------------------------------------

@pytest.mark.parametrize("batch,k,r,length,gf_derived", [
    (1, 4, 2, 512, True),
    (3, 8, 3, 1000, True),
    (2, 5, 3, 77, False),
    (2, 1, 4, 16, True),
])
def test_plain_matmul_matches_jax(batch, k, r, length, gf_derived):
    rng = np.random.default_rng(batch * 100 + k)
    mat = rng.integers(0, 256, (r, k), np.uint8)
    bm = (gf.matrix_to_bitmatrix(mat).astype(np.int8) if gf_derived
          else bitmatrix(rng, r, k, False))
    data = rng.integers(0, 256, (batch, k, length), np.uint8)
    got = matmul(bm, torch.from_numpy(data))
    want = np.asarray(jbp.gf_matmul_bitplane(jnp.asarray(bm), jnp.asarray(data)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    if gf_derived:
        for b in range(batch):
            assert np.array_equal(want[b], gf.gf_matmul(mat, data[b]))


def test_plain_matmul_steps_over_columns(monkeypatch):
    rng = np.random.default_rng(1)
    bm = torch.from_numpy(bitmatrix(rng, 3, 4, False))
    data = torch.from_numpy(rng.integers(0, 256, (2, 4, 1000), np.uint8))
    whole = matmul(bm, data)
    monkeypatch.setattr(bp, "PLAIN_STEP", 96)
    assert torch.equal(matmul(bm, data), whole)


@pytest.mark.parametrize("batch,k,length", [(1, 4, 512), (3, 1, 33), (2, 7, 1000)])
def test_plain_xor_matches_jax(batch, k, length):
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, (batch, k, length), np.uint8)
    got = bp.xor_reduce(torch.from_numpy(data))
    want = np.asarray(jbp.xor_reduce(jnp.asarray(data)))
    assert np.array_equal(got.numpy(), want)
    words = gc.bytes_to_words(rng.integers(0, 256, (k, 4 * length), np.uint8))
    got = gc.xor_reduce_words(torch.from_numpy(words.copy()))
    assert np.array_equal(got.numpy(), np.asarray(gp.xor_reduce_words(jnp.asarray(words))))


def test_plain_versions_take_strided_views():
    rng = np.random.default_rng(2)
    bm = torch.from_numpy(bitmatrix(rng, 2, 3, True))
    view = strided(rng, 2, 3, 100)
    assert not view.is_contiguous()
    assert torch.equal(matmul(bm, view), matmul(bm, view.contiguous()))
    assert torch.equal(bp.xor_reduce(view), bp.xor_reduce(view.contiguous()))


# -- numpy emulation of the kernels' per-thread procedure ----------------------

def gather_rows(buf, batch, rows, length, sb, sk):
    """The bytes one launch reads: item b, row j at flat offset b*sb + j*sk,
    `length` bytes, zero-padded to whole 16-byte groups as the masked byte
    loads of the ragged end leave them."""
    groups = -(-length // 16)
    out = np.zeros((batch, rows, groups * 16), np.uint8)
    for b in range(batch):
        for j in range(rows):
            start = b * sb + j * sk
            out[b, j, :length] = buf[start : start + length]
    return out


def emulate_bytes_kernel(tables, buf, batch, k, length, sb, sk):
    """csrc/gf_matmul.cu gf_matmul_bytes_kernel: per 16-byte group, four
    words of each input row through the byte-permute lookups
    of the packed kernel, stores masked at `length`."""
    from tests.test_torch_gf_cuda import emulate_kernel

    r = tables.shape[0]
    rows = gather_rows(buf, batch, k, length, sb, sk)
    out = np.zeros((batch, r, length), np.uint8)
    for b in range(batch):
        words = rows[b].view("<u4").view(np.int32)
        out[b] = emulate_kernel(tables, words).view(np.uint8)[:, :length]
    return out


def xor_rows_constants() -> tuple[int, int]:
    """(kRowsThreads, kRowsStep) of csrc/xor_rowmatmul.cu."""
    with open(os.path.join(CSRC, "xor_rowmatmul.cu")) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kRowsThreads", "kRowsStep"))


def emulate_xor_kernel(buf, batch, k, length, sb, sk, aligned=True, constants=None,
                       max_grid_y=65535):
    """launch_xor_rows: csrc/xor_rowmatmul.cu's xor_rows_launch and
    xor_rows_kernel, thread by thread -> (batch, 1, length). Thread i of
    block (x, y) takes the 16-byte group x * threads + i of items y,
    y + grid_y, ...: the loads of `step` rows before their XORs (the vector
    path: whole aligned groups), or masked byte loads row by row (a ragged
    length or unaligned rows). `constants` replaces the source's (threads,
    step) to exercise the tiling at small sizes."""
    threads, step = constants or xor_rows_constants()
    groups = -(-length // 16)
    blocks_x, blocks_y = -(-groups // threads), min(batch, max_grid_y)
    vec = length % 16 == 0 and sb % 16 == 0 and sk % 16 == 0 and aligned
    out = np.zeros((batch, 1, length), np.uint8)
    stores = np.zeros((batch, length), np.int64)

    def load(b, j, c0, nb):
        v = np.zeros(16, np.uint8)
        start = b * sb + j * sk + c0
        v[:nb] = buf[start : start + nb]
        return v

    for bx in range(blocks_x):
        for by in range(blocks_y):
            for tid in range(threads):
                g = bx * threads + tid
                if g >= groups:
                    continue
                c0 = g * 16
                nb = 16 if vec else min(16, length - c0)
                for b in range(by, batch, blocks_y):
                    acc = np.zeros(16, np.uint8)
                    if vec:
                        for j0 in range(0, k, step):
                            v = [load(b, j0 + r, c0, 16) if j0 + r < k
                                 else np.zeros(16, np.uint8) for r in range(step)]
                            for r in range(step):
                                acc ^= v[r]
                    else:
                        for j in range(k):
                            acc ^= load(b, j, c0, nb)
                    out[b, 0, c0 : c0 + nb] = acc[:nb]
                    stores[b, c0 : c0 + nb] += 1
    assert (stores == 1).all()  # every output byte written exactly once
    return out


def flat(view: torch.Tensor):
    """(flat byte buffer, batch stride, row stride) of a strided uint8 view."""
    base = view._base if view._base is not None else view
    buf = base.contiguous().numpy().reshape(-1)
    return buf[view.storage_offset():], view.stride(0), view.stride(1)


def aligned_view(rng, batch, k, length, offset):
    """A strided (batch, k, length) view whose row and batch strides are
    multiples of 16 bytes, starting `offset` bytes into its buffer."""
    row = -(-(length + offset) // 16) * 16 + 16
    base = rng.integers(0, 256, (batch, k + 1, row), np.uint8)
    return torch.from_numpy(base)[:, 1:, offset : offset + length]


@pytest.mark.parametrize("batch,k,r,length,gf_derived,contiguous", [
    (2, 4, 3, 64, True, True),       # whole 16-byte groups (the vector path)
    (3, 4, 2, 37, True, False),      # ragged end, strided rows
    (2, 1, 4, 21, True, False),      # k = 1
    (2, 5, 5, 48, False, False),     # a bit-matrix that is not GF(2^8)'s, 2 row groups
    (1, 3, 1, 5, False, True),       # shorter than one group
])
def test_bytes_kernel_emulation_matches_plain(batch, k, r, length, gf_derived, contiguous):
    rng = np.random.default_rng(length)
    bm = bitmatrix(rng, r, k, gf_derived)
    view = (torch.from_numpy(rng.integers(0, 256, (batch, k, length), np.uint8))
            if contiguous else strided(rng, batch, k, length))
    buf, sb, sk = flat(view)
    got = emulate_bytes_kernel(gc.kernel_tables(bm), buf, batch, k, length, sb, sk)
    assert np.array_equal(got, bp.gf_matmul_bitplane_plain(torch.from_numpy(bm), view).numpy())


@pytest.mark.parametrize("batch,k,length,contiguous", [
    (2, 3, 64, True), (3, 1, 19, False), (2, 6, 100, False), (1, 2, 3, True),
])
def test_xor_kernel_emulation_matches_plain(batch, k, length, contiguous):
    rng = np.random.default_rng(k * 7 + length)
    view = (torch.from_numpy(rng.integers(0, 256, (batch, k, length), np.uint8))
            if contiguous else strided(rng, batch, k, length))
    buf, sb, sk = flat(view)
    got = emulate_xor_kernel(buf, batch, k, length, sb, sk)
    assert np.array_equal(got, bp.xor_reduce_plain(view).numpy())


@pytest.mark.parametrize("batch,k,length,layout,max_grid_y", [
    (3, 5, 16 * 37, "contiguous", 65535),  # whole groups, several blocks and row steps
    (5, 3, 16 * 9, "contiguous", 2),       # more items than grid rows: the batch loop
    (2, 4, 16 * 21, "aligned", 65535),     # strided rows on 16-byte strides: vector path
    (2, 2, 16 * 21, "offset", 65535),      # strided rows, unaligned start: masked path
    (3, 6, 16 * 11 + 7, "contiguous", 2),  # ragged end: masked path
    (2, 1, 200, "strided", 65535),         # k = 1, strided rows
])
def test_xor_rows_tiling_emulation_matches_plain(batch, k, length, layout, max_grid_y):
    """The XOR-of-rows kernel's tiling at small block sizes (4 threads, 2
    rows a step): every block, group, row step and batch item lands once,
    and the result is the plain version's."""
    rng = np.random.default_rng(batch * 31 + k * 7 + length)
    if layout == "contiguous":
        view = torch.from_numpy(rng.integers(0, 256, (batch, k, length), np.uint8))
    elif layout in ("aligned", "offset"):
        view = aligned_view(rng, batch, k, length, 0 if layout == "aligned" else 4)
    else:
        view = strided(rng, batch, k, length)
    buf, sb, sk = flat(view)
    got = emulate_xor_kernel(buf, batch, k, length, sb, sk,
                             aligned=view.storage_offset() % 16 == 0,
                             constants=(4, 2), max_grid_y=max_grid_y)
    assert np.array_equal(got, bp.xor_reduce_plain(view).numpy())


@pytest.mark.parametrize("k,n4", [(2, 4 * 64), (3, 4 * 64 + 37)])
def test_xor_rows_emulation_of_words_matches_plain(k, n4):
    """xor_reduce_words' (1, k, 4 N4) byte view through the kernel's
    procedure at small block sizes equals xor_reduce_words_plain."""
    rng = np.random.default_rng(k * n4)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (k, n4), dtype=np.int64)
                             .astype(np.int32))
    as_bytes = words.view(torch.uint8)[None]
    buf, sb, sk = flat(as_bytes)
    got = emulate_xor_kernel(buf, 1, k, 4 * n4, sb, sk, constants=(4, 2))
    assert np.array_equal(got[0].view(np.int32), gc.xor_reduce_words_plain(words).numpy())


def test_words_are_the_xor_kernels_bytes():
    """xor_reduce_words hands the kernel a (1, k, 4 N4) byte view of the
    words; the XOR of that view is the XOR of the words."""
    rng = np.random.default_rng(3)
    words = torch.from_numpy(gc.bytes_to_words(rng.integers(0, 256, (5, 84), np.uint8)).copy())
    as_bytes = words.view(torch.uint8)[None]
    assert as_bytes.shape == (1, 5, 84) and as_bytes.stride() == (420, 84, 1)
    buf, sb, sk = flat(as_bytes)
    got = emulate_xor_kernel(buf, 1, 5, 84, sb, sk)
    assert np.array_equal(got[0].view(np.int32), gc.xor_reduce_words(words).numpy())


# -- bindings and refusals -----------------------------------------------------

def launch_params(source: str, name: str) -> list[str]:
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    launch = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    return [p.strip() for p in launch.group(1).split(",") if p.strip()]


class _FakeFn:
    argtypes = None


@pytest.mark.parametrize("source,name,loader", [
    ("gf_matmul.cu", "gf_matmul_bytes_launch", gc._lib),
    ("gf_matmul.cu", "gf_matmul_packed_launch", gc._lib),
    ("gf_matmul.cu", "gf_matmul_plan", gc._lib),
    ("xor_rowmatmul.cu", "xor_rowmatmul_launch", gc._xor_lib),
    ("xor_rowmatmul.cu", "xor_rows_launch", gc._xor_lib),
])
def test_kernel_source_and_binding_agree(monkeypatch, source, name, loader):
    """The ctypes argument types match the extern "C" signature: one
    c_void_p per pointer, c_int per int, c_long per long."""
    params = launch_params(source, name)

    class FakeLib:
        def __getattr__(self, attr):
            fn = _FakeFn()
            setattr(self, attr, fn)
            return fn

    monkeypatch.setattr(cuda_build, "load", lambda n: FakeLib())
    argtypes = getattr(loader(), name).argtypes
    want = [ctypes.c_void_p if "*" in p else ctypes.c_long if p.startswith("long")
            else ctypes.c_int for p in params]
    assert argtypes == want


def test_wrappers_refuse_what_the_kernels_do_not_take():
    bm = torch.from_numpy(bitmatrix(np.random.default_rng(4), 2, 4, True))
    tables = torch.from_numpy(gc.kernel_tables(bm.numpy()))
    for data, error, match in [
        (torch.zeros((1, 4, 8), dtype=torch.int32), TypeError, None),
        (torch.zeros((4, 8), dtype=torch.uint8), TypeError, None),
        (torch.zeros((1, 3, 8), dtype=torch.uint8), ValueError, "does not take"),
        (torch.zeros((1, 4, 8), dtype=torch.uint8, device="meta"), ValueError,
         "unsupported device"),
    ]:
        with pytest.raises(error, match=match):
            bp.gf_matmul_bitplane(bm, data, tables=tables)
    with pytest.raises(TypeError):
        bp.gf_matmul_bitplane(bm.numpy(), torch.zeros((1, 4, 8), dtype=torch.uint8),
                              tables=tables)
    with pytest.raises(TypeError):
        bp.xor_reduce(torch.zeros((1, 0, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        bp.xor_reduce(torch.zeros((1, 2, 8), dtype=torch.int16))
    with pytest.raises(ValueError, match="unsupported device"):
        bp.xor_reduce(torch.zeros((1, 2, 8), dtype=torch.uint8, device="meta"))
    with pytest.raises(TypeError):
        gc.xor_reduce_words(torch.zeros((2, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="unsupported device"):
        gc.xor_reduce_words(torch.zeros((2, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        gc.row_strides(torch.zeros((1, 2, 8), dtype=torch.uint8)[:, :, ::2], "x")
    rows = torch.zeros((1, 2, 8), dtype=torch.uint8)
    for lists in (torch.tensor([0, 2], dtype=torch.int32),             # too short
                  torch.tensor([0, 2, 0, 1], dtype=torch.int64),       # not int32
                  torch.zeros(gc.MAX_LIST_WORDS + 1, dtype=torch.int32)):  # too long
        with pytest.raises(ValueError, match="lists must be"):
            gc.launch_row_lists(lists, 2, rows, "x")


def test_cpu_wrappers_count_no_launch():
    rng = np.random.default_rng(5)
    bm = torch.from_numpy(bitmatrix(rng, 2, 3, True))
    data = torch.from_numpy(rng.integers(0, 256, (2, 3, 40), np.uint8))
    before = (bp.gf_matmul_bitplane.launches, bp.xor_reduce.launches,
              gc.xor_reduce_words.launches)
    matmul(bm, data)
    bp.xor_reduce(data)
    gc.xor_reduce_words(data[0].contiguous().view(torch.int32)[:, :10].contiguous())
    assert (bp.gf_matmul_bitplane.launches, bp.xor_reduce.launches,
            gc.xor_reduce_words.launches) == before


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card():
    """The byte matmul and XOR kernels against their plain versions on the
    card: a GF and a non-GF matrix, ragged and aligned widths, k = 1,
    strided survivors, and the planar words of the m=1 path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    rng = np.random.default_rng(11)
    gen = torch.Generator(device="cuda").manual_seed(11)
    before = (bp.gf_matmul_bitplane.launches, bp.xor_reduce.launches,
              gc.xor_reduce_words.launches)
    cases = [(4, 4, 3, 1 << 16, True), (3, 5, 2, 1000, False), (2, 1, 4, 77, True)]
    for batch, k, r, length, gf_derived in cases:
        bm = torch.from_numpy(bitmatrix(rng, r, k, gf_derived)).cuda()
        data = torch.randint(0, 256, (batch, k + 2, length), dtype=torch.uint8,
                             device="cuda", generator=gen)
        view = data[:, 1 : 1 + k]
        got = matmul(bm, view)
        assert torch.equal(got, bp.gf_matmul_bitplane_plain(bm, view))
        got = bp.xor_reduce(view)
        assert torch.equal(got, bp.xor_reduce_plain(view))
    words = torch.randint(0, 256, (3, 4 * ((1 << 16) + 3)), dtype=torch.uint8,
                          device="cuda", generator=gen).view(torch.int32)
    assert torch.equal(gc.xor_reduce_words(words), gc.xor_reduce_words_plain(words))
    torch.cuda.synchronize()
    assert (bp.gf_matmul_bitplane.launches, bp.xor_reduce.launches,
            gc.xor_reduce_words.launches) == (before[0] + 3, before[1] + 3, before[2] + 1)
