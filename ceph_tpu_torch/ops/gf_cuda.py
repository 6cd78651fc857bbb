"""Packed-word GF(2^8) matmul: the CUDA kernel and its plain torch version.

Port of ceph_tpu/ops/gf_pallas.py, with the same contract:

  * data lives as (k, N/4) int32 words, a free reinterpret of the (k, N) uint8
    chunk-planar layout (chunk j is row j), four bytes to a word;
  * the coding matrix is an (8r, 8k) {0,1} bit-matrix (any GF(2^8) matrix
    expands to one via ceph_tpu_torch.ops.gf.matrix_to_bitmatrix), carried
    as the (32r, 32k) packed-lane matrix of `pack_matrix`;
  * `gf_matmul_packed(packed_mat, words)` -> (r, N/4) int32 words.

For a CUDA tensor the wrapper launches the hand-written kernel in
csrc/gf_matmul.cu, which works from byte-permute tables (`kernel_tables`)
derived once per matrix. For a CPU tensor it runs `gf_matmul_packed_plain`,
a direct transcription of the Pallas kernel's arithmetic. Nothing else
selects between them, and nothing falls back.

`xor_reduce_words` (the m=1 planar parity) is built the same way over
csrc/xor_rowmatmul.cu, the XOR kernels: `launch_row_lists` binds its
row-list kernel for `ec.bitmatrix.xor_rowmatmul`; its XOR-of-rows kernel
(`xor_rows_launch`) serves `xor_reduce_words` and, through
`launch_xor_rows`, `gf_bitplane.xor_reduce`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build

__all__ = [
    "available",
    "pack_matrix",
    "unpack_matrix",
    "kernel_tables",
    "bytes_to_words",
    "words_to_bytes",
    "gf_matmul_packed",
    "gf_matmul_packed_plain",
    "device_tables",
    "tables_to",
    "xor_reduce_words",
    "xor_reduce_words_plain",
    "launch_row_lists",
    "launch_xor_rows",
]

#: r*k*32 table bytes the kernel takes (csrc/gf_matmul.cu kMaxTableBytes)
MAX_TABLE_BYTES = 48 * 1024

#: the row-list kernel stages R + 1 row offsets and the selected rows, int32,
#: in shared memory: at most the 227 KB a block can have
#: (csrc/xor_rowmatmul.cu kMaxListWords)
MAX_LIST_WORDS = 232448 // 4

#: columns per step of the plain version: bounds its float32 bit-plane temporaries
PLAIN_STEP_WORDS = 1 << 20


def available() -> bool:
    """True when a CUDA device is present. Informational only: it never picks
    the CPU; the device of the tensors does."""
    return torch.cuda.is_available()


def pack_matrix(bitmat: np.ndarray) -> np.ndarray:
    """(8r, 8k) {0,1} bit-matrix -> (32r, 32k) packed-lane matrix.

    Row/column order is (bit, item, byte-in-word): index b*4n + 4i + s. The
    identity over s expresses that byte s of an output word only ever depends
    on byte s of the input words.
    """
    r8, k8 = bitmat.shape
    if r8 % 8 or k8 % 8:
        raise ValueError(f"bit-matrix shape {bitmat.shape} must be 8-aligned")
    r, k = r8 // 8, k8 // 8
    bm4 = np.asarray(bitmat, dtype=np.int8).reshape(r, 8, k, 8)
    eye4 = np.eye(4, dtype=np.int8)
    big = (
        bm4.transpose(1, 0, 3, 2)[:, :, None, :, :, None]
        * eye4[None, None, :, None, None, :]
    )  # (bo, i, s, bi, j, s')
    return np.ascontiguousarray(big.reshape(32 * r, 32 * k))


def unpack_matrix(packed: np.ndarray) -> np.ndarray:
    """(32r, 32k) packed-lane matrix -> (8r, 8k) bit-matrix. Inverse of
    pack_matrix; raises if `packed` is not of pack_matrix's form."""
    packed = np.asarray(packed, dtype=np.int8)
    r32, k32 = packed.shape
    if r32 % 32 or k32 % 32:
        raise ValueError(f"packed matrix shape {packed.shape} must be 32-aligned")
    r, k = r32 // 32, k32 // 32
    # entry [bo*4r + 4i + s, bi*4k + 4j + s] for s = 0, as (bo, i, bi, j)
    diag = packed.reshape(8, r, 4, 8, k, 4)[:, :, 0, :, :, 0]
    bitmat = np.ascontiguousarray(diag.transpose(1, 0, 3, 2).reshape(8 * r, 8 * k))
    if not np.array_equal(pack_matrix(bitmat), packed):
        raise ValueError("matrix is not a pack_matrix() expansion of a bit-matrix")
    return bitmat


#: the kernel's split of an input byte x into fields, each looked up in its
#: own table of block (i, j): (first byte of the table, first bit, bits)
TABLE_FIELDS = ((0, 0, 3), (8, 3, 3), (16, 6, 2))


def kernel_tables(bitmat: np.ndarray) -> np.ndarray:
    """(8r, 8k) {0,1} bit-matrix -> (r, k, 32) uint8 tables of the kernel.

    Block (i, j) is a GF(2)-linear map f on a byte, so f(x) is the XOR of
    its values on x's fields: bits 0-2, 3-5 and 6-7. Bytes [0:8] hold
    f(x) for x < 8, [8:16] f(x << 3), [16:20] f(x << 6); the rest is zero.
    A byte permute looks up one 8-entry (or 4-entry) table at four bytes at
    once, so f(x) = T[x & 7] ^ T[8 + ((x >> 3) & 7)] ^ T[16 + (x >> 6)].
    """
    bm = np.asarray(bitmat)
    if bm.ndim != 2 or bm.shape[0] % 8 or bm.shape[1] % 8:
        raise ValueError(f"bit-matrix shape {bm.shape} must be 8-aligned")
    if not np.isin(bm, (0, 1)).all():
        raise ValueError("bit-matrix entries must be 0 or 1")
    r, k = bm.shape[0] // 8, bm.shape[1] // 8
    blocks = bm.astype(np.int64).reshape(r, 8, k, 8)  # (i, bo, j, bi)
    weights = (1 << np.arange(8)).reshape(1, 8, 1, 1)
    image = (blocks * weights).sum(axis=1)  # (i, j, bi): output byte of bit bi
    tables = np.zeros((r, k, 32), dtype=np.int64)
    for start, first, width in TABLE_FIELDS:
        x = np.arange(1 << width)
        for b in range(width):
            has = ((x >> b) & 1)[None, None, :]
            tables[..., start:start + len(x)] ^= has * image[..., first + b : first + b + 1]
    return tables.astype(np.uint8)


def bytes_to_words(chunks: np.ndarray) -> np.ndarray:
    """(k, N) uint8 -> (k, N/4) int32, little-endian (free host-side view)."""
    chunks = np.ascontiguousarray(chunks, dtype=np.uint8)
    if chunks.shape[-1] % 4:
        raise ValueError("chunk length must be a multiple of 4 bytes")
    return chunks.view("<i4")


def words_to_bytes(words: np.ndarray) -> np.ndarray:
    """(k, N/4) int32 -> (k, N) uint8. Inverse of bytes_to_words."""
    return np.ascontiguousarray(words, dtype="<i4").view(np.uint8)


def _is_tensor(x) -> bool:
    """isinstance(x, torch.Tensor), with the exact type tried first (the
    isinstance check goes through torch's metaclass, slow on a busy host)."""
    return type(x) is torch.Tensor or isinstance(x, torch.Tensor)


def _check_shapes(packed_mat: torch.Tensor, words: torch.Tensor) -> tuple[int, int]:
    # each .shape read costs a fraction of a microsecond: at one object's
    # width the checks are a fair part of a call, so each is read once
    if not (_is_tensor(packed_mat) and _is_tensor(words)):
        raise TypeError("gf_matmul_packed takes torch tensors")
    pshape, wshape = packed_mat.shape, words.shape
    if len(pshape) != 2 or pshape[0] % 32 or pshape[1] % 32:
        raise ValueError(f"packed matrix shape {tuple(pshape)} must be (32r, 32k)")
    r, k = pshape[0] // 32, pshape[1] // 32
    if len(wshape) != 2 or words.dtype != torch.int32:
        raise TypeError(f"words must be (k, N4) int32, got {tuple(wshape)} {words.dtype}")
    if wshape[0] != k:
        raise ValueError(f"words rows {wshape[0]} != matrix k {k}")
    return r, k


def gf_matmul_packed_plain(packed_mat: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """(32r, 32k) packed matrix x (k, N4) int32 words -> (r, N4) int32 words,
    in torch ops on the tensors' device.

    The Pallas kernel's arithmetic, step by step: bit-plane b of the four
    packed bytes is (w >> b) & 0x01010101, split into four byte rows (row
    b*4k + 4j + s); one contraction against the packed matrix; the parity bit
    (& 1); and eight shift-or steps that repack the bits into bytes. Shifts of
    the words run on int64 and the repack on uint8, so no sign bit of the
    int32 view can enter. The contraction runs in float32, exact because the
    entries are {0,1} and every sum is at most 32k < 2^24.
    """
    r, k = _check_shapes(packed_mat, words)
    n4 = words.shape[1]
    mat = packed_mat.to(device=words.device, dtype=torch.float32)
    out = torch.empty((r, n4), dtype=torch.int32, device=words.device)
    for c in range(0, n4, PLAIN_STEP_WORDS):
        w = words[:, c : c + PLAIN_STEP_WORDS].to(torch.int64) & 0xFFFFFFFF
        n = w.shape[1]
        planes = torch.stack([(w >> b) & 0x01010101 for b in range(8)])  # (8, k, n)
        bits = (
            planes.to(torch.int32).view(torch.uint8)  # (8, k, 4n): byte s of word c at 4c+s
            .reshape(8, k, n, 4).permute(0, 1, 3, 2).reshape(32 * k, n)
        )
        acc = mat @ bits.to(torch.float32)  # (32r, n), rows bo*4r + 4i + s
        par = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(8, r, 4, n)
        o = par[0].clone()
        for b in range(1, 8):
            o |= par[b] << b
        # (r, 4n) bytes, then words: a one-word step's (r, 1, 4) permute is
        # "contiguous" with a byte stride on its size-1 axis, which view refuses
        out[:, c : c + n] = o.permute(0, 2, 1).reshape(r, 4 * n).contiguous().view(torch.int32)
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gf_matmul")
    fn = lib.gf_matmul_packed_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [p, p, p, p, i, i, ll, p]
        fn.restype = ctypes.c_int
        lib.gf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gf_cuda_error_string.restype = ctypes.c_char_p
        lib.gf_matmul_bytes_launch.argtypes = [p, p, p, p, i, i, ll, ll, ll, ll, p]
        lib.gf_matmul_bytes_launch.restype = ctypes.c_int
        lib.gf_matmul_plan.argtypes = [ll, p, p]
        lib.gf_matmul_plan.restype = ctypes.c_int
    return lib


def device_tables(host: np.ndarray, device) -> torch.Tensor:
    """(r, k, 32) uint8 kernel tables on `device`, with their host bytes kept
    beside them, so that the kernel's launches never read them back."""
    host = np.ascontiguousarray(host, dtype=np.uint8)
    out = torch.from_numpy(host).to(device)
    if out.device.type == "cuda":
        out._gf_host = (out._version, host)
    return out


def tables_to(tables: torch.Tensor, device) -> torch.Tensor:
    """`tables` on `device` (itself when it is there already), the host
    bytes kept beside a copy as `device_tables` keeps them."""
    out = tables.to(device)
    host = getattr(tables, "_gf_host", None)
    if out is not tables and host is not None and host[0] == tables._version:
        out._gf_host = (out._version, host[1])
    return out


def _checked_tables(tables, what: str) -> tuple:
    """(version, r, k, device index, host address, host bytes) of a CUDA
    tables tensor, after the checks the launcher relies on. The host bytes
    are those `device_tables` kept, else one read of the tensor."""
    if (not isinstance(tables, torch.Tensor) or tables.dtype != torch.uint8
            or tables.dim() != 3 or tables.shape[2] != 32 or not tables.is_cuda
            or not tables.is_contiguous() or tables.data_ptr() % 16):
        raise ValueError(
            f"{what}: tables must be contiguous 16-byte-aligned (r, k, 32) uint8 on "
            f"a CUDA device, got {getattr(tables, 'shape', None)} "
            f"{getattr(tables, 'dtype', None)} on {getattr(tables, 'device', None)}")
    version = tables._version
    host = getattr(tables, "_gf_host", None)
    host = host[1] if host is not None and host[0] == version else tables.cpu().numpy()
    r, k, _ = tables.shape
    return (version, r, k, tables.get_device(), host.ctypes.data, host)


def launch_tables(tables, r: int, k: int, device: int, what: str) -> int:
    """Host address of the bytes of `tables`, the (r, k, 32) kernel tables on
    CUDA device `device`, for the launcher's parameter route. The checks run
    once per tensor (and again after an in-place change); a call after that
    compares four integers."""
    memo = getattr(tables, "_gf_launch", None)
    if memo is None or memo[0] != tables._version:
        memo = _checked_tables(tables, what)
        tables._gf_launch = memo
    if memo[1] != r or memo[2] != k or memo[3] != device:
        raise ValueError(
            f"{what}: tables must be ({r}, {k}, 32) on cuda:{device}, got "
            f"({memo[1]}, {memo[2]}, 32) on cuda:{memo[3]}")
    return memo[4]


def launch_plan(work: int) -> tuple[int, int]:
    """(threads per block, blocks) the kernel's launcher picks on the current
    CUDA device for `work` 16-byte groups (csrc/gf_matmul.cu plan_for)."""
    threads, blocks = ctypes.c_int(), ctypes.c_long()
    err = _lib().gf_matmul_plan(work, ctypes.addressof(threads), ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"gf_matmul_plan failed: CUDA error {err}")
    return threads.value, blocks.value


def on_device(device: int, fn, *args, stream: torch.cuda.Stream | None = None) -> int:
    """fn(*args, stream handle): a launcher called with the raw handle of
    `stream` (default: CUDA device `device`'s current stream), `device` made
    current first only when it is not already (the host path of a launch at
    one object's width is a fair part of its call)."""
    if device != torch._C._cuda_getDevice():
        with torch.cuda.device(device):
            return on_device(device, fn, *args, stream=stream)
    handle = torch._C._cuda_getCurrentRawStream(device) if stream is None else stream.cuda_stream
    return fn(*args, handle)


def _xor_lib() -> ctypes.CDLL:
    lib = cuda_build.load("xor_rowmatmul")
    fn = lib.xor_rowmatmul_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        fn.argtypes = [p, i, i, p, p, ll, ll, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.xor_rows_launch.argtypes = [p, p, i, ll, ll, ll, ll, p]
        lib.xor_rows_launch.restype = ctypes.c_int
        lib.xor_rowmatmul_error_string.argtypes = [ctypes.c_int]
        lib.xor_rowmatmul_error_string.restype = ctypes.c_char_p
    return lib


def row_strides(data: torch.Tensor, what: str) -> tuple[int, int]:
    """(batch, row) strides in bytes of a (B, n, L) uint8 CUDA tensor whose
    last axis is contiguous: the kernels read strided slices such as
    `survivors[:, :k, :]` in place, without a copy. Raises otherwise."""
    if data.shape[-1] > 1 and data.stride(-1) != 1:
        raise ValueError(f"{what}: the last axis must be contiguous, got strides "
                         f"{data.stride()}")
    return data.stride(0), data.stride(1)


def launch_row_lists(lists: torch.Tensor, rows_out: int, data: torch.Tensor,
                     what: str) -> torch.Tensor:
    """(B, C, L) uint8 CUDA tensor (last axis contiguous, any batch and row
    strides) -> (B, rows_out, L) uint8 by csrc/xor_rowmatmul.cu on the
    current stream: output row i is the XOR of the input rows that `lists`
    (int32 on the same device: rows_out + 1 offsets, then the selected
    rows) gives it. Counts nothing: each wrapper counts its own."""
    if (lists.dtype != torch.int32 or lists.dim() != 1 or lists.numel() < rows_out + 1
            or lists.numel() > MAX_LIST_WORDS or lists.device != data.device
            or not lists.is_contiguous()):
        raise ValueError(
            f"{what}: lists must be contiguous int32 on {data.device} with "
            f"{rows_out + 1} to {MAX_LIST_WORDS} words, got {tuple(lists.shape)} "
            f"{lists.dtype} on {lists.device}"
        )
    in_sb, in_sc = row_strides(data, what)
    batch, _, length = data.shape
    out = torch.empty((batch, rows_out, length), dtype=torch.uint8, device=data.device)
    if batch == 0 or length == 0:
        return out
    lib = _xor_lib()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.xor_rowmatmul_launch(
            lists.data_ptr(), rows_out, lists.numel(), data.data_ptr(), out.data_ptr(),
            batch, length, in_sb, in_sc, stream)
    if err != 0:
        msg = lib.xor_rowmatmul_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
    return out


def _xor_rows(data: torch.Tensor, out: torch.Tensor, k: int, batch: int, length: int,
              in_sb: int, in_sc: int, what: str) -> None:
    """Launches `xor_rows_launch` on data's device and its current stream
    (`on_device`: at the m=1 shapes the host path is a fair part of a call)."""
    lib = _xor_lib()
    err = on_device(data.get_device(), lib.xor_rows_launch, data.data_ptr(), out.data_ptr(),
                    k, batch, length, in_sb, in_sc)
    if err != 0:
        msg = lib.xor_rowmatmul_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def launch_xor_rows(data: torch.Tensor, what: str) -> torch.Tensor:
    """(B, k, L) uint8 CUDA tensor (last axis contiguous, any batch and row
    strides) -> (B, 1, L) uint8, the XOR of the k rows, by
    csrc/xor_rowmatmul.cu's `xor_rows_launch` on the current stream. Counts
    nothing: each wrapper counts its own."""
    in_sb, in_sc = row_strides(data, what)
    batch, k, length = data.shape
    out = torch.empty((batch, 1, length), dtype=torch.uint8, device=data.device)
    if batch and length:
        _xor_rows(data, out, k, batch, length, in_sb, in_sc, what)
    return out


def _tables_for(packed_mat: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The kernel's tables for `packed_mat` on `device`: derived on first use
    (one read of the matrix back to the host) and memoised on the tensor
    until it is modified in place."""
    memo = getattr(packed_mat, "_gf_kernel_tables", None)
    if memo is None or memo[0] != packed_mat._version or memo[1].device != device:
        bitmat = unpack_matrix(packed_mat.cpu().numpy())
        memo = (packed_mat._version, device_tables(kernel_tables(bitmat), device))
        packed_mat._gf_kernel_tables = memo
    return memo[1]


def gf_matmul_packed(
    packed_mat: torch.Tensor,
    words: torch.Tensor,
    *,
    tables: torch.Tensor | None = None,
) -> torch.Tensor:
    """(32r, 32k) packed matrix x (k, N4) int32 words -> (r, N4) int32 words.

    A CPU `words` runs the plain version. A CUDA `words` launches the kernel
    on the current stream, with `tables` (r, k, 32) uint8 on the same device
    when the caller has them cached (the codecs' `CodingTables.tables_t`,
    made by `device_tables`; else they are derived from packed_mat once and
    memoised on it), and raises on anything the kernel does not take. Each
    launch adds one to `gf_matmul_packed.launches`.
    """
    r, k = _check_shapes(packed_mat, words)
    if not words.is_cuda:
        if words.device.type == "cpu":
            return gf_matmul_packed_plain(packed_mat, words)
        raise ValueError(f"gf_matmul_packed: unsupported device {words.device}")
    if not words.is_contiguous():
        raise ValueError("gf_matmul_packed: words must be contiguous")
    if r * k * 32 > MAX_TABLE_BYTES:
        raise ValueError(
            f"gf_matmul_packed: r*k*32 = {r * k * 32} table bytes exceed the "
            f"kernel's {MAX_TABLE_BYTES}"
        )
    if tables is None:
        tables = _tables_for(packed_mat, words.device)
    device = words.get_device()
    host = launch_tables(tables, r, k, device, "gf_matmul_packed")
    n4 = words.shape[1]
    out = words.new_empty((r, n4))
    if n4 == 0:
        return out
    err = on_device(device, _lib().gf_matmul_packed_launch, tables.data_ptr(), host,
                    words.data_ptr(), out.data_ptr(), k, r, n4)
    if err != 0:
        msg = _lib().gf_cuda_error_string(err).decode()
        raise RuntimeError(f"gf_matmul_packed launch failed: CUDA error {err} ({msg})")
    gf_matmul_packed.launches += 1
    return out


#: kernel launches made by the wrapper (the plain version counts none)
gf_matmul_packed.launches = 0


def xor_reduce_words_plain(words: torch.Tensor) -> torch.Tensor:
    """(k, N4) int32 -> (1, N4): the XOR of the rows, in torch ops."""
    out = words[0].clone()
    for j in range(1, words.shape[0]):
        out ^= words[j]
    return out[None, :]


def xor_reduce_words(words: torch.Tensor) -> torch.Tensor:
    """m=1 fast path on packed words: (k, N4) int32 -> (1, N4) XOR.

    Mirrors the reference ISA plugin's m==1 region-XOR short-circuit
    (ErasureCodeIsa.cc:121-128, xor_op.cc) — XOR commutes with the packing.
    A CPU tensor runs the plain version. A CUDA tensor (contiguous) launches
    csrc/xor_rowmatmul.cu's XOR-of-rows kernel on its bytes, read as a
    (1, k, 4 N4) uint8 block, and adds one to `xor_reduce_words.launches`.
    """
    if not isinstance(words, torch.Tensor):
        raise TypeError("xor_reduce_words takes a torch tensor")
    if words.dim() != 2 or words.dtype != torch.int32 or words.shape[0] < 1:
        raise TypeError(f"words must be (k, N4) int32 with k >= 1, got "
                        f"{tuple(words.shape)} {words.dtype}")
    if words.device.type == "cpu":
        return xor_reduce_words_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"xor_reduce_words: unsupported device {words.device}")
    if not words.is_contiguous():
        raise ValueError("xor_reduce_words: words must be contiguous")
    k, n4 = words.shape
    out = torch.empty((1, n4), dtype=torch.int32, device=words.device)
    if n4:
        # the words' bytes as one (1, k, 4 N4) block, without a view
        _xor_rows(words, out, k, 1, 4 * n4, 4 * n4 * k, 4 * n4, "xor_reduce_words")
        xor_reduce_words.launches += 1
    return out


#: kernel launches made by the wrapper (the plain version counts none)
xor_reduce_words.launches = 0
