"""Packed-word GF(2^8) matmul: the CUDA kernel and its plain torch version.

Port of ceph_tpu/ops/gf_pallas.py, with the same contract:

  * data lives as (k, N/4) int32 words, a free reinterpret of the (k, N) uint8
    chunk-planar layout (chunk j is row j), four bytes to a word;
  * the coding matrix is an (8r, 8k) {0,1} bit-matrix (any GF(2^8) matrix
    expands to one via ceph_tpu_torch.ops.gf.matrix_to_bitmatrix), carried
    as the (32r, 32k) packed-lane matrix of `pack_matrix`;
  * `gf_matmul_packed(packed_mat, words)` -> (r, N/4) int32 words.

For a CUDA tensor the wrapper launches the hand-written kernel in
csrc/gf_matmul.cu, which works from split-nibble tables (`nibble_tables`)
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
    "nibble_tables",
    "bytes_to_words",
    "words_to_bytes",
    "gf_matmul_packed",
    "gf_matmul_packed_plain",
    "xor_reduce_words",
    "xor_reduce_words_plain",
    "launch_row_lists",
    "launch_xor_rows",
]

#: the kernel stages r*k*32 table bytes in (non-opt-in) shared memory
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


def nibble_tables(bitmat: np.ndarray) -> np.ndarray:
    """(8r, 8k) {0,1} bit-matrix -> (r, k, 32) uint8 split-nibble tables.

    Block (i, j) maps an input byte x to the output byte
    T_lo[x & 15] ^ T_hi[x >> 4]; entries [0:16] are T_lo, [16:32] T_hi.
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
    x = np.arange(16)
    tables = np.zeros((r, k, 32), dtype=np.int64)
    for b in range(4):
        has = ((x >> b) & 1)[None, None, :]
        tables[..., :16] ^= has * image[..., b : b + 1]
        tables[..., 16:] ^= has * image[..., 4 + b : 5 + b]
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


def _check_shapes(packed_mat: torch.Tensor, words: torch.Tensor) -> tuple[int, int]:
    if not isinstance(packed_mat, torch.Tensor) or not isinstance(words, torch.Tensor):
        raise TypeError("gf_matmul_packed takes torch tensors")
    if packed_mat.dim() != 2 or packed_mat.shape[0] % 32 or packed_mat.shape[1] % 32:
        raise ValueError(f"packed matrix shape {tuple(packed_mat.shape)} must be (32r, 32k)")
    r, k = packed_mat.shape[0] // 32, packed_mat.shape[1] // 32
    if words.dim() != 2 or words.dtype != torch.int32:
        raise TypeError(f"words must be (k, N4) int32, got {tuple(words.shape)} {words.dtype}")
    if words.shape[0] != k:
        raise ValueError(f"words rows {words.shape[0]} != matrix k {k}")
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
        out[:, c : c + n] = o.permute(0, 2, 1).contiguous().view(torch.int32).reshape(r, n)
    return out


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("gf_matmul")
    fn = lib.gf_matmul_packed_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.gf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gf_cuda_error_string.restype = ctypes.c_char_p
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.gf_matmul_bytes_launch.argtypes = [p, p, p, i, i, ll, ll, ll, ll, p]
        lib.gf_matmul_bytes_launch.restype = ctypes.c_int
    return lib


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
    """Launches `xor_rows_launch` on data's device and its current stream.
    The host path is kept short, since at the m=1 shapes it is a fair part
    of a call: the raw stream handle, and a device switch only when data
    lies on another device than the current one."""
    idx = data.get_device()
    if idx != torch.cuda.current_device():
        with torch.cuda.device(idx):
            return _xor_rows(data, out, k, batch, length, in_sb, in_sc, what)
    lib = _xor_lib()
    err = lib.xor_rows_launch(data.data_ptr(), out.data_ptr(), k, batch, length, in_sb, in_sc,
                              torch._C._cuda_getCurrentRawStream(idx))
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
    memo = getattr(packed_mat, "_gf_nibble_tables", None)
    if memo is None or memo[0] != packed_mat._version or memo[1].device != device:
        bitmat = unpack_matrix(packed_mat.cpu().numpy())
        memo = (packed_mat._version, torch.from_numpy(nibble_tables(bitmat)).to(device))
        packed_mat._gf_nibble_tables = memo
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
    when the caller has them cached (else they are derived from packed_mat
    once and memoised on it), and raises on anything the kernel does not
    take. Each launch adds one to
    `gf_matmul_packed.launches`.
    """
    r, k = _check_shapes(packed_mat, words)
    if words.device.type == "cpu":
        return gf_matmul_packed_plain(packed_mat, words)
    if words.device.type != "cuda":
        raise ValueError(f"gf_matmul_packed: unsupported device {words.device}")
    if not words.is_contiguous():
        raise ValueError("gf_matmul_packed: words must be contiguous")
    if r * k * 32 > MAX_TABLE_BYTES:
        raise ValueError(
            f"gf_matmul_packed: r*k*32 = {r * k * 32} table bytes exceed the "
            f"kernel's {MAX_TABLE_BYTES} bytes of shared memory"
        )
    if tables is None:
        tables = _tables_for(packed_mat, words.device)
    if (tables.dtype != torch.uint8 or tuple(tables.shape) != (r, k, 32)
            or tables.device != words.device or not tables.is_contiguous()):
        raise ValueError(
            f"tables must be contiguous ({r}, {k}, 32) uint8 on {words.device}, "
            f"got {tuple(tables.shape)} {tables.dtype} on {tables.device}"
        )
    n4 = words.shape[1]
    out = torch.empty((r, n4), dtype=torch.int32, device=words.device)
    if n4 == 0:
        return out
    lib = _lib()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.gf_matmul_packed_launch(
            tables.data_ptr(), words.data_ptr(), out.data_ptr(), k, r, n4, stream
        )
    if err != 0:
        msg = lib.gf_cuda_error_string(err).decode()
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
