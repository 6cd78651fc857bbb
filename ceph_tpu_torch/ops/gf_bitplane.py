"""Batched GF(2^8) matmul and XOR reduction on (B, k, L) bytes — the
byte-API path of the codecs.

Port of ceph_tpu/ops/gf_bitplane.py (XLA device code). Two functions, each a
wrapper over a hand-written CUDA kernel with a plain torch version beside it:

  * `gf_matmul_bitplane(bitmat, data, tables=...)`: (8r, 8k) {0,1}
    bit-matrix x (B, k, L) uint8 -> (B, r, L). A CUDA tensor launches
    csrc/gf_matmul.cu's byte entry point, which looks bytes up in the
    byte-permute tables of `gf_cuda.kernel_tables` (exact for any GF(2)-linear
    byte map, so also for bit-matrices that are not images of GF(2^8)
    matrices; the codecs keep them in `ec.rs.CodingTables`); a CPU tensor
    runs `gf_matmul_bitplane_plain`.
  * `xor_reduce(data)`: (B, k, L) -> (B, 1, L), the m=1 parity. A CUDA
    tensor launches csrc/xor_rowmatmul.cu's XOR-of-rows kernel
    (`gf_cuda.launch_xor_rows`); a CPU tensor runs `xor_reduce_plain`.

The plain version of the matmul is the JAX function's formulation: multiply
by a constant in GF(2^8) is linear over GF(2), so the matmul is one {0,1}
contraction over the unpacked bits followed by a parity (mod 2) reduction:

    bytes (B, k, L)  --unpack-->  bits (B, 8k, L)   {0,1}
    bits_out = (M8 @ bits) & 1
    bytes_out (B, r, L)  <--pack--  bits_out

CUDA's `torch.matmul` has no int8 path, so the (chunk, bit) contraction runs
in float32. That is exact: every entry is 0 or 1 (also exact in TF32), and
each sum counts at most 8k <= 2048 ones, far below 2^24, the largest integer
float32 holds exactly.

Both CUDA paths read the input in place through its batch and row strides
(the last axis must be contiguous), so a slice such as `survivors[:, :k, :]`
is not copied first. Nothing selects between kernel and plain version but
the tensor's device, and nothing falls back. On a CUDA tensor each call is
a "gf.wrapper" span of `common.tracer.hot_spans`, as in `gf_cuda`. The
numpy oracle lives in ceph_tpu_torch.ops.gf; tests assert bit-exact
equality with it and with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.common.tracer import hot_spans
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops import gf_cuda as gc
from ceph_tpu_torch.ops.gf import matrix_to_bitmatrix

__all__ = [
    "bitplane_matrix",
    "unpack_bits",
    "pack_bits",
    "gf_matmul_bitplane",
    "gf_matmul_bitplane_plain",
    "xor_reduce",
    "xor_reduce_plain",
]

#: columns per step of the plain matmul: bounds its float32 bit temporaries
PLAIN_STEP = 1 << 18


def bitplane_matrix(mat: np.ndarray, device=None) -> torch.Tensor:
    """Expand an (r x c) GF(2^8) matrix to its (8r x 8c) GF(2) form as int8.

    Host-side, done once per (technique, k, m, erasure-signature) and cached by
    the codec layer — the analogue of the reference's decode-table cache
    (ErasureCodeIsaTableCache.cc).
    """
    bits = matrix_to_bitmatrix(mat).astype(np.int8)
    return torch.from_numpy(bits).to(resolve_device(device))


def _shifts(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=x.device)[:, None]


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., n, L) uint8 -> (..., 8n, L) int8 bits, LSB-first within each byte.

    Row n*8+b holds bit b of chunk-row n, matching the bit order of
    ceph_tpu_torch.ops.gf.bytes_to_bits / mul_bitmatrix.
    """
    bits = (x[..., :, None, :] >> _shifts(x)) & 1
    return bits.reshape(*x.shape[:-2], x.shape[-2] * 8, x.shape[-1]).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n, L) {0,1} int -> (..., n, L) uint8. Inverse of unpack_bits."""
    n8, length = bits.shape[-2], bits.shape[-1]
    b = bits.reshape(*bits.shape[:-2], n8 // 8, 8, length).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device))[:, None]
    return (b * weights).sum(dim=-2).to(torch.uint8)


def _check_matmul(bitmat, data) -> tuple[int, int]:
    if not (gc._is_tensor(bitmat) and gc._is_tensor(data)):
        raise TypeError("gf_matmul_bitplane takes torch tensors")
    dshape, bshape = data.shape, bitmat.shape  # each read once: see gf_cuda._check_shapes
    if data.dtype != torch.uint8 or len(dshape) != 3:
        raise TypeError(f"data must be (B, k, L) uint8, got {tuple(dshape)} {data.dtype}")
    k = dshape[1]
    if len(bshape) != 2 or bshape[0] % 8 or bshape[1] != 8 * k:
        raise ValueError(f"bit-matrix {tuple(bshape)} does not take k={k} chunks")
    return bshape[0] // 8, k


def gf_matmul_bitplane_plain(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Batched GF(2^8) matmul in torch ops: (8r, 8k) bit-matrix x (B, k, L)
    bytes -> (B, r, L), on the tensors' device.

    The contraction runs over the chunk and bit axes at once: the unpacked
    bits keep their (B, k, 8, L) order, which flattens to row j*8+b, the
    column order of the bit-matrix. Columns go in steps of PLAIN_STEP.
    """
    r, k = _check_matmul(bitmat, data)
    batch, _, length = data.shape
    mat = bitmat.to(device=data.device, dtype=torch.float32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=data.device))[:, None]
    out = torch.empty((batch, r, length), dtype=torch.uint8, device=data.device)
    for c in range(0, length, PLAIN_STEP):
        part = data[:, :, c : c + PLAIN_STEP]
        n = part.shape[-1]
        bits = ((part[:, :, None, :] >> _shifts(part)) & 1).to(torch.float32)
        acc = torch.matmul(mat, bits.reshape(batch, 8 * k, n))  # exact small integers
        acc = (acc.to(torch.int32) & 1).reshape(batch, r, 8, n)
        out[:, :, c : c + n] = (acc * weights).sum(dim=2).to(torch.uint8)
    return out


def gf_matmul_bitplane(
    bitmat: torch.Tensor, data: torch.Tensor, *, tables: torch.Tensor,
) -> torch.Tensor:
    """Batched GF(2^8) matmul: (8r, 8k) bit-matrix x (B, k, L) bytes -> (B, r, L).

    A CPU `data` runs the plain version and ignores `tables`. A CUDA `data`
    launches the kernel on its device's current stream with `tables`,
    bitmat's (r, k, 32) uint8 `gf_cuda.kernel_tables` on the same device
    (the codecs' `CodingTables.tables_t`); `data` may have any batch and row
    strides, its last axis contiguous. It raises on anything the kernel does
    not take. Each launch adds one to `gf_matmul_bitplane.launches`.
    """
    if hot_spans.on and getattr(data, "is_cuda", False):
        return hot_spans.call("gf.wrapper", _gf_matmul_bitplane, bitmat, data, tables)
    return _gf_matmul_bitplane(bitmat, data, tables)


def _gf_matmul_bitplane(bitmat, data, tables) -> torch.Tensor:
    r, k = _check_matmul(bitmat, data)
    if not data.is_cuda:
        if data.device.type == "cpu":
            return gf_matmul_bitplane_plain(bitmat, data)
        raise ValueError(f"gf_matmul_bitplane: unsupported device {data.device}")
    if r * k * 32 > gc.MAX_TABLE_BYTES:
        raise ValueError(
            f"gf_matmul_bitplane: r*k*32 = {r * k * 32} table bytes exceed the "
            f"kernel's {gc.MAX_TABLE_BYTES}"
        )
    device = data.get_device()
    host = gc.launch_tables(tables, r, k, device, "gf_matmul_bitplane")
    in_sb, in_sk = gc.row_strides(data, "gf_matmul_bitplane")
    batch, _, length = data.shape
    out = data.new_empty((batch, r, length))
    if batch == 0 or length == 0:
        return out
    lib = gc._lib()
    args = (tables.data_ptr(), host, data.data_ptr(), out.data_ptr(), k, r, batch, length,
            in_sb, in_sk)
    err = gc.on_device(device, lib.gf_matmul_bytes_launch, *args)
    if err != 0:
        msg = lib.gf_cuda_error_string(err).decode()
        raise RuntimeError(f"gf_matmul_bitplane launch failed: CUDA error {err} ({msg})")
    gf_matmul_bitplane.launches += 1
    return out


#: kernel launches made by the wrapper (the plain version counts none)
gf_matmul_bitplane.launches = 0


def _check_xor(data) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError("xor_reduce takes a torch tensor")
    if data.dtype != torch.uint8 or data.dim() != 3 or data.shape[1] < 1:
        raise TypeError(f"data must be (B, k, L) uint8 with k >= 1, got "
                        f"{tuple(data.shape)} {data.dtype}")


def xor_reduce_plain(data: torch.Tensor) -> torch.Tensor:
    """(B, k, L) uint8 -> (B, 1, L): the XOR of the k chunks, in torch ops."""
    _check_xor(data)
    out = data[:, 0, :].clone()
    for j in range(1, data.shape[1]):
        out ^= data[:, j, :]
    return out[:, None, :]


def xor_reduce(data: torch.Tensor) -> torch.Tensor:
    """m=1 fast path: parity chunk = XOR of the k data chunks.

    Mirrors the reference ISA plugin's short-circuit for a single parity
    (region XOR, ErasureCodeIsa.cc:121-128 / xor_op.cc) — no bit expansion.
    data: (B, k, L) uint8 -> (B, 1, L) uint8. A CPU tensor runs the plain
    version; a CUDA tensor (any batch and row strides, last axis contiguous)
    launches csrc/xor_rowmatmul.cu through `gf_cuda.launch_xor_rows` and
    adds one to `xor_reduce.launches`.
    """
    if hot_spans.on and getattr(data, "is_cuda", False):
        return hot_spans.call("gf.wrapper", _xor_reduce, data)
    return _xor_reduce(data)


def _xor_reduce(data) -> torch.Tensor:
    _check_xor(data)
    if data.device.type == "cpu":
        return xor_reduce_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"xor_reduce: unsupported device {data.device}")
    out = gc.launch_xor_rows(data, "xor_reduce")
    if out.numel():
        xor_reduce.launches += 1
    return out


#: kernel launches made by the wrapper (the plain version counts none)
xor_reduce.launches = 0
