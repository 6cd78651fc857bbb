"""Pure-bitmatrix RAID-6 codecs: jerasure's liberation / blaum_roth /
liber8tion techniques (ErasureCodeJerasure.h:191-252, .cc Liberation classes).

Port of ceph_tpu/ec/bitmatrix.py. These are m=2 array codes defined directly
by GF(2) bit matrices, not by GF(2^w) byte matrices: each chunk is viewed as
w packet rows and each parity row is an XOR of selected data rows. The
reference turns the bitmatrix into an XOR schedule and streams packets
through it (jerasure_schedule_encode with `packetsize`); the port keeps the
matrix and XORs the selected rows of a whole batch of stripes in one launch
of csrc/xor_rowmatmul.cu (`xor_rowmatmul`), with a plain torch version
beside it for CPU tensors.

Constructions (copied from the JAX package, which re-derives them from the
published algorithms; tests verify the RAID-6 MDS property):

  * liberation (Plank, "The RAID-6 Liberation Codes", FAST'08; jerasure
    liberation.c): w prime > 2, k <= w. Q block for data disk j is the cyclic
    shift S^j plus, for j > 0, one excess bit at row (j*(w-1)/2) mod w,
    column (row + j - 1) mod w.
  * blaum_roth (Blaum & Roth, "On Lowest Density MDS Codes"): w with w+1
    prime; Q block j = C^j where C is multiplication by x in
    GF(2)[x]/(1 + x + ... + x^w). w=7 is accepted for Firefly backward
    compatibility exactly as the reference does (ErasureCodeJerasure.cc
    BlaumRoth::check_w) even though w+1=8 is not prime — that geometry is NOT
    MDS (e.g. losing both chunks of k=2 is unrecoverable).
  * liber8tion (Plank, "The RAID-6 Liber8tion Code"): w=8, m=2, k <= 8, built
    from multiplication-by-alpha^j companion blocks over GF(2^8): the same
    geometry and parameter envelope as jerasure's, provably MDS, but not
    chunk-compatible with jerasure's search-found tables (the JAX package and
    the corpus are the reference here).

Byte layout: jerasure's packet-group organization — a chunk is G groups of w
packets of `packetsize` bytes; bit-row r of the code acts on packet r of every
group (jerasure_schedule_encode semantics). `_rows` and `_chunks` are torch
reshapes and transposes (one copy each way); the kernel reads the (B, C, P)
row form. The constructions, `gf2_invert` and the decode matrices stay host
numpy; each matrix the codec uses is also kept on its device with its row
lists, once.
"""

from __future__ import annotations

import errno
from typing import Sequence

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import (
    DecodeTableCache,
    ErasureCode,
    ErasureCodeError,
    chunk_size_jerasure_style,
    profile_to_bool,
    profile_to_int,
    to_device,
)
from ceph_tpu_torch.ec.rs import LARGEST_VECTOR_WORDSIZE
from ceph_tpu_torch.ops import gf_cuda as gc
from ceph_tpu_torch.ops.gf import mul_bitmatrix

#: row-list words the kernel takes (`gf_cuda.MAX_LIST_WORDS`); a matrix
#: with longer lists is refused on either device
MAX_LIST_WORDS = gc.MAX_LIST_WORDS


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % p for p in range(2, int(n**0.5) + 1))


# -- constructions -----------------------------------------------------------


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) coding bitmatrix: P identities, Q = shift + excess bit."""
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    for j in range(k):
        for i in range(w):
            bm[i, j * w + i] = 1                    # P: identity block
            bm[w + i, j * w + (j + i) % w] = 1      # Q: cyclic shift by j
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            bm[w + i, j * w + (i + j - 1) % w] ^= 1  # the excess bit
    return bm


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw): Q block j = C^j, C = mult-by-x mod 1 + x + ... + x^w."""
    c = np.zeros((w, w), dtype=np.uint8)
    for i in range(w - 1):
        c[i + 1, i] = 1          # x * x^i = x^(i+1)
    c[:, w - 1] = 1              # x^w = 1 + x + ... + x^(w-1)
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    blk = np.eye(w, dtype=np.uint8)
    for j in range(k):
        bm[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:, j * w : (j + 1) * w] = blk
        blk = (c @ blk) % 2
    return bm


def liber8tion_bitmatrix(k: int, w: int = 8) -> np.ndarray:
    """(2w, kw): Q block j = bitmatrix of multiplication by alpha^j in
    GF(2^8) (poly 0x11d) — MDS for every k <= 8 (distinct nonzero alpha^j)."""
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    g = 1
    for j in range(k):
        bm[:w, j * w : (j + 1) * w] = np.eye(w, dtype=np.uint8)
        bm[w:, j * w : (j + 1) * w] = mul_bitmatrix(g)
        g = (g << 1) ^ (0x11D if g & 0x80 else 0)
    return bm


BUILDERS = {
    "liberation": liberation_bitmatrix,
    "blaum_roth": blaum_roth_bitmatrix,
    "liber8tion": liber8tion_bitmatrix,
}


def gf2_invert(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix by Gauss-Jordan; raises on singular."""
    n = mat.shape[0]
    a = (mat % 2).astype(np.uint8)
    inv = np.eye(n, dtype=np.uint8)
    row = 0
    for col in range(n):
        piv = None
        for i in range(row, n):
            if a[i, col]:
                piv = i
                break
        if piv is None:
            raise ErasureCodeError(errno.EIO, "singular GF(2) matrix")
        if piv != row:
            a[[row, piv]] = a[[piv, row]]
            inv[[row, piv]] = inv[[piv, row]]
        hit = np.nonzero(a[:, col])[0]
        hit = hit[hit != row]
        a[hit] ^= a[row]
        inv[hit] ^= inv[row]
        row += 1
    return inv


# -- the row product: kernel wrapper and plain version -------------------------


def row_lists(bitmat) -> np.ndarray:
    """(R, C) {0,1} matrix -> the kernel's int32 row lists: R + 1 offsets,
    then the input rows output row i selects, at entries
    [offsets[i], offsets[i + 1]), ascending. Raises past MAX_LIST_WORDS."""
    bm = np.asarray(bitmat)
    if bm.ndim != 2 or not np.isin(bm, (0, 1)).all():
        raise ValueError("bit-matrix must be a 2-D {0,1} matrix")
    nz_rows, nz_cols = np.nonzero(bm)
    offsets = np.zeros(bm.shape[0] + 1, dtype=np.int64)
    np.add.at(offsets, nz_rows + 1, 1)
    lists = np.concatenate([np.cumsum(offsets), nz_cols]).astype(np.int32)
    _check_list_words(lists.size)
    return lists


def _check_list_words(n_words: int) -> None:
    if n_words > MAX_LIST_WORDS:
        raise ValueError(
            f"xor_rowmatmul: {n_words} row-list words exceed the kernel's "
            f"{MAX_LIST_WORDS} (227 KB of shared memory)"
        )


def _check_rows(bitmat, rows) -> tuple[int, int]:
    if not isinstance(bitmat, torch.Tensor) or not isinstance(rows, torch.Tensor):
        raise TypeError("xor_rowmatmul takes torch tensors")
    if rows.dtype != torch.uint8 or rows.dim() != 3:
        raise TypeError(f"rows must be (B, C, P) uint8, got {tuple(rows.shape)} {rows.dtype}")
    if bitmat.dim() != 2 or bitmat.shape[1] != rows.shape[1] or bitmat.shape[0] < 1:
        raise ValueError(
            f"bit-matrix {tuple(bitmat.shape)} does not take {rows.shape[1]} rows"
        )
    return bitmat.shape[0], bitmat.shape[1]


def xor_rowmatmul_plain(bitmat: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(R, C) {0,1} x (B, C, P) uint8 -> (B, R, P) in torch ops: output row
    i is the XOR of the input rows its matrix row selects."""
    r, _c = _check_rows(bitmat, rows)
    mask = (bitmat != 0).cpu().numpy()
    batch, _, length = rows.shape
    out = torch.zeros((batch, r, length), dtype=torch.uint8, device=rows.device)
    for i in range(r):
        for c in np.nonzero(mask[i])[0]:
            out[:, i] ^= rows[:, int(c)]
    return out


def xor_rowmatmul(bitmat: torch.Tensor, rows: torch.Tensor, *, lists: torch.Tensor
                  ) -> torch.Tensor:
    """Mod-2 row product: (R, C) {0,1} bit-matrix x (B, C, P) uint8 rows ->
    (B, R, P); each output row is the XOR of the selected input rows.

    `lists` is bitmat's int32 `row_lists` (the codecs' `RowMatrix.lists_t`);
    lists longer than MAX_LIST_WORDS raise on either device. A CPU `rows`
    runs the plain version. A CUDA `rows` (any batch and row strides, last
    axis contiguous) launches csrc/xor_rowmatmul.cu on the current stream
    with `lists` on the same device, and adds one to
    `xor_rowmatmul.launches`.
    """
    r, _c = _check_rows(bitmat, rows)
    _check_list_words(lists.numel())
    if rows.device.type == "cpu":
        return xor_rowmatmul_plain(bitmat, rows)
    if rows.device.type != "cuda":
        raise ValueError(f"xor_rowmatmul: unsupported device {rows.device}")
    out = gc.launch_row_lists(lists, r, rows, "xor_rowmatmul")
    xor_rowmatmul.launches += 1
    return out


#: kernel launches made by the wrapper (the plain version counts none)
xor_rowmatmul.launches = 0


class RowMatrix:
    """One bit-matrix of the codec: host array, and on the codec's device
    the matrix and its kernel row lists."""

    def __init__(self, bits: np.ndarray, device: torch.device):
        self.bits = np.array(bits, dtype=np.uint8, order="C")
        self.bits_t = torch.from_numpy(self.bits).to(device)
        self.lists_t = torch.from_numpy(row_lists(self.bits)).to(device)


# -- codec -------------------------------------------------------------------


class ErasureCodeBitmatrix(ErasureCode):
    """jerasure's liberation-family techniques on the row-product kernel."""

    def __init__(self, technique: str, device=None):
        super().__init__()
        if technique not in BUILDERS:
            raise ErasureCodeError(
                errno.EINVAL, f"unknown bitmatrix technique {technique!r}"
            )
        self.technique = technique
        self.device = resolve_device(device)
        self.w = 0
        self.packetsize = 0
        self.per_chunk_alignment = False
        self._bitmat: np.ndarray | None = None
        self._gen_bits: np.ndarray | None = None
        self._encode: RowMatrix | None = None
        self._decode_cache = DecodeTableCache()

    # -- profile ------------------------------------------------------------

    def parse(self, profile) -> None:
        # defaults k=2, m=2, w=7 (w=8 liber8tion): ErasureCodeJerasure.h:203-246
        self.k = profile_to_int(profile, "k", 2)
        self.m = profile_to_int(profile, "m", 2)
        default_w = 8 if self.technique == "liber8tion" else 7
        self.w = profile_to_int(profile, "w", default_w)
        self.packetsize = profile_to_int(profile, "packetsize", 2048)
        self.per_chunk_alignment = profile_to_bool(
            profile, "jerasure-per-chunk-alignment", False
        )
        if self.technique == "liber8tion":
            # the reference erases m and w to their defaults (.cc parse)
            self.m, self.w = 2, 8
            profile["m"], profile["w"] = "2", "8"
        if self.m != 2:
            raise ErasureCodeError(
                errno.EINVAL,
                f"technique={self.technique} is a RAID-6 code: m must be 2",
            )
        if self.k > self.w:
            raise ErasureCodeError(
                errno.EINVAL, f"k={self.k} must be <= w={self.w}"
            )
        if self.technique == "liberation":
            if self.w <= 2 or not _is_prime(self.w):
                raise ErasureCodeError(
                    errno.EINVAL, f"w={self.w} must be > 2 and prime"
                )
        elif self.technique == "blaum_roth":
            # w=7 tolerated for Firefly compat (NOT MDS), as the reference does
            if self.w != 7 and (self.w <= 2 or not _is_prime(self.w + 1)):
                raise ErasureCodeError(
                    errno.EINVAL, f"w={self.w} must be > 2 with w+1 prime"
                )
        if self.packetsize == 0:
            raise ErasureCodeError(errno.EINVAL, "packetsize must be set")
        if self.packetsize % 4:
            raise ErasureCodeError(
                errno.EINVAL,
                f"packetsize={self.packetsize} must be a multiple of 4",
            )
        self.sanity_check_k_m()
        self._parse_mapping(profile)

    def prepare(self) -> None:
        self._set_bitmatrix(BUILDERS[self.technique](self.k, self.w))

    def _set_bitmatrix(self, bitmat: np.ndarray) -> None:
        self._bitmat = np.array(bitmat, dtype=np.uint8)
        # full generator: kw identity rows (data), then the 2w coding rows
        self._gen_bits = np.concatenate(
            [np.eye(self.k * self.w, dtype=np.uint8), self._bitmat]
        )
        self._encode = RowMatrix(self._bitmat, self.device)
        self._decode_cache.clear()

    # -- geometry -----------------------------------------------------------

    def get_chunk_size(self, object_size: int) -> int:
        # ErasureCodeJerasureLiberation::get_alignment
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
        return chunk_size_jerasure_style(
            self.k, object_size, alignment, self.per_chunk_alignment
        )

    # -- compute ------------------------------------------------------------

    def _rows(self, chunks: torch.Tensor) -> torch.Tensor:
        """(B, n, chunk) -> (B, n*w, chunk/w) bit rows, honoring packetsize.

        jerasure's layout (jerasure_schedule_encode): a chunk is G groups of
        w packets of `packetsize` bytes; bit-row r of the code is the
        concatenation over groups of packet r. chunk = G * w * packetsize."""
        b, n, length = chunks.shape
        g = length // (self.w * self.packetsize)
        x = chunks.reshape(b, n, g, self.w, self.packetsize)
        return x.transpose(2, 3).reshape(b, n * self.w, g * self.packetsize)

    def _chunks(self, rows: torch.Tensor, n: int) -> torch.Tensor:
        """Inverse of _rows for n output chunks."""
        b = rows.shape[0]
        g = rows.shape[-1] // self.packetsize
        x = rows.reshape(b, n, self.w, g, self.packetsize)
        return x.transpose(2, 3).reshape(b, n, -1)

    def _check_blocksize(self, length: int) -> None:
        if length % (self.w * self.packetsize):
            raise ErasureCodeError(
                errno.EINVAL,
                f"chunk size {length} not divisible by w*packetsize = "
                f"{self.w}*{self.packetsize} (jerasure_schedule_encode "
                "requires whole packet groups)",
            )

    def encode_array(self, data) -> torch.Tensor:
        """(B, k, L) uint8 -> (B, m, L) parity, a tensor on the codec's device."""
        data = to_device(data, torch.uint8, self.device)
        self._check_blocksize(data.shape[-1])
        enc = self._encode
        parity_rows = xor_rowmatmul(enc.bits_t, self._rows(data), lists=enc.lists_t)
        return self._chunks(parity_rows, self.m)

    def _decode_rows(self, present: Sequence[int], targets: Sequence[int]) -> RowMatrix:
        def build():
            w = self.w
            rows = np.concatenate(
                [self._gen_bits[c * w : (c + 1) * w] for c in present[: self.k]]
            )  # (kw, kw)
            inv = gf2_invert(rows)
            dm = np.concatenate(
                [
                    (self._gen_bits[t * w : (t + 1) * w] @ inv) % 2
                    for t in targets
                ]
            ).astype(np.uint8)  # (len(targets)*w, kw)
            return RowMatrix(dm, self.device)

        key = (tuple(present[: self.k]), tuple(targets))
        return self._decode_cache.get_or(key, build)

    def decode_array(self, present, targets, survivors) -> torch.Tensor:
        if len(present) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        survivors = to_device(survivors, torch.uint8, self.device)[:, : self.k, :]
        self._check_blocksize(survivors.shape[-1])
        dm = self._decode_rows(list(present), list(targets))
        rebuilt = xor_rowmatmul(dm.bits_t, self._rows(survivors), lists=dm.lists_t)
        return self._chunks(rebuilt, len(targets))


def from_reference_arrays(
    bitmat: np.ndarray, technique: str, profile: dict, *, device=None
) -> ErasureCodeBitmatrix:
    """A bitmatrix codec whose coding matrix is carried over from another
    implementation (for the JAX package: `_bitmat`) rather than built by this
    package's constructions; `profile` gives the geometry. Raises if the
    matrix is not a (2w, kw) {0,1} matrix for that geometry."""
    codec = ErasureCodeBitmatrix(technique, device=device)
    codec.profile = dict(profile)
    codec.parse(codec.profile)
    bm = np.asarray(bitmat)
    if bm.shape != (2 * codec.w, codec.k * codec.w) or not np.isin(bm, (0, 1)).all():
        raise ValueError(
            f"bit-matrix {bm.shape} is not a (2w, kw) = "
            f"({2 * codec.w}, {codec.k * codec.w}) {{0,1}} matrix"
        )
    codec._set_bitmatrix(bm)
    return codec
