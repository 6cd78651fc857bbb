"""SHEC — Shingled Erasure Code (locally repairable), on the port's kernels.

Port of ceph_tpu/ec/shec.py, which re-expresses the reference shec plugin
(src/erasure-code/shec/ErasureCodeShec.cc) on the batched GF(2^8) matmul:

  * the coding matrix is jerasure's Vandermonde distribution matrix with a
    sliding window of columns KEPT per parity row and the rest zeroed
    (shec_reedsolomon_coding_matrix, ErasureCodeShec.cc:461-533); each parity
    covers only ~k*c/m data chunks, so repairing one lost chunk reads a
    fraction of the stripe — recovery bandwidth traded against storage;
  * technique=multiple splits the m parities into two banks (m1,c1)/(m2,c2),
    chosen by exhaustive search minimizing the average recovery cost
    (shec_calc_recovery_efficiency1, ErasureCodeShec.cc:420-460);
  * decode searches the cheapest invertible (rows x columns) submatrix over
    all 2^m parity subsets (shec_make_decoding_matrix,
    ErasureCodeShec.cc:531-755) and _minimum_to_decode returns exactly the
    chunks that search selects (ErasureCodeShec.cc:71-123), so a single
    lost chunk is read back from fewer than k chunks;
  * the search and inversion are host control flow, cached per erasure
    signature like ErasureCodeShecTableCache, with each matrix's bit-matrix
    and kernel tables kept on the codec's device; the chunk math — encode
    and batched decode — runs on gf_bitplane.gf_matmul_bitplane (the CUDA
    kernel for a card codec), and decode assembles its output on the device.

SHEC is NOT MDS: it guarantees recovery of any <= c erasures (tests verify
exhaustively), and some > c patterns are unrecoverable by design.
"""

from __future__ import annotations

import errno
from collections import OrderedDict
from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.interface import (
    ErasureCode,
    ErasureCodeError,
    align_up,
    profile_to_string,
    to_device,
)
from ceph_tpu_torch.ec.rs import CodingTables
from ceph_tpu_torch.ops import gf_bitplane as bp
from ceph_tpu_torch.ops.gf import gf_invert_matrix, matrix_to_bitmatrix

MULTIPLE = 0  # ErasureCodeShec.h:31
SINGLE = 1
DECODE_TABLE_CACHE_SIZE = 256


def calc_recovery_efficiency1(
    k: int, m1: int, m2: int, c1: int, c2: int
) -> float:
    """Average recovery cost of a (m1,c1)/(m2,c2) parity-bank split
    (shec_calc_recovery_efficiency1, ErasureCodeShec.cc:420-460)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = 0.0
    for m_bank, c_bank in ((m1, c1), (m2, c2)):
        for rr in range(m_bank):
            start = ((rr * k) // m_bank) % k
            end = (((rr + c_bank) * k) // m_bank) % k
            cost = ((rr + c_bank) * k) // m_bank - (rr * k) // m_bank
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], cost)
                cc = (cc + 1) % k
            r_e1 += cost
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, technique: int) -> np.ndarray:
    """The (m x k) SHEC parity matrix (shec_reedsolomon_coding_matrix,
    ErasureCodeShec.cc:461-533): Vandermonde rows with a kept window per row.
    """
    if technique != SINGLE:
        c1_best, m1_best = -1, -1
        min_r_e1 = 100.0
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r_e1 = calc_recovery_efficiency1(k, m1, m2, c1, c2)
                # epsilon comparison as in the reference
                if min_r_e1 - r_e1 > np.finfo(float).eps and r_e1 < min_r_e1:
                    min_r_e1, c1_best, m1_best = r_e1, c1, m1
        m1, c1 = m1_best, c1_best
        m2, c2 = m - m1_best, c - c1_best
    else:
        m1, c1, m2, c2 = 0, 0, m, c

    mat = matrices.jerasure_vandermonde(k, m).astype(np.uint8)
    # zero everything OUTSIDE the kept window [end, start) of each row
    for rr in range(m1):
        end = ((rr * k) // m1) % k
        start = (((rr + c1) * k) // m1) % k
        cc = start
        while cc != end:
            mat[rr, cc] = 0
            cc = (cc + 1) % k
    for rr in range(m2):
        end = ((rr * k) // m2) % k
        start = (((rr + c2) * k) // m2) % k
        cc = start
        while cc != end:
            mat[m1 + rr, cc] = 0
            cc = (cc + 1) % k
    return mat


class ErasureCodeShec(ErasureCode):
    """plugin=shec — ErasureCodeShecReedSolomonVandermonde parity."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.c = 0
        self.w = 8
        self.technique = MULTIPLE
        self._matrix: np.ndarray | None = None
        self._encode: CodingTables | None = None
        # (want, avails) -> (mindup, dm_row, dm_column, minimum, inv)
        self._decode_cache: OrderedDict[tuple, tuple] = OrderedDict()

    # -- profile ------------------------------------------------------------

    def parse(self, profile) -> None:
        # (k, m, c) default together or must be given together
        # (ErasureCodeShecReedSolomonVandermonde::parse, .cc:276-345)
        if "k" not in profile and "m" not in profile and "c" not in profile:
            self.k, self.m, self.c = 4, 3, 2
        elif "k" not in profile or "m" not in profile or "c" not in profile:
            raise ErasureCodeError(errno.EINVAL, "(k, m, c) must be chosen")
        else:
            try:
                self.k = int(profile["k"], 10)
                self.m = int(profile["m"], 10)
                self.c = int(profile["c"], 10)
            except ValueError:
                raise ErasureCodeError(
                    errno.EINVAL, "could not convert k/m/c to int"
                ) from None
        if self.k <= 0 or self.m <= 0 or self.c <= 0:
            raise ErasureCodeError(errno.EINVAL, "k, m, c must be positive")
        if self.m < self.c:
            raise ErasureCodeError(errno.EINVAL, f"c={self.c} must be <= m")
        if self.k > 12:
            raise ErasureCodeError(errno.EINVAL, f"k={self.k} must be <= 12")
        if self.k + self.m > 20:
            raise ErasureCodeError(errno.EINVAL, "k+m must be <= 20")
        if self.k < self.m:
            raise ErasureCodeError(errno.EINVAL, f"m={self.m} must be <= k")
        t = profile_to_string(profile, "technique", "multiple")
        if t == "multiple":
            self.technique = MULTIPLE
        elif t == "single":
            self.technique = SINGLE
        else:
            raise ErasureCodeError(
                errno.EINVAL,
                f"technique={t} is not a valid coding technique "
                "(choose multiple or single)",
            )
        # the reference accepts w in {8,16,32} (falling back to 8 on other
        # values); this framework implements GF(2^8) only
        w = profile.get("w", "")
        self.w = 8
        if w not in ("", "8"):
            raise ErasureCodeError(
                errno.EINVAL, f"w={w} not supported (GF(2^8) only)"
            )
        profile["w"] = "8"
        # the reference shec plugin has no chunk-remap support (its _decode
        # bypasses ErasureCode::decode); accepting mapping= here would let
        # the inherited encode() apply it while decode ignored it
        if profile.get("mapping"):
            raise ErasureCodeError(
                errno.EINVAL, "shec does not support mapping="
            )

    def prepare(self) -> None:
        self._set_matrix(shec_coding_matrix(self.k, self.m, self.c, self.technique))

    def _set_matrix(self, matrix: np.ndarray) -> None:
        self._matrix = np.array(matrix, dtype=np.uint8)
        self._encode = CodingTables.from_bitmatrix(
            matrix_to_bitmatrix(self._matrix), self.device
        )
        self._decode_cache.clear()

    # -- geometry -----------------------------------------------------------

    def get_chunk_size(self, object_size: int) -> int:
        # padded to k*w*sizeof(int) then split (get_alignment + .cc:60-68)
        alignment = self.k * self.w * 4
        return align_up(object_size, alignment) // self.k

    # -- decode-set search ---------------------------------------------------

    def _make_decoding_matrix(self, want_in: Sequence[int], avails: Sequence[int]):
        """Port of shec_make_decoding_matrix (ErasureCodeShec.cc:531-755).

        want_in/avails: 0/1 vectors of length k+m. Returns
        (dm_row, dm_column, minimum, missing_idx, data_bits, parity_targets,
        parity_bits): dm_row are original chunk ids whose values feed the
        inverse, dm_column the data chunks it rebuilds, minimum the chunk-id
        set to read, and the *_bits CodingTables (host arrays and their
        tensors on the codec's device) rebuild the unavailable data columns /
        wanted-missing parities directly. Raises EIO when unrecoverable.
        """
        k, m = self.k, self.m
        mat = self._matrix
        want = list(want_in)
        # a wanted-but-missing parity pulls in every data chunk it covers
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if mat[i, j] > 0:
                        want[j] = 1

        key = (tuple(want), tuple(avails))
        cached = self._decode_cache.get(key)
        if cached is not None:
            self._decode_cache.move_to_end(key)
            return cached

        mindup, minp = k + 1, k + 1
        dm_row: list[int] = []
        dm_column: list[int] = []
        inv: np.ndarray | None = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            ek = len(p)
            if ek > minp:
                continue
            if any(not avails[k + i] for i in p):
                continue
            tmprow = [0] * (k + m)
            tmpcolumn = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcolumn[i] = 1
            for i in p:
                tmprow[k + i] = 1
                for j in range(k):
                    if mat[i, j] != 0:
                        tmpcolumn[j] = 1
                        if avails[j] == 1:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_column = sum(tmpcolumn)
            if dup_row != dup_column:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                dm_row, dm_column, inv = [], [], None
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcolumn[j]]
                tmpmat = np.zeros((dup, dup), dtype=np.uint8)
                for ri, i in enumerate(rows):
                    for ci, j in enumerate(cols):
                        if i < k:
                            tmpmat[ri, ci] = 1 if i == j else 0
                        else:
                            tmpmat[ri, ci] = mat[i - k, j]
                try:
                    cand_inv = gf_invert_matrix(tmpmat)
                except np.linalg.LinAlgError:
                    continue  # singular: determinant zero in the reference
                mindup = dup
                dm_row, dm_column, inv = rows, cols, cand_inv
                minp = ek

        if mindup == k + 1:
            raise ErasureCodeError(
                errno.EIO, "shec: can't find recover matrix"
            )

        minimum = [0] * (k + m)
        for r in dm_row:
            minimum[r] = 1
        for i in range(k):
            if want[i] and avails[i]:
                minimum[i] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                # an avail wanted parity must be read only if it covers data
                # outside the wanted set (else it is re-encoded for free)
                if any(mat[i, j] > 0 and not want[j] for j in range(k)):
                    minimum[k + i] = 1

        # hot-path tables, built once per erasure signature (the analogue of
        # ErasureCodeShecTableCache): (a) the inverse rows rebuilding
        # unavailable data columns and (b) the parity rows re-encoding
        # wanted-missing parities, each as host arrays and as the bit-matrix
        # and kernel tables on the codec's device
        missing_idx = [
            i for i, dcol in enumerate(dm_column) if not avails[dcol]
        ]
        data_bits = (
            CodingTables.from_bitmatrix(
                matrix_to_bitmatrix(np.stack([inv[i] for i in missing_idx])),
                self.device,
            )
            if inv is not None and missing_idx
            else None
        )
        parity_targets = [
            k + i for i in range(m) if want[k + i] and not avails[k + i]
        ]
        parity_bits = (
            CodingTables.from_bitmatrix(
                matrix_to_bitmatrix(np.stack([mat[t - k] for t in parity_targets])),
                self.device,
            )
            if parity_targets
            else None
        )

        result = (
            dm_row, dm_column, minimum,
            missing_idx, data_bits, parity_targets, parity_bits,
        )
        self._decode_cache[key] = result
        if len(self._decode_cache) > DECODE_TABLE_CACHE_SIZE:
            self._decode_cache.popitem(last=False)
        return result

    # -- minimum_to_decode ---------------------------------------------------

    def _minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        n = self.k + self.m
        if any(not 0 <= i < n for i in want_to_read | available):
            raise ErasureCodeError(errno.EINVAL, "chunk id out of range")
        want = [1 if i in want_to_read else 0 for i in range(n)]
        avails = [1 if i in available else 0 for i in range(n)]
        minimum = self._make_decoding_matrix(want, avails)[2]
        return {i for i in range(n) if minimum[i]}

    # -- compute -------------------------------------------------------------

    def encode_array(self, data) -> torch.Tensor:
        """(B, k, L) uint8 -> (B, m, L) parity, a tensor on the codec's device."""
        data = to_device(data, torch.uint8, self.device)
        enc = self._encode
        return bp.gf_matmul_bitplane(enc.bits_t, data, tables=enc.tables_t)

    def decode_array(self, present, targets, survivors) -> torch.Tensor:
        """Rebuild logical chunks `targets` from survivor chunks `present`.

        survivors: (batch, len(present), chunk). Unlike the MDS codecs, the
        usable survivor set is found by the SHEC submatrix search, so all
        provided survivors participate (not just the first k). Returns
        (batch, len(targets), chunk), assembled on the codec's device.
        """
        n = self.k + self.m
        present = list(present)
        want = [0] * n
        for t in targets:
            want[t] = 1
        avails = [0] * n
        for pch in present:
            avails[pch] = 1
        (
            dm_row, dm_column, _,
            missing_idx, data_bits, parity_targets, parity_bits,
        ) = self._make_decoding_matrix(want, avails)

        survivors = to_device(survivors, torch.uint8, self.device)
        batch, _, chunk = survivors.shape
        col_of = {pch: idx for idx, pch in enumerate(present)}

        # data targets rebuilt by the cached inverse rows over dm_row values
        rebuilt: dict[int, torch.Tensor] = {}
        if data_bits is not None:
            src = survivors[:, [col_of[r] for r in dm_row], :]
            out = bp.gf_matmul_bitplane(data_bits.bits_t, src, tables=data_bits.tables_t)
            for pos, i in enumerate(missing_idx):
                rebuilt[dm_column[i]] = out[:, pos, :]

        # full data vector (zeros where untouched-missing: their matrix
        # coefficients are zero in every parity row that needs re-encoding)
        def data_chunk(j: int) -> torch.Tensor:
            if avails[j]:
                return survivors[:, col_of[j], :]
            if j in rebuilt:
                return rebuilt[j]
            return torch.zeros((batch, chunk), dtype=torch.uint8, device=self.device)

        parity_out: dict[int, torch.Tensor] = {}
        if parity_bits is not None:
            data_full = torch.stack([data_chunk(j) for j in range(self.k)], dim=1)
            out = bp.gf_matmul_bitplane(
                parity_bits.bits_t, data_full, tables=parity_bits.tables_t
            )
            for pos, t in enumerate(parity_targets):
                parity_out[t] = out[:, pos, :]

        cols = []
        for t in targets:
            if t < self.k:
                cols.append(data_chunk(t))
            elif avails[t]:
                cols.append(survivors[:, col_of[t], :])
            else:
                cols.append(parity_out[t])
        return torch.stack(cols, dim=1)

    # -- byte-level decode (no k-survivor precondition) ----------------------

    def decode(self, want_to_read, chunks: Mapping[int, bytes]):
        """SHEC can decode from fewer than k chunks (that is the point), so
        the base class's len(have) >= k gate does not apply
        (ErasureCodeShec::_decode has no such check, .cc:172-213)."""
        return self._decode_bytes_ungated(
            want_to_read, chunks, self.decode_array
        )


def from_reference_arrays(matrix: np.ndarray, profile: dict, *, device=None) -> ErasureCodeShec:
    """A shec codec whose (m, k) coding matrix is carried over from another
    implementation (for the JAX package: `_matrix`) rather than built by
    shec_coding_matrix; `profile` gives the geometry. Raises if the matrix
    does not fit it."""
    codec = ErasureCodeShec(device=device)
    codec.profile = dict(profile)
    codec.parse(codec.profile)
    mat = np.asarray(matrix)
    if mat.shape != (codec.m, codec.k):
        raise ValueError(f"matrix {mat.shape} does not match k={codec.k} m={codec.m}")
    codec._set_matrix(mat)
    return codec
