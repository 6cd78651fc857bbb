"""Reed-Solomon / Cauchy codecs on the port's GF(2^8) kernels.

Port of ceph_tpu/ec/rs.py. One codec class covers the matrix techniques of the
reference's `jerasure` and `isa` plugins (ErasureCodeJerasure.cc,
ErasureCodeIsa.cc): the technique picks the coding-matrix family
(ceph_tpu_torch.ec.matrices); the byte API runs the batched matmul or, for
an m=1 XOR code, the XOR reduction of ceph_tpu_torch.ops.gf_bitplane; the
planar word API runs the packed-word kernel or the planar XOR of
ceph_tpu_torch.ops.gf_cuda (each a CUDA kernel for a card codec, its plain
version for a CPU codec); and decode matrices are memoized per erasure
signature — the analogue of the reference's LRU decoding-table cache
(ErasureCodeIsaTableCache.cc:234-296).

Each codec lives on one device (`device`, default cuda). Its coding matrices
are kept on the host and, once per matrix, as tensors on that device: the
bit-plane matrix, the packed matrix and the kernel's byte-permute tables.

Parameter envelopes mirror the reference:
  * w=8 only (the GF(2^8) field; jerasure also offers w=16/32, which change the
    chunk layout only for non-default techniques — out of scope, rejected);
  * isa vandermonde MDS guard k<=32, m<=4, (m==4 -> k<=21) (ErasureCodeIsa.cc:325-364);
  * jerasure defaults k=7, m=3 (ErasureCodeJerasure.h:89-91).
"""

from __future__ import annotations

import errno
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ceph_tpu_torch.common.tracer import hot_spans
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.interface import (
    SIMD_ALIGN,
    DecodeTableCache,
    ErasureCode,
    ErasureCodeError,
    align_up,
    chunk_size_isa_style,
    chunk_size_jerasure_style,
    profile_to_bool,
    profile_to_int,
    profile_to_string,
    to_device,
)
from ceph_tpu_torch.ops import gf_bitplane as bp
from ceph_tpu_torch.ops import gf_cuda as gc
from ceph_tpu_torch.ops.gf import matrix_to_bitmatrix

LARGEST_VECTOR_WORDSIZE = 16  # reference: ErasureCodeJerasure.cc:30


@dataclass(frozen=True)
class CodingTables:
    """One coding matrix in every form the codec uses: host arrays (the
    (8r, 8k) int8 bit-matrix and its (32r, 32k) packed expansion) and the
    tensors derived from them on the codec's device (bit-matrix, packed
    matrix, and the (r, k, 32) byte-permute tables of the CUDA kernel)."""

    bits: np.ndarray
    packed: np.ndarray
    bits_t: torch.Tensor
    packed_t: torch.Tensor
    tables_t: torch.Tensor

    @classmethod
    def from_bitmatrix(cls, bitmat: np.ndarray, device: torch.device) -> "CodingTables":
        bits = np.array(bitmat, dtype=np.int8, order="C")  # owned, writable
        packed = gc.pack_matrix(bits)
        return cls(
            bits=bits,
            packed=packed,
            bits_t=torch.from_numpy(bits).to(device),
            packed_t=torch.from_numpy(packed).to(device),
            tables_t=gc.device_tables(gc.kernel_tables(bits), device),
        )


class ErasureCodeRs(ErasureCode):
    """Matrix-technique RS codec; family selects reference-compatible behavior.

    family: "tpu" | "jerasure" | "isa" — controls technique-name namespace,
    defaults, chunk-size rule, and parameter envelope.
    """

    #: reference technique name -> matrix builder key
    TECHNIQUES = {
        "jerasure": {
            "reed_sol_van": "reed_sol_van",
            "reed_sol_r6_op": "reed_sol_r6_op",
            "cauchy_orig": "cauchy_orig",
            "cauchy_good": "cauchy_good",
        },
        "isa": {
            "reed_sol_van": "isa_vandermonde",
            "cauchy": "isa_cauchy",
        },
        # the native namespace exposes every family directly
        "tpu": {name: name for name in matrices.TECHNIQUES},
    }

    #: every technique here reduces to parity = gen @ data applied
    #: byte-column-wise over GF(2^8), so sub-stripe (column window)
    #: re-encoding is exact — the OSD's partial-overwrite fast path
    column_independent = True

    def __init__(self, family: str = "tpu", device=None):
        super().__init__()
        if family not in self.TECHNIQUES:
            raise ErasureCodeError(errno.EINVAL, f"unknown family {family!r}")
        self.family = family
        self.device = resolve_device(device)
        self.technique = ""
        self.w = 8
        self.per_chunk_alignment = False
        self._gen: np.ndarray | None = None
        self._encode: CodingTables | None = None
        self._xor_ok = False
        self._decode_cache = DecodeTableCache()

    # -- profile ------------------------------------------------------------

    def parse(self, profile) -> None:
        default_technique = "reed_sol_van" if self.family != "tpu" else "isa_cauchy"
        self.k = profile_to_int(profile, "k", 7)
        self.m = profile_to_int(profile, "m", 3)
        self.w = profile_to_int(profile, "w", 8)
        self.technique = profile_to_string(profile, "technique", default_technique)
        self.per_chunk_alignment = profile_to_bool(
            profile, "jerasure-per-chunk-alignment", False
        )
        # packetsize only exists for jerasure's bitmatrix (cauchy) techniques
        self.packetsize = (
            profile_to_int(profile, "packetsize", 2048)
            if self.family == "jerasure"
            else 1
        )
        techniques = self.TECHNIQUES[self.family]
        if self.technique not in techniques:
            raise ErasureCodeError(
                errno.EINVAL,
                f"technique={self.technique} is not a valid {self.family} "
                f"technique (know {sorted(techniques)})",
            )
        matrix_key = techniques[self.technique]
        if matrix_key == "reed_sol_r6_op":
            # RAID6 is m=2 by construction; the reference coerces m rather
            # than rejecting (ErasureCodeJerasure.cc:238-252 erases profile m),
            # so coerce BEFORE the geometry checks below run
            self.m = 2
            profile["m"] = "2"
        self.sanity_check_k_m()
        if self.w != 8:
            raise ErasureCodeError(
                errno.EINVAL, f"w={self.w} not supported (GF(2^8) only)"
            )
        if self.k + self.m > 256:
            raise ErasureCodeError(errno.EINVAL, "k+m must be <= 256 for w=8")
        if matrix_key == "isa_vandermonde":
            # MDS safety envelope, ErasureCodeIsa.cc:325-364
            if self.k > 32 or self.m > 4 or (self.m == 4 and self.k > 21):
                raise ErasureCodeError(
                    errno.EINVAL,
                    "isa reed_sol_van is only MDS for k<=32, m<=4 "
                    "(k<=21 when m=4)",
                )
        self._matrix_key = matrix_key
        self._parse_mapping(profile)

    def prepare(self) -> None:
        parity = matrices.build_parity_matrix(self._matrix_key, self.k, self.m)
        if self.family == "isa" and self.m == 1:
            # the reference's isa plugin short-circuits m==1 to region XOR for
            # BOTH matrix types (isa_encode/isa_decode, ErasureCodeIsa.cc:125,
            # 196-203), so the code it actually implements is the all-ones row
            parity = np.ones_like(parity)
        self._set_matrices(
            np.concatenate([np.eye(self.k, dtype=np.uint8), parity]),
            matrix_to_bitmatrix(parity),
        )

    def _set_matrices(self, gen: np.ndarray, parity_bits: np.ndarray) -> None:
        parity = gen[self.k:]
        # the XOR fast path is only valid when the parity row really is XOR
        self._xor_ok = self.m == 1 and bool(np.all(parity == 1))
        self._gen = gen
        self._encode = CodingTables.from_bitmatrix(parity_bits, self.device)
        self._decode_cache.clear()

    # -- geometry -----------------------------------------------------------

    def get_chunk_size(self, object_size: int) -> int:
        if self.family == "jerasure":
            # bitmatrix (cauchy) techniques fold packetsize into the alignment
            # (ErasureCodeJerasureCauchy::get_alignment, .cc:279-293); the
            # matrix techniques use the plain word alignment (.cc:174-184)
            cauchy = self.technique.startswith("cauchy")
            if self.per_chunk_alignment:
                if cauchy:
                    alignment = align_up(
                        self.w * self.packetsize, LARGEST_VECTOR_WORDSIZE
                    )
                else:
                    alignment = self.w * LARGEST_VECTOR_WORDSIZE
            else:
                packet = self.packetsize if cauchy else 1
                alignment = self.k * self.w * packet * 4
                if (self.w * packet * 4) % LARGEST_VECTOR_WORDSIZE:
                    alignment = self.k * self.w * packet * LARGEST_VECTOR_WORDSIZE
            return chunk_size_jerasure_style(
                self.k, object_size, alignment, self.per_chunk_alignment
            )
        if self.family == "isa":
            return chunk_size_isa_style(self.k, object_size, SIMD_ALIGN)
        # native tpu family: 128 B aligned chunks (the reference package's
        # TPU lane width), kept so chunk sizes match it byte for byte
        return chunk_size_isa_style(self.k, object_size, 128)

    # -- compute ------------------------------------------------------------

    # Each entry and the decode-table lookup is a span of `hot_spans`
    # (named "ec.<method>", "ec.decode_table") while `bench_profile` is on.

    def encode_array(self, data) -> torch.Tensor:
        """(B, k, L) uint8 -> (B, m, L) parity, a tensor on the codec's device."""
        if hot_spans.on:
            return hot_spans.call("ec.encode_array", self._encode_array, data)
        return self._encode_array(data)

    def _encode_array(self, data) -> torch.Tensor:
        data = to_device(data, torch.uint8, self.device)
        if self._xor_ok:
            return bp.xor_reduce(data)
        enc = self._encode
        return bp.gf_matmul_bitplane(enc.bits_t, data, tables=enc.tables_t)

    def decode_bitmatrix(self, present: Sequence[int], targets: Sequence[int]) -> CodingTables:
        """Memoized decode matrices for an erasure signature, in host and
        device form — the analogue of the reference's LRU decode-table
        cache (ErasureCodeIsaTableCache.cc:234-296)."""
        if hot_spans.on:
            return hot_spans.call("ec.decode_table", self._decode_bitmatrix, present, targets)
        return self._decode_bitmatrix(present, targets)

    def _decode_bitmatrix(self, present: Sequence[int], targets: Sequence[int]) -> CodingTables:
        def build():
            dm = matrices.decode_matrix(
                self._gen, self.k, list(present), list(targets)
            )
            return CodingTables.from_bitmatrix(matrix_to_bitmatrix(dm), self.device)

        key = (tuple(present[: self.k]), tuple(targets))
        return self._decode_cache.get_or(key, build)

    def decode_array(self, present, targets, survivors) -> torch.Tensor:
        if hot_spans.on:
            return hot_spans.call("ec.decode_array", self._decode_array, present, targets,
                                  survivors)
        return self._decode_array(present, targets, survivors)

    def _decode_array(self, present, targets, survivors) -> torch.Tensor:
        if len(present) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        # a strided view: the kernel reads the first k rows in place
        survivors = to_device(survivors, torch.uint8, self.device)[:, : self.k, :]
        dec = self.decode_bitmatrix(present, targets)
        return bp.gf_matmul_bitplane(dec.bits_t, survivors, tables=dec.tables_t)

    # -- planar word API: the CUDA kernel's entry point -------------------------

    def encode_words(self, words) -> torch.Tensor:
        """Chunk-planar encode: (k, N/4) int32 words -> (m, N/4) parity words.

        Rows are whole chunk columns (many objects' chunk j packed end to
        end), bytes ride four to a word through the kernel
        (ceph_tpu_torch.ops.gf_cuda). On a CPU codec the same call runs the
        kernel's plain version.
        """
        if hot_spans.on:
            return hot_spans.call("ec.encode_words", self._encode_words, words)
        return self._encode_words(words)

    def _encode_words(self, words) -> torch.Tensor:
        words = to_device(words, torch.int32, self.device)
        if self._xor_ok:
            return gc.xor_reduce_words(words)
        enc = self._encode
        return gc.gf_matmul_packed(enc.packed_t, words, tables=enc.tables_t)

    def decode_words(self, present, targets, words) -> torch.Tensor:
        """Planar decode: words holds the first k survivor chunks (logical ids
        `present`, ascending); returns len(targets) rebuilt chunk rows."""
        if hot_spans.on:
            return hot_spans.call("ec.decode_words", self._decode_words, present, targets,
                                  words)
        return self._decode_words(present, targets, words)

    def _decode_words(self, present, targets, words) -> torch.Tensor:
        if len(present) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        words = to_device(words, torch.int32, self.device)[: self.k]
        dec = self.decode_bitmatrix(present, targets)
        return gc.gf_matmul_packed(dec.packed_t, words, tables=dec.tables_t)


def from_reference_arrays(
    gen: np.ndarray,
    encode_bits: np.ndarray,
    encode_packed: np.ndarray,
    *,
    family: str = "tpu",
    device=None,
) -> ErasureCodeRs:
    """A codec whose state is carried over from another implementation's
    arrays rather than built by this package's matrix constructions: `gen`
    the (k+m, k) systematic generator, `encode_bits` its (8m, 8k) parity
    bit-matrix and `encode_packed` the (32m, 32k) packed form (for the JAX
    package: `_gen`, `_encode_bits`, `_encode_packed`). Decode matrices are
    derived from `gen` on demand, as prepare() would. Raises if the three
    arrays disagree in shape or packing."""
    gen = np.array(gen, dtype=np.uint8)
    bits = np.asarray(encode_bits, dtype=np.int8)
    n, k = gen.shape
    m = n - k
    if m < 1 or not np.array_equal(gen[:k], np.eye(k, dtype=np.uint8)):
        raise ValueError("gen must be a systematic (k+m, k) generator matrix")
    if bits.shape != (8 * m, 8 * k):
        raise ValueError(f"bit-matrix {bits.shape} does not match k={k} m={m}")
    if not np.array_equal(gc.pack_matrix(bits), np.asarray(encode_packed)):
        raise ValueError("encode_packed is not pack_matrix(encode_bits)")
    codec = ErasureCodeRs(family, device=device)
    codec.k, codec.m, codec.technique = k, m, "reference"
    codec._set_matrices(gen, bits)
    return codec
