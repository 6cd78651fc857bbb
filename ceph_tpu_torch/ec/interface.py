"""Erasure-code interface layer: the behavioral contracts of the reference.

This module re-expresses the semantics of Ceph's `ErasureCodeInterface`
(src/erasure-code/ErasureCodeInterface.h:170-462) and the shared
base-class logic of `ceph::ErasureCode`
(src/erasure-code/ErasureCode.cc) in idiomatic Python:

  * profiles are str->str dicts with defaulting/validating accessors
    (to_int/to_bool/to_string, ErasureCode.cc:295-343);
  * systematic-code contract: chunks 0..k-1 are the (padded) object data, chunks
    k..k+m-1 are parity;
  * `encode_prepare` pads the object to k * get_chunk_size(len) with zeros and
    splits it (ErasureCode.cc:151-186, SIMD_ALIGN=32);
  * optional `mapping=DD_D...` remaps logical chunk i to physical position
    chunk_index(i) (to_mapping, ErasureCode.cc:274-292);
  * `minimum_to_decode` defaults to "any k available chunks", returned as
    {chunk: [(offset, count)]} sub-chunk lists so array codes (CLAY) can read
    fractions of chunks (ErasureCode.cc:103-137);
  * decode fills missing wanted chunks from >= k survivors.

The byte-level encode/decode API mirrors the reference for drop-in test parity;
the device entry points are the batched array methods (`encode_array` /
`decode_array`) that concrete codecs implement over (batch, k, chunk) uint8
tensors — that is where stripes from many objects get packed into one launch.
Those return tensors on the codec's device; the byte API brings them to the
host explicitly (`to_host`).
"""

from __future__ import annotations

import errno
from collections import OrderedDict
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.common.perf_counters import PerfCounters

SIMD_ALIGN = 32  # reference: ErasureCode.cc:42 (bufferlist alignment for SIMD)

ErasureCodeProfile = dict  # str -> str, as in ErasureCodeInterface.h:155


def to_host(x) -> np.ndarray:
    """A codec result as a host numpy array (copies a device tensor back;
    `.cpu()` waits for the kernel that produced it)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


_NUMPY_DTYPE = {torch.uint8: np.uint8, torch.int32: np.int32}


def to_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a `dtype` tensor on `device` (read-only or
    strided numpy buffers are copied before torch sees them). Host input is
    copied to `device`; a tensor on another kind of device raises, so a CPU
    codec never pulls card data back to compute it on the host."""
    if isinstance(x, torch.Tensor):
        if x.dtype != dtype:
            raise TypeError(f"expected a {dtype} tensor, got {x.dtype}")
        if x.device.type not in ("cpu", device.type):
            raise ValueError(
                f"tensor on {x.device} given to a codec on {device}: "
                "move it, or build the codec on that device"
            )
        return x.to(device)
    arr = np.asarray(x, dtype=_NUMPY_DTYPE[dtype])
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


class ErasureCodeError(Exception):
    """Error with an errno, mirroring the reference's int return codes."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class DecodeTableCache:
    """LRU memo for per-erasure-signature decode tables — the analogue of
    the reference's ErasureCodeIsaTableCache (LRU keyed on the erasure
    signature, ErasureCodeIsaTableCache.cc:234-296). Shared by every codec
    that inverts a matrix per erasure pattern."""

    #: reference LRU is sized for <=(12,4) patterns
    DEFAULT_CAPACITY = 256

    #: lookups that found their tables, lookups that built them, and
    #: entries dropped at capacity, over every cache of the process: one
    #: add a lookup, read by the `ec_codec` perf block (`CodecCounters`)
    hits = 0
    misses = 0
    evictions = 0

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._entries: OrderedDict = OrderedDict()
        self._capacity = capacity

    def get_or(self, key, build: Callable):
        entry = self._entries.get(key)
        if entry is not None:
            DecodeTableCache.hits += 1
            self._entries.move_to_end(key)
            return entry
        DecodeTableCache.misses += 1
        entry = self._entries[key] = build()
        if len(self._entries) > self._capacity:
            DecodeTableCache.evictions += 1
            self._entries.popitem(last=False)
        return entry

    def clear(self) -> None:
        self._entries.clear()


class CodecCounters(PerfCounters):
    """The `ec_codec` perf block: the decode-table caches' hits, misses
    and evictions and the codec kernels' launches. Nothing is counted
    here: `dump()` reads the counts where the hot path keeps them (the
    `DecodeTableCache` class attributes, the wrappers' `.launches`), so
    they are process-wide and always on."""

    def __init__(self):
        super().__init__("ec_codec")
        for key, desc in (
            ("decode_table_hits", "decode-table lookups that found their tables"),
            ("decode_table_misses", "decode-table lookups that built their tables"),
            ("decode_table_evictions", "decode tables dropped at the cache's capacity"),
        ):
            self.add_u64_counter(key, desc)
        for name in self.wrappers():
            self.add_u64_counter(f"{name}_launches", f"{name} kernel launches")

    @staticmethod
    def wrappers() -> dict:
        """The codec kernels' wrappers by name, each counting its launches
        in `.launches` (a CPU tensor runs the plain version, counted by none)."""
        from ceph_tpu_torch.ops import gf_bitplane, gf_cuda

        return {"gf_matmul_packed": gf_cuda.gf_matmul_packed,
                "xor_reduce_words": gf_cuda.xor_reduce_words,
                "gf_matmul_bitplane": gf_bitplane.gf_matmul_bitplane,
                "xor_reduce": gf_bitplane.xor_reduce}

    def dump(self) -> dict:
        self.set("decode_table_hits", DecodeTableCache.hits)
        self.set("decode_table_misses", DecodeTableCache.misses)
        self.set("decode_table_evictions", DecodeTableCache.evictions)
        for name, wrapper in self.wrappers().items():
            self.set(f"{name}_launches", int(wrapper.launches))
        return super().dump()


#: the process's `ec_codec` block; a daemon adds it to its perf collection
codec_perf = CodecCounters()


def profile_to_int(profile: ErasureCodeProfile, name: str, default: int) -> int:
    value = profile.get(name, "")
    if value == "":
        profile[name] = str(default)
        return default
    try:
        return int(value, 10)
    except ValueError:
        raise ErasureCodeError(
            errno.EINVAL, f"could not convert {name}={value!r} to int"
        ) from None


def profile_to_bool(profile: ErasureCodeProfile, name: str, default: bool) -> bool:
    value = profile.get(name, "")
    if value == "":
        profile[name] = "true" if default else "false"
        return default
    return value in ("yes", "true")


def profile_to_string(profile: ErasureCodeProfile, name: str, default: str) -> str:
    value = profile.get(name, "")
    if value == "":
        profile[name] = default
        return default
    return value


class ErasureCode:
    """Abstract codec. Concrete codecs set self.k / self.m in parse() and
    implement encode_array/decode_array (+ optionally sharper minimum_to_decode).
    """

    #: True when parity byte column c depends ONLY on data byte column c
    #: (a pure per-column GF matmul). That property is what lets the OSD
    #: re-encode just the column windows a partial overwrite touches
    #: (sub-stripe RMW); codecs with cross-column coupling (CLAY's paired
    #: planes, LRC/SHEC layer compositions unless proven) leave it False
    #: and take the whole-object RMW path.
    column_independent = False

    def __init__(self):
        self.k = 0
        self.m = 0
        self.chunk_mapping: list[int] = []
        self.profile: ErasureCodeProfile = {}

    # -- profile / geometry -------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> "ErasureCode":
        self.profile = profile
        self.parse(profile)
        self.prepare()
        return self

    def parse(self, profile: ErasureCodeProfile) -> None:
        self._parse_mapping(profile)

    def prepare(self) -> None:
        pass

    def _parse_mapping(self, profile: ErasureCodeProfile) -> None:
        # 'D' marks a data position; others are coding (ErasureCode.cc:274).
        # Must be called after k/m are known: a mapping whose length is not
        # k+m (or with the wrong number of 'D's) is rejected as the reference
        # does (ErasureCodeJerasure.cc:69-75), else chunks would silently map
        # to out-of-range physical positions.
        mapping = profile.get("mapping")
        if mapping is None:
            self.chunk_mapping = []
            return
        data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
        if len(mapping) != self.get_chunk_count() or len(data_pos) != self.k:
            raise ErasureCodeError(
                errno.EINVAL,
                f"mapping {mapping!r} needs length k+m={self.get_chunk_count()}"
                f" with exactly k={self.k} 'D' positions",
            )
        self.chunk_mapping = data_pos + coding_pos

    def sanity_check_k_m(self) -> None:
        if self.k < 2:
            raise ErasureCodeError(errno.EINVAL, f"k={self.k} must be >= 2")
        if self.m < 1:
            raise ErasureCodeError(errno.EINVAL, f"m={self.m} must be >= 1")

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_sub_chunk_count(self) -> int:
        return 1

    def get_chunk_size(self, object_size: int) -> int:
        raise NotImplementedError

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    def chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    def logical_index(self, physical: int) -> int:
        """Inverse of chunk_index."""
        if not self.chunk_mapping:
            return physical
        return self.chunk_mapping.index(physical)

    # -- minimum_to_decode --------------------------------------------------

    def _minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> set[int]:
        """Default: wanted chunks if all present, else the first k available
        (ErasureCode.cc:103-121)."""
        if want_to_read <= available:
            return set(want_to_read)
        if len(available) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough chunks to decode")
        return set(sorted(available)[: self.k])

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        """{chunk: [(sub_chunk_offset, sub_chunk_count)]} — whole chunks by
        default (ErasureCode.cc:122-137)."""
        chosen = self._minimum_to_decode(want_to_read, available)
        whole = [(0, self.get_sub_chunk_count())]
        return {c: list(whole) for c in chosen}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int]
    ) -> set[int]:
        return self._minimum_to_decode(want_to_read, set(available))

    # -- array-level API (the device entry points) --------------------------

    def encode_array(self, data: np.ndarray) -> np.ndarray:
        """(batch, k, chunk) uint8 -> (batch, m, chunk) parity, logical order."""
        raise NotImplementedError

    def decode_array(
        self,
        present: Sequence[int],
        targets: Sequence[int],
        survivors: np.ndarray,
    ) -> np.ndarray:
        """Rebuild logical chunks `targets` from the first k of logical chunks
        `present`: survivors (batch, >=k, chunk) -> (batch, len(targets), chunk).
        """
        raise NotImplementedError

    # -- byte-level API (reference-compatible) ------------------------------

    def encode_prepare(self, data: bytes) -> tuple[np.ndarray, int]:
        """Pad + split an object into a (1, k, blocksize) uint8 tensor."""
        blocksize = self.get_chunk_size(len(data))
        padded = np.zeros(self.k * blocksize, dtype=np.uint8)
        padded[: len(data)] = np.frombuffer(data, dtype=np.uint8)
        return padded.reshape(1, self.k, blocksize), blocksize

    def encode(
        self, want_to_encode: Iterable[int], data: bytes
    ) -> dict[int, bytes]:
        """Returns {physical chunk id: chunk bytes} for the wanted ids
        (ErasureCode.cc:188-209)."""
        want = set(want_to_encode)
        bad = [i for i in want if not 0 <= i < self.get_chunk_count()]
        if bad:
            raise ErasureCodeError(errno.EINVAL, f"invalid chunk ids {bad}")
        chunks, _ = self.encode_prepare(data)
        parity = to_host(self.encode_array(chunks))
        out: dict[int, bytes] = {}
        for logical in range(self.get_chunk_count()):
            physical = self.chunk_index(logical)
            if physical not in want:
                continue
            if logical < self.k:
                out[physical] = chunks[0, logical].tobytes()
            else:
                out[physical] = parity[0, logical - self.k].tobytes()
        return out

    def decode(
        self, want_to_read: Iterable[int], chunks: Mapping[int, bytes]
    ) -> dict[int, bytes]:
        """Return the wanted physical chunks, rebuilding missing ones from >= k
        survivors (ErasureCode.cc:212-248)."""
        want = set(want_to_read)
        have = set(chunks)
        if want <= have:
            return {i: bytes(chunks[i]) for i in want}
        if len(have) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough chunks to decode")
        blocksize = len(next(iter(chunks.values())))
        present_logical = sorted(self.logical_index(p) for p in have)
        missing = sorted(want - have)
        targets_logical = [self.logical_index(p) for p in missing]
        survivors = np.stack(
            [
                np.frombuffer(chunks[self.chunk_index(l)], dtype=np.uint8)
                for l in present_logical
            ]
        )[None, :, :]
        rebuilt = to_host(
            self.decode_array(present_logical, targets_logical, survivors)
        )
        out = {i: bytes(chunks[i]) for i in want & have}
        for pos, physical in enumerate(missing):
            out[physical] = rebuilt[0, pos].tobytes()
        assert all(len(v) == blocksize for v in out.values())
        return out

    def _decode_bytes_ungated(
        self, want_to_read, chunks: Mapping[int, bytes], decode_physical
    ) -> dict[int, bytes]:
        """Byte-level decode WITHOUT the >= k survivor gate, for codecs that
        can rebuild from fewer than k chunks (shec, lrc). `decode_physical`
        is (present, targets, survivors) -> (batch, len(targets), chunk);
        chunk ids are physical positions and recoverability errors are its
        job to raise."""
        want = set(want_to_read)
        have = set(chunks)
        if want <= have:
            return {i: bytes(chunks[i]) for i in want}
        if not have:
            raise ErasureCodeError(errno.EIO, "no chunks to decode from")
        present = sorted(have)
        missing = sorted(want - have)
        survivors = np.stack(
            [np.frombuffer(chunks[i], dtype=np.uint8) for i in present]
        )[None, :, :]
        rebuilt = to_host(decode_physical(present, missing, survivors))
        out = {i: bytes(chunks[i]) for i in want & have}
        for pos, i in enumerate(missing):
            out[i] = rebuilt[0, pos].tobytes()
        return out

    def decode_concat(self, chunks: Mapping[int, bytes]) -> bytes:
        """Concatenate the data chunks in logical order (ErasureCode.cc:344+)."""
        want = {self.chunk_index(i) for i in range(self.k)}
        decoded = self.decode(want, chunks)
        return b"".join(decoded[self.chunk_index(i)] for i in range(self.k))


def align_up(value: int, alignment: int) -> int:
    return value + (alignment - value % alignment) % alignment


def chunk_size_isa_style(k: int, object_size: int, alignment: int) -> int:
    """ceil(size/k) rounded up to `alignment` (ErasureCodeIsa.cc:66-79)."""
    return align_up(max(1, (object_size + k - 1) // k), alignment)


def chunk_size_jerasure_style(
    k: int, object_size: int, alignment: int, per_chunk_alignment: bool
) -> int:
    """Jerasure pads the whole object to `alignment` then splits, unless
    per_chunk_alignment (ErasureCodeJerasure.cc:80-103)."""
    if per_chunk_alignment:
        return align_up(max(1, (object_size + k - 1) // k), alignment)
    padded = align_up(object_size, alignment)
    assert padded % k == 0
    return padded // k
