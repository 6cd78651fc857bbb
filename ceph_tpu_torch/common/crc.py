"""ceph_crc32c — the Castagnoli CRC the reference uses everywhere.

Re-expresses src/include/crc32c.h (`ceph_crc32c(seed, data,
len)`) / src/common/sctp_crc32.c: CRC-32C (polynomial 0x1EDC6F41, reflected
0x82F63B78), bitwise-reflected in/out, NO final inversion — callers seed with
-1 themselves (e.g. the EC deep-scrub shard hashes, ECBackend.cc:2482
`bufferhash(-1)`, and ECUtil::HashInfo's cumulative shard hashes).

The C slicing-by-8 of native/crc32c.c is built into `_build/` at first
import and called through ctypes (`HAVE_NATIVE` says whether it loaded).
Without a compiler the byte loop runs over a numpy view with the same
tables, sliced eight bytes per step (`crc32c_numpy`): the same bits, on the
host either way. tests/test_torch_scrub.py holds both paths to the JAX
package's.
"""

from __future__ import annotations

import ctypes

import numpy as np

_POLY = 0x82F63B78


def _make_table() -> np.ndarray:
    table = np.zeros((8, 256), dtype=np.uint32)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table[0, n] = c
    for k in range(1, 8):
        for n in range(256):
            c = table[k - 1, n]
            table[k, n] = table[0, c & 0xFF] ^ (c >> 8)
    return table


_TABLE = _make_table()


def _load_native():
    """C slicing-by-8 via ctypes (ceph_tpu_torch/native/crc32c.c): the frame
    checksum and shard hashes are per-byte hot paths that a Python loop
    turns into the daemon's top CPU sink. Falls back to numpy silently
    (same bits either way; parity pinned in tests)."""
    try:
        import ctypes
        import os

        from ceph_tpu_torch.native.build import build_shared

        so = build_shared(
            "crc32c",
            os.path.join(
                os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)
                )),
                "native", "crc32c.c",
            ),
        )
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        fn = lib.ceph_crc32c_native
        fn.restype = ctypes.c_uint32
        fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        return fn
    # cephlint: disable=error-taxonomy (native-impl probe: any failure falls back to the python crc)
    except Exception:
        return None


_NATIVE = _load_native()

#: whether ceph_crc32c runs the C path (False: the numpy path)
HAVE_NATIVE = _NATIVE is not None


def ceph_crc32c(
    seed: int, data: bytes | np.ndarray, length: int | None = None
) -> int:
    """crc32c(seed, data[:length]) with ceph's conventions (no final xor).

    `length` checksums a prefix without materializing the slice — the wire
    read path hands the whole `payload+crc` buffer straight here. Chaining
    is supported the way the reference's bufferlist crc is: the return
    value is the raw register state, so crc(AB) == crc32c(crc32c(seed, A),
    B) — Frame.encode_parts exploits that to checksum a segment list
    without joining it first.
    """
    if _NATIVE is not None:
        if isinstance(data, memoryview) and data.contiguous:
            # the shm-ring receive path checksums loaned views; handing
            # the buffer address over directly keeps it zero-copy
            n = data.nbytes if length is None else min(length, data.nbytes)
            try:
                buf = (ctypes.c_char * data.nbytes).from_buffer(data)
                return int(_NATIVE(seed & 0xFFFFFFFF, buf, n))
            except TypeError:
                pass  # read-only exporter: fall through to the copy
        raw = data if isinstance(data, bytes) else bytes(data)
        n = len(raw) if length is None else min(length, len(raw))
        return int(_NATIVE(seed & 0xFFFFFFFF, raw, n))
    return crc32c_numpy(seed, data, length)


def crc32c_numpy(
    seed: int, data: bytes | np.ndarray, length: int | None = None
) -> int:
    """ceph_crc32c's numpy path (slice-by-8 over the same tables)."""
    crc = np.uint32(seed & 0xFFFFFFFF)
    buf = np.frombuffer(
        data if isinstance(data, (bytes, bytearray, memoryview))
        else bytes(data),
        dtype=np.uint8,
    )
    if length is not None:
        buf = buf[:length]
    t = _TABLE
    n8 = len(buf) // 8 * 8
    if n8:
        words = buf[:n8].reshape(-1, 8)
        for row in words:
            crc = np.uint32(
                t[7, (crc ^ row[0]) & np.uint32(0xFF)]
                ^ t[6, ((crc >> np.uint32(8)) ^ row[1]) & np.uint32(0xFF)]
                ^ t[5, ((crc >> np.uint32(16)) ^ row[2]) & np.uint32(0xFF)]
                ^ t[4, ((crc >> np.uint32(24)) ^ row[3]) & np.uint32(0xFF)]
                ^ t[3, row[4]] ^ t[2, row[5]] ^ t[1, row[6]] ^ t[0, row[7]]
            )
    for b in buf[n8:]:
        crc = np.uint32(t[0, (crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8)))
    return int(crc)
