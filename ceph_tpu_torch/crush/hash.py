"""CRUSH's Robert Jenkins hash — scalar and vectorized, bit-exact.

Reference: src/crush/hash.c (rjenkins1 mix, seed 1315423911).
The scalar path (python ints masked to 32 bits) drives the oracle mapper; the
numpy path evaluates whole arrays (the tester's pool-id hash). The tensor
version lives in torch_mapper.py, the CUDA one in csrc/crush_choose.cu.
"""

from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = 1315423911
CRUSH_HASH_RJENKINS1 = 0

_M = 0xFFFFFFFF


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b - c) & _M; a ^= c >> 13
    b = (b - c - a) & _M; b ^= (a << 8) & _M
    c = (c - a - b) & _M; c ^= b >> 13
    a = (a - b - c) & _M; a ^= c >> 12
    b = (b - c - a) & _M; b ^= (a << 16) & _M
    c = (c - a - b) & _M; c ^= b >> 5
    a = (a - b - c) & _M; a ^= c >> 3
    b = (b - c - a) & _M; b ^= (a << 10) & _M
    c = (c - a - b) & _M; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= _M
    h = CRUSH_HASH_SEED ^ a
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= _M; b &= _M
    h = CRUSH_HASH_SEED ^ a ^ b
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= _M; b &= _M; c &= _M
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= _M; b &= _M; c &= _M; d &= _M
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= _M; b &= _M; c &= _M; d &= _M; e &= _M
    h = CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


# -- vectorized (numpy uint32) ----------------------------------------------


def _mix_np(a, b, c):
    a = a - b - c; a ^= c >> np.uint32(13)
    b = b - c - a; b ^= a << np.uint32(8)
    c = c - a - b; c ^= b >> np.uint32(13)
    a = a - b - c; a ^= c >> np.uint32(12)
    b = b - c - a; b ^= a << np.uint32(16)
    c = c - a - b; c ^= b >> np.uint32(5)
    a = a - b - c; a ^= c >> np.uint32(3)
    b = b - c - a; b ^= a << np.uint32(10)
    c = c - a - b; c ^= b >> np.uint32(15)
    return a, b, c


def crush_hash32_3_np(a, b, c) -> np.ndarray:
    """Broadcasting 3-arg hash over uint32 arrays."""
    a = np.asarray(a).astype(np.uint32)
    b = np.asarray(b).astype(np.uint32)
    c = np.asarray(c).astype(np.uint32)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
    x = np.broadcast_to(np.uint32(231232), h.shape).copy()
    y = np.broadcast_to(np.uint32(1232), h.shape).copy()
    a, b, h = _mix_np(a, b, h)
    c, x, h = _mix_np(c, x, h)
    y, a, h = _mix_np(y, a, h)
    b, x, h = _mix_np(b, x, h)
    y, c, h = _mix_np(y, c, h)
    return h


def crush_hash32_2_np(a, b) -> np.ndarray:
    a = np.asarray(a).astype(np.uint32)
    b = np.asarray(b).astype(np.uint32)
    h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b
    x = np.broadcast_to(np.uint32(231232), h.shape).copy()
    y = np.broadcast_to(np.uint32(1232), h.shape).copy()
    a, b, h = _mix_np(a, b, h)
    x, a, h = _mix_np(x, a, h)
    b, y, h = _mix_np(b, y, h)
    return h
