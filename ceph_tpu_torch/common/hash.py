"""String hashes used for object -> PG placement.

ceph_str_hash_rjenkins is the default object-name hash
(src/common/ceph_hash.cc:21-78, Robert Jenkins' 96-bit mix):
the first step of the data path's placement function
(object name -> ps -> stable_mod -> pg -> CRUSH).
"""

from __future__ import annotations

_M = 0xFFFFFFFF


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b - c) & _M
    a ^= c >> 13
    b = (b - c - a) & _M
    b ^= (a << 8) & _M
    c = (c - a - b) & _M
    c ^= b >> 13
    a = (a - b - c) & _M
    a ^= c >> 12
    b = (b - c - a) & _M
    b ^= (a << 16) & _M
    c = (c - a - b) & _M
    c ^= b >> 5
    a = (a - b - c) & _M
    a ^= c >> 3
    b = (b - c - a) & _M
    b ^= (a << 10) & _M
    c = (c - a - b) & _M
    c ^= b >> 15
    return a, b, c


def ceph_str_hash_rjenkins(data: bytes | str) -> int:
    if isinstance(data, str):
        data = data.encode()
    length = len(data)
    a = b = 0x9E3779B9
    c = 0
    k = 0
    rem = length
    while rem >= 12:
        a = (a + int.from_bytes(data[k : k + 4], "little")) & _M
        b = (b + int.from_bytes(data[k + 4 : k + 8], "little")) & _M
        c = (c + int.from_bytes(data[k + 8 : k + 12], "little")) & _M
        a, b, c = _mix(a, b, c)
        k += 12
        rem -= 12
    c = (c + length) & _M
    tail = data[k:]
    shifts = [
        (10, "c", 24), (9, "c", 16), (8, "c", 8),
        (7, "b", 24), (6, "b", 16), (5, "b", 8), (4, "b", 0),
        (3, "a", 24), (2, "a", 16), (1, "a", 8), (0, "a", 0),
    ]
    for idx, reg, sh in shifts:
        if rem > idx:
            v = (tail[idx] << sh) & _M
            if reg == "a":
                a = (a + v) & _M
            elif reg == "b":
                b = (b + v) & _M
            else:
                c = (c + v) & _M
    a, b, c = _mix(a, b, c)
    return c
