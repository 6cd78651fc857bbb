"""Plain GF(2^8) erasure-code reference for the benchmark's `correct`.

Written from the published algorithms alone, with numpy and torch and no
code of the program under test:

  * the field from log and antilog tables of a primitive polynomial
    (Ceph's isa and jerasure plugins: x^8+x^4+x^3+x^2+1, 0x11d, generator 2);
  * isa `cauchy`: ISA-L's gf_gen_cauchy1_matrix, parity entry (i, j) is
    1 / ((k + i) ^ j);
  * jerasure `reed_sol_van`: reed_sol.c's
    reed_sol_big_vandermonde_distribution_matrix, whose last m rows are
    the coding matrix;
  * decoding: the k x k rows of the generator that survive, inverted by
    Gauss-Jordan elimination, times the generator rows of the lost chunks;
  * encode and decode as a GF(2^8) matrix times chunk rows, by a 256 x 256
    product table gathered on the rows' own device, in column blocks.

`GF(poly, generator)` builds any field; the benchmark's control builds the
same codec over another polynomial (`CONTROL_FIELD`).
"""

from __future__ import annotations

import numpy as np
import torch

#: the field of Ceph's isa and jerasure plugins (w = 8)
CEPH_FIELD = (0x11D, 2)
#: the control's field: AES's polynomial, of which 3 is a primitive element
CONTROL_FIELD = (0x11B, 3)

#: elements gathered per step of `apply`: bounds its int64 index temporaries
BLOCK_ELEMENTS = 1 << 22


class GF:
    """GF(2^8) over `poly` with primitive element `generator`."""

    def __init__(self, poly: int, generator: int):
        exp = np.zeros(512, dtype=np.int64)
        log = np.full(256, -1, dtype=np.int64)
        x = 1
        for i in range(255):
            if log[x] != -1:
                raise ValueError(f"{generator:#x} is not primitive for {poly:#x}")
            exp[i] = x
            log[x] = i
            x = self._times_x(x, generator, poly)
        exp[255:510] = exp[:255]
        self.poly, self.exp, self.log = poly, exp, log
        a = np.arange(256)
        prod = exp[(log[a][:, None] + log[a][None, :]) % 255]
        prod[0, :] = 0
        prod[:, 0] = 0
        #: product table: table[a, b] = a * b
        self.table = prod.astype(np.uint8)

    @staticmethod
    def _times_x(x: int, g: int, poly: int) -> int:
        """x * g by shift-and-add, reduced by `poly`."""
        out = 0
        while g:
            if g & 1:
                out ^= x
            g >>= 1
            x <<= 1
            if x & 0x100:
                x ^= poly
        return out

    def mul(self, a: int, b: int) -> int:
        return int(self.table[a, b])

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("0 has no inverse in GF(2^8)")
        return int(self.exp[(255 - self.log[a]) % 255])

    def matmul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """(r, n) x (n, c) over the field."""
        out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
        for j in range(a.shape[1]):
            out ^= self.table[a[:, j][:, None], b[j][None, :]]
        return out

    def invert(self, mat: np.ndarray) -> np.ndarray:
        """Inverse of a square matrix by Gauss-Jordan; raises if singular."""
        n = mat.shape[0]
        a = np.concatenate([mat.astype(np.uint8), np.eye(n, dtype=np.uint8)], axis=1)
        for col in range(n):
            pivot = next((r for r in range(col, n) if a[r, col]), None)
            if pivot is None:
                raise ValueError("singular matrix")
            a[[col, pivot]] = a[[pivot, col]]
            a[col] = self.table[self.inv(int(a[col, col])), a[col]]
            for r in range(n):
                if r != col and a[r, col]:
                    a[r] ^= self.table[int(a[r, col]), a[col]]
        return a[:, n:].copy()


def isa_cauchy(gf: GF, k: int, m: int) -> np.ndarray:
    """(m, k) parity rows of ISA-L's gf_gen_cauchy1_matrix."""
    return np.array([[gf.inv((k + i) ^ j) for j in range(k)] for i in range(m)],
                    dtype=np.uint8)


def jerasure_reed_sol_van(gf: GF, k: int, m: int) -> np.ndarray:
    """(m, k) coding matrix of jerasure's reed_sol_vandermonde_coding_matrix:
    the extended Vandermonde matrix, column operations that make its top
    k x k block the identity, then row k scaled to all ones by columns and
    each later row scaled so that its first entry is one."""
    rows = k + m
    d = np.zeros((rows, k), dtype=np.uint8)
    d[0, 0] = 1
    d[rows - 1, k - 1] = 1
    for i in range(1, rows - 1):
        p = 1
        for j in range(k):
            d[i, j] = p
            p = gf.mul(p, i)
    for i in range(1, k):
        j = next(r for r in range(i, rows) if d[r, i])
        if j != i:
            d[[i, j]] = d[[j, i]]
        if d[i, i] != 1:
            d[:, i] = gf.table[gf.inv(int(d[i, i])), d[:, i]]
        for j in range(k):
            e = int(d[i, j])
            if j != i and e:
                d[:, j] ^= gf.table[e, d[:, i]]
    for j in range(k):
        if d[k, j] != 1:
            d[k:, j] = gf.table[gf.inv(int(d[k, j])), d[k:, j]]
    for i in range(k + 1, rows):
        if d[i, 0] != 1:
            d[i] = gf.table[gf.inv(int(d[i, 0])), d[i]]
    return d[k:].copy()


CONSTRUCTIONS = {
    ("isa", "cauchy"): isa_cauchy,
    ("jerasure", "reed_sol_van"): jerasure_reed_sol_van,
}


class Codec:
    """The reference codec of one profile: its systematic (k+m, k) generator
    and, per lost-chunk signature, its decode matrix."""

    def __init__(self, plugin: str, profile: dict, field: tuple[int, int] = CEPH_FIELD):
        self.k, self.m = int(profile["k"]), int(profile["m"])
        technique = profile["technique"]
        try:
            build = CONSTRUCTIONS[(plugin, technique)]
        except KeyError:
            raise ValueError(f"no reference for plugin={plugin} "
                             f"technique={technique}") from None
        self.gf = GF(*field)
        parity = build(self.gf, self.k, self.m)
        self.gen = np.concatenate([np.eye(self.k, dtype=np.uint8), parity])

    def decode_matrix(self, present, targets) -> np.ndarray:
        """(len(targets), k) matrix that rebuilds `targets` from the chunks
        `present[:k]`."""
        rows = list(present)[: self.k]
        if len(rows) < self.k:
            raise ValueError("fewer than k chunks present")
        inv = self.gf.invert(self.gen[rows])
        return self.gf.matmul(self.gen[list(targets)], inv)

    def apply(self, mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
        """(r, k) GF matrix x chunk rows: data (..., k, L) uint8 -> (..., r, L),
        on data's device."""
        return apply(self.gf, mat, data)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """(..., k, L) data chunks -> (..., m, L) parity chunks."""
        return self.apply(self.gen[self.k:], data)

    def decode(self, present, targets, survivors: torch.Tensor) -> torch.Tensor:
        """(..., >=k, L) chunks `present` (the first k used) -> (..., len(targets), L)."""
        return self.apply(self.decode_matrix(present, targets), survivors[..., : self.k, :])


def apply(gf: GF, mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """out[..., i, :] = XOR over j of mat[i, j] * data[..., j, :], each
    product read from the field's table, in column blocks."""
    r, k = mat.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(f"data must be (..., {k}, L) uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    table = torch.from_numpy(gf.table).to(data.device)
    lead, length = data.shape[:-2], data.shape[-1]
    out = torch.zeros((*lead, r, length), dtype=torch.uint8, device=data.device)
    rows = max(1, int(np.prod(lead, dtype=np.int64)))
    step = max(1, BLOCK_ELEMENTS // rows)
    for c in range(0, length, step):
        for j in range(k):
            idx = data[..., j, c : c + step].to(torch.int64)
            for i in range(r):
                coef = int(mat[i, j])
                if coef:
                    out[..., i, c : c + step] ^= torch.take(table[coef], idx)
    return out
