"""CLAY (Coupled LAYer) MSR regenerating code, on the port's kernels.

Port of ceph_tpu/ec/clay.py, which re-expresses the reference's clay plugin
(src/erasure-code/clay/ErasureCodeClay.{h,cc}, IISc): an (k, m, d) vector
code that wraps a scalar MDS code and couples its codewords across q^t
sub-chunk "planes" so that repairing ONE lost chunk reads only a 1/q
fraction (sub_chunk_no/q sub-chunks) of each of d helper chunks — the
minimum-storage-regenerating (MSR) point.

Geometry (parse, ErasureCodeClay.cc:188-302): q = d-k+1, nu pads k+m to a
multiple of q, t = (k+m+nu)/q, sub_chunk_no = q^t. Nodes live on a (t x q)
grid; node_xy = y*q + x; data chunks are nodes 0..k-1, nu virtual zero chunks
k..k+nu-1, parity chunks map to nodes k+nu..q*t-1. A plane z in [0, q^t) has
base-q digit vector z_vec (get_plane_vector, .cc:888-894).

Coupling: in plane z, node (x, y) with z_vec[y] != x pairs with node
(z_vec[y], y) in plane z_sw (z with digit y replaced by x). The pair's
coupled values (C_hi, C_lo) and uncoupled values (U_hi, U_lo) — hi is the
point whose x exceeds its plane digit — form one codeword of a (k=2, m=2)
scalar "pft" code, so ANY two of the four determine the rest
(get_uncoupled_from_coupled / get_coupled_from_uncoupled / recover_type1,
.cc:776-871). Dot points (z_vec[y] == x) have U == C.

Decode is layered (decode_layered, .cc:647-712): planes are processed in
increasing "intersection score" order (number of erased nodes whose x equals
their plane digit); each group computes U for intact nodes from coupled data
recovered in earlier groups, MDS-decodes the erased nodes' U across the plane
(decode_uncoupled -> the scalar mds code), then maps U back to C.

Where it runs, as in the JAX package: the plane schedule and the pairwise
coupling (GF(2^8) axpy on whole plane slices, ceph_tpu_torch.ops.gf) are
host numpy; the per-plane MDS decodes of each order group are batched into
one (group, k+nu, columns) `decode_array` call of the inner codec, built on
this codec's device, so on a card each group is one launch of the GF(2^8)
matmul kernel (its survivors copied there and its output back). The codec's
array results are tensors on its device.
"""

from __future__ import annotations

import errno
import itertools
from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import (
    ErasureCode,
    ErasureCodeError,
    align_up,
    profile_to_int,
    profile_to_string,
    to_host,
)
from ceph_tpu_torch.ops import gf


def _pow_int(a: int, x: int) -> int:
    return a ** x


class ErasureCodeClay(ErasureCode):
    DEFAULT_K = 4
    DEFAULT_M = 2

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.d = 0
        self.w = 8
        self.q = self.t = self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None  # scalar MDS over k+nu data / m parity (plane decode)
        self.pft = None  # (2,2) pairwise coupling transform code
        self._G4: np.ndarray | None = None  # (4,2) pair generator

    # -- profile -------------------------------------------------------------

    def parse(self, profile) -> None:
        self.k = profile_to_int(profile, "k", self.DEFAULT_K)
        self.m = profile_to_int(profile, "m", self.DEFAULT_M)
        self.sanity_check_k_m()
        self.d = profile_to_int(profile, "d", self.k + self.m - 1)
        scalar_mds = profile_to_string(profile, "scalar_mds", "jerasure")
        # deviation from the reference: scalar_mds=shec is accepted there
        # (ErasureCodeClay.cc:207) but SHEC(2,2,c=2) has no systematic
        # [I; P] generator to derive the pairwise transform from; this
        # implementation supports the MDS wrappers only
        if scalar_mds not in ("jerasure", "isa"):
            raise ErasureCodeError(
                errno.EINVAL,
                f"scalar_mds {scalar_mds!r} is not supported here, use "
                "one of 'jerasure', 'isa'",
            )
        technique = profile_to_string(profile, "technique", "reed_sol_van")
        # liber8tion (allowed by the reference, .cc:232) is omitted until the
        # bitmatrix techniques land in the jerasure family
        allowed = {
            "jerasure": ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                         "cauchy_good"),
            "isa": ("reed_sol_van", "cauchy"),
        }[scalar_mds]
        if technique not in allowed:
            raise ErasureCodeError(
                errno.EINVAL,
                f"technique {technique!r} is not currently supported for "
                f"scalar_mds={scalar_mds}, use one of {allowed}",
            )
        if technique == "reed_sol_r6_op" and self.m != 2:
            # the inner jerasure codec coerces its m to 2 for RAID6; with
            # CLAY's m baked into the plane geometry that coercion would
            # desynchronize the two, so require agreement up front
            raise ErasureCodeError(
                errno.EINVAL, "technique=reed_sol_r6_op requires m=2"
            )
        if not self.k <= self.d <= self.k + self.m - 1:
            raise ErasureCodeError(
                errno.EINVAL,
                f"value of d {self.d} must be within "
                f"[{self.k},{self.k + self.m - 1}]",
            )
        self.q = self.d - self.k + 1
        self.nu = (-(self.k + self.m)) % self.q
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeError(errno.EINVAL, "k+m+nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = _pow_int(self.q, self.t)
        self._scalar_mds = scalar_mds
        self._technique = technique
        self._parse_mapping(profile)

    def prepare(self) -> None:
        from ceph_tpu_torch.ec.registry import registry

        mds_profile = {
            "k": str(self.k + self.nu), "m": str(self.m), "w": "8",
            "technique": self._technique,
        }
        pft_profile = {"k": "2", "m": "2", "w": "8",
                       "technique": self._technique}
        self.mds = registry.factory(self._scalar_mds, mds_profile, self.device)
        self.pft = registry.factory(self._scalar_mds, pft_profile, self.device)
        # (4, 2) pair generator: rows (C_hi, C_lo, U_hi, U_lo) over the
        # variables (C_hi, C_lo); any 2 rows invert (the pft code is MDS).
        # The 6 possible 2x2 inverses are precomputed — _pair_solve runs in
        # every plane of every decode/repair
        pft_parity = np.asarray(self.pft._gen[2:4], dtype=np.uint8)
        self._G4 = np.concatenate([np.eye(2, dtype=np.uint8), pft_parity])
        self._pair_inv = {
            rows: gf.gf_invert_matrix(self._G4[list(rows)])
            for rows in itertools.combinations(range(4), 2)
        }

    # -- geometry ------------------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, object_size: int) -> int:
        # reference: alignment = sub_chunk_no * k * pft.get_chunk_size(1)
        # (ErasureCodeClay.cc:90-96)
        alignment = self.sub_chunk_no * self.k * self.pft.get_chunk_size(1)
        return align_up(max(1, object_size), alignment) // self.k

    # -- node/plane helpers ----------------------------------------------------

    def _node_of(self, chunk: int) -> int:
        """Logical chunk id -> grid node id (parities shift past virtuals)."""
        return chunk if chunk < self.k else chunk + self.nu

    def _chunk_of(self, node: int) -> int | None:
        """Grid node id -> logical chunk id (None for virtual nodes)."""
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None
        return node - self.nu

    def _plane_digits(self) -> np.ndarray:
        """(sub_chunk_no, t) base-q digits; column y is z_vec[y]
        (get_plane_vector: z_vec[t-1-i] = z-th least significant digit)."""
        z = np.arange(self.sub_chunk_no)
        digits = np.empty((self.sub_chunk_no, self.t), dtype=np.int64)
        for i in range(self.t):
            digits[:, self.t - 1 - i] = z % self.q
            z = z // self.q
        return digits

    # -- pairwise transform ----------------------------------------------------

    def _pair_solve(
        self, knowns: dict[int, np.ndarray], targets: Sequence[int]
    ) -> list[np.ndarray]:
        """Solve the (2,2) pair code: given 2 of (C_hi, C_lo, U_hi, U_lo)
        (positions 0..3), return the requested positions. Vectorized over
        arbitrary array shapes."""
        rows = sorted(knowns)[:2]
        v0, v1 = knowns[rows[0]], knowns[rows[1]]

        def lin2(a, x, b, y):
            return gf.gf_mul(a, x) ^ gf.gf_mul(b, y)

        if rows == [0, 1]:  # knowns ARE the variables; skip the identity solve
            c_hi, c_lo = v0, v1
        else:
            Minv = self._pair_inv[tuple(rows)]
            c_hi = lin2(Minv[0, 0], v0, Minv[0, 1], v1)
            c_lo = lin2(Minv[1, 0], v0, Minv[1, 1], v1)
        out = []
        for tpos in targets:
            if tpos == 0:
                out.append(c_hi)
            elif tpos == 1:
                out.append(c_lo)
            else:
                a, b = self._G4[tpos]
                out.append(lin2(a, c_hi, b, c_lo))
        return out

    def _pair_at(self, x: int, y: int, z: int, digits: np.ndarray):
        """For node (x,y) in plane z: (node_sw, z_sw, is_hi)."""
        dig = int(digits[z, y])
        node_sw = y * self.q + dig
        z_sw = z + (x - dig) * _pow_int(self.q, self.t - 1 - y)
        return node_sw, z_sw, x > dig, dig

    # -- layered decode (shared by encode and full-chunk decode) ---------------

    def _decode_layered(self, erased: set[int], C: np.ndarray) -> None:
        """Recover C[node, z, :] for erased nodes in place.

        C: (q*t, sub_chunk_no, cols) uint8; intact entries filled, erased
        entries arbitrary. Mirrors decode_layered (ErasureCodeClay.cc:647-712)
        with the per-plane MDS decodes of each order group batched.
        """
        q, t, k, m, nu = self.q, self.t, self.k, self.m, self.nu
        qt = q * t
        S = self.sub_chunk_no
        erased = set(erased)
        if not erased:
            return
        if len(erased) > m:
            raise ErasureCodeError(errno.EIO, "too many erasures")
        # pad erasures to exactly m with unwanted parity nodes (.cc:658-664)
        for i in range(k + nu, qt):
            if len(erased) >= m:
                break
            erased.add(i)
        digits = self._plane_digits()

        # order[z] = #erased nodes whose x equals their plane digit (.cc:763)
        order = np.zeros(S, dtype=np.int64)
        for node in erased:
            x, y = node % q, node // q
            order += digits[:, y] == x

        U = np.zeros_like(C)
        present_nodes = [i for i in range(qt) if i not in erased]
        targets = sorted(erased)

        for iscore in range(int(order.max()) + 1):
            zs = np.nonzero(order == iscore)[0]
            if zs.size == 0:
                continue
            # phase 1: uncoupled values of intact nodes (decode_erasures,
            # .cc:714-741) — vectorized over the group's planes
            for node in present_nodes:
                x, y = node % q, node // q
                dig = digits[zs, y]
                z_sw = zs + (x - dig) * _pow_int(q, t - 1 - y)
                node_sw = y * q + dig
                c_xy = C[node, zs]  # (G, cols)
                c_sw = C[node_sw, z_sw]
                hi = dig < x
                dot = dig == x
                # hi view: (C_hi, C_lo) = (c_xy, c_sw); lo view swapped.
                # the lo value is computed unconditionally: when the pair is
                # intact this reproduces the value the reference writes from
                # the pair's hi-side pass (same C inputs), when erased the
                # pair's C was recovered in the previous order group
                u_hi = self._pair_solve({0: c_xy, 1: c_sw}, [2])[0]
                u_lo = self._pair_solve({0: c_sw, 1: c_xy}, [3])[0]
                U[node, zs] = np.where(
                    dot[:, None], c_xy, np.where(hi[:, None], u_hi, u_lo)
                )
            # phase 2: batched MDS decode of erased U rows (decode_uncoupled,
            # .cc:743-761): survivors (G, k+nu, cols) -> (G, m', cols)
            surv = np.stack([U[n][zs] for n in present_nodes[: k + nu]], axis=1)
            rebuilt = to_host(
                self.mds.decode_array(present_nodes, targets, surv)
            )
            for pos, node in enumerate(targets):
                U[node, zs] = rebuilt[:, pos]
            # phase 3: recover coupled values of erased nodes (.cc:686-708),
            # vectorized over the group's planes
            erased_mask = np.zeros(qt, dtype=bool)
            erased_mask[sorted(erased)] = True
            for node in sorted(erased):
                x, y = node % q, node // q
                dig = digits[zs, y]
                z_sw = zs + (x - dig) * _pow_int(q, t - 1 - y)
                node_sw = y * q + dig
                pair_erased = erased_mask[node_sw]
                dot = dig == x
                hi = dig < x
                u_own = U[node, zs]
                u_sw = U[node_sw, z_sw]
                c_sw = C[node_sw, z_sw]
                # type-1: C_xy from intact C_sw + own U (.cc:776-812)
                t1 = np.where(
                    hi[:, None],
                    self._pair_solve({1: c_sw, 2: u_own}, [0])[0],
                    self._pair_solve({0: c_sw, 3: u_own}, [1])[0],
                )
                # both erased: full pair from both U (.cc:814-839); done once
                # from the hi perspective, which also writes the lo partner
                both_hi, both_lo = self._pair_solve({2: u_own, 3: u_sw}, [0, 1])
                val = np.where(
                    dot[:, None],
                    u_own,
                    np.where(
                        ~pair_erased[:, None],
                        t1,
                        np.where(hi[:, None], both_hi, C[node, zs]),
                    ),
                )
                C[node, zs] = val
                scatter = hi & pair_erased
                if scatter.any():
                    C[node_sw[scatter], z_sw[scatter]] = both_lo[scatter]

    # -- chunk-array assembly --------------------------------------------------

    def _grid_arrays(self, chunks: Mapping[int, np.ndarray], cols: int):
        """(q*t, S, cols) C array with virtual nodes zeroed; chunks maps
        logical chunk id -> (S, cols) uint8."""
        C = np.zeros((self.q * self.t, self.sub_chunk_no, cols), dtype=np.uint8)
        for chunk_id, arr in chunks.items():
            C[self._node_of(chunk_id)] = arr
        return C

    def _host(self, x) -> np.ndarray:
        """An array argument as host numpy for the plane schedule. A tensor
        must be uint8 on the host or on the codec's kind of device, as
        `to_device` demands of the other codecs' inputs."""
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.uint8:
                raise TypeError(f"expected a torch.uint8 tensor, got {x.dtype}")
            if x.device.type not in ("cpu", self.device.type):
                raise ValueError(
                    f"tensor on {x.device} given to a codec on {self.device}: "
                    "move it, or build the codec on that device"
                )
            return x.cpu().numpy()
        return np.asarray(x, dtype=np.uint8)

    def encode_array(self, data) -> torch.Tensor:
        """(batch, k, chunk) -> (batch, m, chunk): parity via decode_layered
        with the parity nodes erased (encode_chunks, .cc:129-157); a tensor
        on the codec's device."""
        data = self._host(data)
        batch, k, chunk = data.shape
        S = self.sub_chunk_no
        if chunk % S:
            raise ErasureCodeError(
                errno.EINVAL, f"chunk size {chunk} not divisible by q^t={S}"
            )
        sc = chunk // S
        cols = batch * sc
        # (k, S, batch*sc): plane z of chunk j across the whole batch
        per_node = {
            j: np.moveaxis(data[:, j].reshape(batch, S, sc), 0, 1).reshape(S, cols)
            for j in range(k)
        }
        C = self._grid_arrays(per_node, cols)
        erased = {self._node_of(k + i) for i in range(self.m)}
        self._decode_layered(erased, C)
        out = np.empty((batch, self.m, chunk), dtype=np.uint8)
        for i in range(self.m):
            node = self._node_of(k + i)
            out[:, i] = np.moveaxis(
                C[node].reshape(S, batch, sc), 0, 1
            ).reshape(batch, chunk)
        return torch.from_numpy(out).to(self.device)

    def decode_array(self, present, targets, survivors) -> torch.Tensor:
        """Full-chunk decode: all survivor chunks participate (the layered
        decode needs every intact node, not just k of them)."""
        survivors = self._host(survivors)
        batch, _, chunk = survivors.shape
        S = self.sub_chunk_no
        if chunk % S:
            raise ErasureCodeError(
                errno.EINVAL, f"chunk size {chunk} not divisible by q^t={S}"
            )
        sc = chunk // S
        cols = batch * sc
        per_node = {
            p: np.moveaxis(
                survivors[:, idx].reshape(batch, S, sc), 0, 1
            ).reshape(S, cols)
            for idx, p in enumerate(present)
        }
        C = self._grid_arrays(per_node, cols)
        erased = {
            self._node_of(i)
            for i in range(self.k + self.m)
            if i not in set(present)
        }
        self._decode_layered(erased, C)
        out = np.empty((batch, len(targets), chunk), dtype=np.uint8)
        for pos, tgt in enumerate(targets):
            node = self._node_of(tgt)
            out[:, pos] = np.moveaxis(
                C[node].reshape(S, batch, sc), 0, 1
            ).reshape(batch, chunk)
        return torch.from_numpy(out).to(self.device)

    # -- repair (the MSR read-minimal path) ------------------------------------

    def is_repair(self, want_to_read: set[int], available: set[int]) -> bool:
        """Single lost chunk, whole q-group co-located, >= d helpers
        (is_repair, .cc:304-323). Ids are physical (as in the byte API) and
        are translated through chunk_mapping before the group-geometry test."""
        if want_to_read <= available:
            return False
        if len(want_to_read) > 1:
            return False
        want_to_read = {self.logical_index(p) for p in want_to_read}
        available = {self.logical_index(p) for p in available}
        lost = next(iter(want_to_read))
        lost_node = self._node_of(lost)
        for x in range(self.q):
            node = (lost_node // self.q) * self.q + x
            chunk = self._chunk_of(node)
            if chunk is None or chunk == lost:
                continue
            if chunk not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(offset, count) runs of the planes with digit y_lost == x_lost
        (get_repair_subchunks, .cc:363-377)."""
        y_lost, x_lost = lost_node // self.q, lost_node % self.q
        seq = _pow_int(self.q, self.t - 1 - y_lost)
        runs = []
        index = x_lost * seq
        for _ in range(_pow_int(self.q, y_lost)):
            runs.append((index, seq))
            index += self.q * seq
        return runs

    def get_repair_sub_chunk_count(self, want_to_read: set[int]) -> int:
        weight = [0] * self.t
        for c in want_to_read:
            weight[self._node_of(self.logical_index(c)) // self.q] += 1
        remaining = 1
        for y in range(self.t):
            remaining *= self.q - weight[y]
        return self.sub_chunk_no - remaining

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        want_to_read, available = set(want_to_read), set(available)
        if not self.is_repair(want_to_read, available):
            return super().minimum_to_decode(want_to_read, available)
        # minimum_to_repair (.cc:325-361): the lost node's q-group first,
        # then arbitrary helpers up to d, all reading the repair sub-chunks.
        # Group geometry is logical; the returned keys are the caller's
        # physical ids
        lost_node = self._node_of(
            self.logical_index(next(iter(want_to_read)))
        )
        runs = self.get_repair_subchunks(lost_node)
        minimum: dict[int, list[tuple[int, int]]] = {}
        for j in range(self.q):
            if j == lost_node % self.q:
                continue
            chunk = self._chunk_of((lost_node // self.q) * self.q + j)
            if chunk is not None:
                minimum[self.chunk_index(chunk)] = list(runs)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, list(runs))
        assert len(minimum) == self.d
        return minimum

    def repair_array(
        self, lost: int, helpers: Mapping[int, np.ndarray], batch_cols: int
    ) -> torch.Tensor:
        """Rebuild logical chunk `lost` from d helpers' repair sub-chunks.

        helpers: {logical chunk id: (S/q, cols) uint8} holding ONLY the repair
        planes (in ascending plane order, as minimum_to_decode requests them).
        Returns (S, cols), a tensor on the codec's device. Mirrors
        repair_one_lost_chunk (.cc:462-644), with each order group's planes
        processed as one batch: phase 1 is vectorized over the group, phase 2
        is a single batched MDS decode.
        """
        helpers = {c: self._host(a) for c, a in helpers.items()}
        q, t, k, m, nu = self.q, self.t, self.k, self.m, self.nu
        qt, S = q * t, self.sub_chunk_no
        lost_node = self._node_of(lost)
        digits = self._plane_digits()
        runs = self.get_repair_subchunks(lost_node)
        repair_planes = [
            z for (off, count) in runs for z in range(off, off + count)
        ]
        n_rep = len(repair_planes)
        plane_pos = np.full(S, -1, dtype=np.int64)
        plane_pos[repair_planes] = np.arange(n_rep)

        helper_nodes = {self._node_of(c): a for c, a in helpers.items()}
        for i in range(k, k + nu):  # virtual shortening nodes are zero
            helper_nodes[i] = np.zeros((n_rep, batch_cols), dtype=np.uint8)
        aloof = {
            n for n in range(qt)
            if n != lost_node and n not in helper_nodes
        }
        erasures = {
            (lost_node // q) * q + i for i in range(q)
        } | aloof
        if len(erasures) > m:
            raise ErasureCodeError(errno.EIO, "not repairable")

        # dense helper C view (zeros at the lost/aloof rows, masked out below)
        H = np.zeros((qt, n_rep, batch_cols), dtype=np.uint8)
        for node, arr in helper_nodes.items():
            H[node] = arr
        aloof_mask = np.zeros(qt, dtype=bool)
        aloof_mask[list(aloof)] = True

        # plane order: #({lost} ∪ aloof) hole-dot intersections (.cc:481-498)
        order_of = np.zeros(S, dtype=np.int64)
        for node in {lost_node} | aloof:
            order_of += digits[:, node // q] == node % q
        groups: dict[int, list[int]] = {}
        for z in repair_planes:
            groups.setdefault(int(order_of[z]), []).append(z)

        U = np.zeros((qt, S, batch_cols), dtype=np.uint8)
        u_known = np.zeros((qt, S), dtype=bool)
        C_lost = np.zeros((S, batch_cols), dtype=np.uint8)
        present_nodes = [i for i in range(qt) if i not in erasures]
        targets = sorted(erasures)

        for o in sorted(groups):
            zs = np.asarray(groups[o])
            # phase 1: uncoupled values of helper nodes (.cc:536-593),
            # vectorized over the group's planes
            for node in present_nodes:
                x, y = node % q, node // q
                dig = digits[zs, y]
                z_sw = zs + (x - dig) * _pow_int(q, t - 1 - y)
                node_sw = y * q + dig
                c_xy = H[node, plane_pos[zs]]  # (G, cols)
                c_sw = H[node_sw, plane_pos[z_sw]]
                u_sw = U[node_sw, z_sw]
                dot = dig == x
                hi = dig < x
                pair_aloof = aloof_mask[node_sw]
                # pair C of an aloof node is unavailable: its U from an
                # earlier (order-1) plane substitutes (.cc:553-566)
                assert bool(np.all(u_known[node_sw, z_sw] | ~pair_aloof))
                u_hi = self._pair_solve({0: c_xy, 1: c_sw}, [2])[0]
                u_lo = self._pair_solve({0: c_sw, 1: c_xy}, [3])[0]
                u_hi_al = self._pair_solve({0: c_xy, 3: u_sw}, [2])[0]
                u_lo_al = self._pair_solve({1: c_xy, 2: u_sw}, [3])[0]
                sel = np.where(
                    hi[:, None],
                    np.where(pair_aloof[:, None], u_hi_al, u_hi),
                    np.where(pair_aloof[:, None], u_lo_al, u_lo),
                )
                U[node, zs] = np.where(dot[:, None], c_xy, sel)
                u_known[node, zs] = True
            # phase 2: one batched MDS decode of erased U rows (.cc:595)
            surv = np.stack([U[n][zs] for n in present_nodes[: k + nu]], axis=1)
            rebuilt = to_host(
                self.mds.decode_array(present_nodes, targets, surv)
            )
            for pos, node in enumerate(targets):
                U[node, zs] = rebuilt[:, pos]
                u_known[node, zs] = True
            # phase 3: recover lost-chunk C sub-chunks (.cc:597-639).
            # On repair planes the lost node is always the hole-dot (its
            # digit equals x_lost), and every other non-aloof erasure is a
            # same-group helper whose pair is the lost node
            for node in targets:
                if node in aloof:
                    continue
                x, y = node % q, node // q
                if node == lost_node:
                    C_lost[zs] = U[node, zs]
                    continue
                dig = digits[zs, y]  # == x_lost on every repair plane
                z_sw = zs + (x - dig) * _pow_int(q, t - 1 - y)
                c_xy = H[node, plane_pos[zs]]
                if x > lost_node % q:  # node is hi, lost node is lo
                    C_lost[z_sw] = self._pair_solve(
                        {0: c_xy, 2: U[node, zs]}, [1]
                    )[0]
                else:
                    C_lost[z_sw] = self._pair_solve(
                        {1: c_xy, 3: U[node, zs]}, [0]
                    )[0]
        return torch.from_numpy(C_lost).to(self.device)

    # -- byte-level API overrides ----------------------------------------------

    def decode(
        self,
        want_to_read,
        chunks: Mapping[int, bytes],
        chunk_size: int | None = None,
    ) -> dict[int, bytes]:
        """Repair-aware decode (decode, .cc:109-125): when the provided
        buffers are the partial repair reads (shorter than chunk_size), run
        the sub-chunk repair path; otherwise fall back to full decode."""
        want = set(want_to_read)
        have = set(chunks)
        if chunks and chunk_size is not None and self.is_repair(want, have):
            some = len(next(iter(chunks.values())))
            if chunk_size > some:
                return self._repair_bytes(want, chunks, chunk_size)
        return super().decode(want, chunks)

    def _repair_bytes(
        self, want: set[int], chunks: Mapping[int, bytes], chunk_size: int
    ) -> dict[int, bytes]:
        lost = next(iter(want))
        repair_subchunks = self.sub_chunk_no // self.q
        repair_blocksize = len(next(iter(chunks.values())))
        if repair_blocksize % repair_subchunks:
            raise ErasureCodeError(errno.EINVAL, "bad repair block size")
        sc = repair_blocksize // repair_subchunks
        if sc * self.sub_chunk_no != chunk_size:
            raise ErasureCodeError(errno.EINVAL, "bad repair chunk size")
        if len(chunks) != self.d:
            raise ErasureCodeError(
                errno.EIO, f"repair needs exactly d={self.d} helpers"
            )
        helpers = {
            self.logical_index(c): np.frombuffer(b, dtype=np.uint8).reshape(
                repair_subchunks, sc
            )
            for c, b in chunks.items()
        }
        rebuilt = to_host(self.repair_array(self.logical_index(lost), helpers, sc))
        return {lost: rebuilt.reshape(-1).tobytes()}
