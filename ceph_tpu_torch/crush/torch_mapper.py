"""Batched CRUSH mapper: crush_do_rule evaluated for a whole batch of x.

Counterpart of ceph_tpu/crush/jax_mapper.py, with the same public names. The
rule program is interpreted on the host into a sequence of choose stages;
each stage maps every x of the batch at once:

  * on a CUDA map, `ops/crush_cuda.crush_choose` launches the hand-written
    kernel of csrc/crush_choose.cu, one thread per x running the reference's
    per-x choose loop;
  * on a CPU map, the same wrapper runs `choose_stage_plain`, the torch-ops
    form of the stage (lockstep over the batch, as the JAX stages are). The
    tests and the on-card comparison use it; the card's main path does not.

Semantics reproduced exactly (bit-for-bit against mapper.py and
jax_mapper.py on every map shape the tests build):

  * straw2 draws: hash -> 16-bit u -> crush_ln -> truncating int64 division
    by the 16.16 weight -> first-argmax (mapper.c:334,361);
  * firstn: per-rep bounded retry, r' = r + ftotal, collision and is_out
    rejection, chooseleaf recursion with the leaf-collision scope and the
    vary_r/stable tunables (mapper.c:460);
  * indep: breadth-first positional retries, r' = r + numrep*ftotal, UNDEF ->
    NONE at the end (mapper.c:655);
  * EMIT: firstn blocks append placed entries only, indep blocks keep their
    positional NONE holes, everything past result_max is dropped.

Scope, as in jax_mapper.py: straw2 buckets, rjenkins1 hash, and
choose_local_tries == choose_local_fallback_tries == 0 (every tunable
profile from bobtail on); `supports()` says which rules qualify, and the
tester sends the others to the scalar mapper. Known divergences from the
scalar mapper, shared with jax_mapper.py and met only off well-formed maps: a
descent is bounded by the hierarchy's depth, and a chained stage keeps a NONE
entry of the working vector in place (an indep stage from it yields NONE
holes where the reference yields nothing).

Deliberate differences from jax_mapper.py, of interface and not of output:
no int16 packing of results, no `crush_chunk_size` config (`map_rule` takes
an explicit `chunk` and launches at the exact N, unpadded), no one-hot
`crush_ln_fast` (the tables are read directly), and no try-0 fan-out or
straggler compaction in the plain version. Everything is integer-exact.
"""

from __future__ import annotations

import copy
import functools
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch.crush.ln_tables import LL_TBL, RH_LH_TBL
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    BucketAlg,
    CrushMap,
    RuleOp,
)
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops import crush_cuda

MAX_DEPTH = 10  # CRUSH_MAX_DEPTH (crush.h:26)
#: x per launch on a CUDA map: the 1M-x tester run is one launch per stage
DEFAULT_CHUNK = 1 << 20
#: x per step on a CPU map: bounds the plain version's (x, bucket) temporaries
PLAIN_CHUNK = 1 << 14
_S64_MIN = -(2**63)
_M32 = 0xFFFFFFFF
_SEED = 1315423911


# -- integer primitives on tensors ---------------------------------------------
#
# torch's uint32 supports shifts and subtraction only in part, so 32-bit lanes
# ride int64 tensors masked back to 32 bits after every step that can leave
# them (the values stay in [0, 2^32) throughout).


def _u32(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.int64) & _M32


def _mix(a, b, c):
    a = (a - b - c) & _M32; a = a ^ (c >> 13)
    b = (b - c - a) & _M32; b = b ^ ((a << 8) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 13)
    a = (a - b - c) & _M32; a = a ^ (c >> 12)
    b = (b - c - a) & _M32; b = b ^ ((a << 16) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 5)
    a = (a - b - c) & _M32; a = a ^ (c >> 3)
    b = (b - c - a) & _M32; b = b ^ ((a << 10) & _M32)
    c = (c - a - b) & _M32; c = c ^ (b >> 15)
    return a, b, c


def hash32_3(a, b, c) -> torch.Tensor:
    """crush_hash32_3 (hash.c:48) over broadcast tensors; int64 in [0, 2^32)."""
    a, b, c = torch.broadcast_tensors(_u32(a), _u32(b), _u32(c))
    h = a ^ b ^ c ^ _SEED
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_2(a, b) -> torch.Tensor:
    """crush_hash32_2 over broadcast tensors; int64 in [0, 2^32)."""
    a, b = torch.broadcast_tensors(_u32(a), _u32(b))
    h = a ^ b ^ _SEED
    x = torch.full_like(h, 231232)
    y = torch.full_like(h, 1232)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def ln_tables_np() -> np.ndarray:
    """RH_LH (258) then LL (256) int64 entries: the kernel's shared-memory
    copy and the plain version's gather source."""
    return np.concatenate([RH_LH_TBL, LL_TBL]).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _ln_tables(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ln_tables_np()).to(device)


def crush_ln(xin: torch.Tensor) -> torch.Tensor:
    """2^44*log2(x+1) for 16-bit inputs (mapper.c:248), step by step from
    the RH/LH and LL tables; int64."""
    tbl = _ln_tables(xin.device)
    x = (xin.to(torch.int64) & 0xFFFF) + 1  # [1, 0x10000]
    bl = torch.zeros_like(x)
    v = x
    for s in (16, 8, 4, 2, 1):
        big = (v >> s) > 0
        bl = bl + torch.where(big, s, 0)
        v = torch.where(big, v >> s, v)
    bits = torch.where((x & 0x18000) == 0, 15 - bl, 0)  # __builtin_clz - 16
    x = x << bits
    iexpon = 15 - bits
    index1 = (x >> 8) << 1
    rh = tbl[index1 - 256]
    lh = tbl[index1 - 255]
    # (x * rh) >> 48 with x <= 2^16, rh <= 2^48: split rh at bit 24 so no
    # product leaves int64
    xl = (x * (rh >> 24) + ((x * (rh & 0xFFFFFF)) >> 24)) >> 24
    lh = lh + tbl[258 + (xl & 0xFF)]
    return (iexpon << 44) + (lh >> 4)


def straw2_draws(x, ids, rs, weights, valid) -> torch.Tensor:
    """Broadcast straw2 draws; weights 16.16 int64; zero weight or an invalid
    slot draws S64_MIN (mapper.c:361)."""
    u = hash32_3(x, ids, rs) & 0xFFFF
    ln = crush_ln(u) - (1 << 48)  # always <= 0
    draw = -torch.div(-ln, weights.clamp(min=1), rounding_mode="trunc")
    return torch.where(valid & (weights > 0), draw, _S64_MIN)


def argmax_draws(draws: torch.Tensor) -> torch.Tensor:
    """First index of the largest draw (the reference's `>` keeps the first,
    so an all-S64_MIN bucket picks slot 0)."""
    return torch.argmax(draws, dim=-1)


# -- compiled map ----------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CompiledMap:
    """Tensor form of a straw2 CrushMap, every tensor on `device`.

    One ragged layout serves the plain version and the kernel: bucket row b
    (rows in ascending bucket id) owns slots offsets[b] .. offsets[b] +
    sizes[b] of `items`, `ids` and `weights`. jax_mapper.py's padded table
    and per-bucket exact-width copies are gathers and slices of it here.
    Straw2 ids do not depend on the weight-set position, so `ids` has no
    position axis.
    """

    items: torch.Tensor           # (T,) int32: member ids
    ids: torch.Tensor             # (T,) int32: straw2 hash ids
    weights: torch.Tensor         # (P, T) int64: 16.16 weights per position
    offsets: torch.Tensor         # (B,) int32: first slot of each bucket row
    sizes: torch.Tensor           # (B,) int32
    row_of: torch.Tensor          # (max_buckets,) int32: -1-id -> row (or -1)
    type_of_bucket: torch.Tensor  # (B,) int32
    ln_tables: torch.Tensor       # (514,) int64: RH_LH then LL
    max_devices: int
    n_positions: int              # P (1 unless choose_args weight_sets)
    depth: int                    # longest root->device chain
    source: CrushMap
    device: torch.device
    #: rulenos the batched path may evaluate (per-rule scope, computed once)
    supported_rules: frozenset = frozenset()


def _reachable_buckets(cmap: CrushMap, ruleno: int) -> set[int]:
    """Bucket ids a rule can traverse: the closure of its TAKE roots."""
    out: set[int] = set()
    stack = [
        step.arg1 for step in cmap.rules[ruleno].steps
        if step.op == RuleOp.TAKE
    ]
    while stack:
        bid = stack.pop()
        if bid >= 0 or bid in out:
            continue
        out.add(bid)
        b = cmap.buckets.get(bid)
        if b is not None:
            stack.extend(i for i in b.items if i < 0)
    return out


def supports(cmap: CrushMap, ruleno: int | None = None) -> bool:
    """True if the batched path evaluates this map exactly: every rule by
    default, or ONE rule when `ruleno` is given (the gate is then scoped to
    the buckets that rule can reach, so a legacy bucket elsewhere in the map
    does not cost supported rules the batched path)."""
    if ruleno is not None and ruleno not in cmap.rules:
        return False
    t = cmap.tunables
    if t.choose_local_tries or t.choose_local_fallback_tries:
        return False
    rules = cmap.rules.values() if ruleno is None else [cmap.rules[ruleno]]
    for rule in rules:
        for step in rule.steps:
            if step.op in (RuleOp.SET_CHOOSE_LOCAL_TRIES,
                           RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES) \
                    and step.arg1 > 0:
                return False
    if ruleno is None:
        return all(b.alg == BucketAlg.STRAW2 for b in cmap.buckets.values())
    return all(
        cmap.buckets[bid].alg == BucketAlg.STRAW2
        for bid in _reachable_buckets(cmap, ruleno)
        if bid in cmap.buckets
    )


def _hierarchy_depth(cmap: CrushMap) -> int:
    depth: dict[int, int] = {}

    def depth_of(bid: int) -> int:
        if bid >= 0:
            return 0
        if bid in depth:
            return depth[bid]
        depth[bid] = MAX_DEPTH  # cycle guard
        b = cmap.buckets.get(bid)
        d = 1 + max((depth_of(i) for i in b.items), default=0) if b else 0
        depth[bid] = min(d, MAX_DEPTH)
        return depth[bid]

    return max((depth_of(b) for b in cmap.buckets), default=1)


def compile_map(cmap: CrushMap, positions: int = 0, device=None) -> CompiledMap:
    """Flatten the bucket hierarchy into tensors on `device` (default cuda).

    positions: number of straw2 weight-set positions to materialise (by
    default the longest choose_args weight_set; positions past it clamp to
    its last row, as get_choose_arg_weights does, mapper.c:310).
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ok = (
        any(supports(cmap, r) for r in cmap.rules)
        if cmap.rules else supports(cmap)
    )
    if not ok:
        raise ValueError("map not supported by the batched path")
    rows = sorted(cmap.buckets)
    if positions <= 0 and cmap.choose_args:
        positions = max(
            (len(ca.weight_set) for ca in cmap.choose_args.values()
             if ca.weight_set is not None),
            default=1,
        )
    p = max(1, positions if cmap.choose_args else 1)

    nb = max(len(rows), 1)
    total = max(sum(b.size for b in cmap.buckets.values()), 1)
    items = np.zeros(total, dtype=np.int32)
    ids = np.zeros(total, dtype=np.int32)
    weights = np.zeros((p, total), dtype=np.int64)
    offsets = np.zeros(nb, dtype=np.int32)
    sizes = np.zeros(nb, dtype=np.int32)
    types = np.zeros(nb, dtype=np.int32)
    row_of = np.full(max((-b for b in rows), default=1), -1, dtype=np.int32)
    off = 0
    for row, bid in enumerate(rows):
        b = cmap.buckets[bid]
        slots = slice(off, off + b.size)
        offsets[row], sizes[row], types[row] = off, b.size, b.type
        row_of[-1 - bid] = row
        items[slots] = b.items
        arg = cmap.choose_args.get(bid)
        ids[slots] = arg.ids if arg is not None and arg.ids is not None else b.items
        for pos in range(p):
            w = b.item_weights
            if arg is not None and arg.weight_set is not None:
                w = arg.weight_set[min(pos, len(arg.weight_set) - 1)]
            weights[pos, slots] = w
        off += b.size

    def t(a):
        return torch.from_numpy(a).to(dev)

    return CompiledMap(
        items=t(items),
        ids=t(ids),
        weights=t(weights),
        offsets=t(offsets),
        sizes=t(sizes),
        row_of=t(row_of),
        type_of_bucket=t(types),
        ln_tables=_ln_tables(dev),
        max_devices=cmap.max_devices,
        n_positions=p,
        depth=_hierarchy_depth(cmap),
        source=cmap,
        device=dev,
        supported_rules=frozenset(r for r in cmap.rules if supports(cmap, r)),
    )


# -- content-keyed compile cache --------------------------------------------------
#
# Tools re-decode the same map (the mgr each epoch, the tester per call); the
# fingerprint covers exactly what compile_map reads, so equal fingerprints
# give identical tensors and the cached instance is shared.


def _map_fingerprint(cmap: CrushMap, positions: int) -> str:
    t = cmap.tunables
    state = (
        positions,
        cmap.max_devices,
        tuple(
            (bid, b.type, int(b.alg), b.hash, b.weight, b.item_weight,
             tuple(b.items), tuple(b.item_weights))
            for bid, b in sorted(cmap.buckets.items())
        ),
        tuple(
            (rid, r.ruleset, r.type, r.min_size, r.max_size,
             tuple((int(s.op), s.arg1, s.arg2) for s in r.steps))
            for rid, r in sorted(cmap.rules.items())
        ),
        tuple(
            (bid,
             tuple(ca.ids) if ca.ids else None,
             tuple(map(tuple, ca.weight_set)) if ca.weight_set else None)
            for bid, ca in sorted(cmap.choose_args.items())
        ),
        (t.choose_local_tries, t.choose_local_fallback_tries,
         t.choose_total_tries, t.chooseleaf_descend_once,
         t.chooseleaf_vary_r, t.chooseleaf_stable, t.straw_calc_version),
    )
    return hashlib.sha256(repr(state).encode()).hexdigest()


_COMPILE_CACHE: dict[tuple[str, str], CompiledMap] = {}
_COMPILE_CACHE_MAX = 8


def compile_map_cached(cmap: CrushMap, positions: int = 0,
                       device=None) -> CompiledMap:
    """compile_map behind a small content-keyed cache (per device).

    The cached CompiledMap's `source` is a deep copy, so later mutation of
    the caller's CrushMap cannot skew an instance other callers still hold.
    Bounded FIFO: the tensors are device memory.
    """
    dev = resolve_device(device)
    key = (_map_fingerprint(cmap, positions), str(dev))
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        return hit
    cm = compile_map(copy.deepcopy(cmap), positions, dev)
    _COMPILE_CACHE[key] = cm
    while len(_COMPILE_CACHE) > _COMPILE_CACHE_MAX:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
    return cm


# -- runtime weight-sets -----------------------------------------------------------


def runtime_weight_arrays(compiled: CompiledMap,
                          weight_sets: dict[int, list[list[int]]]) -> torch.Tensor:
    """Weights for `map_rule(runtime_weights=...)`: the crush-compat
    balancer's candidate weight-sets, read in place of the compiled ones.

    weight_sets: bucket id -> per-position weight rows (16.16 ints; a shorter
    set clamps to its last row, as compile-time choose_args do). Buckets
    absent from the dict keep their compiled weights. Positions run to the
    longest override, P_rt, and every bucket reads position
    min(pos, P_rt - 1). Returns a (P_rt, T) int64 tensor on the map's
    device, in the layout of `compiled.weights`.
    """
    cmap = compiled.source
    p_rt = max((len(rows) for rows in weight_sets.values() if rows),
               default=1) or 1
    last = compiled.n_positions - 1
    weights = compiled.weights.cpu().numpy()[[min(pos, last) for pos in range(p_rt)]]
    offsets = compiled.offsets.cpu().numpy()
    row_of = {bid: i for i, bid in enumerate(sorted(cmap.buckets))}
    for bid, rows in weight_sets.items():
        bucket = cmap.buckets.get(bid)
        if bucket is None or not rows:
            continue
        off = offsets[row_of[bid]]
        for pos in range(p_rt):
            weights[pos, off:off + bucket.size] = rows[min(pos, len(rows) - 1)][:bucket.size]
    return torch.from_numpy(weights).to(compiled.device)


# -- the plain version of the choose stage -------------------------------------------
#
# Torch ops over the whole batch in lockstep, the form of jax_mapper.py's
# stage functions (_descend_b, _leaf_firstn_b, _firstn_try,
# _choose_firstn_static/_dynamic, _choose_indep_b) written out plainly.
# Lanes that finished early ride along masked; a retry loop ends when no lane
# needs it. A lane's leaf search stops at its first skip, as the reference's
# recursion does.


def _item_lookup(cm: CompiledMap, item: torch.Tensor):
    """(type, bucket row) per lane; devices 0 / -1; unknown buckets -1 / -1."""
    item = item.to(torch.int64)
    n_row_of = cm.row_of.shape[0]
    is_dev = item >= 0
    idx = -1 - item
    row = cm.row_of[idx.clamp(0, n_row_of - 1)].to(torch.int64)
    known = ~is_dev & (idx < n_row_of) & (row >= 0)
    t = torch.where(known, cm.type_of_bucket[row.clamp(min=0)].to(torch.int64), -1)
    return torch.where(is_dev, 0, t), torch.where(known, row, -1)


def _is_out(weight_vec: torch.Tensor, item: torch.Tensor, x: torch.Tensor):
    """mapper.c:424 against the 16.16 device weight vector."""
    n_w = weight_vec.shape[0]
    w = weight_vec[item.to(torch.int64).clamp(0, n_w - 1)]
    full = w >= 0x10000
    h = (hash32_2(x, item) & 0xFFFF) >= w
    return (item >= n_w) | (~full & ((w == 0) | h))


def _choose_rows(cm, rt, rows, xs, rs, positions):
    """(N,) bucket rows, or one (1,) row for every lane -> (N,) chosen items.

    Each lane draws over its row's slots, gathered at the widest of the rows
    given (a host read of their sizes); slots past a row's size are invalid.
    """
    table = cm.weights if rt is None else rt
    sizes = cm.sizes[rows].to(torch.int64)
    slot = torch.arange(max(int(sizes.max()), 1), device=xs.device)[None, :]
    idx = (cm.offsets[rows].to(torch.int64)[:, None] + slot).clamp(
        max=cm.items.shape[0] - 1)
    pos = positions.clamp(max=table.shape[0] - 1)
    ws = table[pos[:, None], idx]
    draws = straw2_draws(xs[:, None], cm.ids[idx], rs[:, None], ws,
                         slot < sizes[:, None])
    pick = argmax_draws(draws)[:, None]
    return cm.items[idx.expand(xs.shape[0], -1).gather(1, pick)[:, 0]]


def _descend(cm, rt, start, xs, rs, want_type, positions):
    """Walk each lane down from `start` (a static bucket id, or (N,) inner
    rows with -1 for no bucket) to an item of want_type, at most cm.depth
    buckets. Returns (item, item_row, reached, skip): skip marks an item
    past max_devices or of a wrong type that is not a bucket (the reference
    gives up the rep), neither marks an empty bucket or the depth bound (the
    reference retries)."""
    n = xs.shape[0]
    dev = xs.device
    levels = cm.depth
    if isinstance(start, int):
        b = cm.source.buckets.get(start)
        if b is None or b.size == 0:
            z = torch.zeros(n, dtype=torch.int64, device=dev)
            f = torch.zeros(n, dtype=torch.bool, device=dev)
            return z, z - 1, f, f
        root = cm.row_of[-1 - start].to(torch.int64).reshape(1)
        item = _choose_rows(cm, rt, root, xs, rs, positions).to(torch.int64)
        t, nrow = _item_lookup(cm, item)
        skip = (item >= cm.max_devices) | ((t != want_type) & (nrow < 0))
        reached = ~skip & (t == want_type)
        done = skip | reached
        row = torch.where(done, -1, nrow)
        levels -= 1
    else:
        row = start.to(torch.int64)
        item = torch.zeros(n, dtype=torch.int64, device=dev)
        done = row < 0
        reached = torch.zeros(n, dtype=torch.bool, device=dev)
        skip = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(levels):
        if bool(done.all()):
            break
        safe = row.clamp(min=0)
        empty = cm.sizes[safe] == 0
        nxt = _choose_rows(cm, rt, safe, xs, rs, positions).to(torch.int64)
        t, nrow = _item_lookup(cm, nxt)
        bad = (nxt >= cm.max_devices) | ((t != want_type) & (nrow < 0))
        hit = ~empty & ~bad & (t == want_type)
        live = ~done & ~empty
        item = torch.where(live, nxt, item)
        reached = reached | (~done & hit)
        skip = skip | (live & bad)
        row = torch.where(live & ~bad & ~hit, nrow, row)
        done = done | empty | bad | hit
    _, item_row = _item_lookup(cm, item)
    return item, item_row, reached, skip


def _collides(out: torch.Tensor, upto: torch.Tensor, item: torch.Tensor):
    """item in out[:upto] per lane."""
    slot = torch.arange(out.shape[1], device=out.device)[None, :]
    return ((slot < upto[:, None]) & (out == item[:, None])).any(dim=1)


def _leaf_firstn(cm, rt, weight_vec, item_rows, xs, out2, outpos, sub_r,
                 recurse_tries, stable, need):
    """chooseleaf recursion for firstn (mapper.c:565-585): one non-out device
    under each lane's item row that no earlier leaf of the lane took."""
    rep0 = 0 if stable else outpos
    leaf = torch.zeros_like(outpos)
    got = torch.zeros_like(need)
    stop = torch.zeros_like(need)
    for ft in range(recurse_tries):
        act = need & ~got & ~stop
        if not bool(act.any()):
            break
        rs = rep0 + sub_r + ft + torch.zeros_like(outpos)
        item, _, reached, skip = _descend(cm, rt, item_rows, xs, rs, 0, outpos)
        good = act & reached & ~_collides(out2, outpos, item) \
            & ~_is_out(weight_vec, item, xs)
        leaf = torch.where(good, item, leaf)
        got = got | good
        stop = stop | (act & skip)
    return leaf, got


def _firstn_try(cm, rt, weight_vec, start, xs, out, out2, outpos, r,
                want_type, recurse, recurse_tries, vary_r, stable, active):
    """One firstn attempt at r = rep + ftotal for the active lanes; returns
    (item, leaf, good, skip)."""
    rs = torch.full_like(outpos, r)
    item, item_row, reached, skip = _descend(cm, rt, start, xs, rs, want_type, outpos)
    fresh = active & reached & ~_collides(out, outpos, item)
    good = fresh
    leaf = torch.zeros_like(item)
    if recurse:
        sub_r = (r >> (vary_r - 1)) if vary_r else 0
        leaf_found, got = _leaf_firstn(
            cm, rt, weight_vec, item_row, xs, out2, outpos, sub_r,
            recurse_tries, stable, fresh & (item < 0))
        leaf = torch.where(item >= 0, item, leaf_found)
        good = good & (got | (item >= 0))
    if want_type == 0:
        good = good & ~_is_out(weight_vec, item, xs)
    return item, leaf, good, active & skip


def _choose_firstn_plain(cm, rt, weight_vec, start, xs, numrep, want_type,
                         recurse, tries, recurse_tries, vary_r, stable, out_slots):
    n = xs.shape[0]
    dev = xs.device
    out = torch.full((n, out_slots), CRUSH_ITEM_NONE, dtype=torch.int64, device=dev)
    out2 = out.clone()
    outpos = torch.zeros(n, dtype=torch.int64, device=dev)
    slot = torch.arange(out_slots, device=dev)[None, :]
    for rep in range(numrep):
        item = torch.zeros_like(outpos)
        leaf = torch.zeros_like(outpos)
        placed = torch.zeros(n, dtype=torch.bool, device=dev)
        skip = torch.zeros_like(placed)
        for ftotal in range(tries):
            act = ~placed & ~skip
            if not bool(act.any()):
                break
            it, lf, good, skp = _firstn_try(
                cm, rt, weight_vec, start, xs, out, out2, outpos, rep + ftotal,
                want_type, recurse, recurse_tries, vary_r, stable, act)
            item = torch.where(good, it, item)
            leaf = torch.where(good, lf, leaf)
            placed = placed | good
            skip = skip | skp
        write = (placed & (outpos < out_slots))[:, None] & (slot == outpos[:, None])
        out = torch.where(write, item[:, None], out)
        out2 = torch.where(write, leaf[:, None], out2)
        outpos = outpos + write.any(dim=1).to(torch.int64)
    return out, out2


def _leaf_indep(cm, rt, weight_vec, item_rows, xs, rep, r, numrep,
                recurse_tries, need):
    """chooseleaf recursion for indep: r2 = rep + r + numrep*ft2, weight-set
    position rep, no collision scope; a skip ends the lane's search."""
    leaf = torch.full_like(item_rows, CRUSH_ITEM_NONE)
    got = torch.zeros_like(need)
    stop = torch.zeros_like(need)
    pos = torch.full_like(item_rows, rep)
    for ft2 in range(recurse_tries):
        act = need & ~got & ~stop
        if not bool(act.any()):
            break
        rs = torch.full_like(item_rows, rep + r + numrep * ft2)
        item, _, reached, skip = _descend(cm, rt, item_rows, xs, rs, 0, pos)
        good = act & reached & ~_is_out(weight_vec, item, xs)
        leaf = torch.where(good, item, leaf)
        got = got | good
        stop = stop | (act & skip)
    return leaf, got


def _choose_indep_plain(cm, rt, weight_vec, start, xs, numrep, want_type,
                        recurse, tries, recurse_tries, out_slots):
    n = xs.shape[0]
    dev = xs.device
    out = torch.full((n, out_slots), CRUSH_ITEM_UNDEF, dtype=torch.int64, device=dev)
    out2 = out.clone()
    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    for ftotal in range(tries):
        if not bool((out == CRUSH_ITEM_UNDEF).any()):
            break
        for rep in range(out_slots):
            unplaced = out[:, rep] == CRUSH_ITEM_UNDEF
            if not bool(unplaced.any()):
                continue
            r = rep + numrep * ftotal
            item, item_row, reached, skip = _descend(
                cm, rt, start, xs, zeros + r, want_type, zeros)
            good = unplaced & reached & ~(out == item[:, None]).any(dim=1)
            leaf = torch.full_like(item, CRUSH_ITEM_NONE)
            if recurse:
                leaf_found, got = _leaf_indep(
                    cm, rt, weight_vec, item_row, xs, rep, r, numrep,
                    recurse_tries, good & (item < 0))
                leaf = torch.where(item >= 0, item, leaf_found)
                good = good & (got | (item >= 0))
            if want_type == 0:
                good = good & ~_is_out(weight_vec, item, xs)
            out[:, rep] = torch.where(good, item, out[:, rep])
            if recurse:
                out2[:, rep] = torch.where(good, leaf, out2[:, rep])
            # a bad item or type marks the slot NONE for good (mapper.c:737-747)
            kill = unplaced & skip
            out[:, rep] = torch.where(kill, CRUSH_ITEM_NONE, out[:, rep])
            out2[:, rep] = torch.where(kill, CRUSH_ITEM_NONE, out2[:, rep])
    out = torch.where(out == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE, out)
    out2 = torch.where(out2 == CRUSH_ITEM_UNDEF, CRUSH_ITEM_NONE, out2)
    return out, out2


def choose_stage_plain(cm: CompiledMap, xs: torch.Tensor, start, weight_vec,
                       *, firstn: bool, numrep: int, want_type: int,
                       recurse: bool, tries: int, recurse_tries: int,
                       vary_r: int, stable: int, out_slots: int, rt=None):
    """One choose stage for every x, in torch ops on the tensors' device.

    start: a static TAKE item id (int) or an (N,) int32 tensor of per-lane
    start items (a chained stage). Returns (out, out2), (N, out_slots) int32:
    firstn places items left to right and pads with NONE (out2 holds the
    chooseleaf leaves, 0 for a plain choose); indep is positional, NONE where
    nothing was placed (out2 NONE for a plain choose).
    """
    if not isinstance(start, int):
        start = _item_lookup(cm, start)[1]
    if firstn:
        out, out2 = _choose_firstn_plain(
            cm, rt, weight_vec, start, xs, numrep, want_type, recurse, tries,
            recurse_tries, vary_r, stable, out_slots)
    else:
        out, out2 = _choose_indep_plain(
            cm, rt, weight_vec, start, xs, numrep, want_type, recurse, tries,
            recurse_tries, out_slots)
    return out.to(torch.int32), out2.to(torch.int32)


# -- rule interpreter ----------------------------------------------------------------


def _assemble_blocks(blocks, n: int, result_max: int):
    """Append emitted blocks per row exactly as the reference's EMIT does:
    firstn blocks contribute only placed entries (each advances result_len),
    indep blocks contribute every positional slot including NONE holes, and
    everything past result_max is dropped (mapper.c CRUSH_RULE_EMIT loop)."""
    out = np.full((n, result_max), CRUSH_ITEM_NONE, dtype=np.int32)
    pos = np.zeros(n, dtype=np.int64)
    rows = np.arange(n)
    for firstn, cols in blocks:
        for j in range(cols.shape[1]):
            col = cols[:, j]
            if firstn:
                write = (col != CRUSH_ITEM_NONE) & (pos < result_max)
            else:
                write = pos < result_max
            out[rows[write], pos[write]] = col[write]
            pos[write] += 1
    return out, pos.astype(np.int32)


def _map_rule_chunk(compiled, rule, xs, weight_vec, result_max, rt):
    """Interpret the rule's steps over one chunk of x; returns the EMIT
    blocks as (firstn, (n, w) int32 tensor) on the map's device."""
    t = compiled.source.tunables
    choose_tries = t.choose_total_tries + 1  # off-by-one compat (mapper.c:922)
    choose_leaf_tries = 0
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    n = xs.shape[0]
    w_cols: list = []  # (static item | None, (n,) column | None)
    blocks: list = []
    last_mode_firstn = True

    for step in rule.steps:
        op = step.op
        if op in (RuleOp.SET_CHOOSE_LOCAL_TRIES,
                  RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES):
            # legacy local retries are not modelled; a nonzero arg would
            # diverge from the reference, so it goes to the scalar mapper
            if step.arg1 > 0:
                raise ValueError(
                    f"rule step op {int(op)} (set_choose_local_*_tries) with "
                    "nonzero arg is not supported by the batched path; "
                    "use the scalar mapper"
                )
        elif op == RuleOp.TAKE:
            item = step.arg1
            if 0 <= item < compiled.max_devices or item in compiled.source.buckets:
                w_cols = [(item, None)]
        elif op == RuleOp.SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == RuleOp.SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN,
                    RuleOp.CHOOSE_INDEP, RuleOp.CHOOSELEAF_INDEP):
            firstn = op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
            recurse = op in (RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP)
            last_mode_firstn = firstn
            numrep = step.arg1
            if numrep <= 0:
                numrep += result_max
                if numrep <= 0:
                    continue
            if choose_leaf_tries:
                recurse_tries = choose_leaf_tries
            elif firstn and t.chooseleaf_descend_once:
                recurse_tries = 1
            elif firstn:
                recurse_tries = choose_tries
            else:
                recurse_tries = 1

            new_cols: list = []
            budget = result_max
            for bid, col in w_cols:
                if budget <= 0:
                    break
                # firstn keeps all numrep slots per take entry and EMIT's
                # compaction and truncation enforce result_max (the
                # reference's per-entry cap gives the same emitted prefix);
                # indep slots are positional, so the static cap is exact
                slots = numrep if firstn else min(numrep, budget)
                out, out2 = crush_cuda.crush_choose(
                    compiled, xs, bid if col is None else col.contiguous(), weight_vec,
                    firstn=firstn, numrep=numrep, want_type=step.arg2,
                    recurse=recurse, tries=choose_tries,
                    recurse_tries=recurse_tries, vary_r=vary_r,
                    stable=stable, out_slots=slots, rt=rt,
                )
                picked = out2 if recurse else out
                new_cols.extend((None, picked[:, j]) for j in range(slots))
                if not firstn:
                    budget -= slots
            w_cols = new_cols
        elif op == RuleOp.EMIT:
            cols = [
                torch.full((n,), bid, dtype=torch.int32, device=xs.device)
                if col is None else col
                for bid, col in w_cols
            ]
            if cols:
                blocks.append((last_mode_firstn, torch.stack(cols, dim=1)))
            w_cols = []
    return blocks


def _as_device_tensor(value, dtype, device: torch.device, what: str):
    """Host data (numpy, lists) is copied to the map's device; a tensor must
    already be on a device of the map's kind."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    elif value.device.type != device.type:
        raise ValueError(f"map_rule: {what} is on {value.device}, the map on {device}")
    return value.to(device=device, dtype=dtype)


def map_rule(
    compiled: CompiledMap,
    ruleno: int,
    xs,
    weight,
    result_max: int,
    chunk: int | None = None,
    return_lengths: bool = False,
    runtime_weights=None,
):
    """Evaluate one rule for a whole batch of x on the map's device.

    xs: (N,) ints (read as uint32, as the reference's x is); weight: (D,)
    16.16 device weights. Returns an (N, result_max) int32 numpy array padded
    with CRUSH_ITEM_NONE: firstn results are compacted per row, indep results
    are positional (NONE holes kept). Each choose stage is one launch per
    `chunk` x (default DEFAULT_CHUNK on a CUDA map, PLAIN_CHUNK on a CPU
    map), at the chunk's exact length.

    return_lengths=True also returns the (N,) per-row emitted result length,
    which tells an indep row's trailing NONE holes from padding.

    runtime_weights: from runtime_weight_arrays(); straw2 weights are read
    from it instead of the compiled ones.
    """
    if ruleno not in compiled.supported_rules:
        raise ValueError(
            f"rule {ruleno} reaches buckets outside the batched path's scope "
            "(use the scalar mapper for it)"
        )
    rule = compiled.source.rules[ruleno]
    dev = compiled.device
    if not isinstance(xs, torch.Tensor):  # x is a uint32: keep its bits
        xs = (np.asarray(xs, dtype=np.int64) & _M32).astype(np.uint32).view(np.int32)
    xs = _as_device_tensor(xs, torch.int32, dev, "xs")
    if not isinstance(weight, torch.Tensor):
        weight = np.asarray(weight, dtype=np.int64)
    weight_vec = _as_device_tensor(weight, torch.int64, dev, "weight")
    if chunk is None:
        chunk = DEFAULT_CHUNK if dev.type == "cuda" else PLAIN_CHUNK
    n = xs.shape[0]
    pieces, len_pieces = [], []
    for lo in range(0, n, chunk):
        part = xs[lo:lo + chunk]
        blocks = _map_rule_chunk(compiled, rule, part, weight_vec, result_max,
                                 runtime_weights)
        host = [(f, cols.cpu().numpy()) for f, cols in blocks]
        res, lens = _assemble_blocks(host, part.shape[0], result_max)
        pieces.append(res)
        len_pieces.append(lens)
    out = (np.concatenate(pieces, axis=0) if pieces
           else np.zeros((0, result_max), np.int32))
    if return_lengths:
        lengths = np.concatenate(len_pieces) if len_pieces else np.zeros(0, np.int32)
        return out, lengths
    return out
