"""Batched upmap balancing: calc_pg_upmaps at device speed.

The reference's calc_pg_upmaps (OSDMap.cc:4512) walks PGs one move at a
time: pick the most overfull OSD, scan its PGs, try a remap, repeat —
O(moves x PGs) python-scale work, which is why the mgr balancer caps at
~10 changes per tick. This module keeps the greedy *commit* order (one
move at a time, each revalidated by replaying the scalar pipeline's
upmap/up stages over the batched raw rows, so resulting placements are
bit-identical to `pg_to_up_acting_osds`) but lifts the *search* onto
the batched mapper:

  * per-OSD PG loads come from `OSDMap.pool_mappings` — one device launch
    per pool, vectorized counting;
  * every candidate (pg, from_osd, to_osd) move is scored in ONE kernel
    launch per pool on a card (ops/upmap_cuda.upmap_score over
    csrc/upmap_score.cu; a CPU map runs the plain torch version
    `score_chunk_plain` per chunk of rows): deviation-weighted gain for each up-set member x
    each same-failure-domain replacement target, masked for validity
    (target carries weight, is not already in the up set, and preserves
    the rule's failure-domain invariant — same subtree as the source, or
    a subtree the PG does not touch yet);
  * moves are selected greedily host-side from the scored tensor, applied
    incrementally (only the touched OSDs are recounted), and scoring
    relaunches only when the round's candidate list goes stale.

So the python iteration count is O(accepted moves + launches), not
O(PGs): `max_changes` becomes a real budget (hundreds per tick) instead
of a wall.

CRUSH-legality mask: a pg_upmap_items entry replaces `from` with `to`
*after* crush ran, so CRUSH itself never validates the result. The rule's
failure-domain type (the chooseleaf/choose step's type argument) defines
the invariant the original placement satisfied — at most one member per
domain subtree. Replacing a member with a target in the SAME subtree
trivially preserves it; a target in a subtree no other member occupies
preserves it too. Both are admitted; everything else is masked out. The
scalar-oracle revalidation after each accepted move keeps the final word.

Port of ceph_tpu/crush/balance.py. Scoring runs where the OSDMap's `device`
says. A CPU map scores in the JAX package's chunks of rows, so its
BalanceResult (launches included) equals the reference's; a card scores a
whole pool per launch, and `launches` counts those launches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch.crush.types import CrushMap, RuleOp
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops import upmap_cuda

CRUSH_ITEM_NONE = 0x7FFFFFFF

#: PG rows per plain-version call on a CPU map: candidates are (rows, size,
#: n_osd) temporaries — 2^15 rows at most, and at most 2^24 candidates
#: (the JAX package's chunking, so a CPU map reports the same launches)
SCORE_CHUNK = 1 << 15


def plain_chunk_rows(size: int, n: int) -> int:
    """Rows per plain-version call on a CPU map of `n` OSDs and rows of
    `size` slots: at most SCORE_CHUNK, and at most 2^24 candidates."""
    return max(256, min(SCORE_CHUNK, (1 << 24) // max(1, size * n)))


# -- failure domains ----------------------------------------------------------


def rule_failure_domain_type(cmap: CrushMap, ruleno: int) -> int:
    """The failure-domain TYPE a rule spreads replicas across: the first
    choose/chooseleaf step's type argument (0 = device-level, i.e. no
    cross-domain invariant beyond distinct OSDs)."""
    rule = cmap.rules.get(ruleno)
    if rule is None:
        return 0
    for step in rule.steps:
        if step.op in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP,
                       RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP):
            return int(step.arg2)
    return 0


def rule_failure_domains(
    cmap: CrushMap, ruleno: int, max_osd: int
) -> np.ndarray:
    """Per-OSD failure-domain id under `ruleno` (int32, (max_osd,)).

    Walks the rule's TAKE subtrees assigning each device the bucket id of
    its nearest ancestor of the rule's failure-domain type; devices the
    rule cannot reach stay -1 (never valid move targets). For type-0
    rules every reachable device shares the TAKE root's id — the mask
    degenerates to "any reachable OSD", which is exactly the invariant a
    device-level rule guarantees.
    """
    dom = np.full(max_osd, -1, dtype=np.int32)
    rule = cmap.rules.get(ruleno)
    if rule is None:
        return dom
    want_type = rule_failure_domain_type(cmap, ruleno)

    def walk(item: int, current: int) -> None:
        if item >= 0:
            if item < max_osd and current != -1:
                dom[item] = current
            return
        b = cmap.buckets.get(item)
        if b is None:
            return
        nxt = item if (want_type == 0 or b.type == want_type) else current
        # for type-0 rules the TAKE root itself is the single domain
        if want_type == 0 and current != -1:
            nxt = current
        for child in b.items:
            walk(child, nxt)

    for step in rule.steps:
        if step.op == RuleOp.TAKE:
            root = step.arg1
            if root >= 0:
                if root < max_osd:
                    dom[root] = root
            else:
                walk(root, root if want_type == 0 else -1)
    return dom


def _dense_domains(dom: np.ndarray) -> np.ndarray:
    """Remap raw domain ids (bucket/OSD ids) to dense indices [0, D);
    -1 (unreachable) stays -1 — so sentinel values < -1 can never collide
    with a real domain inside the scorer."""
    ids = sorted({int(d) for d in dom if d != -1})
    index = {d: i for i, d in enumerate(ids)}
    return np.array([index.get(int(d), -1) for d in dom], dtype=np.int32)


# -- the vectorized move scorer ----------------------------------------------


def score_chunk_plain(up, dev, valid_target, dom, max_dev):
    """Best (gain, from, to) per PG row: the plain torch version of
    csrc/upmap_score.cu, and the port of the JAX package's `_score_chunk`.

    up: (C, S) int32 up-set rows, -1 for NONE/padding.
    dev: (n+1,) float32 per-OSD deviation (count - weight-share target);
         slot n is the padding sentinel.
    valid_target: (n+1,) bool — carries weight, exists, up (False at n).
    dom: (n+1,) int32 — failure-domain id per osd (-1 unreachable under
         this pool's rule; a never-matching sentinel at slot n).
    max_dev: float32 — only sources above it are worth moving.

    Every valid OSD is a candidate target for every up-set slot; a
    (slot, target) pair is legal when the target's failure domain is the
    source's own (a within-subtree swap) OR a domain the PG does not
    occupy at all — both preserve the rule's one-replica-per-domain
    invariant, nothing else can.

    A move must improve: the source sits more than one PG above the
    target, and at least one endpoint is outside the deviation band
    (source overfull OR target underfull) — draining overfull OSDs alone
    leaves stragglers below target that only inbound moves can fill.

    Returns (best_gain (C,) f32, best_from (C,) i32, best_to (C,) i32);
    gain is -inf where no legal improving move exists, and the first
    maximum in s * n + t order wins (so an all-illegal row gives
    from = up[row, 0], to = 0). Builds (C, S, n) temporaries: callers
    bound C.
    """
    n = dev.shape[0] - 1
    max_dev = torch.as_tensor(max_dev, dtype=torch.float32, device=dev.device)
    frm = up  # (C, S)
    frm_c = torch.where(frm >= 0, frm, n).clamp(max=n).long()
    fdev = dev[frm_c]                       # (C, S)
    fdom = dom[frm_c]                       # (C, S)
    tdev = dev[:-1]                         # (N,)
    tdom = dom[:-1]                         # (N,)
    tval = valid_target[:-1] & (tdom >= 0)  # (N,)
    # per-row occupancy: which targets are members / whose domain is taken
    targets = torch.arange(n, dtype=frm.dtype, device=frm.device)
    in_up = (frm[:, :, None] == targets[None, None, :]).any(dim=1)  # (C, N)
    occ = (
        torch.where(frm >= 0, fdom, -2)[:, :, None] == tdom[None, None, :]
    ).any(dim=1)                             # (C, N)
    # (domain ids are DENSE indices >= 0; -1 unreachable, -2 sentinels)
    same = fdom[:, :, None] == tdom[None, None, :]       # (C, S, N)
    diff = fdev[:, :, None] - tdev[None, None, :]        # (C, S, N) f32
    ok = (
        (frm >= 0)[:, :, None]
        & (fdom >= 0)[:, :, None]
        & tval[None, None, :]
        & ~in_up[:, None, :]
        & (same | ~occ[:, None, :])
        & (diff > 1.0)
        & (
            (fdev[:, :, None] > max_dev)
            | (tdev[None, None, :] < -max_dev)
        )
    )
    gain = torch.where(ok, diff - 1.0, float("-inf"))

    c, s, nn = gain.shape
    flat = gain.reshape(c, s * nn)
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    bs = torch.div(best, nn, rounding_mode="floor")
    best_from = frm.gather(1, bs[:, None])[:, 0]
    best_to = (best % nn).to(torch.int32)
    return best_gain, best_from, best_to


# -- the balancer -------------------------------------------------------------


@dataclass
class BalanceResult:
    """What one calc_pg_upmaps pass did (the balancer module's perf/tracing
    payload)."""

    changes: int = 0
    launches: int = 0          # pool maps + scoring calls (one per pool on a card)
    rounds: int = 0            # scoring rounds until converged/exhausted
    spread_before: float = 0.0  # max |deviation| before
    spread_after: float = 0.0   # max |deviation| after
    pgs: int = 0               # PG instances counted across selected pools
    score_seconds: float = 0.0  # host-visible time inside scoring calls


def _row_members(row: np.ndarray) -> set[int]:
    return {int(o) for o in row if o != CRUSH_ITEM_NONE}


def calc_pg_upmaps(
    osdmap,
    max_deviation: float = 1.0,
    max_changes: int = 10,
    pools: set[int] | None = None,
    max_rounds: int = 64,
) -> BalanceResult:
    """Batched greedy upmap balancing over `osdmap` (mutates
    pg_upmap_items exactly like the scalar reference path).

    Every accepted move is revalidated by replaying `apply_upmap` +
    `raw_to_up_osds` (the scalar pipeline's own stages) over the cached
    batched raw rows — committed placements are bit-identical to what
    every other consumer of the map computes, without a per-move python
    CRUSH walk.
    """
    res = BalanceResult()
    pool_ids = sorted(pools if pools is not None else osdmap.pools)
    n = osdmap.max_osd
    if not pool_ids or n == 0:
        return res

    weights = np.asarray(
        osdmap.osd_weight * (osdmap.osd_exists & osdmap.osd_up),
        dtype=np.int64,
    )
    wtotal = int(weights.sum())
    if wtotal == 0:
        return res

    # per-pool batched mapping + vectorized per-OSD counting; the raw
    # (pre-upmap) rows are kept so per-move revalidation can replay
    # apply_upmap/raw_to_up_osds over them instead of paying a full
    # scalar CRUSH walk per accepted move
    ups: dict[int, np.ndarray] = {}
    raws: dict[int, np.ndarray] = {}
    counts = np.zeros(n, dtype=np.int64)
    total_pgs = 0
    rules: dict[int, int] = {}
    for pid in pool_ids:
        pool = osdmap.pools[pid]
        total_pgs += pool.pg_num * pool.size
        rows, raw_rows = osdmap.pool_mappings(pid, return_raw=True)
        res.launches += 1
        ups[pid] = np.array(rows, dtype=np.int32)
        raws[pid] = np.array(raw_rows, dtype=np.int32)
        flat = ups[pid][ups[pid] != CRUSH_ITEM_NONE]
        counts += np.bincount(flat, minlength=n)[:n]
        rules[pid] = osdmap.find_rule(pool.crush_rule, pool.type, pool.size)
    if total_pgs == 0:
        return res
    res.pgs = total_pgs
    pgs_per_weight = total_pgs / wtotal
    target = weights.astype(np.float64) * pgs_per_weight

    considered = (weights > 0) | (counts > 0)

    def spread() -> float:
        dev = counts - target
        return float(np.abs(dev[considered]).max()) if considered.any() else 0.0

    res.spread_before = spread()

    # failure-domain geometry per pool rule (static across the pass)
    valid_tgt = weights > 0
    geo: dict[int, np.ndarray] = {}
    for pid in pool_ids:
        dom = rule_failure_domains(osdmap.crush, rules[pid], n)
        geo[pid] = _dense_domains(dom)

    device = resolve_device(osdmap.device)
    valid_pad = torch.from_numpy(
        np.concatenate([valid_tgt, [False]])).to(device)
    dom_pads = {
        pid: torch.from_numpy(
            np.concatenate([geo[pid], [np.int32(-2)]])).to(device)
        for pid in pool_ids
    }

    def score_round() -> list[tuple[float, int, int, int, int]]:
        """One scoring sweep over every pool: [(gain, pid, ps, frm, to)]."""
        dev32 = np.concatenate(
            [(counts - target).astype(np.float32), [np.float32(0.0)]]
        )
        cands: list[tuple[float, int, int, int, int]] = []
        t0 = time.perf_counter()
        dev_t = torch.from_numpy(dev32).to(device)
        for pid in pool_ids:
            rows = ups[pid]
            up_sane = torch.from_numpy(
                np.where(rows == CRUSH_ITEM_NONE, -1, rows)).to(device)
            # a card scores the whole pool in one launch; the plain
            # version's gain tensor is (chunk, size, n_osd), so on the CPU
            # the chunk shrinks as the cluster grows
            if device.type == "cuda":
                chunk_rows = max(1, up_sane.shape[0])
            else:
                chunk_rows = plain_chunk_rows(rows.shape[1], n)
            for lo in range(0, up_sane.shape[0], chunk_rows):
                g, f, t = upmap_cuda.upmap_score(
                    up_sane[lo : lo + chunk_rows],
                    dev_t,
                    valid_pad,
                    dom_pads[pid],
                    max_deviation,
                )
                res.launches += 1
                g = g.cpu().numpy()
                f = f.cpu().numpy()
                t = t.cpu().numpy()
                hit = np.isfinite(g) & (g > 0)
                for i in np.nonzero(hit)[0]:
                    cands.append(
                        (float(g[i]), pid, lo + int(i), int(f[i]), int(t[i]))
                    )
        res.score_seconds += time.perf_counter() - t0
        return cands

    changed = 0
    for _round in range(max_rounds):
        if changed >= max_changes:
            break
        if spread() <= max_deviation:
            break
        cands = score_round()
        res.rounds += 1
        if not cands:
            break
        # deterministic greedy order: gain desc, then (pid, ps) asc
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        progressed = False
        for _gain, pid, ps, frm, to in cands:
            if changed >= max_changes:
                break
            dev_frm = counts[frm] - target[frm]
            dev_to = counts[to] - target[to]
            # stale candidates (earlier moves shifted the deviations) are
            # rechecked against live counts, not re-scored on device
            if dev_frm - dev_to <= 1.0 or (
                dev_frm <= max_deviation and dev_to >= -max_deviation
            ):
                continue
            if weights[to] == 0:
                continue
            row = ups[pid][ps]
            before = _row_members(row)
            if frm not in before or to in before:
                continue
            # failure-domain legality against the LIVE row (the scorer saw
            # a snapshot): target must share the source's domain or land in
            # one the PG does not occupy
            dom = geo[pid]
            if dom[to] < 0:
                continue
            if dom[to] != dom[frm] and int(dom[to]) in {
                int(dom[o]) for o in before if o != frm
            }:
                continue
            pg = (pid, ps)
            items = osdmap.pg_upmap_items.setdefault(pg, [])
            items.append((frm, to))
            # replay the scalar pipeline's upmap/up stages over the cached
            # raw row: identical checks to a full pg_to_up_acting_osds call
            # (the raw stage is the batched mapper's bit-matched output) at
            # O(size + items) per move instead of a python CRUSH walk
            pool = osdmap.pools[pid]
            raw_list = osdmap._remove_nonexistent(
                pool, [int(o) for o in raws[pid][ps]]
            )
            new_up = osdmap.raw_to_up_osds(
                pool, osdmap.apply_upmap(pid, ps, raw_list)
            )
            placed = [o for o in new_up if o != CRUSH_ITEM_NONE]
            if (
                frm in new_up
                or to not in new_up
                or len(set(placed)) != len(placed)
            ):
                items.pop()
                if not items:
                    del osdmap.pg_upmap_items[pg]
                continue
            new_row = np.full(len(row), CRUSH_ITEM_NONE, np.int32)
            new_row[: len(new_up)] = new_up
            # incremental recount: only the membership diff is touched —
            # normally exactly {frm--, to++}
            after = _row_members(new_row)
            for o in before - after:
                counts[o] -= 1
            for o in after - before:
                counts[o] += 1
            ups[pid][ps] = new_row
            changed += 1
            progressed = True
        if not progressed:
            break

    res.changes = changed
    res.spread_after = spread()
    if changed:
        osdmap.epoch += 1
    return res


# -- scalar reference (the pre-batched greedy, kept for benchmarking) ---------


def calc_pg_upmaps_scalar(
    osdmap,
    max_deviation: float = 1.0,
    max_changes: int = 10,
    pools: set[int] | None = None,
) -> int:
    """The original one-move-at-a-time greedy (reference OSDMap.cc:4512
    shape): kept as the measured baseline for the batched path and as a
    second opinion in property tests. Like the reference, it builds its
    pgs_by_osd table by scalar-mapping every PG host-side (O(PGs) python
    CRUSH walks — the cost the batched path's per-pool launches replace);
    commit rules match the batched driver, only the search differs."""
    pool_ids = sorted(pools if pools is not None else osdmap.pools)
    pgs_by_osd: dict[int, set[tuple[int, int]]] = {
        o: set() for o in range(osdmap.max_osd)
    }
    up_cache: dict[tuple[int, int], np.ndarray] = {}
    total_pgs = 0
    for pid in pool_ids:
        pool = osdmap.pools[pid]
        total_pgs += pool.pg_num * pool.size
        for ps in range(pool.pg_num):
            up, *_ = osdmap.pg_to_up_acting_osds(pid, ps)
            row = np.full(pool.size, CRUSH_ITEM_NONE, np.int32)
            row[: len(up)] = up
            up_cache[(pid, ps)] = row
            for o in row:
                if o != CRUSH_ITEM_NONE:
                    pgs_by_osd[int(o)].add((pid, ps))

    weights = osdmap.osd_weight * (osdmap.osd_exists & osdmap.osd_up)
    wtotal = int(weights.sum())
    if wtotal == 0 or total_pgs == 0:
        return 0
    pgs_per_weight = total_pgs / wtotal

    def deviation(o: int) -> float:
        return len(pgs_by_osd[o]) - int(weights[o]) * pgs_per_weight

    changed = 0
    for _ in range(max_changes):
        devs = sorted(
            (deviation(o), o) for o in range(osdmap.max_osd)
            if weights[o] > 0 or pgs_by_osd[o]
        )
        if not devs:
            break
        over_dev, over = devs[-1]
        if over_dev <= max_deviation:
            break
        moved = False
        for pg in sorted(pgs_by_osd[over]):
            up = up_cache[pg]
            members = {int(o) for o in up if o != CRUSH_ITEM_NONE}
            for under_dev, under in devs:
                if under_dev >= over_dev - 1:
                    break
                if under in members or weights[under] == 0:
                    continue
                items = osdmap.pg_upmap_items.setdefault(pg, [])
                items.append((over, under))
                new_up, *_ = osdmap.pg_to_up_acting_osds(*pg)
                if over in new_up or under not in new_up or len(
                    set(new_up) - {CRUSH_ITEM_NONE}
                ) != len([o for o in new_up if o != CRUSH_ITEM_NONE]):
                    items.pop()
                    if not items:
                        del osdmap.pg_upmap_items[pg]
                    continue
                row = np.full(len(up), CRUSH_ITEM_NONE, np.int32)
                row[: len(new_up)] = new_up
                up_cache[pg] = row
                pgs_by_osd[over].discard(pg)
                pgs_by_osd[under].add(pg)
                changed += 1
                moved = True
                break
            if moved:
                break
        if not moved:
            break
    if changed:
        osdmap.epoch += 1
    return changed
