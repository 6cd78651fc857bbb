"""Scalar CRUSH mapper — the host-side oracle for the batched torch mapper.

A faithful, pure-Python re-expression of the placement semantics of
src/crush/mapper.c: the five bucket choose algorithms
(uniform/perm, list, tree, straw, straw2), the overload test `is_out`, the
depth-first `crush_choose_firstn` with collision/out/retry handling
(r' = r + ftotal), the breadth-first positionally-stable `crush_choose_indep`
(r' = r + numrep * ftotal), and the `crush_do_rule` step interpreter
(TAKE / CHOOSE[LEAF]_{FIRSTN,INDEP} / EMIT / SET_* tunable overrides).

This module is deliberately scalar and structured for auditability, not speed
— the batched path (torch_mapper.py and its CUDA kernel) must produce
bit-identical output. It is also the tester's path for the rules that
torch_mapper.supports() refuses (legacy bucket algorithms, local tries).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.crush.hash import crush_hash32_2, crush_hash32_3, crush_hash32_4
from ceph_tpu_torch.crush.ln_tables import crush_ln
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    Bucket,
    BucketAlg,
    ChooseArg,
    CrushMap,
)

S64_MIN = -(2**63)


@dataclass
class _PermState:
    perm_x: int = 0
    perm_n: int = 0
    perm: list[int] = field(default_factory=list)


class Workspace:
    """Per-map scratch state (crush_init_workspace): uniform-bucket
    permutation cache, reusable across calls for the same map."""

    def __init__(self):
        self.perm: dict[int, _PermState] = {}

    def bucket_state(self, bucket: Bucket) -> _PermState:
        st = self.perm.get(bucket.id)
        if st is None:
            st = _PermState(perm=[0] * bucket.size)
            self.perm[bucket.id] = st
        return st


def bucket_perm_choose(bucket: Bucket, work: _PermState, x: int, r: int) -> int:
    """Random-permutation choose for uniform buckets (mapper.c:73)."""
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = crush_hash32_3(x, bucket.id, 0) % bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: see mapper.c
            return bucket.items[s]
        work.perm = list(range(bucket.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        work.perm[1:] = [i for i in range(1, bucket.size)]
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = crush_hash32_3(x, bucket.id, p) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(x, bucket.items[i], r, bucket.id)
        w &= 0xFFFF
        w = (w * bucket.sum_weights[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    n = len(bucket.node_weights) >> 1
    while not (n & 1):
        w = bucket.node_weights[n]
        t = (crush_hash32_4(x, n, r, bucket.id) * w) >> 32
        h = 0
        nn = n
        while (nn & 1) == 0:
            h += 1
            nn >>= 1
        left = n - (1 << (h - 1))
        n = left if t < bucket.node_weights[left] else n + (1 << (h - 1))
    return bucket.items[n >> 1]


def bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    high, high_draw = 0, 0
    for i in range(bucket.size):
        draw = crush_hash32_3(x, bucket.items[i], r) & 0xFFFF
        draw *= bucket.straws[i]
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def draw_straw2(x: int, item_id: int, r: int, weight: int) -> int:
    """One exponential-distribution draw (generate_exponential_distribution)."""
    u = crush_hash32_3(x, item_id, r) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    # C division truncates toward zero; ln <= 0, weight > 0
    return -((-ln) // weight)


def bucket_straw2_choose(
    bucket: Bucket, x: int, r: int, arg: ChooseArg | None, position: int
) -> int:
    weights = bucket.item_weights
    ids = bucket.items
    if arg is not None:
        if arg.weight_set is not None:
            pos = min(position, len(arg.weight_set) - 1)
            weights = arg.weight_set[pos]
        if arg.ids is not None:
            ids = arg.ids
    high, high_draw = 0, 0
    for i in range(bucket.size):
        if weights[i]:
            draw = draw_straw2(x, ids[i], r, weights[i])
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high, high_draw = i, draw
    return bucket.items[high]


def bucket_choose(
    map: CrushMap,
    bucket: Bucket,
    work: Workspace,
    x: int,
    r: int,
    position: int,
) -> int:
    arg = map.choose_args.get(bucket.id)
    if bucket.alg == BucketAlg.UNIFORM:
        return bucket_perm_choose(bucket, work.bucket_state(bucket), x, r)
    if bucket.alg == BucketAlg.LIST:
        return bucket_list_choose(bucket, x, r)
    if bucket.alg == BucketAlg.TREE:
        return bucket_tree_choose(bucket, x, r)
    if bucket.alg == BucketAlg.STRAW:
        return bucket_straw_choose(bucket, x, r)
    if bucket.alg == BucketAlg.STRAW2:
        return bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def is_out(weight: list[int], item: int, x: int) -> bool:
    """Overload test against the 16.16 external weight vector (mapper.c:424)."""
    if item >= len(weight):
        return True
    w = weight[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= w


def choose_firstn(
    map: CrushMap,
    work: Workspace,
    bucket: Bucket,
    weight: list[int],
    x: int,
    numrep: int,
    type: int,
    out: list[int],
    outpos: int,
    out_size: int,
    tries: int,
    recurse_tries: int,
    local_retries: int,
    local_fallback_retries: int,
    recurse_to_leaf: bool,
    vary_r: int,
    stable: int,
    out2: list[int] | None,
    parent_r: int,
) -> int:
    """Depth-first replica selection with retry logic (mapper.c:460)."""
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        retry_descent = True
        while retry_descent:
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            retry_bucket = True
            while retry_bucket:
                retry_bucket = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject, collide = True, False
                else:
                    if (
                        local_fallback_retries > 0
                        and flocal >= (in_bucket.size >> 1)
                        and flocal > local_fallback_retries
                    ):
                        item = bucket_perm_choose(
                            in_bucket, work.bucket_state(in_bucket), x, r
                        )
                    else:
                        item = bucket_choose(map, in_bucket, work, x, r, outpos)
                    if item >= map.max_devices:
                        skip_rep = True
                        break
                    itemtype = map.item_type(item)
                    if itemtype != type:
                        if item >= 0 or map.buckets.get(item) is None:
                            skip_rep = True
                            break
                        in_bucket = map.buckets[item]
                        retry_bucket = True
                        continue
                    collide = item in out[:outpos]
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            got = choose_firstn(
                                map, work, map.buckets[item], weight, x,
                                1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0,
                                local_retries, local_fallback_retries,
                                False, vary_r, stable, None, sub_r,
                            )
                            if got <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide and itemtype == 0:
                        reject = is_out(weight, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (
                        local_fallback_retries > 0
                        and flocal <= in_bucket.size + local_fallback_retries
                    ):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                        break
                    else:
                        skip_rep = True
        if not skip_rep:
            out[outpos] = item
            outpos += 1
            count -= 1
        rep += 1
    return outpos


def choose_indep(
    map: CrushMap,
    work: Workspace,
    bucket: Bucket,
    weight: list[int],
    x: int,
    left: int,
    numrep: int,
    type: int,
    out: list[int],
    outpos: int,
    tries: int,
    recurse_tries: int,
    recurse_to_leaf: bool,
    out2: list[int] | None,
    parent_r: int,
) -> None:
    """Breadth-first positionally-stable selection for EC (mapper.c:655)."""
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if (
                    in_bucket.alg == BucketAlg.UNIFORM
                    and in_bucket.size % numrep == 0
                ):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                item = bucket_choose(map, in_bucket, work, x, r, outpos)
                if item >= map.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = map.item_type(item)
                if itemtype != type:
                    if item >= 0 or map.buckets.get(item) is None:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = map.buckets[item]
                    continue
                if item in out[outpos:endpos]:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        choose_indep(
                            map, work, map.buckets[item], weight, x,
                            1, numrep, 0, out2, rep,
                            recurse_tries, 0, False, None, r,
                        )
                        if out2 is not None and out2[rep] == CRUSH_ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and is_out(weight, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def do_rule(
    map: CrushMap,
    ruleno: int,
    x: int,
    weight: list[int],
    result_max: int,
    work: Workspace | None = None,
) -> list[int]:
    """Evaluate a rule program for input x (crush_do_rule, mapper.c:900)."""
    rule = map.rules.get(ruleno)
    if rule is None:
        return []
    if work is None:
        work = Workspace()

    t = map.tunables
    choose_tries = t.choose_total_tries + 1  # off-by-one compat (mapper.c:922)
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    w: list[int] = []
    result: list[int] = []

    for step in rule.steps:
        op = step.op
        if op == 1:  # TAKE
            item = step.arg1
            valid = (0 <= item < map.max_devices) or item in map.buckets
            if valid:
                w = [item]
        elif op == 8:  # SET_CHOOSE_TRIES
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif op == 9:  # SET_CHOOSELEAF_TRIES
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif op == 10:  # SET_CHOOSE_LOCAL_TRIES
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif op == 11:  # SET_CHOOSE_LOCAL_FALLBACK_TRIES
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif op == 12:  # SET_CHOOSELEAF_VARY_R
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif op == 13:  # SET_CHOOSELEAF_STABLE
            if step.arg1 >= 0:
                stable = step.arg1
        elif op in (2, 3, 6, 7):  # CHOOSE[LEAF]_{FIRSTN,INDEP}
            if not w:
                continue
            firstn = op in (2, 6)
            recurse_to_leaf = op in (6, 7)
            # the reference advances the OUTPUT POINTER per take-entry
            # (o+osize, c+osize) and starts each choose call at outpos 0
            # (mapper.c:1030,1050), so rep numbering and collision scope are
            # per-call — use per-entry sub-arrays and splice
            o: list[int] = []
            c: list[int] = []
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                bucket = map.buckets.get(wi)
                if bucket is None:
                    continue
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    cap = result_max - osize
                    sub_o = [0] * cap
                    sub_c = [0] * cap
                    got = choose_firstn(
                        map, work, bucket, weight, x, numrep, step.arg2,
                        sub_o, 0, cap,
                        choose_tries, recurse_tries,
                        choose_local_retries, choose_local_fallback_retries,
                        recurse_to_leaf, vary_r, stable,
                        sub_c, 0,
                    )
                    o.extend(sub_o[:got])
                    c.extend(sub_c[:got])
                    osize += got
                else:
                    out_size = min(numrep, result_max - osize)
                    sub_o = [0] * out_size
                    sub_c = [0] * out_size
                    choose_indep(
                        map, work, bucket, weight, x, out_size, numrep,
                        step.arg2, sub_o, 0,
                        choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, sub_c, 0,
                    )
                    o.extend(sub_o)
                    c.extend(sub_c)
                    osize += out_size
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w = o[:osize]
        elif op == 4:  # EMIT
            result.extend(w[: result_max - len(result)])
            w = []
    return result
