"""Map construction: buckets with derived fields, rules, reweighting.

Re-expresses src/crush/builder.c: each bucket algorithm
precomputes what its choose function needs — list buckets a running weight
prefix (builder.c crush_make_list_bucket), tree buckets a binary-heap weight
array over nodes 2i+1 (crush_make_tree_bucket), straw(1) buckets calibrated
straw lengths via the historical float search (crush_calc_straw, version >= 1
semantics), straw2 just the raw weights. All weights 16.16 fixed point.
"""

from __future__ import annotations

from ceph_tpu_torch.crush.types import (
    Bucket,
    BucketAlg,
    CrushMap,
    Rule,
    RuleOp,
    RuleStep,
)


def tree_depth(size: int) -> int:
    if size == 0:
        return 0
    depth = 1
    t = size - 1
    while t:
        t >>= 1
        depth += 1
    return depth


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _tree_parent(n: int) -> int:
    h = _tree_height(n)
    if n & (1 << (h + 1)):
        return n - (1 << h)
    return n + (1 << h)


def calc_straws(weights: list[int], straw_calc_version: int = 1) -> list[int]:
    """Straw(1) calibration — the flawed-but-frozen historical algorithm
    (builder.c crush_calc_straw). Returns 16.16 straw lengths."""
    size = len(weights)
    order = sorted(range(size), key=lambda i: (weights[i], i))
    straws = [0] * size
    numleft = size
    straw = 1.0
    wbelow = 0.0
    lastw = 0.0
    i = 0
    while i < size:
        if straw_calc_version == 0:
            if weights[order[i]] == 0:
                straws[order[i]] = 0
                i += 1
                continue
            straws[order[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            if weights[order[i]] == weights[order[i - 1]]:
                continue
            wbelow += (weights[order[i - 1]] - lastw) * numleft
            j = i
            while j < size and weights[order[j]] == weights[order[i]]:
                numleft -= 1
                j += 1
            wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= (1.0 / pbelow) ** (1.0 / numleft)
            lastw = weights[order[i - 1]]
        else:
            if weights[order[i]] == 0:
                straws[order[i]] = 0
                i += 1
                numleft -= 1
                continue
            straws[order[i]] = int(straw * 0x10000)
            i += 1
            if i == size:
                break
            wbelow += (weights[order[i - 1]] - lastw) * numleft
            numleft -= 1
            wnext = numleft * (weights[order[i]] - weights[order[i - 1]])
            pbelow = wbelow / (wbelow + wnext)
            straw *= (1.0 / pbelow) ** (1.0 / numleft)
            lastw = weights[order[i - 1]]
    return straws


def make_bucket(
    map: CrushMap,
    bucket_id: int,
    alg: BucketAlg,
    type: int,
    items: list[int],
    weights: list[int],
    hash: int = 0,
) -> Bucket:
    """Create a bucket with derived fields and register it in the map.

    For UNIFORM buckets every item must carry the same weight (the reference's
    crush_make_bucket takes a single item_weight; CrushWrapper passes the
    first item's weight).
    """
    assert bucket_id < 0, "bucket ids are negative"
    assert len(items) == len(weights)
    size = len(items)
    b = Bucket(
        id=bucket_id,
        type=type,
        alg=alg,
        hash=hash,
        weight=sum(weights),
        items=list(items),
        item_weights=list(weights),
    )
    if alg == BucketAlg.UNIFORM:
        b.item_weight = weights[0] if size else 0
        b.weight = size * b.item_weight
    elif alg == BucketAlg.LIST:
        acc = 0
        b.sum_weights = []
        for w in weights:
            acc += w
            b.sum_weights.append(acc)
    elif alg == BucketAlg.TREE:
        depth = tree_depth(size)
        num_nodes = 1 << depth
        node_weights = [0] * num_nodes
        for i, w in enumerate(weights):
            node = (i << 1) + 1  # crush_calc_tree_node
            node_weights[node] = w
            for _ in range(1, depth):
                node = _tree_parent(node)
                node_weights[node] += w
        b.node_weights = node_weights
    elif alg == BucketAlg.STRAW:
        b.straws = calc_straws(weights, map.tunables.straw_calc_version)
    elif alg == BucketAlg.STRAW2:
        pass
    else:
        raise ValueError(f"unknown bucket alg {alg}")
    map.buckets[bucket_id] = b
    if map.max_devices <= max((i for i in items if i >= 0), default=-1):
        map.max_devices = max(i for i in items if i >= 0) + 1
    return b


def make_rule(
    map: CrushMap,
    rule_id: int,
    steps: list[RuleStep],
    rule_type: int = 1,
    min_size: int = 1,
    max_size: int = 10,
) -> Rule:
    rule = Rule(
        rule_id=rule_id,
        ruleset=rule_id,
        type=rule_type,
        min_size=min_size,
        max_size=max_size,
        steps=list(steps),
    )
    map.rules[rule_id] = rule
    return rule


def make_simple_rule(
    map: CrushMap,
    rule_id: int,
    root: int,
    failure_domain_type: int,
    mode: str = "firstn",
    num: int = 0,
) -> Rule:
    """The common replicated/EC rule shape (CrushWrapper::add_simple_rule):
    take root -> chooseleaf <mode> num type <domain> -> emit."""
    op = (
        RuleOp.CHOOSELEAF_FIRSTN if mode == "firstn" else RuleOp.CHOOSELEAF_INDEP
    )
    steps = [
        RuleStep(RuleOp.TAKE, root),
        RuleStep(op, num, failure_domain_type),
        RuleStep(RuleOp.EMIT),
    ]
    return make_rule(map, rule_id, steps, rule_type=1 if mode == "firstn" else 3)


def bucket_add_item(
    map: CrushMap, bucket_id: int, item: int, weight: int
) -> None:
    """Add one item to a straw2 bucket and propagate the weight change up
    the hierarchy (crush_bucket_add_item, builder.c:863, plus the ancestor
    reweight CrushWrapper::insert_item performs).

    straw2 needs no per-item recalibration (the draw divides by the raw
    16.16 weight), which is why cluster expansion targets straw2 maps; the
    legacy algs would need their derived tables rebuilt."""
    b = map.buckets.get(bucket_id)
    if b is None:
        raise ValueError(f"no bucket {bucket_id}")
    if b.alg != BucketAlg.STRAW2:
        raise ValueError("bucket_add_item supports straw2 buckets only")
    if item in b.items:
        raise ValueError(f"item {item} already in bucket {bucket_id}")
    b.items.append(item)
    b.item_weights.append(weight)
    b.weight += weight
    if item >= 0 and map.max_devices <= item:
        map.max_devices = item + 1
    _adjust_ancestor_weights(map, bucket_id, weight)
    if map.class_bucket:
        populate_classes(map)  # shadows must track the real hierarchy


def _adjust_ancestor_weights(map: CrushMap, child: int, delta: int) -> None:
    for bid, parent in map.buckets.items():
        if child in parent.items:
            idx = parent.items.index(child)
            parent.item_weights[idx] += delta
            parent.weight += delta
            if parent.alg != BucketAlg.STRAW2:
                raise ValueError(
                    "ancestor reweight supports straw2 buckets only"
                )
            _adjust_ancestor_weights(map, bid, delta)


def populate_classes(map: CrushMap) -> None:
    """Build per-class shadow hierarchies (CrushWrapper::populate_classes /
    device_class_clone, src/crush/CrushWrapper.cc): for every (bucket,
    device class) pair, a shadow bucket holding only that class's devices
    (and the shadow clones of child buckets). A classed rule step
    (`step take root class ssd`) then TAKEs the shadow id and the mapper —
    scalar or batched — needs no class awareness at all: shadows are ordinary
    buckets.

    Rebuilds from scratch (idempotent): callers re-run it after any
    hierarchy or class change, the way the reference rebuilds shadows on
    rebuild_roots.
    """
    for sid in set(map.class_bucket.values()):
        map.buckets.pop(sid, None)
        map.item_names.pop(sid, None)
    map.class_bucket = {}
    classes = sorted(set(map.device_classes.values()))
    if not classes:
        return

    # children-first order so a shadow can reference its child shadows
    order: list[int] = []
    seen: set[int] = set()

    def visit(bid: int) -> None:
        if bid in seen:
            return
        seen.add(bid)
        for item in map.buckets[bid].items:
            if item < 0 and item in map.buckets:
                visit(item)
        order.append(bid)

    for bid in sorted(map.buckets, reverse=True):
        visit(bid)

    next_id = min(map.buckets, default=-1) - 1
    for cls in classes:
        for bid in order:
            b = map.buckets[bid]
            kept_items: list[int] = []
            kept_weights: list[int] = []
            for pos, item in enumerate(b.items):
                if item >= 0:
                    if map.device_classes.get(item) == cls:
                        kept_items.append(item)
                        kept_weights.append(
                            b.item_weights[pos]
                            if pos < len(b.item_weights)
                            else b.item_weight
                        )
                else:
                    sid = map.class_bucket.get((item, cls))
                    if sid is not None and map.buckets[sid].items:
                        kept_items.append(sid)
                        kept_weights.append(map.buckets[sid].weight)
            shadow = make_bucket(
                map, next_id, b.alg, b.type, kept_items, kept_weights,
                hash=b.hash,
            )
            map.class_bucket[(bid, cls)] = shadow.id
            base = map.item_names.get(bid, f"bucket{-bid}")
            map.item_names[shadow.id] = f"{base}~{cls}"
            next_id -= 1


def reweight_subtree(
    map: CrushMap, root_id: int, weight: int
) -> int:
    """Set every device under `root_id` to `weight` (16.16) and rebuild
    bucket weights bottom-up (CrushWrapper::adjust_subtree_weightset /
    `ceph osd crush reweight-subtree` semantics). Returns the number of
    devices touched. Straw2 only, like the other mutators here."""
    touched = 0

    def rebuild(bid: int) -> int:
        nonlocal touched
        b = map.buckets[bid]
        if b.alg != BucketAlg.STRAW2:
            raise ValueError("reweight_subtree supports straw2 buckets only")
        total = 0
        for pos, item in enumerate(b.items):
            if item >= 0:
                b.item_weights[pos] = weight
                touched += 1
            else:
                b.item_weights[pos] = rebuild(item)
            total += b.item_weights[pos]
        b.weight = total
        return total

    new = rebuild(root_id)
    for bid, parent in map.buckets.items():
        if root_id in parent.items:
            idx = parent.items.index(root_id)
            delta = new - parent.item_weights[idx]
            parent.item_weights[idx] = new
            parent.weight += delta
            _adjust_ancestor_weights(map, bid, delta)
    if map.class_bucket:
        populate_classes(map)  # shadows must track the real weights
    return touched
