"""CrushTreeDumper: the generic hierarchy visitor + validation walk.

Re-expresses src/crush/CrushTreeDumper.h:1-291 — the one tree-walk
engine behind `ceph osd tree`, `crushtool --tree`, and the map-sanity
checks — instead of per-tool ad-hoc recursion:

  * `walk(cmap, visit)` — depth-first from every root in reference
    order (highest bucket id first), calling
    `visit(item_id, bucket_or_None, depth)` per node, cycle-safe
    (a malformed map with a bucket loop terminates and is reported by
    `validate`, never recursed forever).
  * `dump_items(cmap)` — the flat annotated node list (id, name, type,
    depth, weight) both CLIs render.
  * `validate(cmap)` — the structural checks CrushTester's name-map and
    overlap validation performs (check_name_maps, CrushTester.cc:415):
    dangling item references, cycles, weight sums that disagree with
    the bucket's advertised weight, duplicate child entries, and items
    past max_devices.
"""

from __future__ import annotations

from typing import Callable

from ceph_tpu_torch.crush.types import BucketAlg, CrushMap


def roots_of(cmap: CrushMap) -> list[int]:
    """Bucket ids reachable from nowhere, reference order (id -1 down)."""
    children = {
        i for b in cmap.buckets.values() for i in b.items if i < 0
    }
    return sorted(
        (bid for bid in cmap.buckets if bid not in children),
        reverse=True,
    )


def walk(
    cmap: CrushMap,
    visit: Callable[[int, object, int], None],
    root: int | None = None,
) -> None:
    """Depth-first visit of every (item, bucket-or-None, depth)."""
    seen: set[int] = set()

    def rec(item: int, depth: int) -> None:
        if item >= 0:
            visit(item, None, depth)
            return
        if item in seen:
            return  # cycle: validate() reports it; never loop
        seen.add(item)
        b = cmap.buckets.get(item)
        visit(item, b, depth)
        if b is not None:
            for child in b.items:
                rec(child, depth + 1)
        seen.discard(item)

    for bid in [root] if root is not None else roots_of(cmap):
        rec(bid, 0)


def item_weight(cmap: CrushMap, item: int) -> int:
    """16.16 weight of an item: a bucket's own weight, or the weight its
    parent assigns a device (first parent wins, like the dumper)."""
    if item < 0:
        b = cmap.buckets.get(item)
        return b.weight if b else 0
    for b in cmap.buckets.values():
        if item in b.items:
            j = b.items.index(item)
            return (
                b.item_weight
                if b.alg == BucketAlg.UNIFORM
                else b.item_weights[j]
            )
    return 0


def dump_items(cmap: CrushMap, root: int | None = None) -> list[dict]:
    """Flat node list in visit order (the Dumper::dump_item shape)."""
    nodes: list[dict] = []

    def visit(item: int, bucket, depth: int) -> None:
        if item >= 0:
            nodes.append({
                "id": item,
                "name": cmap.item_names.get(item, f"osd.{item}"),
                "type": "osd",
                "depth": depth,
                "weight": item_weight(cmap, item) / 0x10000,
            })
        else:
            nodes.append({
                "id": item,
                "name": cmap.item_names.get(item, f"bucket{-item}"),
                "type": (
                    cmap.type_names.get(bucket.type, str(bucket.type))
                    if bucket is not None else "?"
                ),
                "depth": depth,
                "weight": (
                    bucket.weight / 0x10000 if bucket is not None
                    else 0.0
                ),
            })

    walk(cmap, visit, root=root)
    return nodes


def validate(cmap: CrushMap) -> list[str]:
    """Structural problems, empty when the map is sound."""
    problems: list[str] = []
    for bid, b in cmap.buckets.items():
        if len(set(b.items)) != len(b.items):
            problems.append(f"bucket {bid} lists a duplicate child")
        weight_sum = 0
        for j, item in enumerate(b.items):
            w = (
                b.item_weight
                if b.alg == BucketAlg.UNIFORM
                else b.item_weights[j]
            )
            weight_sum += w
            if item < 0 and item not in cmap.buckets:
                problems.append(
                    f"bucket {bid} references missing bucket {item}"
                )
            if item >= cmap.max_devices:
                problems.append(
                    f"bucket {bid} references device {item} past "
                    f"max_devices {cmap.max_devices}"
                )
        if b.items and weight_sum != b.weight:
            problems.append(
                f"bucket {bid} weight {b.weight} != sum of item "
                f"weights {weight_sum}"
            )
    # cycles: a DFS that re-enters a bucket on the current path
    state: dict[int, int] = {}  # 1 = on path, 2 = done

    def dfs(bid: int, path: tuple) -> None:
        if state.get(bid) == 1:
            problems.append(
                "cycle: " + " -> ".join(str(p) for p in path + (bid,))
            )
            return
        if state.get(bid) == 2:
            return
        state[bid] = 1
        for item in cmap.buckets[bid].items:
            if item < 0 and item in cmap.buckets:
                dfs(item, path + (bid,))
        state[bid] = 2

    for bid in sorted(cmap.buckets, reverse=True):
        if state.get(bid) is None:
            dfs(bid, ())
    return problems
