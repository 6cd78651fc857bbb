"""CRUSH data model: buckets, rules, maps, tunables, choose_args.

Idiomatic-Python re-expression of the structs in
src/crush/crush.h (crush_bucket and its five per-algorithm
variants, crush_rule/crush_rule_step, crush_choose_arg, crush_map). Weights are
16.16 fixed point throughout, exactly as in the reference; derived per-
algorithm fields (list sum_weights, tree node_weights, straw straws) are
computed by builder.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

# crush.h:33-37
CRUSH_ITEM_UNDEF = 0x7FFFFFFE
CRUSH_ITEM_NONE = 0x7FFFFFFF

CRUSH_MAX_DEVICE_WEIGHT = 100 * 0x10000
CRUSH_MAX_BUCKET_WEIGHT = 65535 * 0x10000


class BucketAlg(IntEnum):  # crush.h:140-190
    UNIFORM = 1
    LIST = 2
    TREE = 3
    STRAW = 4
    STRAW2 = 5


class RuleOp(IntEnum):  # crush.h:55-69
    NOOP = 0
    TAKE = 1
    CHOOSE_FIRSTN = 2
    CHOOSE_INDEP = 3
    EMIT = 4
    CHOOSELEAF_FIRSTN = 6
    CHOOSELEAF_INDEP = 7
    SET_CHOOSE_TRIES = 8
    SET_CHOOSELEAF_TRIES = 9
    SET_CHOOSE_LOCAL_TRIES = 10
    SET_CHOOSE_LOCAL_FALLBACK_TRIES = 11
    SET_CHOOSELEAF_VARY_R = 12
    SET_CHOOSELEAF_STABLE = 13


@dataclass
class Bucket:
    """One interior node of the hierarchy (crush.h:229 + per-alg variants)."""

    id: int  # negative
    type: int  # operator-defined level (host/rack/...)
    alg: BucketAlg
    hash: int  # CRUSH_HASH_RJENKINS1 == 0
    weight: int  # 16.16, sum of item weights
    items: list[int]
    # per-algorithm payloads (builder.py fills the derived ones):
    item_weights: list[int] = field(default_factory=list)  # list/straw/straw2
    item_weight: int = 0  # uniform: every item has this weight
    sum_weights: list[int] = field(default_factory=list)  # list: prefix sums
    node_weights: list[int] = field(default_factory=list)  # tree: heap array
    straws: list[int] = field(default_factory=list)  # straw: calibrated lengths

    @property
    def size(self) -> int:
        return len(self.items)


@dataclass
class RuleStep:
    op: RuleOp
    arg1: int = 0
    arg2: int = 0


@dataclass
class Rule:
    """A placement program (crush.h crush_rule: mask + steps)."""

    rule_id: int
    ruleset: int
    type: int  # pool type (1=replicated, 3=erasure)
    min_size: int
    max_size: int
    steps: list[RuleStep] = field(default_factory=list)


@dataclass
class ChooseArg:
    """Per-bucket weight_set/ids overrides (crush.h:248-294), used by the
    balancer's crush-compat mode."""

    ids: list[int] | None = None
    weight_set: list[list[int]] | None = None  # [position][item] 16.16


@dataclass
class Tunables:
    """mapper behavior knobs; defaults = the reference's 'jewel' profile,
    which CrushWrapper sets via set_tunables_default (CrushWrapper.h:147+)."""

    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1

    @classmethod
    def argonaut(cls) -> "Tunables":
        return cls(2, 5, 19, 0, 0, 0, 0)

    @classmethod
    def bobtail(cls) -> "Tunables":
        return cls(0, 0, 50, 1, 0, 0, 1)

    @classmethod
    def firefly(cls) -> "Tunables":
        return cls(0, 0, 50, 1, 1, 0, 1)

    @classmethod
    def jewel(cls) -> "Tunables":
        return cls(0, 0, 50, 1, 1, 1, 1)


@dataclass
class CrushMap:
    """The whole placement function: hierarchy + rules + tunables.

    buckets are keyed by bucket id (negative); max_devices bounds positive
    item ids, as in struct crush_map (crush.h:354).
    """

    buckets: dict[int, Bucket] = field(default_factory=dict)
    rules: dict[int, Rule] = field(default_factory=dict)
    max_devices: int = 0
    tunables: Tunables = field(default_factory=Tunables)
    choose_args: dict[int, ChooseArg] = field(default_factory=dict)
    # name/type maps (CrushWrapper): id -> name, type id -> type name
    type_names: dict[int, str] = field(default_factory=dict)
    item_names: dict[int, str] = field(default_factory=dict)
    rule_names: dict[int, str] = field(default_factory=dict)
    # device id -> class name (CrushWrapper class_map)
    device_classes: dict[int, str] = field(default_factory=dict)
    # (original bucket id, class name) -> shadow bucket id
    # (CrushWrapper::class_bucket; filled by builder.populate_classes)
    class_bucket: dict = field(default_factory=dict)
    # every named choose_args map from the text grammar (choose_args <id>);
    # `choose_args` above is the active one the mapper consumes
    choose_args_maps: dict[int, dict[int, ChooseArg]] = field(
        default_factory=dict
    )

    @property
    def max_buckets(self) -> int:
        return max((-b for b in self.buckets), default=0)

    def bucket(self, item: int) -> Bucket | None:
        return self.buckets.get(item)

    def item_type(self, item: int) -> int:
        if item >= 0:
            return 0
        b = self.buckets.get(item)
        return b.type if b else -1
