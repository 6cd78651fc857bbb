"""CrushTester parity: the `crushtool --test` placement-statistics engine.

Re-expresses src/crush/CrushTester.{h,cc} (the loop at
CrushTester.cc:477-700): for each rule and each numrep in [min_rep, max_rep],
map every x in [min_x, max_x] and aggregate per-device counts, result-size
histograms, bad mappings, and expected-vs-actual utilization. Output lines
mirror the reference byte for byte (the cli test fixtures in
src/test/cli/crushtool/*.t are the oracle for the formats).

Port of ceph_tpu/crush/tester.py; its output is byte-identical. The mapping
loop is where the card helps: the reference evaluates one x at a time in a
single thread (BASELINE's "1M PGs over a 10k-OSD map" is exactly this); here
a rule that torch_mapper.supports() takes maps its whole x range in one
batched torch_mapper.map_rule call on `device` (default cuda). A rule it
refuses (legacy bucket algorithms, nonzero local tries) is the reference's
own semantics that the batched path does not model: it goes to the scalar
mapper per x, and `scalar_rules` counts each such (rule, numrep) batch.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush import mapper as scalar_mapper
from ceph_tpu_torch.crush import torch_mapper as tm
from ceph_tpu_torch.crush.hash import crush_hash32_2_np
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, CrushMap, RuleOp
from ceph_tpu_torch.device import resolve_device


def _fmt_float(x: float) -> str:
    """C++ default ostream float formatting: 6 significant digits."""
    return f"{x:.6g}"


def _vec(out: list[int]) -> str:
    return "[" + ",".join(str(v) for v in out) + "]"


@dataclass
class CrushTester:
    cmap: CrushMap
    min_x: int = -1
    max_x: int = -1
    min_rule: int = -1
    max_rule: int = -1
    min_rep: int = -1
    max_rep: int = -1
    ruleset: int = -1
    pool_id: int = -1
    device_weight: dict[int, int] = field(default_factory=dict)
    output_mappings: bool = False
    output_bad_mappings: bool = False
    output_utilization: bool = False
    output_utilization_all: bool = False
    output_statistics: bool = False
    out: object = None  # stream; defaults to stdout
    device: object = None  # None -> cuda; raises without a card
    #: (rule, numrep) batches mapped by the scalar mapper
    scalar_rules: int = 0
    #: seconds spent mapping (the rest of test() is host aggregation)
    map_seconds: float = 0.0
    _compiled: object = None  # memoized torch_mapper.CompiledMap

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _err(self, line: str) -> None:
        print(line, file=self.out or sys.stdout)

    # -- pieces of CrushTester::test ----------------------------------------

    def _weights(self) -> list[int]:
        present: set[int] = set()
        for b in self.cmap.buckets.values():
            present.update(i for i in b.items if i >= 0)
        weight = []
        for o in range(self.cmap.max_devices):
            if o in self.device_weight:
                weight.append(self.device_weight[o])
            elif o in present:
                weight.append(0x10000)
            else:
                weight.append(0)
        return weight

    def _max_affected_by_rule(self, rule) -> int:
        """CrushTester::get_maximum_affected_by_rule: upper bound on output
        size from the choose steps' types and replication counts."""
        affected: list[int] = []
        reps: dict[int, int] = {}
        for step in rule.steps:
            # the reference's filter is `op >= 2 && op != 4` — which also
            # sweeps in SET_* steps (their arg2 is 0 = device type, arg1 the
            # tries count); mirrored verbatim for output parity
            if step.op >= 2 and step.op != RuleOp.EMIT:
                affected.append(step.arg2)
                reps[step.arg2] = step.arg1
        max_of_type: dict[int, int] = {}
        for t in affected:
            n = 0
            for item in self.cmap.item_names:
                if self.cmap.item_type(item) == t:
                    n += 1
            max_of_type[t] = n
        for t in affected:
            if 0 < reps[t] < max_of_type[t]:
                max_of_type[t] = reps[t]
        max_affected = max(self.cmap.max_buckets, self.cmap.max_devices)
        for t in affected:
            if 0 < max_of_type[t] < max_affected:
                max_affected = max_of_type[t]
        return max_affected

    def _map_batch(self, ruleno: int, xs: np.ndarray, nr: int,
                   weight: list[int]) -> list[list[int]]:
        """All placements for the x batch: batched when supported."""
        t0 = time.perf_counter()
        real_xs = xs
        if self.pool_id != -1:
            real_xs = crush_hash32_2_np(xs, self.pool_id).astype(np.int64)
        if tm.supports(self.cmap, ruleno):
            if self._compiled is None:
                self._compiled = tm.compile_map_cached(self.cmap, device=self.device)
            got, lengths = tm.map_rule(
                self._compiled, ruleno, real_xs, weight, nr, return_lengths=True
            )
            rows = [row[:length] for row, length in zip(got.tolist(), lengths.tolist())]
        else:
            self.scalar_rules += 1
            ws = scalar_mapper.Workspace()
            rows = [
                scalar_mapper.do_rule(self.cmap, ruleno, int(x), weight, nr, ws)
                for x in real_xs
            ]
        self.map_seconds += time.perf_counter() - t0
        return rows

    # -- the test loop ------------------------------------------------------

    def test(self) -> int:
        min_rule, max_rule = self.min_rule, self.max_rule
        if min_rule < 0 or max_rule < 0:
            min_rule = 0
            max_rule = max(self.cmap.rules, default=-1)
        min_x, max_x = self.min_x, self.max_x
        if min_x < 0 or max_x < 0:
            min_x, max_x = 0, 1023

        weight = self._weights()
        if self.output_utilization_all:
            hexw = "[" + ",".join("%x" % w for w in weight) + "]"
            self._err(f"devices weights (hex): {hexw}")

        for r in range(min_rule, max_rule + 1):
            rule = self.cmap.rules.get(r)
            if rule is None:
                if self.output_statistics:
                    self._err(f"rule {r} dne")
                continue
            if self.ruleset >= 0 and rule.ruleset != self.ruleset:
                continue
            minr, maxr = self.min_rep, self.max_rep
            if minr < 0 or maxr < 0:
                minr, maxr = rule.min_size, rule.max_size
            rname = self.cmap.rule_names.get(r, "")
            if self.output_statistics:
                self._err(
                    f"rule {r} ({rname}), x = {min_x}..{max_x}, "
                    f"numrep = {minr}..{maxr}"
                )
            for nr in range(minr, maxr + 1):
                per = np.zeros(self.cmap.max_devices, dtype=np.int64)
                sizes: dict[int, int] = {}
                num_objects = max_x - min_x + 1
                total_weight = sum(weight)
                if total_weight == 0:
                    continue
                expected_objects = (
                    min(nr, self._max_affected_by_rule(rule)) * num_objects
                )
                proportional = np.asarray(weight, dtype=np.float64) / float(
                    total_weight
                )
                num_objects_expected = proportional * float(expected_objects)

                xs = np.arange(min_x, max_x + 1)
                results = self._map_batch(r, xs, nr, weight)
                for x, vals in zip(xs, results):
                    if self.output_mappings:
                        self._err(f"CRUSH rule {r} x {x} {_vec(vals)}")
                    has_none = False
                    for v in vals:
                        if v == CRUSH_ITEM_NONE:
                            has_none = True
                        elif 0 <= v < len(per):
                            # non-leaf results (choose type host) emit bucket
                            # ids; the reference writes those out of bounds
                            # (UB) — skip them instead
                            per[v] += 1
                    sizes[len(vals)] = sizes.get(len(vals), 0) + 1
                    if self.output_bad_mappings and (
                        len(vals) != nr or has_none
                    ):
                        self._err(
                            f"bad mapping rule {r} x {x} num_rep {nr} "
                            f"result {_vec(vals)}"
                        )

                if self.output_utilization and not self.output_statistics:
                    for i in range(len(per)):
                        self._err(f"  device {i}:\t{per[i]}")
                if self.output_statistics:
                    for size in sorted(sizes):
                        self._err(
                            f"rule {r} ({rname}) num_rep {nr} result size "
                            f"== {size}:\t{sizes[size]}/{num_objects}"
                        )
                    for i in range(len(per)):
                        show = (
                            self.output_utilization
                            and num_objects_expected[i] > 0
                            and per[i] > 0
                        ) or self.output_utilization_all
                        if show:
                            self._err(
                                f"  device {i}:\t\t stored : {per[i]}"
                                f"\t expected : "
                                f"{_fmt_float(num_objects_expected[i])}"
                            )
        return 0
