"""Text crushmap compiler/decompiler — CrushCompiler parity.

Re-expresses src/crush/CrushCompiler.{h,cc} (1375 LoC,
boost::spirit grammar in grammar.h:120-191) as a recursive-descent parser over
the same token grammar:

    crushmap    := *(tunable | device | type) *(bucket | rule) *choose_args
    tunable     := "tunable" name posint
    device      := "device" posint name ["class" name]
    type        := "type" posint name
    bucket      := typename name "{" *("id" negint ["class" name])
                   "alg" name *("hash" (int|"rjenkins1"))
                   *("item" name ["weight" real] ["pos" posint]) "}"
    rule        := "rule" [name] "{" ("id"|"ruleset") int "type" name
                   "min_size" int "max_size" int *step "}"
    choose_args := "choose_args" posint "{" *choose_arg "}"

Comments run from '#' to end of line. Weights are parsed as float32 *
0x10000 truncated, matching parse_bucket's `float_node(...) * (float)0x10000`
(CrushCompiler.cc:685). Decompile mirrors the reference's exact output format
(CrushCompiler.cc:92-156, 287-420): tab indentation, "%.3f" fixed-point
weights, `# do not change unnecessarily` annotations, tunables only when they
differ from the legacy defaults, DFS bucket ordering, and choose_args blocks.

Device classes: class-filtered TAKE steps ("step take root class ssd")
compile against per-class shadow hierarchies built lazily on first use
(builder.populate_classes, mirroring CrushWrapper::populate_classes);
shadow buckets are derived state — decompile never emits them and instead
reverse-maps shadow TAKE targets back to `take <bucket> class <c>`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush import builder as cb
from ceph_tpu_torch.crush.types import (
    BucketAlg,
    ChooseArg,
    CrushMap,
    Rule,
    RuleOp,
    RuleStep,
    Tunables,
)

#: legacy (argonaut) tunables: what a freshly created crush_map has and the
#: baseline against which decompile omits defaults (crush.c set_tunables)
LEGACY_TUNABLES = dict(
    choose_local_tries=2,
    choose_local_fallback_tries=5,
    choose_total_tries=19,
    chooseleaf_descend_once=0,
    chooseleaf_vary_r=0,
    chooseleaf_stable=0,
    straw_calc_version=0,
)

ALG_NAMES = {
    BucketAlg.UNIFORM: "uniform",
    BucketAlg.LIST: "list",
    BucketAlg.TREE: "tree",
    BucketAlg.STRAW: "straw",
    BucketAlg.STRAW2: "straw2",
}
ALG_BY_NAME = {v: k for k, v in ALG_NAMES.items()}

_STEP_SETS = {
    "set_choose_tries": RuleOp.SET_CHOOSE_TRIES,
    "set_choose_local_tries": RuleOp.SET_CHOOSE_LOCAL_TRIES,
    "set_choose_local_fallback_tries": RuleOp.SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    "set_chooseleaf_tries": RuleOp.SET_CHOOSELEAF_TRIES,
    "set_chooseleaf_vary_r": RuleOp.SET_CHOOSELEAF_VARY_R,
    "set_chooseleaf_stable": RuleOp.SET_CHOOSELEAF_STABLE,
}


class CompileError(ValueError):
    pass


def parse_weight(text: str) -> int:
    """float32(text) * float32(0x10000), truncated — CrushCompiler.cc:685."""
    return int(np.float32(text) * np.float32(0x10000))


_TOKEN_RE = re.compile(r"[A-Za-z0-9_.\-]+|[{}\[\]]")


def _tokenize(text: str) -> list[str]:
    out: list[str] = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        out.extend(_TOKEN_RE.findall(line))
    return out


@dataclass
class _Parser:
    tokens: list[str]
    pos: int = 0
    cmap: CrushMap = field(default_factory=CrushMap)
    names: dict[str, int] = field(default_factory=dict)  # item name -> id
    type_ids: dict[str, int] = field(default_factory=dict)

    def peek(self) -> str | None:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise CompileError("unexpected end of crushmap")
        self.pos += 1
        return tok

    def expect(self, want: str) -> None:
        tok = self.next()
        if tok != want:
            raise CompileError(f"expected {want!r}, got {tok!r}")

    def expect_int(self) -> int:
        tok = self.next()
        try:
            return int(tok)
        except ValueError:
            raise CompileError(f"expected integer, got {tok!r}") from None

    # -- statements ---------------------------------------------------------

    def parse(self) -> CrushMap:
        self.cmap.tunables = Tunables(**LEGACY_TUNABLES)
        while (tok := self.peek()) is not None:
            if tok == "tunable":
                self._tunable()
            elif tok == "device":
                self._device()
            elif tok == "type":
                self._type()
            elif tok == "rule":
                self._rule()
            elif tok == "choose_args":
                self._choose_args()
            elif tok in self.type_ids:
                self._bucket()
            else:
                raise CompileError(f"unknown statement at {tok!r}")
        return self.cmap

    def _tunable(self) -> None:
        self.next()
        name = self.next()
        value = self.expect_int()
        if name in LEGACY_TUNABLES:
            setattr(self.cmap.tunables, name, value)
        elif name == "allowed_bucket_algs":
            pass  # bucket-alg feature gating: no effect on mapping math
        else:
            raise CompileError(f"unknown tunable {name!r}")

    def _device(self) -> None:
        self.next()
        dev_id = self.expect_int()
        name = self.next()
        self.names[name] = dev_id
        self.cmap.item_names[dev_id] = name
        self.cmap.max_devices = max(self.cmap.max_devices, dev_id + 1)
        if self.peek() == "class":
            self.next()
            self.cmap.device_classes[dev_id] = self.next()

    def _type(self) -> None:
        self.next()
        type_id = self.expect_int()
        name = self.next()
        self.type_ids[name] = type_id
        self.cmap.type_names[type_id] = name

    def _bucket(self) -> None:
        type_name = self.next()
        bucket_name = self.next()
        if bucket_name in self.names:
            raise CompileError(f"bucket {bucket_name!r} already defined")
        self.expect("{")
        bucket_id = None
        alg = None
        hash_ = 0
        items: list[int] = []
        weights: list[int] = []
        while (tok := self.next()) != "}":
            if tok == "id":
                val = self.expect_int()
                if self.peek() == "class":
                    self.next()
                    self.next()  # per-class shadow id: recomputed, not stored
                else:
                    bucket_id = val
            elif tok == "alg":
                alg_name = self.next()
                if alg_name not in ALG_BY_NAME:
                    raise CompileError(f"unknown bucket alg {alg_name!r}")
                alg = ALG_BY_NAME[alg_name]
            elif tok == "hash":
                h = self.next()
                hash_ = 0 if h == "rjenkins1" else int(h)
            elif tok == "item":
                item_name = self.next()
                if item_name not in self.names:
                    raise CompileError(
                        f"item {item_name!r} not defined before use"
                    )
                items.append(self.names[item_name])
                weight = None
                if self.peek() == "weight":
                    self.next()
                    weight = parse_weight(self.next())
                if self.peek() == "pos":
                    self.next()
                    pos = self.expect_int()
                    if pos != len(items) - 1:
                        raise CompileError(
                            f"item {item_name!r} pos {pos} out of order "
                            "(reordered pos lists are not supported)"
                        )
                if weight is None:
                    # devices default to 1.0; buckets contribute their weight
                    child = self.cmap.buckets.get(items[-1])
                    weight = child.weight if child else 0x10000
                weights.append(weight)
            else:
                raise CompileError(f"unexpected token {tok!r} in bucket")
        if alg is None:
            raise CompileError(f"bucket {bucket_name!r} has no alg")
        if bucket_id is None:
            bucket_id = -1 - self.cmap.max_buckets
        if type_name not in self.type_ids:
            raise CompileError(f"unknown bucket type {type_name!r}")
        cb.make_bucket(
            self.cmap, bucket_id, alg, self.type_ids[type_name], items,
            weights, hash=hash_,
        )
        self.names[bucket_name] = bucket_id
        self.cmap.item_names[bucket_id] = bucket_name

    def _rule(self) -> None:
        self.next()
        rule_name = None
        if self.peek() != "{":
            rule_name = self.next()
        self.expect("{")
        tok = self.next()
        if tok not in ("id", "ruleset"):
            raise CompileError(f"expected id/ruleset, got {tok!r}")
        rule_id = self.expect_int()
        self.expect("type")
        tname = self.next()
        rtype = {"replicated": 1, "erasure": 3}.get(tname)
        if rtype is None:
            rtype = int(tname)
        self.expect("min_size")
        min_size = self.expect_int()
        self.expect("max_size")
        max_size = self.expect_int()
        steps: list[RuleStep] = []
        while (tok := self.next()) != "}":
            if tok != "step":
                raise CompileError(f"expected step, got {tok!r}")
            op = self.next()
            if op == "take":
                item_name = self.next()
                if item_name not in self.names:
                    raise CompileError(f"take: unknown item {item_name!r}")
                target = self.names[item_name]
                if self.peek() == "class":
                    self.next()
                    cls = self.next()
                    if cls not in set(self.cmap.device_classes.values()):
                        raise CompileError(
                            f"take: unknown device class {cls!r}"
                        )
                    # shadow hierarchies are derived state: build them on
                    # first classed take (all buckets are parsed by now —
                    # rules follow buckets in the grammar)
                    if (target, cls) not in self.cmap.class_bucket:
                        from ceph_tpu_torch.crush.builder import (
                            populate_classes,
                        )

                        populate_classes(self.cmap)
                    shadow = self.cmap.class_bucket.get((target, cls))
                    if shadow is None:
                        raise CompileError(
                            f"take {item_name!r} class {cls!r}: classed "
                            f"take needs a bucket, not a device"
                        )
                    target = shadow
                steps.append(RuleStep(RuleOp.TAKE, target))
            elif op == "emit":
                steps.append(RuleStep(RuleOp.EMIT))
            elif op in ("choose", "chooseleaf"):
                mode = self.next()
                if mode not in ("firstn", "indep"):
                    raise CompileError(f"bad choose mode {mode!r}")
                num = self.expect_int()
                self.expect("type")
                type_name = self.next()
                if type_name not in self.type_ids:
                    raise CompileError(f"choose: unknown type {type_name!r}")
                opmap = {
                    ("choose", "firstn"): RuleOp.CHOOSE_FIRSTN,
                    ("choose", "indep"): RuleOp.CHOOSE_INDEP,
                    ("chooseleaf", "firstn"): RuleOp.CHOOSELEAF_FIRSTN,
                    ("chooseleaf", "indep"): RuleOp.CHOOSELEAF_INDEP,
                }
                steps.append(
                    RuleStep(opmap[(op, mode)], num, self.type_ids[type_name])
                )
            elif op in _STEP_SETS:
                steps.append(RuleStep(_STEP_SETS[op], self.expect_int()))
            else:
                raise CompileError(f"unknown step {op!r}")
        if rule_id in self.cmap.rules:
            raise CompileError(f"rule {rule_id} already exists")
        rule = Rule(
            rule_id=rule_id, ruleset=rule_id, type=rtype,
            min_size=min_size, max_size=max_size, steps=steps,
        )
        self.cmap.rules[rule_id] = rule
        if rule_name:
            self.cmap.rule_names[rule_id] = rule_name

    def _choose_args(self) -> None:
        self.next()
        args_id = self.expect_int()
        self.expect("{")
        amap: dict[int, ChooseArg] = {}
        while (tok := self.next()) != "}":
            if tok != "{":
                raise CompileError(f"expected {{ in choose_args, got {tok!r}")
            self.expect("bucket_id")
            bucket_id = self.expect_int()
            ids = None
            weight_set = None
            while (tok := self.next()) != "}":
                if tok == "weight_set":
                    self.expect("[")
                    weight_set = []
                    while self.peek() == "[":
                        self.next()
                        row = []
                        while self.peek() != "]":
                            row.append(parse_weight(self.next()))
                        self.next()
                        weight_set.append(row)
                    self.expect("]")
                elif tok == "ids":
                    self.expect("[")
                    ids = []
                    while self.peek() != "]":
                        ids.append(self.expect_int())
                    self.next()
                else:
                    raise CompileError(
                        f"unexpected {tok!r} in choose_args entry"
                    )
            amap[bucket_id] = ChooseArg(ids=ids, weight_set=weight_set)
        if args_id in self.cmap.choose_args_maps:
            raise CompileError(f"choose_args {args_id} already defined")
        self.cmap.choose_args_maps[args_id] = amap
        if len(self.cmap.choose_args_maps) == 1:
            # single map: it is THE active choose_args for the mapper
            self.cmap.choose_args = amap


def compile_crushmap(text: str) -> CrushMap:
    """Text crushmap -> CrushMap (CrushCompiler::compile)."""
    return _Parser(_tokenize(text)).parse()


# -- decompile ---------------------------------------------------------------


def _fixedpoint(w: int) -> str:
    return "%.3f" % (np.float32(w) / np.float32(0x10000))


def _item_name(cmap: CrushMap, item: int) -> str:
    name = cmap.item_names.get(item)
    if name is not None:
        return name
    return f"device{item}" if item >= 0 else f"bucket{-item}"


def decompile_crushmap(cmap: CrushMap) -> str:
    """CrushMap -> text, mirroring CrushCompiler::decompile's exact format.

    Type ids with no registered name get a synthesized `type<N>` entry so
    the output always re-compiles (the grammar requires bucket and
    chooseleaf types to be declared names); maps built via the compiler or
    with named types are unaffected."""
    type_names = dict(cmap.type_names)
    used_types = {b.type for b in cmap.buckets.values()}
    for rule in cmap.rules.values():
        for step in rule.steps:
            if step.op in (
                RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP,
                RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP,
            ):
                used_types.add(step.arg2)
    for tid in sorted(used_types):
        type_names.setdefault(tid, f"type{tid}")

    out: list[str] = ["# begin crush map\n"]
    t = cmap.tunables
    for name, default in LEGACY_TUNABLES.items():
        value = getattr(t, name)
        if value != default:
            out.append(f"tunable {name} {value}\n")

    out.append("\n# devices\n")
    for dev in range(cmap.max_devices):
        # every slot is declared (named or `device<N>` fallback) so items
        # can always resolve on re-compile, as the reference decompiler does
        line = f"device {dev} {_item_name(cmap, dev)}"
        if dev in cmap.device_classes:
            line += f" class {cmap.device_classes[dev]}"
        out.append(line + "\n")

    out.append("\n# types\n")
    for type_id in sorted(type_names):
        out.append(f"type {type_id} {type_names[type_id]}\n")

    out.append("\n# buckets\n")
    done: set[int] = set()
    # shadow (per-class clone) buckets are derived state: never emitted,
    # recompile rebuilds them from the classed take steps
    shadow_ids = set(cmap.class_bucket.values())
    shadow_to_class = {
        sid: (orig, cls) for (orig, cls), sid in cmap.class_bucket.items()
    }

    def emit_bucket(bid: int) -> None:
        if bid in done or bid not in cmap.buckets or bid in shadow_ids:
            return
        done.add(bid)
        b = cmap.buckets[bid]
        for item in b.items:
            if item < 0:
                emit_bucket(item)
        type_name = type_names[b.type]
        out.append(f"{type_name} {_item_name(cmap, bid)} {{\n")
        out.append(f"\tid {bid}\t\t# do not change unnecessarily\n")
        out.append(f"\t# weight {_fixedpoint(b.weight)}\n")
        alg_line = f"\talg {ALG_NAMES[b.alg]}"
        dopos = False
        if b.alg == BucketAlg.UNIFORM:
            alg_line += (
                f"\t# do not change bucket size ({b.size}) unnecessarily"
            )
            dopos = True
        elif b.alg == BucketAlg.LIST:
            alg_line += (
                "\t# add new items at the end; do not change order "
                "unnecessarily"
            )
        elif b.alg == BucketAlg.TREE:
            alg_line += "\t# do not change pos for existing items unnecessarily"
            dopos = True
        out.append(alg_line + "\n")
        out.append(f"\thash {b.hash}\t# rjenkins1\n")
        for j, item in enumerate(b.items):
            w = (
                b.item_weight
                if b.alg == BucketAlg.UNIFORM
                else b.item_weights[j]
            )
            line = f"\titem {_item_name(cmap, item)} weight {_fixedpoint(w)}"
            if dopos:
                line += f" pos {j}"
            out.append(line + "\n")
        out.append("}\n")

    # DFS from most recently assigned (id -1 downward), reference order
    for bid in range(-1, -1 - cmap.max_buckets, -1):
        emit_bucket(bid)

    out.append("\n# rules\n")
    for rule_id in sorted(cmap.rules):
        rule = cmap.rules[rule_id]
        name = cmap.rule_names.get(rule_id)
        out.append(f"rule {name + ' ' if name else ''}{{\n")
        out.append(f"\tid {rule_id}\n")
        type_name = {1: "replicated", 3: "erasure"}.get(
            rule.type, str(rule.type)
        )
        out.append(f"\ttype {type_name}\n")
        out.append(f"\tmin_size {rule.min_size}\n")
        out.append(f"\tmax_size {rule.max_size}\n")
        for step in rule.steps:
            if step.op == RuleOp.TAKE:
                if step.arg1 in shadow_to_class:
                    orig, cls = shadow_to_class[step.arg1]
                    out.append(
                        f"\tstep take {_item_name(cmap, orig)} "
                        f"class {cls}\n"
                    )
                else:
                    out.append(
                        f"\tstep take {_item_name(cmap, step.arg1)}\n"
                    )
            elif step.op == RuleOp.EMIT:
                out.append("\tstep emit\n")
            elif step.op in (
                RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP,
                RuleOp.CHOOSELEAF_FIRSTN, RuleOp.CHOOSELEAF_INDEP,
            ):
                verb = (
                    "choose"
                    if step.op
                    in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSE_INDEP)
                    else "chooseleaf"
                )
                mode = (
                    "firstn"
                    if step.op
                    in (RuleOp.CHOOSE_FIRSTN, RuleOp.CHOOSELEAF_FIRSTN)
                    else "indep"
                )
                tname = type_names[step.arg2]
                out.append(
                    f"\tstep {verb} {mode} {step.arg1} type {tname}\n"
                )
            else:
                name_by_op = {v: k for k, v in _STEP_SETS.items()}
                out.append(
                    f"\tstep {name_by_op[step.op]} {step.arg1}\n"
                )
        out.append("}\n")

    maps = cmap.choose_args_maps
    if not maps and cmap.choose_args:
        maps = {0: cmap.choose_args}
    if maps:
        out.append("\n# choose_args\n")
    for args_id in sorted(maps):
        out.append(f"choose_args {args_id} {{\n")
        for bucket_id in sorted(maps[args_id], reverse=True):
            arg = maps[args_id][bucket_id]
            if arg.ids is None and arg.weight_set is None:
                continue
            out.append("  {\n")
            out.append(f"    bucket_id {bucket_id}\n")
            if arg.weight_set is not None:
                out.append("    weight_set [\n")
                for row in arg.weight_set:
                    out.append(
                        "      [ "
                        + " ".join(_fixedpoint(w) for w in row)
                        + " ]\n"
                    )
                out.append("    ]\n")
            if arg.ids is not None:
                out.append(
                    "    ids [ " + " ".join(str(i) for i in arg.ids) + " ]\n"
                )
            out.append("  }\n")
        out.append("}\n")

    out.append("\n# end crush map\n")
    return "".join(out)
