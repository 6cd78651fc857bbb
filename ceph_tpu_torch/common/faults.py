"""Seeded wire-fault schedules (the chaos harness's decision engine).

BlockStore's device-fault pattern (`blockstore_inject_*`: 1-in-N rates,
one cached flag check when disarmed) applied to the wire: a
`ms_inject_chaos_schedule` string compiles into per-(src, dst) fault
streams that the messenger consults once per outgoing corked frame run.
Each peer pair draws from its OWN `random.Random`, seeded from
(`ms_inject_chaos_seed`, src, dst) — so the decision sequence a pair
sees depends only on how many frames IT sent, never on global
interleaving, and a run replays bit-identically from the seed.

Schedule grammar (';'-separated rules; entity names are comma-separated
fnmatch globs like ``osd.1``, ``osd.*``, ``*``):

    drop:SRC>DST[:prob]             sever the connection (frame lost;
                                    lossless sessions replay on
                                    reconnect, lossy sessions lose it)
    delay:SRC>DST[:prob[:max_s]]    stall the write up to max_s seconds
    dup:SRC>DST[:prob]              send the frame run twice (receiver
                                    seq-dedup must absorb it)
    partition:A|B                   every A->B AND B->A send fails
    partition:A>B                   one-way: A cannot reach B, B still
                                    reaches A (asymmetric partition)

Probabilities default to 1.0 (drop/dup/partition) and delays to 50 ms.
Multiple matching rules are evaluated in schedule order per decision;
the first that fires wins (partition is checked first — it is not
probabilistic).
"""

from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from fnmatch import fnmatchcase

__all__ = ["FaultRule", "WireFaults", "parse_schedule"]

#: decision kinds returned by _PairFaults.next_action()
DROP = "drop"
DELAY = "delay"
DUP = "dup"

_DEFAULT_DELAY_MAX = 0.05


@dataclass(frozen=True)
class FaultRule:
    kind: str  # drop | delay | dup | partition
    src: tuple[str, ...]  # glob patterns
    dst: tuple[str, ...]
    prob: float = 1.0
    param: float = _DEFAULT_DELAY_MAX  # delay: max seconds
    both_ways: bool = False  # partition:A|B

    def matches(self, src: str, dst: str) -> bool:
        if _match(self.src, src) and _match(self.dst, dst):
            return True
        return self.both_ways and (
            _match(self.src, dst) and _match(self.dst, src)
        )


def _match(patterns: tuple[str, ...], name: str) -> bool:
    return any(fnmatchcase(name, p) for p in patterns)


def _globs(spec: str) -> tuple[str, ...]:
    out = tuple(s.strip() for s in spec.split(",") if s.strip())
    if not out:
        raise ValueError(f"empty entity spec in {spec!r}")
    return out


def parse_schedule(text: str) -> list[FaultRule]:
    """Compile a schedule string; raises ValueError on bad grammar (a
    typo'd schedule must fail loudly at arm time, not silently inject
    nothing)."""
    rules: list[FaultRule] = []
    for raw in (text or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        kind = parts[0].strip()
        if kind == "partition":
            if len(parts) != 2:
                raise ValueError(f"partition takes no args: {raw!r}")
            spec = parts[1]
            if "|" in spec:
                a, b = spec.split("|", 1)
                rules.append(FaultRule(
                    "partition", _globs(a), _globs(b), both_ways=True,
                ))
            elif ">" in spec:
                a, b = spec.split(">", 1)
                rules.append(
                    FaultRule("partition", _globs(a), _globs(b))
                )
            else:
                raise ValueError(
                    f"partition needs A|B or A>B: {raw!r}"
                )
            continue
        if kind not in (DROP, DELAY, DUP):
            raise ValueError(f"unknown fault kind {kind!r} in {raw!r}")
        if len(parts) < 2 or ">" not in parts[1]:
            raise ValueError(f"{kind} needs SRC>DST: {raw!r}")
        a, b = parts[1].split(">", 1)
        prob = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"probability out of [0,1]: {raw!r}")
        param = (
            float(parts[3]) if len(parts) > 3 and parts[3]
            else _DEFAULT_DELAY_MAX
        )
        rules.append(
            FaultRule(kind, _globs(a), _globs(b), prob, param)
        )
    return rules


class _PairFaults:
    """The fault stream one (src, dst) direction draws from: its own
    RNG keyed by (seed, src, dst), so decisions replay per pair."""

    __slots__ = ("rules", "rng", "decisions")

    def __init__(self, rules: list[FaultRule], seed: int,
                 src: str, dst: str):
        self.rules = rules
        key = zlib.crc32(f"{src}>{dst}".encode()) & 0xFFFFFFFF
        self.rng = random.Random((seed << 32) ^ key)
        self.decisions = 0  # frames judged (replay/debug surface)

    def next_action(self):
        """Fault for the next outgoing frame run, or None. One of:
        ("drop",) | ("delay", seconds) | ("dup",)."""
        self.decisions += 1
        for r in self.rules:
            if r.kind == "partition":
                return (DROP,)
            # one draw per rule per frame keeps streams aligned with
            # the schedule (rules consume randomness deterministically)
            roll = self.rng.random()
            if roll >= r.prob:
                continue
            if r.kind == DROP:
                return (DROP,)
            if r.kind == DUP:
                return (DUP,)
            return (DELAY, self.rng.uniform(0.0, r.param))
        return None


class WireFaults:
    """Compiled schedule + per-pair stream cache. Built once per
    messenger when `ms_inject_chaos_schedule` is non-empty; the
    messenger keeps None when disarmed so the hot path pays one
    attribute check."""

    def __init__(self, schedule: str, seed: int = 0):
        self.schedule = schedule
        self.seed = int(seed)
        self.rules = parse_schedule(schedule)
        self._pairs: dict[tuple[str, str], _PairFaults | None] = {}

    def pair(self, src: str, dst: str) -> _PairFaults | None:
        """The fault stream for src->dst sends, or None when no rule
        matches the pair (cached — the common no-match case costs one
        dict hit after the first send)."""
        key = (src, dst)
        got = self._pairs.get(key, False)
        if got is not False:
            return got
        matched = [r for r in self.rules if r.matches(src, dst)]
        pf = (
            _PairFaults(matched, self.seed, src, dst)
            if matched else None
        )
        self._pairs[key] = pf
        return pf
