"""Op queues: weighted-priority and mClock-style QoS scheduling.

The reference's OSD pushes every op through a pluggable queue
(`osd_op_queue`): the default WeightedPriorityQueue
(src/common/WeightedPriorityQueue.h) dequeues across priority classes in
proportion to their priority — low-priority recovery makes progress under
client load instead of starving — with a strict-priority band above it for
peering/map messages that must never wait. The mClock queue
(src/osd/scheduler/mClockScheduler.cc, src/dmclock) extends that with
per-class reservation (minimum rate), weight (proportional share), and
limit (maximum rate) tags.

Both shapes here, asyncio-friendly but loop-agnostic (pure data
structures; the daemon drives them):

  * `WeightedPriorityQueue` — strict band (`enqueue_strict`) drained first,
    then weighted round-robin over priority classes, cost-aware.
  * `MClockQueue` — dmclock's tag algebra on a virtual clock: each class
    gets reservation/weight/limit; dequeue picks the earliest eligible
    reservation tag first (guaranteeing minima), then the earliest weight
    tag among classes under their limit. Idle classes don't accumulate
    credit (tags are clamped forward, the "idle reset" dmclock rule).
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass


class _Band:
    """One priority band: deficit-round-robin over klass subqueues, the
    per-client SubQueue structure inside WeightedPriorityQueue.h — two
    klasses at the same priority share it in inverse proportion to their
    op costs."""

    def __init__(self) -> None:
        self.queues: dict = {}  # klass -> deque of (cost, item)
        self.rr: deque = deque()  # klass round-robin order
        self.deficit: dict = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def enqueue(self, klass, cost: int, item) -> None:
        if klass not in self.queues:
            self.queues[klass] = deque()
            self.rr.append(klass)
            self.deficit[klass] = 0
        self.queues[klass].append((cost, item))

    def dequeue(self):
        while True:
            klass = self.rr[0]
            q = self.queues[klass]
            if not q:
                # empty klass leaves the ring and banks nothing
                self.rr.popleft()
                del self.queues[klass]
                del self.deficit[klass]
                continue
            self.deficit[klass] += 1
            cost, item = q[0]
            if self.deficit[klass] >= cost:
                q.popleft()
                self.deficit[klass] -= cost
                # rotate after a pop too, or a cheap klass at the ring
                # head would be revisited (and re-funded) every call and
                # starve its band-mates outright
                self.rr.rotate(-1)
                return item
            self.rr.rotate(-1)


class WeightedPriorityQueue:
    """Strict band + weighted bands of DRR subqueues
    (WeightedPriorityQueue.h)."""

    def __init__(self) -> None:
        self._strict: deque = deque()
        self._bands: dict[int, _Band] = {}
        #: round-robin credit per priority
        self._credit: dict[int, int] = {}

    def enqueue_strict(self, item) -> None:
        self._strict.append(item)

    def enqueue(self, priority: int, cost: int, item, klass=None) -> None:
        if priority <= 0:
            raise ValueError("priority must be positive")
        self._bands.setdefault(priority, _Band()).enqueue(
            klass, max(cost, 1), item
        )

    def __len__(self) -> int:
        return len(self._strict) + sum(
            len(b) for b in self._bands.values()
        )

    def dequeue(self):
        """Next item, or None when empty."""
        if self._strict:
            return self._strict.popleft()
        # weighted round-robin across bands: each pass grants every
        # non-empty band credit equal to its priority; a dequeue spends one
        while True:
            ready = [p for p, b in self._bands.items() if len(b)]
            if not ready:
                return None
            for p in sorted(ready, reverse=True):
                if self._credit.get(p, 0) > 0:
                    self._credit[p] -= 1
                    item = self._bands[p].dequeue()
                    if not len(self._bands[p]):
                        self._credit[p] = 0  # no banking while idle
                    return item
            for p in ready:
                self._credit[p] = self._credit.get(p, 0) + p


@dataclass(frozen=True)
class ClientInfo:
    """dmclock client profile: reservation/weight/limit in ops per tick."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0  # 0 = unlimited


#: mclock class for bulk dataset-prefetch reads (ceph_tpu.data): ops
#: tagged with this class ride a background profile instead of the
#: per-client default, so a saturating prefetch pipeline cannot starve
#: foreground ckpt/RBD traffic (the reference's background_best_effort
#: mclock class for scrub/pg-delete plays the same role)
QOS_DATA_PREFETCH = "data_prefetch"


def data_prefetch_profile(weight: float = 0.25) -> ClientInfo:
    """Background profile for QOS_DATA_PREFETCH: a fractional weight
    against the weight-1 foreground default — under contention the
    foreground classes keep ~1/(1+w) of service each relative to
    prefetch's w, while an idle cluster still serves prefetch at full
    rate (no limit: weight shapes contention only)."""
    return ClientInfo(reservation=0.0, weight=max(0.01, weight), limit=0.0)


#: mclock class for recovery/backfill sub-ops (pulls, rebuild reads,
#: batched pushes): the reference's background_recovery class. Unlike
#: QOS_DATA_PREFETCH it carries a RESERVATION — degraded objects are a
#: durability debt, so a client storm may squeeze recovery down to the
#: floor but never to zero (dmclock phase-1 guarantees the minimum)
QOS_RECOVERY = "recovery"


def recovery_profile(
    weight: float = 0.25, reservation: float = 10.0
) -> ClientInfo:
    """Recovery profile: fractional weight so a recovery storm cannot
    starve weight-1 client classes, plus a reservation floor (ops/s on
    the queue's virtual clock) so sustained client load cannot stall
    healing to zero — the two-sided contract `osd_mclock_recovery_weight`
    / `osd_mclock_recovery_reservation` expose."""
    return ClientInfo(
        reservation=max(0.0, reservation),
        weight=max(0.01, weight),
        limit=0.0,
    )


class MClockQueue:
    """dmclock tag scheduling on a caller-driven virtual clock."""

    def __init__(self) -> None:
        self._profiles: dict[str, ClientInfo] = {}
        #: class -> deque of items
        self._queues: dict[str, deque] = {}
        #: class -> (last_r_tag, last_w_tag, last_l_tag)
        self._tags: dict[str, list[float]] = {}
        self._clock = itertools.count(1)
        self.now = 0.0

    def set_profile(self, cls: str, info: ClientInfo) -> None:
        self._profiles[cls] = info

    def enqueue(self, cls: str, item, cost: int = 1) -> None:
        if cls not in self._profiles:
            raise KeyError(f"no profile for class {cls!r}")
        # arrival time rides with the op: dmclock clamps tags to ARRIVAL,
        # so a backlog that arrived long ago catches its reservation up
        # within a tick, while fresh ops after idle start at now. Cost
        # scales the tag advance: an expensive op consumes more of its
        # class's share (dmclock's cost parameter).
        self._queues.setdefault(cls, deque()).append(
            (self.now, max(1, cost), item)
        )

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _head_tags(self, cls: str) -> tuple[float, float, float]:
        """Tags the head op of `cls` would run at, clamped to its arrival
        time (idle classes accumulate no credit; queued backlogs do catch
        up — the dmclock tag rule)."""
        info = self._profiles[cls]
        arrival, cost, _item = self._queues[cls][0]
        last = self._tags.get(cls, [0.0, 0.0, 0.0])
        r = (
            max(last[0] + cost / info.reservation, arrival)
            if info.reservation
            else float("inf")
        )
        # weight 0 = reservation-only service (never competes in phase 2)
        w = (
            max(last[1] + cost / info.weight, arrival)
            if info.weight
            else float("inf")
        )
        lim = (
            max(last[2] + cost / info.limit, arrival)
            if info.limit
            else 0.0
        )
        return r, w, lim

    def dequeue(self):
        """(cls, item) or None. Reservation tags <= now run first (the
        guaranteed minimum); otherwise the smallest weight tag among
        classes whose limit tag is not in the future."""
        ready = [c for c, q in self._queues.items() if q]
        if not ready:
            return None
        tags = {c: self._head_tags(c) for c in ready}
        # phase 1: overdue reservations, earliest first
        res = [
            (tags[c][0], c) for c in ready if tags[c][0] <= self.now
        ]
        if res:
            _, cls = min(res)
            return self._take(cls, tags[cls], used_reservation=True)
        # phase 2: weight ordering among classes under their limit
        eligible = [
            (tags[c][1], c) for c in ready if tags[c][2] <= self.now
        ]
        if not eligible:
            return None  # everyone is at their limit until the clock moves
        _, cls = min(eligible)
        return self._take(cls, tags[cls], used_reservation=False)

    def _take(self, cls: str, tags, used_reservation: bool):
        _arrival, _cost, item = self._queues[cls].popleft()
        last = self._tags.setdefault(cls, [0.0, 0.0, 0.0])
        r, w, lim = tags
        if used_reservation:
            last[0] = r
        else:
            last[1] = w
        if self._profiles[cls].limit:
            last[2] = lim
        return cls, item


class MClockOpQueue:
    """WPQ-shaped adapter over MClockQueue for the OSD op shards.

    The reference selects its op scheduler via `osd_op_queue`
    (src/common/options.cc; wpq vs mclock_scheduler) — this is the
    mclock side of that switch. Classes default to weight-1 profiles
    (fair share); operators register richer profiles (reservation /
    limit) per client class via set_profile."""

    def __init__(self, default: ClientInfo | None = None):
        self._q = MClockQueue()
        self._default = default or ClientInfo(weight=1.0)

    def set_profile(self, cls: str, info: ClientInfo) -> None:
        self._q.set_profile(cls, info)

    def enqueue(self, priority: int, cost: int, item, klass=None) -> None:
        import time as _time

        cls = str(klass) if klass is not None else "default"
        if cls not in self._q._profiles:
            self._q.set_profile(cls, self._default)
        self._q.now = _time.monotonic()
        self._q.enqueue(cls, item, cost=cost)

    def enqueue_strict(self, item) -> None:
        self.enqueue(255, 1, item, klass="strict")

    def dequeue(self):
        import time as _time

        self._q.now = _time.monotonic()
        got = self._q.dequeue()
        return None if got is None else got[1]

    def __len__(self) -> int:
        return len(self._q)
