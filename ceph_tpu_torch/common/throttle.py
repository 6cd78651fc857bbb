"""Throttle — counting backpressure, the reference's src/common/Throttle.

`Throttle(max)` admits up to `max` units; `get(c)` blocks while the budget
is exhausted (Throttle::get), `get_or_fail(c)` never blocks (Throttle.h's
get_or_fail), `put(c)` returns budget and wakes waiters. Used by the OSD and
messenger to bound in-flight bytes/ops; here it bounds whatever the host
orchestration wants to cap (e.g. concurrent recovery pushes under
osd_recovery_max_active)."""

from __future__ import annotations

import threading


class Throttle:
    def __init__(self, max_units: int, name: str = "throttle"):
        if max_units < 0:
            raise ValueError("max must be >= 0")
        self.name = name
        self._max = max_units
        self._count = 0
        self._cond = threading.Condition()

    @property
    def current(self) -> int:
        return self._count

    @property
    def max(self) -> int:
        return self._max

    def _should_wait(self, c: int) -> bool:
        # Throttle::_should_wait: a request larger than max is admitted
        # alone (when the throttle is empty) rather than deadlocking
        if not self._max:
            return False
        return (
            self._count + c > self._max
            and not (c > self._max and self._count == 0)
        )

    def get(self, c: int = 1, timeout: float | None = None) -> bool:
        """Block until `c` units fit; False on timeout."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._should_wait(c), timeout=timeout
            )
            if not ok:
                return False
            self._count += c
            return True

    def get_or_fail(self, c: int = 1) -> bool:
        with self._cond:
            if self._should_wait(c):
                return False
            self._count += c
            return True

    def put(self, c: int = 1) -> int:
        with self._cond:
            if c > self._count:
                raise ValueError("putting back more than taken")
            self._count -= c
            self._cond.notify_all()
            return self._count

    def reset_max(self, max_units: int) -> None:
        with self._cond:
            self._max = max_units
            self._cond.notify_all()

    def __enter__(self):
        self.get()
        return self

    def __exit__(self, *exc):
        self.put()
        return False
