"""coord.lock: client-side lease lock over the `lock` object class.

The cls (osd/cls.py) owns the truth — holders, types, expirations — and
evaluates every transition against the PRIMARY's clock, atomically with
respect to racing renewals. This wrapper adds the client half of the
reference's rados::cls::lock::Lock + ManagedLock duo:

  * a renew loop that re-locks every `coord_lease * coord_renew_factor`
    seconds so a live holder's lease never lapses, and an `on_lost`
    callback when it does anyway (EBUSY/ENOENT on renewal — somebody
    broke us and possibly took the lock);
  * break-on-expired acquisition: a waiter that finds only lapsed
    holders breaks them with the cls-side `if_expired` guard (atomic vs
    a concurrent renewal) instead of waiting out a dead process;
  * watch/notify wakeup: blocked waiters watch the lock object and are
    notified on release/break, so the configured poll interval
    (`coord_barrier_poll`) is only a lost-notify fallback, not the
    latency floor.
"""

from __future__ import annotations

import asyncio
import json
import time

from ceph_tpu_torch.lint import racecheck
from ceph_tpu_torch.rados.client import ObjectNotFound, RadosError


def make_coord_perf(name: str):
    """The coordination perf block (locks + elections + barriers);
    shared by standalone Locks and the Fleet that owns them."""
    from ceph_tpu_torch.common.perf_counters import PerfCounters

    p = PerfCounters(f"coord.{name}")
    p.add_u64("locks_held", "locks currently held by this process")
    p.add_u64_counter("lock_breaks", "expired/dead holders broken")
    p.add_u64_counter("lease_losses",
                      "held locks lost to lease expiry + break")
    p.add_u64_counter("leader_changes",
                      "times this process won a leader election")
    p.add_time_avg("lock_acquire_wait",
                   "wall time blocked inside Lock.acquire()")
    p.add_time_avg("barrier_wait", "wall time blocked per barrier()")
    p.add_histogram("barrier_wait_ms",
                    "barrier wait latency distribution (ms, log2)")
    p.add_u64_counter("barriers", "barriers completed")
    return p


class Lock:
    """One named advisory lock on one object (cls_lock client half).

    `lease=0` never expires (the RBD header-lock style); `lease=None`
    takes `coord_lease` from config. Shared locks coexist with other
    shared holders; exclusive conflicts get EBUSY and — under
    `acquire(block=True)` — wait on watch/notify for the release.
    """

    def __init__(self, ioctx, obj: str, name: str = "lock", *,
                 owner: str | None = None, cookie: str = "",
                 shared: bool = False, lease: float | None = None,
                 description: str = "", perf=None, on_lost=None):
        self.ioctx = ioctx
        self.obj = obj
        self.name = name
        self.config = ioctx.objecter.config
        self.owner = owner if owner is not None else ioctx.objecter.name
        self.cookie = cookie
        self.type = "shared" if shared else "exclusive"
        self.lease = (float(self.config.get("coord_lease"))
                      if lease is None else float(lease))
        self.description = description
        self.perf = perf
        self.on_lost = on_lost
        self.locked = False
        self._renew_task: asyncio.Task | None = None
        self._watching = False
        self._watch_cookie = f"lk.{name}.{cookie or self.owner}"
        self._wake = asyncio.Event()

    @property
    def tracer(self):
        return self.ioctx.objecter.tracer

    def _params(self, **extra) -> dict:
        d = {"name": self.name, "owner": self.owner, "cookie": self.cookie}
        d.update(extra)
        return d

    async def _exec(self, method: str, inp: dict) -> dict:
        return await self.ioctx.exec(self.obj, "lock", method, inp)

    # -- acquire / release -----------------------------------------------------

    async def acquire(self, *, block: bool = True,
                      timeout: float | None = None,
                      break_dead: bool = True) -> dict:
        """Take the lock; on EBUSY, optionally break expired holders,
        then (if `block`) wait for a release notify and retry. Raises
        TimeoutError past `timeout`, or the EBUSY when not blocking."""
        span = self.tracer.start(
            "lock_acquire",
            tags={"obj": self.obj, "lock": self.name, "owner": self.owner,
                  "type": self.type},
            op_type="lock_acquire",
        )
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        try:
            while True:
                try:
                    rep = await self._exec("lock", self._params(
                        type=self.type, duration=self.lease,
                        description=self.description,
                    ))
                except RadosError as e:
                    if "EBUSY" not in str(e):
                        raise
                    busy = e
                else:
                    self.locked = True
                    if racecheck.active():
                        racecheck.note_acquire(self._rc_class(),
                                               blocking=block)
                    for dead in rep.get("pruned", ()):
                        # the cls dropped a lapsed holder to let us in:
                        # that is a break in all but the syscall
                        if self.perf is not None:
                            self.perf.inc("lock_breaks")
                        self._clog(
                            "WRN",
                            f"lock broken: {self.obj}/{self.name} holder "
                            f"{dead['owner']!r} by {self.owner!r} "
                            f"(lease expired)",
                        )
                    if self.perf is not None:
                        self.perf.inc("locks_held")
                        self.perf.tinc("lock_acquire_wait",
                                       time.monotonic() - t0)
                    if self.lease > 0 and self._renew_task is None:
                        self._renew_task = asyncio.create_task(
                            self._renew_loop()
                        )
                    if span is not None:
                        span.set_tag("acquired", True)
                    return rep
                if break_dead and await self._break_expired():
                    continue  # holders were dead; retake immediately
                if not block:
                    raise busy
                await self._wait_release(deadline)
        finally:
            if span is not None:
                span.finish()
            await self._stop_watch()

    async def release(self) -> None:
        """Unlock (best-effort) and notify waiters."""
        self._stop_renew()
        if not self.locked:
            return
        self.locked = False
        if racecheck.active():
            racecheck.note_release(self._rc_class())
        if self.perf is not None:
            self.perf.dec("locks_held")
        try:
            await self._exec("unlock", self._params())
        except RadosError:
            pass  # already broken/expired-and-pruned: same end state
        await self._notify(event="release")

    async def info(self) -> dict:
        return await self._exec("get_info", {"name": self.name})

    async def break_holder(self, owner: str, cookie: str | None = None, *,
                           if_expired: bool = True) -> dict:
        """Break another holder (recovery path). With `if_expired` the
        cls refuses unless its lease lapsed — safe against a racing
        renewal; pass False only on an operator's explicit --force."""
        inp = {"name": self.name, "owner": owner, "if_expired": if_expired}
        if cookie is not None:
            inp["cookie"] = cookie
        rep = await self._exec("break_lock", inp)
        if self.perf is not None:
            self.perf.inc("lock_breaks")
        self._clog("WRN", f"lock broken: {self.obj}/{self.name} holder "
                          f"{owner!r} by {self.owner!r}"
                          + (" (lease expired)" if if_expired else
                             " (forced)"))
        await self._notify(event="break", owner=owner)
        return rep

    # -- renew loop ------------------------------------------------------------

    async def _renew_loop(self) -> None:
        factor = float(self.config.get("coord_renew_factor"))
        interval = max(0.02, self.lease * factor)
        while self.locked:
            await asyncio.sleep(interval)
            if not self.locked:
                return
            try:
                await self._exec("lock", self._params(
                    type=self.type, duration=self.lease,
                    description=self.description,
                ))
            except asyncio.CancelledError:
                raise
            except RadosError as e:
                if isinstance(e, ObjectNotFound) or "EBUSY" in str(e):
                    # broken while lapsed and (for EBUSY) taken by
                    # someone else: ownership is gone for good
                    self._lost()
                    return
                # transient (retarget/timeout): the lease outlives a
                # couple of missed renewals by construction
            # cephlint: disable=error-taxonomy (transient renewal failure: the lease survives missed renewals)
            except Exception:  # noqa: BLE001
                pass

    def _rc_class(self) -> str:
        # distributed locks order by identity (obj/name), not creation
        # site: every host constructs its own instance of the same lock
        return f"coord.Lock:{self.obj}/{self.name}"

    def _lost(self) -> None:
        if not self.locked:
            return
        self.locked = False
        if racecheck.active():
            racecheck.note_release(self._rc_class())
        self._stop_renew()
        if self.perf is not None:
            self.perf.dec("locks_held")
            self.perf.inc("lease_losses")
        if self.on_lost is not None:
            self.on_lost(self)

    def _stop_renew(self) -> None:
        t, self._renew_task = self._renew_task, None
        if t is not None and t is not asyncio.current_task():
            t.cancel()

    # -- waiters: watch/notify wakeup ------------------------------------------

    def _on_notify(self, name: str, payload) -> None:
        self._wake.set()

    async def _wait_release(self, deadline: float | None) -> None:
        if not self._watching:
            try:
                await self.ioctx.watch(self.obj, self._on_notify,
                                       cookie=self._watch_cookie)
                self._watching = True
            except RadosError:
                pass  # object/primary in flux: poll fallback covers it
        self._wake.clear()
        poll = float(self.config.get("coord_barrier_poll"))
        wait = poll
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"lock {self.obj}/{self.name} acquire timed out"
                )
            wait = min(poll, remaining)
        try:
            await asyncio.wait_for(self._wake.wait(), timeout=wait)
        except asyncio.TimeoutError:
            pass  # poll fallback: retry the exec regardless

    async def _stop_watch(self) -> None:
        if not self._watching:
            return
        self._watching = False
        try:
            await self.ioctx.unwatch(self.obj, cookie=self._watch_cookie)
        except RadosError:
            pass

    async def close(self) -> None:
        await self.release()
        await self._stop_watch()

    # -- plumbing --------------------------------------------------------------

    async def _notify(self, **fields) -> None:
        try:
            await self.ioctx.notify(
                self.obj, json.dumps(dict(fields, lock=self.name)),
                timeout=1.0,
            )
        # cephlint: disable=error-taxonomy (wakeups are best-effort; pollers converge anyway)
        except Exception:  # noqa: BLE001
            pass  # wakeups are best-effort; pollers converge anyway

    def _clog(self, level: str, message: str) -> None:
        try:
            self.ioctx.objecter.mon.cluster_log(level, message)
        # cephlint: disable=error-taxonomy (the log path itself must never throw)
        except Exception:  # noqa: BLE001
            pass

    async def _break_expired(self) -> bool:
        """Break every expired holder; True when at least one fell."""
        try:
            info = await self.info()
        except RadosError:
            return False
        broke = False
        for h in info.get("holders", ()):
            if not h.get("expired"):
                continue
            try:
                await self.break_holder(h["owner"], h.get("cookie", ""),
                                        if_expired=True)
                broke = True
            except RadosError:
                pass  # renewed under us, or another waiter broke first
        return broke
