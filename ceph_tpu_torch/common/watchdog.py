"""SharedWatchdog: one timer for any number of awaited futures.

`asyncio.wait_for(fut, t)` arms and cancels a TimerHandle per call — on the
op submit path and the sub-op fan-out that is timer churn per op (k+m
handles per EC write). The reference sidesteps the same cost with one
SafeTimer sweeping all outstanding op deadlines (Objecter::tick); this is
that shape: deadlines live in a dict, one task sweeps them at a coarse
granularity, and expiry fails the future with asyncio.TimeoutError so
existing `except asyncio.TimeoutError` retry paths work unchanged.

Only suitable where the timeout is a retry pacer, not a precise deadline:
expiry lands up to one sweep-granularity late.
"""

from __future__ import annotations

import asyncio
import itertools


class SharedWatchdog:
    def __init__(self, granularity: float = 0.25):
        self._granularity = granularity
        self._entries: dict[int, tuple[float, asyncio.Future]] = {}
        self._ids = itertools.count(1)
        self._task: asyncio.Task | None = None

    async def wait(self, fut: asyncio.Future, timeout: float):
        """Drop-in for `asyncio.wait_for(fut, timeout)` on futures that
        are resolved elsewhere (dispatch handlers): zero TimerHandles,
        one shared sweep."""
        loop = asyncio.get_event_loop()
        handle = next(self._ids)
        self._entries[handle] = (loop.time() + timeout, fut)
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._sweep())
        try:
            return await fut
        finally:
            self._entries.pop(handle, None)

    async def _sweep(self) -> None:
        loop = asyncio.get_event_loop()
        while self._entries:
            await asyncio.sleep(self._granularity)
            now = loop.time()
            for handle, (deadline, fut) in list(self._entries.items()):
                if fut.done():
                    self._entries.pop(handle, None)
                elif now >= deadline:
                    self._entries.pop(handle, None)
                    fut.set_exception(asyncio.TimeoutError())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self._entries.clear()
