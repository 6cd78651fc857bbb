"""Async checkpoint saves: snapshot-now, persist-in-background.

Port of ceph_tpu/ckpt/async_save.py (a copy). `AsyncSaver.submit()` does
ONLY the work that must see a consistent view of the training state —
`CkptWriter.prepare()`, which copies every leaf off its device to host
bytes — and hands back a `PendingSave` immediately; training mutates its
arrays freely from that point. The
expensive phase (fingerprint/diff, chunk puts, manifest, HEAD CAS) runs
as a background task. This is the CheckFreq decoupling: the
train-visible stall is the snapshot, not the persist.

Two invariants keep the crash-consistency story intact:

  * commit ORDER == submission order. Each persist task waits for its
    predecessor to finish (success or not) before its own HEAD CAS, so
    HEAD never travels backwards and a kill -9 at any instant leaves
    the newest COMMITTED save restorable — exactly the synchronous
    guarantee, with the kill window now covering whole pending saves
    (their chunks are orphans for gc, same as a dying sync saver).
  * bounded pending (`ckpt_async_max_pending`): a submit over the limit
    BLOCKS until the oldest pending save lands, so a slow cluster
    throttles the training loop instead of accumulating host-memory
    snapshots without bound.
"""

from __future__ import annotations

import asyncio
import time
from collections import deque


class PendingSave:
    """Handle to one in-flight async save (the CheckFreq "snapshot
    taken, persist pending" state)."""

    def __init__(self, writer):
        self.writer = writer
        self.save_id: str = writer.save_id
        #: seconds the caller was blocked inside save_async (snapshot
        #: + any backpressure wait) — the train-visible stall
        self.blocking_s: float = 0.0
        #: wall seconds of the background persist (set on completion)
        self.wall_s: float | None = None
        self._task: asyncio.Task | None = None

    @property
    def done(self) -> bool:
        return self._task is not None and self._task.done()

    async def wait(self) -> str:
        """Join the persist; returns the committed save_id or re-raises
        its failure. Shielded: cancelling a waiter does not kill the
        save itself."""
        return await asyncio.shield(self._task)

    def result(self) -> str:
        """The committed save_id; raises if still running or failed."""
        return self._task.result()

    def cancel(self) -> bool:
        """Abort the background persist (the in-process kill -9: HEAD
        stays on the previous committed save; debris is gc's)."""
        return self._task.cancel()

    @property
    def error(self) -> BaseException | None:
        if not self.done or self._task.cancelled():
            return None
        return self._task.exception()


class AsyncSaver:
    """Per-CkptStore background-save queue (one per checkpoint name, so
    commit ordering is a local property)."""

    def __init__(self, store):
        self.store = store
        self._pending: deque[PendingSave] = deque()
        self._tail: asyncio.Task | None = None

    @property
    def pending(self) -> list[PendingSave]:
        return [p for p in self._pending if not p.done]

    async def submit(self, tree, *, save_id: str | None = None) -> PendingSave:
        t0 = time.perf_counter()
        perf = self.store.perf
        limit = max(1, self.store.config.get("ckpt_async_max_pending"))
        while len(self.pending) >= limit:  # backpressure, oldest first
            oldest = self._pending[0]
            try:
                await oldest.wait()
            except asyncio.CancelledError:
                if not oldest._task.cancelled():
                    raise  # the submitter itself was cancelled
            # cephlint: disable=error-taxonomy (surfaced via that handle's own wait()/error)
            except Exception:  # noqa: BLE001
                pass  # surfaced via that handle's own wait()/error
            self._reap()
        writer = self.store.writer(tree, save_id=save_id)
        writer.prepare()  # THE snapshot: device arrays -> host bytes
        ps = PendingSave(writer)
        ps._task = asyncio.create_task(
            self._persist(writer, self._tail, ps)
        )
        ps._task.add_done_callback(lambda t: self._on_done(ps, t))
        self._tail = ps._task
        self._pending.append(ps)
        ps.blocking_s = time.perf_counter() - t0
        if perf is not None:
            perf.inc("save_async_submits")
            perf.set_max("save_async_pending_peak", len(self.pending))
            perf.tinc("save_block_latency", ps.blocking_s)
        return ps

    async def _persist(self, writer, prev: asyncio.Task | None, ps) -> str:
        t0 = time.perf_counter()
        try:
            await writer.put_chunks()
            await writer.put_manifest()
            if prev is not None and not prev.done():
                # commit order == submission order; a failed or
                # cancelled predecessor only forfeits its own commit
                await asyncio.wait({prev})
            return await writer.commit()
        finally:
            ps.wall_s = time.perf_counter() - t0

    def _on_done(self, ps, task: asyncio.Task) -> None:
        if not task.cancelled():
            task.exception()  # mark retrieved; surfaced via ps.error
        self._reap()

    def _reap(self) -> None:
        while self._pending and self._pending[0].done:
            self._pending.popleft()

    async def drain(self) -> list[str]:
        """Join every pending save (training-loop epilogue / clean
        shutdown). Returns the committed save_ids; re-raises the FIRST
        failure after all have settled."""
        done_ids, err = [], None
        while self._pending:
            ps = self._pending[0]
            try:
                done_ids.append(await ps.wait())
            except asyncio.CancelledError:
                if not ps._task.cancelled():
                    raise  # drain itself was cancelled, not the save
                # a deliberately cancel()ed save is not a drain failure
            except Exception as e:  # noqa: BLE001
                err = err if err is not None else e
            self._reap()
            if self._pending and self._pending[0] is ps:
                self._pending.popleft()  # settled but not yet reaped
        if err is not None:
            raise err
        return done_ids
