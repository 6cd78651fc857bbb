"""Runtime asyncio race/leak detector (CEPH_TPU_RACECHECK=1).

The static side of cephlint proves structural invariants; this module
watches the two failure classes that only exist at runtime:

  * **lock-order inversions** — lockdep-style: every ``asyncio.Lock`` is
    assigned a *lock class* by its creation site (file:line), every
    acquisition while other locks are held adds ``held -> acquiring``
    edges to a global order graph, and a new edge that closes a cycle is
    an inversion: two tasks taking the same pair of lock classes in
    opposite orders can deadlock even on a single-threaded event loop,
    because the loop interleaves at every await.
  * **unawaited-task leaks** — a Task garbage-collected while still
    pending had no live reference: nothing could ever await it, and its
    exception (if any) was silently dropped.  This is the runtime twin
    of the static ``task-leak`` check.

It also *reports* (but does not assert on) locks held across messenger
network awaits: coordination leases held over RADOS IO are by design
(e.g. the checkpoint committer lock spans the save), so
``assert_clean()`` covers only inversions and leaks.

Install with :func:`install` (idempotent); the tier-1 conftest does so
for every test session when ``CEPH_TPU_RACECHECK=1`` and calls
:func:`assert_clean` at teardown.  ``coord.lock.Lock`` participates in
the same order graph via :func:`note_acquire`/:func:`note_release`.
"""

from __future__ import annotations

import asyncio
import asyncio.base_events
import os
import sys
import weakref

ENV = "CEPH_TPU_RACECHECK"

_installed = False
_orig_lock = None
_orig_loop_create_task = None

#: lock-class order graph: class -> set of classes acquired while it was
#: held; edge examples carry one (holder_site, acquirer_site) witness
_order: dict[str, set[str]] = {}
_edge_witness: dict[tuple[str, str], str] = {}
#: per-task held lock classes, keyed by id(task) (stable for its lifetime)
_held: dict[int, list[str]] = {}
#: pending tasks by id -> creation site; removed when the task completes
_pending: dict[int, str] = {}

inversions: list[dict] = []
leaks: list[dict] = []
io_under_lock: list[dict] = []
_seen_inversions: set[tuple[str, str]] = set()
_seen_io: set[tuple[str, ...]] = set()


def wanted() -> bool:
    """True when the environment asks for the race detector."""
    return os.environ.get(ENV, "") not in ("", "0")


def active() -> bool:
    return _installed


_THIS_FILE = os.path.abspath(__file__)
#: filename -> (is_foreign, display_name) memo: _site() runs on EVERY
#: create_task, so the per-frame path normalization must be O(dict hit)
_site_fn_cache: dict[str, tuple[bool, str]] = {}


def _site_fn(fn: str) -> tuple[bool, str]:
    got = _site_fn_cache.get(fn)
    if got is None:
        foreign = (os.path.abspath(fn) != _THIS_FILE
                   and f"{os.sep}asyncio{os.sep}" not in fn)
        display = fn if fn.startswith("<") else os.path.relpath(fn)
        got = _site_fn_cache[fn] = (foreign, display)
    return got


def _site(skip_prefixes: tuple[str, ...] = ()) -> str:
    """file:line of the nearest caller outside this module and asyncio."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        foreign, display = _site_fn(fn)
        if foreign and not fn.startswith(skip_prefixes):
            return f"{display}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _task_key() -> int | None:
    try:
        t = asyncio.current_task()
    except RuntimeError:
        return None
    return None if t is None else id(t)


def _path_exists(src: str, dst: str) -> list[str] | None:
    """DFS: a held-before path src -> ... -> dst in the order graph."""
    stack = [(src, [src])]
    visited = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _order.get(node, ()):
            if nxt not in visited:
                visited.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def note_acquire(lock_class: str, *, blocking: bool = True) -> None:
    """Record that the current task now holds `lock_class`; detect any
    order-graph cycle the new held->acquiring edges introduce.

    Lockdep semantics: only a BLOCKING acquisition adds held->acquiring
    edges — a trylock (coord ``block=False``) fails fast instead of
    waiting, so it cannot complete a deadlock cycle as the acquirer.
    Either way the lock joins the held set: HOLDING it while someone
    else blocks is still half of an inversion."""
    key = _task_key()
    if key is None:
        return
    held = _held.setdefault(key, [])
    if not blocking:
        held.append(lock_class)
        return
    for h in held:
        if h == lock_class:
            continue
        # would h -> lock_class close a cycle? (a path the OTHER way
        # already exists: lock_class held before h somewhere else)
        if (h, lock_class) not in _edge_witness:
            back = _path_exists(lock_class, h)
            if back is not None:
                pair = tuple(sorted((h, lock_class)))
                if pair not in _seen_inversions:
                    _seen_inversions.add(pair)
                    inversions.append({
                        "classes": [h, lock_class],
                        "path_back": back,
                        "witness": _edge_witness.get(
                            (back[0], back[1]), "?"),
                        "at": _site(),
                    })
            _order.setdefault(h, set()).add(lock_class)
            _edge_witness[(h, lock_class)] = _site()
    held.append(lock_class)


def note_release(lock_class: str) -> None:
    key = _task_key()
    if key is None:
        return
    held = _held.get(key)
    if held and lock_class in held:
        # remove the most recent acquisition of that class
        for i in range(len(held) - 1, -1, -1):
            if held[i] == lock_class:
                del held[i]
                break
        if not held:
            _held.pop(key, None)


def note_io(kind: str = "net") -> None:
    """Called from the messenger's socket-write path: report (never
    assert) locks held across a network await."""
    if not _installed:
        return
    key = _task_key()
    if key is None:
        return
    held = _held.get(key)
    if held:
        sig = (kind, *sorted(set(held)))
        if sig not in _seen_io:
            _seen_io.add(sig)
            io_under_lock.append({
                "kind": kind, "held": sorted(set(held)), "at": _site(),
            })


class _TrackedLock(asyncio.Lock):
    """asyncio.Lock that reports acquisition order by creation site."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._rc_class = f"asyncio.Lock@{_site()}"

    async def acquire(self):
        ok = await super().acquire()
        note_acquire(self._rc_class)
        return ok

    def release(self):
        super().release()
        note_release(self._rc_class)


def _track_task(task: asyncio.Task, site: str) -> None:
    key = id(task)
    _pending[key] = site

    def _done(t, _key=key):
        _pending.pop(_key, None)
        _held.pop(_key, None)

    task.add_done_callback(_done)

    def _finalized(_ref, _key=key, _site=site):
        # the weakref died: if the entry is still pending the task was
        # garbage-collected before ever completing — nothing held a
        # reference, nothing could await it
        _task_refs.discard(_ref)
        if _pending.pop(_key, None) is not None:
            leaks.append({"task": _site, "gc": "collected while pending"})

    # keep the ref alive via the registry so the callback can fire
    _task_refs.add(weakref.ref(task, _finalized))


_task_refs: set = set()


def install() -> None:
    """Patch asyncio.Lock and loop.create_task (idempotent)."""
    global _installed, _orig_lock, _orig_loop_create_task
    if _installed:
        return
    _orig_lock = asyncio.Lock
    asyncio.Lock = _TrackedLock
    asyncio.locks.Lock = _TrackedLock

    _orig_loop_create_task = asyncio.base_events.BaseEventLoop.create_task

    def create_task(self, coro, **kw):
        task = _orig_loop_create_task(self, coro, **kw)
        _track_task(task, _site())
        return task

    asyncio.base_events.BaseEventLoop.create_task = create_task
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    asyncio.Lock = _orig_lock
    asyncio.locks.Lock = _orig_lock
    asyncio.base_events.BaseEventLoop.create_task = _orig_loop_create_task
    _installed = False


def reset() -> None:
    """Drop accumulated state (between tests / sessions)."""
    _order.clear()
    _edge_witness.clear()
    _held.clear()
    _pending.clear()
    _task_refs.clear()
    inversions.clear()
    leaks.clear()
    io_under_lock.clear()
    _seen_inversions.clear()
    _seen_io.clear()


def report() -> dict:
    return {
        "inversions": list(inversions),
        "leaks": list(leaks),
        "io_under_lock": list(io_under_lock),
        "lock_classes": len(_order),
    }


def assert_clean() -> None:
    """Raise on inversions or unawaited-task leaks.  io_under_lock is
    informational only (coord leases legitimately span RADOS IO)."""
    import gc
    gc.collect()  # flush pending-task finalizers before judging
    problems = []
    for inv in inversions:
        problems.append(
            f"lock-order inversion between {inv['classes'][0]} and "
            f"{inv['classes'][1]} (reverse path {inv['path_back']}, "
            f"detected at {inv['at']})"
        )
    for leak in leaks:
        problems.append(
            f"task created at {leak['task']} was garbage-collected while "
            "still pending — keep a reference and await it (the OSD._spawn "
            "idiom)"
        )
    if problems:
        raise AssertionError(
            "racecheck: " + "; ".join(problems)
        )
