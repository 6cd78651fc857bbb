"""cls: in-OSD object classes — server-side methods on objects.

The reference's object-class mechanism (src/objclass/class_api.cc +
src/cls/*) lets clients invoke named methods that run INSIDE the primary
OSD against the object (rados `exec`/cls_cxx_*): reads and read-modify-write
cycles happen server-side, atomically, without shipping the object to the
client. rbd locking, rgw indexes, and watch bookkeeping all live there.

Mini equivalent: a `ClassHandler` registry of (class, method) -> python
callable with RD/WR flags (objclass method flags); the OSD daemon executes
a "call" op by building a `MethodContext` over the object's current content
+ user xattrs, running the method, and — for WR methods that dirtied the
context — writing the result back through the normal backend path, so the
mutation replicates/EC-encodes like any client write.

Built-in classes (reference parity targets):

  * `lock` — advisory exclusive/shared locks held in user xattrs
    (src/cls/lock/cls_lock.cc: lock_op/unlock_op semantics incl. EBUSY on
    conflicting holders and idempotent re-lock by the same owner+cookie).
  * `version` — object-version read/check gates
    (src/cls/version/cls_version.cc), backed by the PG log's obj_ver.

Custom classes register at runtime (`DEFAULT_HANDLER.register`), the
load-your-own-.so story without dlopen.
"""

from __future__ import annotations

from dataclasses import dataclass, field

RD = 1  #: method reads object state (CLS_METHOD_RD)
WR = 2  #: method may mutate object state (CLS_METHOD_WR)


class ClsError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code  # "EBUSY" | "ENOENT" | "ECANCELED" | ...


@dataclass
class MethodContext:
    """What a method sees of its object (cls_cxx_read/write/get/setxattr)."""

    #: None when the object does not exist yet
    data: bytes | None
    #: free-form user xattrs (json-serializable values)
    user_attrs: dict = field(default_factory=dict)
    #: the PG log's object version (0 when absent)
    version: int = 0
    #: the primary's clock at call time (ceph_clock_now as seen by cls
    #: methods); lease arithmetic uses this, never the client's clock.
    #: The OSD stamps it from time.time() + `cls_clock_offset` so tests
    #: can advance "time" deterministically without sleeping.
    now: float = 0.0
    _writable: bool = False
    dirty: bool = False

    def exists(self) -> bool:
        return self.data is not None

    def read(self) -> bytes:
        if self.data is None:
            raise ClsError("ENOENT", "object does not exist")
        return self.data

    def write(self, data: bytes) -> None:
        if not self._writable:
            raise ClsError("EPERM", "RD method attempted a write")
        self.data = bytes(data)
        self.dirty = True

    def getxattr(self, key: str):
        return self.user_attrs.get(key)

    def setxattr(self, key: str, value) -> None:
        if not self._writable:
            raise ClsError("EPERM", "RD method attempted a write")
        self.user_attrs[key] = value
        self.dirty = True

    def rmxattr(self, key: str) -> None:
        if not self._writable:
            raise ClsError("EPERM", "RD method attempted a write")
        if self.user_attrs.pop(key, None) is not None:
            self.dirty = True

    # -- omap (cls_cxx_map_get_vals / set_vals / remove_key) ------------------
    #
    # Methods see the object's real omap rows; mutations are tracked as an
    # exact delta the OSD replicates (EC pools pass omap_supported=False
    # and methods get EOPNOTSUPP, matching ECBackend's no-omap rule).

    omap: dict = None  # set by the OSD before the call; bytes -> bytes
    omap_supported: bool = True

    def _require_omap(self) -> dict:
        if not self.omap_supported:
            raise ClsError("EOPNOTSUPP", "no omap on this pool")
        if self.omap is None:
            self.omap = {}
        if not hasattr(self, "omap_sets"):
            self.omap_sets: dict = {}
            self.omap_rms: list = []
            self.omap_cleared = False
        return self.omap

    def omap_get_vals(
        self, after: bytes | None = None, max_return: int | None = None,
        prefix: bytes = b"",
    ) -> dict:
        omap = self._require_omap()
        keys = sorted(k for k in omap if k.startswith(prefix))
        if after is not None:
            keys = [k for k in keys if k > after]
        if max_return is not None:
            keys = keys[:max_return]
        return {k: omap[k] for k in keys}

    def omap_get_val(self, key: bytes):
        return self._require_omap().get(key)

    def omap_set(self, kv: dict) -> None:
        if not self._writable:
            raise ClsError("EPERM", "RD method attempted a write")
        omap = self._require_omap()
        omap.update(kv)
        self.omap_sets.update(kv)
        for k in kv:
            if k in self.omap_rms:
                self.omap_rms.remove(k)
        self.dirty = True

    def omap_rm(self, keys) -> None:
        if not self._writable:
            raise ClsError("EPERM", "RD method attempted a write")
        omap = self._require_omap()
        for k in keys:
            omap.pop(k, None)
            self.omap_sets.pop(k, None)
            if k not in self.omap_rms:
                self.omap_rms.append(k)
        self.dirty = True

    def omap_delta(self) -> dict | None:
        """The replication payload (hex kv), or None when untouched."""
        if not hasattr(self, "omap_sets"):
            return None
        if not (self.omap_sets or self.omap_rms or self.omap_cleared):
            return None
        return {
            "sets": {k.hex(): v.hex() for k, v in self.omap_sets.items()},
            "rms": [k.hex() for k in self.omap_rms],
            "clear": self.omap_cleared,
        }


class ClassHandler:
    """(class, method) registry (ClassHandler in src/osd/ClassHandler.h)."""

    def __init__(self) -> None:
        self._methods: dict[tuple[str, str], tuple[int, object]] = {}

    def register(self, cls: str, method: str, flags: int, fn) -> None:
        self._methods[(cls, method)] = (flags, fn)

    def call(self, cls: str, method: str, ctx: MethodContext, inp: dict):
        entry = self._methods.get((cls, method))
        if entry is None:
            raise ClsError("EOPNOTSUPP", f"no method {cls}.{method}")
        flags, fn = entry
        ctx._writable = bool(flags & WR)
        return fn(ctx, inp or {})


# -- cls_lock (src/cls/lock/cls_lock.cc behaviors) ----------------------------
#
# Advisory exclusive/shared locks with cookie+owner identity and lease
# TTLs, held in a user xattr (EC-pool-safe — no omap). A holder with
# `duration > 0` carries `expiration` (primary clock, ctx.now); expired
# holders are invisible to conflict checks and breakable by anyone, while
# a re-lock by the same owner+cookie renews the lease (bumps expiration).
# `duration == 0` means the lock never expires (reference cls_lock's
# LOCK_FLAG_MAY_RENEW / utime_t duration semantics).

def _lock_key(name: str) -> str:
    return f"lock.{name}"


def _lock_live(h: dict, now: float) -> bool:
    exp = h.get("expiration", 0)
    return not exp or exp > now


def _lock_op(ctx: MethodContext, inp: dict):
    name = inp["name"]
    ltype = inp.get("type", "exclusive")
    if ltype not in ("exclusive", "shared"):
        raise ClsError("EINVAL", f"bad lock type {ltype!r}")
    owner = inp["owner"]
    cookie = inp.get("cookie", "")
    duration = float(inp.get("duration", 0) or 0)
    state = ctx.getxattr(_lock_key(name)) or {"type": ltype, "holders": []}
    expiration = ctx.now + duration if duration > 0 else 0
    for h in state["holders"]:
        if h["owner"] == owner and h["cookie"] == cookie:
            # idempotent re-lock by the holder renews the lease — even
            # past expiry, as long as nobody broke or took the lock
            h["expiration"] = expiration
            h["description"] = inp.get("description", h.get("description", ""))
            ctx.setxattr(_lock_key(name), state)
            return {"ok": True, "renewed": True, "expiration": expiration}
    live = [h for h in state["holders"] if _lock_live(h, ctx.now)]
    if live and (ltype == "exclusive" or state["type"] == "exclusive"):
        raise ClsError("EBUSY", f"lock {name!r} held")
    # expired holders are pruned the first time a new locker gets in
    # (reference cls_lock expiration semantics); the reply names them
    # so the client can log/count the implicit break
    pruned = [{"owner": h["owner"], "cookie": h["cookie"]}
              for h in state["holders"] if not _lock_live(h, ctx.now)]
    state["type"] = ltype
    state["holders"] = live + [{
        "owner": owner, "cookie": cookie, "expiration": expiration,
        "since": ctx.now, "description": inp.get("description", ""),
    }]
    ctx.setxattr(_lock_key(name), state)
    return {"ok": True, "expiration": expiration, "pruned": pruned}


def _unlock_op(ctx: MethodContext, inp: dict):
    name = inp["name"]
    state = ctx.getxattr(_lock_key(name))
    owner, cookie = inp["owner"], inp.get("cookie", "")
    # exact owner+cookie match; an expired-but-unbroken holder may still
    # unlock (its entry is present until pruned)
    keep = [] if not state else [
        h for h in state["holders"]
        if not (h["owner"] == owner and h["cookie"] == cookie)
    ]
    if not state or len(keep) == len(state["holders"]):
        raise ClsError("ENOENT", f"not the holder of {name!r}")
    if keep:
        state["holders"] = keep
        ctx.setxattr(_lock_key(name), state)
    else:
        ctx.rmxattr(_lock_key(name))
    return {"ok": True}


def _lock_info(ctx: MethodContext, inp: dict):
    state = ctx.getxattr(_lock_key(inp["name"]))
    holders = []
    for h in ([] if not state else state["holders"]):
        exp = h.get("expiration", 0)
        holders.append(dict(
            h,
            expired=bool(exp) and exp <= ctx.now,
            ttl=max(0.0, exp - ctx.now) if exp else None,
        ))
    return {"holders": holders,
            "type": None if not state else state["type"],
            "now": ctx.now}


def _break_lock(ctx: MethodContext, inp: dict):
    """cls_lock break_lock: remove a NAMED holder without being it —
    the recovery path after the holder died (the caller blocklists the
    holder first so its in-flight ops can't outlive the break). With
    `if_expired`, the break only lands if the holder's lease has lapsed
    — evaluated against the primary's clock inside the primary, so it
    is atomic with respect to a racing renewal."""
    name = inp["name"]
    state = ctx.getxattr(_lock_key(name))
    owner = inp["owner"]
    cookie = inp.get("cookie")  # None = any cookie of that owner
    if not state:
        raise ClsError("ENOENT", f"lock {name!r} not held")

    def match(h):
        return h["owner"] == owner and (cookie is None
                                        or h["cookie"] == cookie)

    matched = [h for h in state["holders"] if match(h)]
    if not matched:
        raise ClsError("ENOENT", f"{owner!r} does not hold {name!r}")
    if inp.get("if_expired"):
        live = [h for h in matched if _lock_live(h, ctx.now)]
        if live:
            raise ClsError("EBUSY", f"{owner!r} lease on {name!r} "
                                    "is still live")
    keep = [h for h in state["holders"] if not match(h)]
    if keep:
        state["holders"] = keep
        ctx.setxattr(_lock_key(name), state)
    else:
        ctx.rmxattr(_lock_key(name))
    return {"ok": True, "broken": len(matched)}


# -- cls_ckpt (ceph_tpu.ckpt HEAD pointer guard) ------------------------------
#
# Compare-and-swap of a checkpoint HEAD pointer, the commit point of the
# ckpt writer's chunks -> manifest -> HEAD protocol. State lives in a user
# xattr (plus the object data for plain-read visibility), NOT omap, so the
# same guard works on EC pools where omap is EOPNOTSUPP. Runs inside the
# primary, so two racing savers serialize on the object: the loser's stale
# `expect` fails with ECANCELED and its chunks stay orphaned (gc's job).

#: committed-save history entries the HEAD object retains (gc retention
#: windows are far smaller; entries whose saves were reclaimed are pruned
#: by ckpt.prune_history on the next gc pass)
CKPT_HISTORY_MAX = 512


def _ckpt_mirror(ctx: MethodContext, head: dict, history: list) -> None:
    """Mirror HEAD + commit history into the object data so a plain
    `ioctx.read(HEAD)` needs no exec."""
    import json as _json

    ctx.write(_json.dumps(
        dict(head, history=history), sort_keys=True
    ).encode())


def _ckpt_cas_head(ctx: MethodContext, inp: dict):
    cur = ctx.getxattr("ckpt.head")
    cur_id = None if cur is None else cur.get("save_id")
    expect = inp.get("expect")
    if cur_id != expect:
        raise ClsError(
            "ECANCELED",
            f"HEAD is {cur_id!r}, caller expected {expect!r}",
        )
    head = dict(inp["head"])
    # commit order for gc retention (keep-last-N / keep-every-Nth):
    # appended atomically with the swap, inside the primary
    history = list(ctx.getxattr("ckpt.history") or ())
    history.append(head["save_id"])
    history = history[-CKPT_HISTORY_MAX:]
    ctx.setxattr("ckpt.head", head)
    ctx.setxattr("ckpt.history", history)
    _ckpt_mirror(ctx, head, history)
    return {"ok": True, "prev": cur_id}


def _ckpt_prune_history(ctx: MethodContext, inp: dict):
    """Drop reclaimed save_ids from the commit history (gc's epilogue;
    idempotent — pruning an absent id is a no-op). HEAD itself is never
    prunable."""
    head = ctx.getxattr("ckpt.head")
    if head is None:
        raise ClsError("ENOENT", "no checkpoint HEAD")
    drop = set(inp.get("remove", ())) - {head.get("save_id")}
    history = [
        sid for sid in (ctx.getxattr("ckpt.history") or [])
        if sid not in drop
    ]
    ctx.setxattr("ckpt.history", history)
    _ckpt_mirror(ctx, head, history)
    return {"ok": True, "history": history}


def _ckpt_read_head(ctx: MethodContext, inp: dict):
    head = ctx.getxattr("ckpt.head")
    if head is None:
        raise ClsError("ENOENT", "no checkpoint HEAD")
    return {"head": head}


# -- cls_version (src/cls/version/cls_version.cc) -----------------------------

def _version_read(ctx: MethodContext, inp: dict):
    return {"ver": ctx.version}


def _version_check(ctx: MethodContext, inp: dict):
    """Fail with ECANCELED unless the object version satisfies the
    condition — the optimistic-concurrency gate rgw relies on."""
    want = inp["ver"]
    cond = inp.get("cond", "eq")
    ok = {
        "eq": ctx.version == want,
        "gt": ctx.version > want,
        "ge": ctx.version >= want,
    }.get(cond)
    if ok is None:
        raise ClsError("EINVAL", f"bad cond {cond!r}")
    if not ok:
        raise ClsError(
            "ECANCELED", f"version {ctx.version} fails {cond} {want}"
        )
    return {"ok": True, "ver": ctx.version}


def default_handler() -> ClassHandler:
    h = ClassHandler()
    h.register("lock", "lock", RD | WR, _lock_op)
    h.register("lock", "unlock", RD | WR, _unlock_op)
    h.register("lock", "get_info", RD, _lock_info)
    h.register("lock", "break_lock", RD | WR, _break_lock)
    h.register("version", "read", RD, _version_read)
    h.register("version", "check", RD, _version_check)
    h.register("ckpt", "cas_head", RD | WR, _ckpt_cas_head)
    h.register("ckpt", "read_head", RD, _ckpt_read_head)
    h.register("ckpt", "prune_history", RD | WR, _ckpt_prune_history)
    return h
