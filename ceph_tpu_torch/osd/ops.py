"""Object op execution: the do_osd_ops analogue.

The reference executes a client op vector against an ObjectContext inside
the primary (PrimaryLogPG::do_osd_ops, src/osd/PrimaryLogPG.cc:5577 — the
giant per-op switch; execute_ctx 3709 builds the transaction that then
replicates). Here the same idea is a pure function over an `ObjectState`:
the primary AND every replica run `execute_ops` on the identical op vector
(sub-ops ship the ops, the reference ships the compiled transaction — same
contract: deterministic application), so partial writes, omap, and xattr
mutations replicate without shipping whole objects.

Op descriptors are JSON dicts; bulk write payloads ride the message's raw
segment, split by `data_lens` (one slice per data-consuming op, in op
order). Read results are returned the same way.

Ops (reference opcode in parens, src/include/rados.h):

  data    write(off) (WRITE), write_full (WRITEFULL), append (APPEND),
          truncate(size) (TRUNCATE), zero(off,len) (ZERO),
          create (CREATE: EEXIST when exclusive), delete (DELETE),
          read(off,len) (READ), stat (STAT)
  omap    omap_set(kv) (OMAPSETVALS), omap_get(after,max) (OMAPGETVALS),
          omap_rm(keys) (OMAPRMKEYS), omap_clear (OMAPCLEAR)
  xattr   setxattr(name) (SETXATTR), getxattr(name) (GETXATTR),
          rmxattr(name) (RMXATTR), getxattrs (GETXATTRS)

EC pools construct ObjectState with omap_supported=False: omap ops raise
EOPNOTSUPP, the errno ECBackend returns (EC pools have no omap in the
reference either).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class OpError(Exception):
    """Typed, client-visible errno (ENOENT/EEXIST/EOPNOTSUPP/...)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


@dataclass
class ObjectState:
    """The mutable object context one op vector executes against."""

    exists: bool = False
    data: bytearray = field(default_factory=bytearray)
    #: user xattrs, name -> bytes (object_info_t attrs role)
    xattrs: dict[str, bytes] = field(default_factory=dict)
    #: user omap, bytes -> bytes; None means "not loaded" (lazy)
    omap: dict[bytes, bytes] | None = None
    omap_supported: bool = True
    # dirty tracking: what persistence must flush
    data_dirty: bool = False
    xattr_dirty: bool = False
    #: exact omap delta (replicas replay these against their local omap)
    omap_sets: dict[bytes, bytes] = field(default_factory=dict)
    omap_rms: list[bytes] = field(default_factory=list)
    omap_cleared: bool = False
    deleted: bool = False

    @property
    def dirty(self) -> bool:
        return (
            self.data_dirty
            or self.xattr_dirty
            or self.omap_dirty
            or self.deleted
        )

    @property
    def omap_dirty(self) -> bool:
        return bool(self.omap_sets or self.omap_rms or self.omap_cleared)

    def _require_omap(self) -> dict[bytes, bytes]:
        if not self.omap_supported:
            raise OpError(
                "EOPNOTSUPP", "omap operations not supported on this pool"
            )
        if self.omap is None:
            self.omap = {}
        return self.omap

    def _touch(self) -> None:
        if not self.exists:
            self.exists = True
            self.data_dirty = True


def execute_ops(
    state: ObjectState, ops: list[dict], datas: list[bytes]
) -> tuple[list[dict], list[bytes]]:
    """Run the vector in order. Returns (per-op results, read payloads);
    read payloads concatenate into the reply's raw segment in op order.
    Raises OpError leaving `state` possibly part-mutated — callers discard
    the state on error (the reference aborts the whole ctx the same way).
    """
    results: list[dict] = []
    reads: list[bytes] = []
    di = 0

    def next_data() -> bytes:
        nonlocal di
        if di >= len(datas):
            raise OpError("EINVAL", "op vector short of data segments")
        d = datas[di]
        di += 1
        return d

    for op in ops:
        kind = op["op"]
        res: dict = {}
        if kind == "create":
            if op.get("exclusive") and state.exists:
                raise OpError("EEXIST", "object exists")
            state._touch()
        elif kind == "write_full":
            buf = next_data()
            state.data = bytearray(buf)
            state._touch()
            state.data_dirty = True
        elif kind == "write":
            buf = next_data()
            off = int(op.get("off", 0))
            if off + len(buf) > len(state.data):
                state.data.extend(
                    b"\x00" * (off + len(buf) - len(state.data))
                )
            state.data[off: off + len(buf)] = buf
            state._touch()
            state.data_dirty = True
        elif kind == "append":
            buf = next_data()
            state.data.extend(buf)
            state._touch()
            state.data_dirty = True
        elif kind == "truncate":
            size = int(op["size"])
            if size <= len(state.data):
                del state.data[size:]
            else:
                state.data.extend(b"\x00" * (size - len(state.data)))
            state._touch()
            state.data_dirty = True
        elif kind == "zero":
            if not state.exists:
                raise OpError("ENOENT", "no such object")
            off, length = int(op["off"]), int(op["len"])
            end = min(off + length, len(state.data))
            if off < len(state.data):
                state.data[off:end] = b"\x00" * (end - off)
            state.data_dirty = True
        elif kind == "delete":
            if not state.exists:
                raise OpError("ENOENT", "no such object")
            state.exists = False
            state.deleted = True
            state.data = bytearray()
            state.xattrs = {}
            if state.omap_supported:
                state.omap = {}
                state.omap_cleared = True
                state.omap_sets = {}
                state.omap_rms = []
        elif kind == "read":
            if not state.exists:
                raise OpError("ENOENT", "no such object")
            off = int(op.get("off", 0))
            length = op.get("length")
            end = len(state.data) if length is None else off + int(length)
            chunk = bytes(state.data[off:end])
            res["data_len"] = len(chunk)
            reads.append(chunk)
        elif kind == "stat":
            if not state.exists:
                raise OpError("ENOENT", "no such object")
            res["size"] = len(state.data)
        elif kind == "omap_set":
            omap = state._require_omap()
            kv = {
                bytes.fromhex(k): bytes.fromhex(v)
                for k, v in op["kv"].items()
            }
            omap.update(kv)
            state.omap_sets.update(kv)
            for k in kv:
                if k in state.omap_rms:
                    state.omap_rms.remove(k)
            state._touch()
        elif kind == "omap_get":
            omap = state._require_omap()
            after = bytes.fromhex(op["after"]) if op.get("after") else None
            max_return = op.get("max_return")
            keys = sorted(omap)
            if after is not None:
                keys = [k for k in keys if k > after]
            if max_return is not None:
                keys = keys[: int(max_return)]
            res["kv"] = {k.hex(): omap[k].hex() for k in keys}
        elif kind == "omap_rm":
            if not state.exists:
                raise OpError("ENOENT", "no such object")
            omap = state._require_omap()
            for khex in op["keys"]:
                k = bytes.fromhex(khex)
                omap.pop(k, None)
                state.omap_sets.pop(k, None)
                if k not in state.omap_rms:
                    state.omap_rms.append(k)
        elif kind == "omap_clear":
            if not state.exists:
                raise OpError("ENOENT", "no such object")
            state._require_omap()
            state.omap = {}
            state.omap_sets = {}
            state.omap_rms = []
            state.omap_cleared = True
        elif kind == "setxattr":
            state.xattrs[op["name"]] = bytes.fromhex(op["value"])
            state.xattr_dirty = True
            state._touch()
        elif kind == "getxattr":
            if op["name"] not in state.xattrs:
                raise OpError("ENOENT", f"no xattr {op['name']!r}")
            res["value"] = state.xattrs[op["name"]].hex()
        elif kind == "rmxattr":
            if state.xattrs.pop(op["name"], None) is not None:
                state.xattr_dirty = True
        elif kind == "getxattrs":
            # reserved names (SnapSet etc.) are internal bookkeeping,
            # invisible to clients like object_info_t attrs are
            res["xattrs"] = {
                k: v.hex() for k, v in state.xattrs.items()
                if not k.startswith("\x01")
            }
        else:
            raise OpError("EINVAL", f"unknown op {kind!r}")
        results.append(res)
    return results, reads


def is_mutating(ops: list[dict]) -> bool:
    read_only = {
        "read", "stat", "omap_get", "getxattr", "getxattrs",
    }
    return any(op["op"] not in read_only for op in ops)
