"""denc-lite: deterministic versioned binary encoding.

The reference threads every wire/disk struct through bufferlist encoders with
a versioned envelope (ENCODE_START/DECODE_START in
src/include/encoding.h): each struct writes

    u8 struct_v . u8 struct_compat . u32 struct_len . <payload>

so old decoders can (a) refuse blobs whose `struct_compat` is newer than what
they understand and (b) skip trailing payload bytes a newer encoder appended —
that skip rule is what makes rolling upgrades possible, and the
`ceph-dencoder` + ceph-object-corpus harness pins the exact bytes across
releases (SURVEY §4 tier 2).

This module re-expresses that contract: little-endian fixed-width primitives
(the reference encodes everything little-endian via ceph_le types), u32
length-prefixed blobs/strings/containers (matching encode(std::vector) /
encode(std::map) shapes), and the versioned envelope with the same
skip-unknown-suffix semantics. No reference bytes are reproduced — the layout
rules are the contract, the structs encoded with it are ours.

tests/test_encoding.py carries a small golden corpus (hex blobs committed in
the repo) playing the role of ceph-object-corpus: any byte drift fails.
"""

from __future__ import annotations

import struct


class DecodeError(ValueError):
    pass


class Encoder:
    def __init__(self) -> None:
        self._parts: list[bytes] = []

    # -- primitives (little-endian, like ceph_le##) ---------------------------

    def u8(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<B", v))
        return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<H", v))
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<I", v))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<Q", v))
        return self

    def s32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<i", v))
        return self

    def s64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<q", v))
        return self

    def f64(self, v: float) -> "Encoder":
        self._parts.append(struct.pack("<d", v))
        return self

    def boolean(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    # -- length-prefixed payloads ---------------------------------------------

    def blob(self, v: bytes) -> "Encoder":
        self.u32(len(v))
        self._parts.append(bytes(v))
        return self

    def string(self, v: str) -> "Encoder":
        return self.blob(v.encode("utf-8"))

    def raw(self, v: bytes) -> "Encoder":
        self._parts.append(bytes(v))
        return self

    def list(self, items, item_fn) -> "Encoder":
        """u32 count + items, the encode(std::vector) shape."""
        self.u32(len(items))
        for it in items:
            item_fn(self, it)
        return self

    def mapping(self, items: dict, key_fn, val_fn) -> "Encoder":
        """u32 count + sorted (key, value) pairs.

        std::map iterates in key order, which is what makes the reference's
        map encodings deterministic; dicts are sorted here for the same
        guarantee.
        """
        keys = sorted(items)
        self.u32(len(keys))
        for k in keys:
            key_fn(self, k)
            val_fn(self, items[k])
        return self

    # -- versioned envelope (ENCODE_START semantics) --------------------------

    def struct(self, version: int, compat: int, body_fn) -> "Encoder":
        body = Encoder()
        body_fn(body)
        payload = body.bytes()
        self.u8(version).u8(compat).u32(len(payload))
        self._parts.append(payload)
        return self

    def bytes(self) -> bytes:
        return b"".join(self._parts)


class Decoder:
    def __init__(self, data: bytes, offset: int = 0, end: int | None = None):
        self._data = data
        self._off = offset
        self._end = len(data) if end is None else end

    def _take(self, n: int) -> bytes:
        if self._off + n > self._end:
            raise DecodeError(
                f"buffer underrun: need {n} bytes at {self._off}, end {self._end}"
            )
        v = self._data[self._off : self._off + n]
        self._off += n
        return v

    def remaining(self) -> int:
        return self._end - self._off

    @property
    def offset(self) -> int:
        """Current read position (for record-stream consumers)."""
        return self._off

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def s64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def blob(self) -> bytes:
        return self._take(self.u32())

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def raw(self, n: int) -> bytes:
        return self._take(n)

    def list(self, item_fn) -> list:
        return [item_fn(self) for _ in range(self.u32())]

    def mapping(self, key_fn, val_fn) -> dict:
        n = self.u32()
        out = {}
        for _ in range(n):
            k = key_fn(self)
            out[k] = val_fn(self)
        return out

    def struct(self, understood_version: int, body_fn):
        """DECODE_START: refuse blobs from a future incompatible encoder,
        decode the payload, skip any suffix a newer-but-compatible encoder
        appended."""
        version = self.u8()
        compat = self.u8()
        length = self.u32()
        if compat > understood_version:
            raise DecodeError(
                f"struct compat {compat} > understood version {understood_version}"
            )
        if self._off + length > self._end:
            raise DecodeError("struct length exceeds buffer")
        body = Decoder(self._data, self._off, self._off + length)
        result = body_fn(body, version)
        self._off += length  # skip anything body_fn did not consume
        return result


# -- dynamic values (the binary op-envelope codec) ----------------------------
#
# Op payloads are JSON-shaped dicts built ad hoc per op type; the wire fast
# path replaces `json.dumps`/`json.loads` per hop with this tagged compact
# encoding. The value model is EXACTLY json's so the two formats are
# interchangeable per connection: tuples encode as lists, non-string dict
# keys stringify the way json.dumps coerces them, and decode always returns
# what json.loads would have (so handlers never see a format difference).
# `bytes` is the one extension (no base64/hex inflation) — op payloads only
# use it for values that never cross into a JSON-encoded hop.

_V_NONE = 0
_V_TRUE = 1
_V_FALSE = 2
_V_INT = 3       # s64
_V_FLOAT = 4     # f64
_V_STR = 5
_V_BYTES = 6
_V_LIST = 7
_V_DICT = 8
_V_BIGINT = 9    # |v| >= 2^63: decimal string


def _json_key(k) -> str:
    """Coerce a dict key the way json.dumps does (parity requirement:
    binary and JSON envelopes must decode to identical payloads)."""
    if isinstance(k, str):
        return k
    if k is True:
        return "true"
    if k is False:
        return "false"
    if k is None:
        return "null"
    if isinstance(k, (int, float)):
        return repr(k) if isinstance(k, float) else str(k)
    raise TypeError(f"unencodable dict key: {k!r}")


def encode_value(e: "Encoder", v) -> None:
    if v is None:
        e.u8(_V_NONE)
    elif v is True:
        e.u8(_V_TRUE)
    elif v is False:
        e.u8(_V_FALSE)
    elif isinstance(v, int):
        if -(1 << 63) <= v < (1 << 63):
            e.u8(_V_INT).s64(v)
        else:
            e.u8(_V_BIGINT).string(str(v))
    elif isinstance(v, float):
        e.u8(_V_FLOAT).f64(v)
    elif isinstance(v, str):
        e.u8(_V_STR).string(v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        e.u8(_V_BYTES).blob(v)
    elif isinstance(v, (list, tuple)):
        e.u8(_V_LIST).u32(len(v))
        for it in v:
            encode_value(e, it)
    elif isinstance(v, dict):
        e.u8(_V_DICT).u32(len(v))
        for k, val in v.items():
            e.string(_json_key(k))
            encode_value(e, val)
    else:
        raise TypeError(f"unencodable value: {type(v).__name__}")


def decode_value(d: "Decoder"):
    tag = d.u8()
    if tag == _V_NONE:
        return None
    if tag == _V_TRUE:
        return True
    if tag == _V_FALSE:
        return False
    if tag == _V_INT:
        return d.s64()
    if tag == _V_FLOAT:
        return d.f64()
    if tag == _V_STR:
        return d.string()
    if tag == _V_BYTES:
        return bytes(d.blob())
    if tag == _V_LIST:
        return [decode_value(d) for _ in range(d.u32())]
    if tag == _V_DICT:
        return {d.string(): decode_value(d) for _ in range(d.u32())}
    if tag == _V_BIGINT:
        return int(d.string())
    raise DecodeError(f"unknown value tag {tag}")


# The Encoder/Decoder-based encode_value/decode_value above are the
# readable spec (and what the golden corpus pins); the helpers below are
# byte-identical tight-loop implementations used on the per-op hot path,
# where this codec has to beat C json to be worth the wire flag.

_B_NONE = bytes((_V_NONE,))
_B_TRUE = bytes((_V_TRUE,))
_B_FALSE = bytes((_V_FALSE,))


def _enc_val(out: bytearray, v, pack=struct.pack) -> None:
    t = type(v)
    if t is str:
        b = v.encode("utf-8")
        out += pack("<BI", _V_STR, len(b))
        out += b
    elif t is int:
        if -(1 << 63) <= v < (1 << 63):
            out += pack("<Bq", _V_INT, v)
        else:
            b = str(v).encode("utf-8")
            out += pack("<BI", _V_BIGINT, len(b))
            out += b
    elif t is dict:
        out += pack("<BI", _V_DICT, len(v))
        for k, val in v.items():
            if type(k) is not str:
                k = _json_key(k)
            kb = k.encode("utf-8")
            out += pack("<I", len(kb))
            out += kb
            _enc_val(out, val)
    elif v is None:
        out += _B_NONE
    elif v is True:
        out += _B_TRUE
    elif v is False:
        out += _B_FALSE
    elif t is float:
        out += pack("<Bd", _V_FLOAT, v)
    elif t is list or t is tuple:
        out += pack("<BI", _V_LIST, len(v))
        for it in v:
            _enc_val(out, it)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        out += pack("<BI", _V_BYTES, len(v))
        out += v
    else:
        # subclasses (IntEnum, bools reached via int subtypes, str
        # subclasses...) — route through the generic spec encoder so the
        # bytes stay identical to encode_value's isinstance dispatch
        e = Encoder()
        encode_value(e, v)
        out += e.bytes()


def _dec_val(buf: bytes, off: int, unpack=struct.unpack_from):
    tag = buf[off]
    off += 1
    if tag == _V_DICT:
        (n,) = unpack("<I", buf, off)
        off += 4
        out = {}
        for _ in range(n):
            (kl,) = unpack("<I", buf, off)
            off += 4
            k = buf[off : off + kl].decode("utf-8")
            off += kl
            out[k], off = _dec_val(buf, off)
        return out, off
    if tag == _V_STR:
        (n,) = unpack("<I", buf, off)
        off += 4
        end = off + n
        if end > len(buf):
            raise DecodeError("string exceeds buffer")
        return buf[off:end].decode("utf-8"), end
    if tag == _V_INT:
        return unpack("<q", buf, off)[0], off + 8
    if tag == _V_LIST:
        (n,) = unpack("<I", buf, off)
        off += 4
        out = [None] * n
        for i in range(n):
            out[i], off = _dec_val(buf, off)
        return out, off
    if tag == _V_NONE:
        return None, off
    if tag == _V_TRUE:
        return True, off
    if tag == _V_FALSE:
        return False, off
    if tag == _V_FLOAT:
        return unpack("<d", buf, off)[0], off + 8
    if tag == _V_BYTES:
        (n,) = unpack("<I", buf, off)
        off += 4
        end = off + n
        if end > len(buf):
            raise DecodeError("blob exceeds buffer")
        return buf[off:end], end
    if tag == _V_BIGINT:
        (n,) = unpack("<I", buf, off)
        off += 4
        return int(buf[off : off + n].decode("utf-8")), off + n
    raise DecodeError(f"unknown value tag {tag}")


def encode_payload(obj) -> bytes:
    """One op payload as a self-contained versioned blob."""
    out = bytearray(6)  # envelope header patched in below
    _enc_val(out, obj)
    struct.pack_into("<BBI", out, 0, 1, 1, len(out) - 6)
    return bytes(out)


def decode_payload(raw) -> object:
    if not isinstance(raw, bytes):
        raw = bytes(raw)
    try:
        _ver, compat, _length = struct.unpack_from("<BBI", raw, 0)
        if compat > 1:
            raise DecodeError(f"struct compat {compat} > understood version 1")
        v, _ = _dec_val(raw, 6)
        return v
    except (struct.error, IndexError) as e:
        raise DecodeError(f"truncated payload: {e}") from e
