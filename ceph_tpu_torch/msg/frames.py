"""ProtocolV2-lite: the on-wire framing.

The reference frames every exchange after the banner as tagged,
crc-protected segments (src/msg/async/frames_v2.h: preamble with tag +
segment count + per-segment crc32c; ProtocolV2.cc drives the handshake tag
sequence HELLO -> AUTH_* -> SESSION). The same shape here, simplified to one
crc per frame:

    u32 magic | u8 tag | u32 len | payload[len] | u32 crc32c(payload)
    [ + 16-byte truncated HMAC-SHA256 when the session is signing ]

The trailing signature is the analogue of secure-mode rx/tx signing
(msgr2 "crc mode with signatures"; CEPH_MSG_AUTH message signing in
ProtocolV1): integrity + authenticity per frame under the session key, no
encryption (the reference's default mode is crc, not secure, too).

Messages (Tag.MESSAGE payloads) are denc-lite structs carrying
(type, tid, seq, map_epoch, data) — the envelope fields every Message
subclass in src/messages/ shares via its ceph_msg_header (type, seq, tid)
plus the osd-op epoch the OSD uses to drop ops from stale clients.

The wire fast path adds two feature-negotiated frame shapes (HELLO carries
a feature-bit word; peers without a bit never see the matching frames):

  * Tag.MESSAGE_SEG — the frames_v2 multi-segment shape: the envelope
    (WITHOUT the bulk `raw` field) is one segment, `raw` rides verbatim as
    the rest of the payload. Object bytes never pass through the envelope
    encoder and arrive as a zero-copy memoryview of the frame buffer.
  * Tag.BATCH — a corked run of frames wrapped in ONE outer frame:
    u32 count, then per inner frame `u8 tag | u32 len | payload`. Inner
    frames carry no crc/signature — the outer crc32c and HMAC cover the
    whole run, amortizing both over every frame in it (the AsyncConnection
    write-event coalescing shape, with the checksum amortized too).
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import struct as struct_mod
from dataclasses import dataclass
from enum import IntEnum

from ceph_tpu_torch.common.crc import ceph_crc32c
from ceph_tpu_torch.common.encoding import (
    Decoder,
    Encoder,
    decode_payload,
    encode_payload,
)

MAGIC = 0x43455054  # "CEPT"
BANNER = b"ceph_tpu msgr v2\n"
SIG_LEN = 16

# -- HELLO feature bits (the msgr2 feature-word role) -------------------------
#
# Appended to the HELLO payload as a trailing u64; decoders from before the
# word existed skip trailing bytes, so negotiation degrades to "no features"
# against old peers and every fast-path shape falls back per connection.

FEATURE_BIN_ENVELOPE = 1 << 0  # MESSAGE_SEG frames + denc-lite op payloads
FEATURE_FRAME_BATCH = 1 << 1   # Tag.BATCH corked multi-frame envelopes
FEATURE_SUBOP_BATCH = 1 << 2   # multi-op sub-op messages (subop_batch)
#: the LocalStack upgrade: HELLO also carries this end's uds:// listener
#: (trailing string — old decoders skip it), and a UDS-dialed session
#: where both ends hold the bit negotiates the shm ring via SHM_SETUP
FEATURE_LOCAL_STACK = 1 << 3
LOCAL_FEATURES = (
    FEATURE_BIN_ENVELOPE | FEATURE_FRAME_BATCH | FEATURE_SUBOP_BATCH
    | FEATURE_LOCAL_STACK
)


class FrameError(Exception):
    pass


class Tag(IntEnum):
    HELLO = 1
    AUTH_REQUEST = 2
    AUTH_CHALLENGE = 3
    AUTH_PROOF = 4
    AUTH_DONE = 5
    MESSAGE = 6
    ACK = 7
    KEEPALIVE = 8
    RESET = 9
    #: zlib-compressed MESSAGE payload (msgr2 compression mode: the
    #: on-wire compression leg of src/compressor wired into ProtocolV2)
    MESSAGE_COMPRESSED = 10
    #: cephx ticket presentation (client -> service daemon): the daemon
    #: verifies with its rotating service keys, never the client's key
    AUTH_TICKET = 11
    #: segmented message: u32 env_len | envelope | raw bytes (feature-
    #: negotiated; the multi-segment frames_v2 shape)
    MESSAGE_SEG = 12
    #: corked multi-frame envelope: u32 count | (u8 tag | u32 len |
    #: payload)* — one crc + one signature for the whole run
    BATCH = 13
    #: shm ring offer (client -> server, right after the handshake on a
    #: UDS session where both HELLOs carried FEATURE_LOCAL_STACK):
    #: string c2s_path | string s2c_path | u64 ring_bytes (0 = stay on
    #: the plain socket)
    SHM_SETUP = 14
    #: server's answer: u8 ok — 1 means both rings mapped and every
    #: subsequent frame rides them; 0 falls back to the socket
    SHM_ACK = 15


_HEAD = struct_mod.Struct("<IBI")  # magic, tag, payload length
_U32 = struct_mod.Struct("<I")


@dataclass
class Frame:
    tag: Tag
    payload: bytes = b""
    #: when set, the logical payload is the concatenation of these
    #: buffers — encode_parts streams them to the socket without joining,
    #: so a bulk `raw` segment is never copied through the frame encoder
    segments: tuple | None = None

    def encode_parts(self, session_key: bytes | None = None) -> list:
        """The frame as a list of buffers ready for one coalesced socket
        write (or one shm-ring record). Segments are NOT joined: the crc
        chains across them (crc(AB) == crc32c(crc32c(seed, A), B)) and
        the native crc takes memoryviews in place, so a bulk `raw`
        segment reaches the transport with zero intermediate copies."""
        segs = self.segments if self.segments is not None else (self.payload,)
        total = 0
        crc = 0xFFFFFFFF
        for s in segs:
            total += len(s)
            crc = ceph_crc32c(crc, s)
        parts: list = [
            _HEAD.pack(MAGIC, int(self.tag), total),
            *(s for s in segs if len(s)),
            _U32.pack(crc),
        ]
        if session_key is not None:
            h = hmac_mod.new(session_key, digestmod=hashlib.sha256)
            for p in parts:
                h.update(p)
            parts.append(h.digest()[:SIG_LEN])
        return parts

    def encode(self, session_key: bytes | None = None) -> bytes:
        return b"".join(self.encode_parts(session_key))


def frame_header_len() -> int:
    return 4 + 1 + 4  # magic + tag + payload length prefix


#: tags whose payload stays a zero-copy memoryview after read_frame (the
#: fast-path shapes slice it themselves); everything else gets bytes so
#: legacy decoders (json.loads, Decoder.string) keep working unchanged
_MV_TAGS = frozenset((int(Tag.MESSAGE_SEG), int(Tag.BATCH)))


async def read_frame(reader, session_key: bytes | None = None) -> Frame:
    """Read one frame from an asyncio StreamReader, verifying crc (and the
    signature when the session is signing). The signature and crc are
    verified over the receive buffers in place — no payload copy."""
    head = await reader.readexactly(frame_header_len())
    magic, tag, length = _HEAD.unpack(head)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    if length > 1 << 30:
        raise FrameError(f"frame too large: {length}")
    rest = await reader.readexactly(length + 4)
    if session_key is not None:
        sig = await reader.readexactly(SIG_LEN)
        h = hmac_mod.new(session_key, digestmod=hashlib.sha256)
        h.update(head)
        h.update(rest)
        if not hmac_mod.compare_digest(sig, h.digest()[:SIG_LEN]):
            raise FrameError("frame signature mismatch")
    (want,) = _U32.unpack_from(rest, length)
    if want != ceph_crc32c(0xFFFFFFFF, rest, length):
        raise FrameError("frame crc mismatch")
    if tag in _MV_TAGS:
        payload = memoryview(rest)[:length]
    else:
        payload = rest[:length]
        if not isinstance(payload, bytes):
            # ring-backed readers hand memoryviews; legacy decoders
            # (json.loads, Decoder.string) need real bytes
            payload = bytes(payload)
    try:
        return Frame(Tag(tag), payload)
    except ValueError as e:
        raise FrameError(f"unknown tag {tag}") from e


# -- corked-run batching (Tag.BATCH) ------------------------------------------


def make_batch_frame(frames: list) -> Frame:
    """Wrap a corked run of frames in one outer frame: inner frames lose
    their per-frame crc/signature (the outer frame's cover the run)."""
    segs: list = [_U32.pack(len(frames))]
    for f in frames:
        inner = f.segments if f.segments is not None else (f.payload,)
        segs.append(
            struct_mod.pack("<BI", int(f.tag), sum(len(s) for s in inner))
        )
        segs.extend(s for s in inner if len(s))
    return Frame(Tag.BATCH, segments=tuple(segs))


def iter_batch(payload):
    """Unpack a BATCH payload into inner Frames. Fast-path inner payloads
    stay memoryview slices of the outer buffer; legacy tags get bytes."""
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    (count,) = _U32.unpack_from(mv, 0)
    off = 4
    for _ in range(count):
        tag, length = struct_mod.unpack_from("<BI", mv, off)
        off += 5
        if off + length > len(mv):
            raise FrameError("batch inner frame exceeds payload")
        inner = mv[off : off + length]
        off += length
        if tag not in _MV_TAGS:
            inner = bytes(inner)
        try:
            yield Frame(Tag(tag), inner)
        except ValueError as e:
            raise FrameError(f"unknown tag {tag} in batch") from e


# -- the message envelope -----------------------------------------------------

#: Message.flags bit: `data` is a denc-lite value blob (decode with
#: decode_payload), not JSON — set per connection at frame-encode time
FLAG_BIN_DATA = 1


@dataclass
class Message:
    """The typed message envelope (ceph_msg_header essentials).

    Two segments, like the reference's multi-segment frames
    (src/msg/async/frames_v2.h: header segment + data segment): `data`
    carries the small structured header, `raw` carries bulk object bytes
    verbatim — never hex-inflated into the header.

    Hot-path senders set `payload` (the structured dict) instead of
    pre-serializing `data`; the connection encodes it at frame-build time
    in whichever format the session negotiated (denc-lite value blob on
    feature-bit peers, JSON otherwise), so one queued Message replays
    correctly to either kind of peer."""

    type: str  #: e.g. "osd_op", "osd_map", "ping" — src/messages/ analogue
    tid: int = 0  #: client transaction id (resend correlation)
    seq: int = 0  #: per-connection sequence (lossless resend/dedup)
    epoch: int = 0  #: sender's map epoch (stale-op fencing)
    data: bytes = b""
    raw: bytes = b""  #: bulk data segment (bufferlist payload analogue)
    #: cumulative piggybacked ack: highest peer seq seen when this frame
    #: was encoded (ceph_msg_header ack_seq role). Standalone ACK frames
    #: only fire on idle connections — request/response traffic acks for
    #: free, halving frame count (each frame is a context switch when
    #: daemons are separate processes)
    ack: int = 0
    #: optional trace context "trace_id:span_id:flags" (the reference
    #: encodes a jaeger trace context into ProtocolV2 message frames the
    #: same way); empty = op is untraced, zero downstream cost
    trace: str = ""
    #: envelope flags (FLAG_*); encoded at struct v5, old decoders skip it
    flags: int = 0
    #: structured payload, encoded into `data` lazily per connection
    payload: object = None

    def encode(self, inline_raw: bool = True) -> bytes:
        raw = self.raw if inline_raw else b""
        return (
            Encoder()
            .struct(
                5,
                1,
                lambda b: b.string(self.type)
                .u64(self.tid)
                .u64(self.seq)
                .u64(self.epoch)
                .blob(self.data)
                .blob(raw)
                .u64(self.ack)
                .string(self.trace)
                .u8(self.flags),
            )
            .bytes()
        )

    @staticmethod
    def decode(raw: bytes) -> "Message":
        def body(b, version):
            return Message(
                type=b.string(),
                tid=b.u64(),
                seq=b.u64(),
                epoch=b.u64(),
                data=b.blob(),
                raw=b.blob() if version >= 2 else b"",
                ack=b.u64() if version >= 3 else 0,
                trace=b.string() if version >= 4 else "",
                flags=b.u8() if version >= 5 else 0,
            )

        return Decoder(raw).struct(1, body)


# fixed runs of the v5 envelope layout, hand-packed on the per-op hot
# path (same bytes Encoder/Message.encode produce — pinned by tests):
#   <BBII  = struct_v, struct_compat, struct_len, len(type)
#   <QQQI  = tid, seq, epoch, len(data)
#   <IQI   = len(raw), ack, len(trace)
_ENV_HEAD = struct_mod.Struct("<BBII")
_ENV_MID = struct_mod.Struct("<QQQI")
_ENV_TAIL = struct_mod.Struct("<IQI")


def message_seg_frame(msg: Message) -> Frame:
    """The MESSAGE_SEG frame for an encoded message: envelope (sans raw)
    as one segment, `raw` appended verbatim — the raw bytes never visit
    an encoder or a payload join."""
    tb = msg.type.encode("utf-8")
    trb = msg.trace.encode("utf-8") if msg.trace else b""
    data = msg.data
    env = bytearray(
        _ENV_HEAD.pack(
            5, 1, 49 + len(tb) + len(data) + len(trb), len(tb)
        )
    )
    env += tb
    env += _ENV_MID.pack(msg.tid, msg.seq, msg.epoch, len(data))
    env += data
    env += _ENV_TAIL.pack(0, msg.ack, len(trb))
    env += trb
    env.append(msg.flags)
    segs = (_U32.pack(len(env)), env)
    if len(msg.raw):
        segs = segs + (msg.raw,)
    return Frame(Tag.MESSAGE_SEG, segments=segs)


def decode_message_seg(payload) -> Message:
    """Inverse of message_seg_frame: the envelope is a small copy, the
    raw segment surfaces as a zero-copy memoryview of the frame buffer."""
    mv = payload if isinstance(payload, memoryview) else memoryview(payload)
    (env_len,) = _U32.unpack_from(mv, 0)
    if 4 + env_len > len(mv):
        raise FrameError("bad MESSAGE_SEG envelope length")
    buf = bytes(mv[4 : 4 + env_len])
    raw = mv[4 + env_len :]
    ver, compat, _blen, tlen = _ENV_HEAD.unpack_from(buf, 0)
    if ver != 5 or compat > 1:
        # an envelope version this fast parser doesn't know: take the
        # generic versioned-decoder path (skip-unknown-suffix semantics)
        msg = Message.decode(buf)
        msg.raw = raw
        return msg
    off = 10 + tlen
    typ = buf[10:off].decode("utf-8")
    tid, seq, epoch, dlen = _ENV_MID.unpack_from(buf, off)
    off += 28
    data = buf[off : off + dlen]
    off += dlen
    rlen, ack, trlen = _ENV_TAIL.unpack_from(buf, off)
    off += 16 + rlen
    trace = buf[off : off + trlen].decode("utf-8") if trlen else ""
    off += trlen
    msg = Message(
        type=typ, tid=tid, seq=seq, epoch=epoch, data=data,
        ack=ack, trace=trace, flags=buf[off] if off < len(buf) else 0,
    )
    msg.raw = raw
    return msg


def payload_of(msg: Message):
    """The structured payload of a received message, whichever envelope
    format the sender used (dispatch sites call this instead of
    json.loads so both formats — and old peers — decode identically)."""
    if not len(msg.data):
        return {}
    if msg.flags & FLAG_BIN_DATA:
        return decode_payload(msg.data)
    return json.loads(msg.data)


def redirect_reply(
    tid: int, primary: int, epoch: int, why: str = "",
    backfill=None,
) -> dict:
    """osd_op_reply payload bouncing a balanced/direct-shard read back to
    the PG primary (MOSDOpReply redirect role): the target cannot prove
    its copy is current — peering, backfill, a stale activation marker, a
    version mismatch, or a local read error — so the client must retry at
    the primary instead of risking wrong data. `primary` and `epoch` are
    the sender's view; the client trusts them only as a hint and refreshes
    its map when the epoch is ahead of its own. `backfill` (when the
    sender's activation marker names backfill targets) tells the client
    which acting members to skip for FUTURE balanced reads of this PG —
    without it every round-robin pass pays this bounce again."""
    out = {
        "tid": tid,
        "ok": False,
        "redirect": True,
        "primary": primary,
        "epoch": epoch,
        "why": why,
    }
    if backfill:
        out["backfill"] = sorted(backfill)
    return out
