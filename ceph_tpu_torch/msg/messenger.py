"""The Messenger: entity-addressed async transport with resend semantics.

Re-expresses the reference's messenger contracts (SURVEY §2.4) on asyncio
TCP instead of epoll worker threads:

  * `Messenger` owns a listening endpoint and a set of `Connection`s,
    created lazily by `connect()` (Messenger::create + get_connection,
    src/msg/Messenger.h:149; AsyncMessenger.cc).
  * A `Dispatcher` receives every inbound message on its connection's
    ordered stream (`ms_dispatch`, fast-dispatch analogue) plus accept and
    reset events (`ms_handle_accept`, `ms_handle_reset`).
  * `Policy` picks lossy vs lossless semantics (Messenger::Policy:
    lossy_client / stateful_server ...). Lossless connections number every
    message (seq), ack on receipt, resend un-acked messages in order after a
    reconnect, and the receiving side drops duplicates by seq — the
    ProtocolV1 lossless resend contract — with per-peer in_seq state owned
    by the Messenger so dedup survives connection instances.
  * Auth is cephx-shaped (src/auth): shared-secret keyring, server
    challenge, HMAC proof, then a per-session key derived from
    (secret, both nonces) signs every subsequent frame (message signing).
    A wrong or missing key is refused with RESET before any message flows.
  * Backpressure: an `AsyncThrottle` bounds in-flight dispatch bytes per
    messenger (Policy::throttler_bytes, src/common/Throttle.cc usage in
    AsyncConnection) — reads stall when the dispatcher falls behind.
  * Fault injection straight from config (options.cc:1044-1066):
    `ms_inject_socket_failures` = 1-in-N chance per frame I/O to drop the
    socket; `ms_inject_internal_delays` = seconds to sleep around I/O.

Delivery guarantees (tested in tests/test_messenger.py): lossless pairs
deliver exactly once, in order, across injected socket failures; lossy
connections may drop on failure but never duplicate or reorder.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import hmac as hmac_mod
import json
import os
import random
import tempfile
from dataclasses import dataclass, field

from ceph_tpu_torch.common.encoding import Decoder, Encoder, encode_payload
from ceph_tpu_torch.msg.frames import (
    BANNER,
    FEATURE_BIN_ENVELOPE,
    FEATURE_FRAME_BATCH,
    FEATURE_LOCAL_STACK,
    FLAG_BIN_DATA,
    LOCAL_FEATURES,
    Frame,
    FrameError,
    Message,
    Tag,
    decode_message_seg,
    iter_batch,
    make_batch_frame,
    message_seg_frame,
)
from ceph_tpu_torch.msg.shm import ShmRing, ShmStream
from ceph_tpu_torch.msg.stack import (
    STACKS,
    InjectingStream,
    format_endpoint,
    parse_endpoint,
)

#: compat alias — the stream type moved to ceph_tpu/msg/stack.py with the
#: NetworkStack split; existing call sites keep working
_InjectingStream = InjectingStream


@dataclass(frozen=True)
class Policy:
    """Connection semantics, Messenger::Policy."""

    lossy: bool
    #: reconnect on failure from this side (client of a stateful session)
    client: bool = True

    @staticmethod
    def lossy_client() -> "Policy":
        return Policy(lossy=True, client=True)

    @staticmethod
    def lossless_client() -> "Policy":
        return Policy(lossy=False, client=True)

    @staticmethod
    def stateful_server() -> "Policy":
        return Policy(lossy=False, client=False)


class Dispatcher:
    """Override any subset; all methods may be coroutines or plain."""

    async def ms_dispatch(self, conn: "Connection", msg: Message) -> None:
        pass

    async def ms_handle_accept(self, conn: "Connection") -> None:
        pass

    async def ms_handle_reset(self, conn: "Connection") -> None:
        pass


async def _call(fn, *args):
    r = fn(*args)
    if asyncio.iscoroutine(r):
        await r


def _est_size(item) -> int:
    """Rough wire size of a queued send item, for byte-capping cork runs.
    An estimate is fine: overruns fall back to the chunked ring path."""
    kind, it = item
    if kind == "msg":
        raw = getattr(it, "raw", b"") or b""
        data = getattr(it, "data", b"") or b""
        return len(raw) + len(data) + 512
    if it.segments is not None:
        return sum(len(s) for s in it.segments) + 64
    return len(it.payload) + 64


def backoff_with_jitter(backoff: float, rng) -> float:
    """Reconnect sleep for one attempt: uniform in [backoff/2, backoff].
    A fenced/killed daemon has EVERY peer's reconnect loop pointed at it;
    without jitter they all wake in lockstep on the shared doubling
    schedule and hammer the returning address together (thundering herd —
    the reference staggers the same way in its backoff paths)."""
    return backoff * (0.5 + 0.5 * rng.random())


class AsyncThrottle:
    """asyncio flavor of common/Throttle: bounds in-flight units."""

    def __init__(self, max_units: int):
        self._max = max_units
        self._count = 0
        self._cond = asyncio.Condition()

    @property
    def current(self) -> int:
        return self._count

    def _should_wait(self, c: int) -> bool:
        if not self._max:
            return False
        return self._count + c > self._max and not (
            c > self._max and self._count == 0
        )

    async def get(self, c: int = 1) -> None:
        async with self._cond:
            await self._cond.wait_for(lambda: not self._should_wait(c))
            self._count += c

    async def put(self, c: int = 1) -> None:
        async with self._cond:
            self._count = max(0, self._count - c)
            self._cond.notify_all()


#: test/observability hook: futures resolved after the next inbound
#: message dispatch anywhere in this process. Live-test helpers park on
#: this instead of polling — every cluster state transition (map commit,
#: recovery push, perf bump) is carried by some dispatched message.
_dispatch_waiters: list = []


def next_dispatch_event() -> asyncio.Future:
    """A future resolved when any messenger in this process finishes
    dispatching an inbound message (a condition-variable style wakeup
    for wait-until-cluster-state helpers)."""
    fut = asyncio.get_event_loop().create_future()
    _dispatch_waiters.append(fut)
    return fut


def _notify_dispatch() -> None:
    if not _dispatch_waiters:
        return
    waiters = _dispatch_waiters[:]
    del _dispatch_waiters[:]
    for fut in waiters:
        if not fut.done():
            try:
                fut.set_result(None)
            except RuntimeError:
                pass  # future bound to an already-closed loop


class Connection:
    """One peer session. Outgoing connections own the reconnect loop;
    incoming ones are replaced by the next accept from the same peer."""

    def __init__(
        self,
        messenger: "Messenger",
        peer_addr: tuple[str, int] | None,
        policy: Policy,
        outgoing: bool,
    ):
        self.messenger = messenger
        self.peer_addr = peer_addr
        #: scheme-tagged local endpoint of the peer (uds://...), from the
        #: cluster map at connect() time — tried before TCP when set
        self.local_hint: str | None = None
        #: transport this session actually rides: "tcp", "uds", or "shm"
        #: (surfaced as a span tag and in daemon_bench's `stack` key)
        self.stack: str = "tcp"
        self.peer_name: str | None = None
        self.peer_nonce: int = 0
        #: the peer's advertised uds:// listener from its HELLO (with
        #: FEATURE_LOCAL_STACK); informational on accepted connections
        self.peer_local_addr: str = ""
        #: feature bits the peer advertised at HELLO (0 until the
        #: handshake lands, and against pre-feature-word peers forever —
        #: every fast-path shape checks a bit before using it)
        self.peer_features: int = 0
        self.policy = policy
        self.outgoing = outgoing
        self.session_key: bytes | None = None
        self.out_seq = 0
        self._unacked: list[Message] = []
        self._send_q: asyncio.Queue = asyncio.Queue()
        self._stream: _InjectingStream | None = None
        self._closed = False
        self._ready = asyncio.Event()
        self._tasks: list[asyncio.Task] = []
        #: ack coalescing: highest peer seq received / highest ack we have
        #: actually communicated. Any outgoing message piggybacks the
        #: current owed ack; a short timer covers idle connections, so
        #: request/response traffic never pays a standalone ACK frame.
        self._ack_owed = 0
        self._ack_sent = 0
        self._ack_timer: asyncio.TimerHandle | None = None

    # -- public API -----------------------------------------------------------

    def send_message(self, msg: Message) -> None:
        """Queue a message; never blocks (AsyncConnection::send_message)."""
        if self._closed:
            return
        tracer = self.messenger.tracer
        if tracer is not None and msg.trace:
            # send-side messenger span: queue wait + encode, finished by
            # _encode_msg_frame when the frame actually hits the stream
            sp = tracer.join(
                msg.trace, "msg_send",
                tags={"type": msg.type, "from": self.messenger.name},
            )
            if sp is not None:
                msg._send_span = sp
        self.out_seq += 1
        msg.seq = self.out_seq
        if not self.policy.lossy:
            self._unacked.append(msg)
            if not self.outgoing and self.peer_name is not None:
                # accepted (server-side) connections are re-created per
                # accept; persisting the counter keeps seqs monotonic per
                # peer instance across accepts so the far side's dedup
                # holds. Outgoing connections persist as objects and keep
                # their own counter — and two peers that dial EACH OTHER
                # hold two independent sessions, so the counters never mix.
                self.messenger._peer_out_seq[
                    (self.peer_name, self.peer_nonce)
                ] = self.out_seq
        self._send_q.put_nowait(("msg", msg))

    def send_keepalive(self) -> None:
        if not self._closed:
            self._send_q.put_nowait(("frame", Frame(Tag.KEEPALIVE, b"")))

    async def close(self) -> None:
        self._closed = True
        if self._ack_timer is not None:
            self._ack_timer.cancel()
            self._ack_timer = None
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    @property
    def is_connected(self) -> bool:
        return self._stream is not None and self._ready.is_set()

    def has_feature(self, bit: int) -> bool:
        return bool(self.peer_features & bit)

    # -- outgoing side --------------------------------------------------------

    def _start_outgoing(self) -> None:
        self._tasks.append(asyncio.create_task(self._run_outgoing()))

    async def _dial(self) -> InjectingStream:
        """Open the byte transport for this session: the peer's local
        (uds://) endpoint when we hold one and ms_local_stack allows it,
        falling back to TCP when the peer is remote, the socket is stale,
        or the local stack is disabled — the graceful-fallback leg."""
        m = self.messenger
        hint = self.local_hint
        if hint and m._local_stack:
            try:
                scheme, target = parse_endpoint(hint)
                if scheme == "uds":
                    reader, writer = await m.stacks["uds"].connect(target)
                    self.stack = "uds"
                    return InjectingStream(reader, writer, m)
            except (OSError, ValueError):
                pass  # not reachable from this host: take TCP below
        reader, writer = await m.stacks["tcp"].connect(self.peer_addr)
        self.stack = "tcp"
        return InjectingStream(reader, writer, m)

    async def _maybe_upgrade_local(
        self, stream: InjectingStream
    ) -> InjectingStream:
        """Client leg of the shm ring negotiation. On a UDS session where
        both HELLOs carried FEATURE_LOCAL_STACK the client ALWAYS sends
        SHM_SETUP (ring_bytes=0 when it can't offer rings), so the server
        can deterministically expect it; the server's SHM_ACK decides
        whether frames ride the rings or stay on the socket."""
        m = self.messenger
        if self.stack != "uds" or not (
            self.peer_features & FEATURE_LOCAL_STACK
        ):
            return stream
        ring_bytes = m._ring_bytes_effective()
        tx = rx = None
        p_tx = p_rx = ""
        if ring_bytes:
            tag = os.urandom(8).hex()
            try:
                d = m._uds_dir_path()
                p_tx = os.path.join(d, f"{tag}.c2s.ring")
                p_rx = os.path.join(d, f"{tag}.s2c.ring")
                tx = ShmRing.create(p_tx, ring_bytes)
                rx = ShmRing.create(p_rx, ring_bytes)
            except (OSError, ValueError):
                if tx is not None:
                    tx.close(unlink=True)
                tx = rx = None
                p_tx = p_rx = ""
        try:
            await stream.send(
                Frame(
                    Tag.SHM_SETUP,
                    Encoder().string(p_tx).string(p_rx)
                    .u64(ring_bytes if tx is not None else 0)
                    .bytes(),
                ),
                self.session_key,
            )
            reply = await stream.recv(self.session_key)
        except BaseException:
            for r in (tx, rx):
                if r is not None:
                    r.close(unlink=True)
            raise
        if reply.tag != Tag.SHM_ACK:
            for r in (tx, rx):
                if r is not None:
                    r.close(unlink=True)
            raise FrameError(f"expected SHM_ACK, got {reply.tag}")
        ok = Decoder(reply.payload).u8()
        if ok and tx is not None:
            # the server mapped and unlinked the ring files: the memory
            # now lives exactly as long as the two maps do (kill -9 safe)
            self.stack = "shm"
            return ShmStream(stream.reader, stream.writer, m, tx=tx, rx=rx)
        for r in (tx, rx):
            if r is not None:
                r.close(unlink=True)
        return stream

    async def _run_outgoing(self) -> None:
        backoff = 0.01
        while not self._closed:
            stream = None
            try:
                stream = await self._dial()
                await self._client_handshake(stream)
                stream = await self._maybe_upgrade_local(stream)
                # the chaos schedule keys on peer identity, known only
                # now — handshake frames ride uninjected by design
                stream.chaos_peer = self.peer_name
                self._stream = stream
                backoff = 0.01
                # Start reading BEFORE replaying so ACKs for replayed
                # messages are processed as they come back: the un-acked
                # window then shrinks monotonically across attempts and a
                # high injected-failure rate still makes forward progress.
                read_task = asyncio.create_task(self._read_loop(stream))
                writer_task = None
                try:
                    # lossless: replay the un-acked window in order before
                    # anything newly queued (requeue_sent, the ProtocolV1
                    # contract); the writer must stay off until the replay
                    # is done or new messages could overtake old seqs and
                    # trip the receiver's duplicate filter
                    if not self.policy.lossy:
                        for m in list(self._unacked):
                            if m not in self._unacked:
                                continue  # acked while we were replaying
                            await stream.send(
                                self._encode_msg_frame(m),
                                self.session_key,
                            )
                    self._ready.set()
                    writer_task = asyncio.create_task(
                        self._write_loop(stream)
                    )
                    await read_task
                finally:
                    for t in (read_task, writer_task):
                        if t is not None:
                            t.cancel()
                            try:
                                await t
                            except (asyncio.CancelledError, Exception):
                                pass
            except asyncio.CancelledError:
                if stream is not None:
                    stream.close()
                raise
            # cephlint: disable=error-taxonomy (teardown race: the reconnect loop owns recovery)
            except Exception:
                pass
            self._ready.clear()
            self._stream = None
            if stream is not None:
                stream.close()
            if self._closed or self.policy.lossy:
                if not self._closed:
                    self._closed = True
                    await _call(
                        self.messenger.dispatcher.ms_handle_reset, self
                    )
                return
            await asyncio.sleep(
                backoff_with_jitter(backoff, self.messenger._rng)
            )
            backoff = min(backoff * 2, 1.0)

    async def _client_handshake(self, stream: _InjectingStream) -> None:
        m = self.messenger
        stream.writer.write(BANNER)
        await stream.writer.drain()
        if await stream.reader.readexactly(len(BANNER)) != BANNER:
            raise FrameError("bad banner")
        # the feature word rides as a trailing u64 (and, with
        # FEATURE_LOCAL_STACK, our uds:// listener as a trailing string):
        # pre-feature decoders ignore trailing HELLO bytes, so
        # negotiation is backward-safe
        hello = (
            Encoder()
            .string(m.name)
            .u64(m.instance_nonce)
            .u64(m.local_features)
            .string(m.my_local_addr or "")
            .bytes()
        )
        await stream.send(Frame(Tag.HELLO, hello), None)
        reply = await stream.recv(None)
        if reply.tag != Tag.HELLO:
            raise FrameError(f"expected HELLO, got {reply.tag}")
        d = Decoder(reply.payload)
        self.peer_name = d.string()
        self.peer_nonce = d.u64()
        # the session feature set is the INTERSECTION of both HELLOs
        # (the msgr2 feature-word rule): a frame shape is legal only
        # when both ends opted in
        self.peer_features = (
            d.u64() if d.remaining() >= 8 else 0
        ) & m.local_features
        self.peer_local_addr = d.string() if d.remaining() >= 4 else ""
        if m.keyring is None:
            return
        service = self.peer_name.split(".", 1)[0]
        ticket = m.tickets.get(service)
        if ticket is not None:
            await self._client_ticket_auth(stream, ticket)
            return
        secret = m.keyring.get(m.name)
        if secret is None:
            raise FrameError(f"no key for {m.name} in local keyring")
        nonce_c = os.urandom(16)
        await stream.send(
            Frame(
                Tag.AUTH_REQUEST,
                Encoder().string(m.name).blob(nonce_c).bytes(),
            ),
            None,
        )
        chal = await stream.recv(None)
        if chal.tag == Tag.RESET:
            raise FrameError("auth refused")
        if chal.tag != Tag.AUTH_CHALLENGE:
            raise FrameError(f"expected AUTH_CHALLENGE, got {chal.tag}")
        nonce_s = Decoder(chal.payload).blob()
        proof = hmac_mod.new(
            secret, b"cli" + nonce_c + nonce_s, hashlib.sha256
        ).digest()
        await stream.send(Frame(Tag.AUTH_PROOF, proof), None)
        done = await stream.recv(None)
        if done.tag != Tag.AUTH_DONE:
            raise FrameError("auth refused")
        # mutual auth (cephx is mutual): the server must prove knowledge
        # of the shared secret too, or a spoofed daemon address could
        # complete the handshake and read every payload we send. The two
        # proofs are domain-separated ("cli"/"srv") so a fake server that
        # sets nonce_s == nonce_c cannot reflect ours back at us.
        server_proof = hmac_mod.new(
            secret, b"srv" + nonce_s + nonce_c, hashlib.sha256
        ).digest()
        if not hmac_mod.compare_digest(done.payload, server_proof):
            raise FrameError("server failed mutual auth proof")
        self.session_key = _session_key(secret, nonce_c, nonce_s)

    async def _client_ticket_auth(
        self, stream: _InjectingStream, ticket: tuple[bytes, bytes]
    ) -> None:
        """cephx ticket presentation: prove possession of the ticket's
        session key (the CephXAuthorizer role); the server never needs
        our entity key, only its rotating service keys."""
        blob, skey = ticket
        nonce_c = os.urandom(16)
        await stream.send(
            Frame(
                Tag.AUTH_TICKET,
                Encoder().blob(blob).blob(nonce_c).bytes(),
            ),
            None,
        )
        chal = await stream.recv(None)
        if chal.tag == Tag.RESET:
            raise FrameError("ticket refused")
        if chal.tag != Tag.AUTH_CHALLENGE:
            raise FrameError(f"expected AUTH_CHALLENGE, got {chal.tag}")
        nonce_s = Decoder(chal.payload).blob()
        proof = hmac_mod.new(
            skey, b"cli" + nonce_c + nonce_s, hashlib.sha256
        ).digest()
        await stream.send(Frame(Tag.AUTH_PROOF, proof), None)
        done = await stream.recv(None)
        if done.tag != Tag.AUTH_DONE:
            raise FrameError("ticket auth refused")
        server_proof = hmac_mod.new(
            skey, b"srv" + nonce_s + nonce_c, hashlib.sha256
        ).digest()
        if not hmac_mod.compare_digest(done.payload, server_proof):
            raise FrameError("server failed mutual ticket proof")
        self.session_key = _session_key(skey, nonce_c, nonce_s)

    # -- shared loops ---------------------------------------------------------

    def _note_ack_owed(self, seq: int) -> None:
        """Record a received seq; piggyback it on the next outgoing
        message, or flush a standalone ACK after a short idle delay.
        A hard cap of 8 owed messages bounds the peer's resend window
        even under replay storms (the window must shrink a little per
        reconnect attempt or injected-failure runs never converge)."""
        if seq <= self._ack_owed:
            return
        self._ack_owed = seq
        if seq - self._ack_sent >= 8:
            if self._ack_timer is not None:
                self._ack_timer.cancel()
                self._ack_timer = None
            self._flush_ack()
        elif self._ack_timer is None:
            self._ack_timer = asyncio.get_event_loop().call_later(
                0.01, self._flush_ack
            )

    def _flush_ack(self) -> None:
        self._ack_timer = None
        if self._ack_owed > self._ack_sent and not self._closed:
            self._ack_sent = self._ack_owed
            self._send_q.put_nowait(
                ("frame",
                 Frame(Tag.ACK, Encoder().u64(self._ack_owed).bytes()))
            )

    def _apply_peer_ack(self, acked: int) -> None:
        # in place: accepted connections share this list with the
        # messenger's per-peer-instance window (_peer_unacked)
        self._unacked[:] = [
            mm for mm in self._unacked if mm.seq > acked
        ]

    def _encode_msg_frame(self, msg: Message, corked: int = 1) -> Frame:
        """MESSAGE / MESSAGE_SEG frame, compressed above the configured
        floor (the msgr2 compression mode via the compressor registry).

        A lazy `msg.payload` is serialized HERE, per connection: binary
        denc-lite on sessions that negotiated FEATURE_BIN_ENVELOPE (and
        whose config asks for it), JSON otherwise — so the same queued
        Message replays correctly to either kind of peer. On the binary
        path the bulk `raw` bytes ride as their own frame segment
        (MESSAGE_SEG) and never pass through an encoder or a join."""
        m = self.messenger
        sp = getattr(msg, "_send_span", None)
        if sp is not None:
            if corked > 1:
                sp.set_tag("corked", corked)
            sp.set_tag("stack", self.stack)
            sp.finish()
            msg._send_span = None  # lossless replays re-encode; once only
        if not self.policy.lossy and self._ack_owed > self._ack_sent:
            msg.ack = self._ack_owed
            self._ack_sent = self._ack_owed
        m.perf.inc("msgs_out")
        use_bin = m._env_binary and (
            self.peer_features & FEATURE_BIN_ENVELOPE
        )
        if msg.payload is not None:
            if use_bin:
                msg.flags |= FLAG_BIN_DATA
                msg.data = encode_payload(msg.payload)
                m.perf.inc("env_binary")
            else:
                msg.flags &= ~FLAG_BIN_DATA
                msg.data = json.dumps(msg.payload).encode()
                m.perf.inc("env_json")
        algo = m._compress_algo
        if algo is None and use_bin:
            return message_seg_frame(msg)
        payload = msg.encode()
        if algo is not None and len(payload) >= m._compress_floor:
            try:
                from ceph_tpu_torch.common.compressor import factory

                # one ratio policy for wire AND store paths
                did, packed = factory(algo).maybe_compress(payload)
            # cephlint: disable=error-taxonomy (unknown/unavailable codec: ship the payload raw)
            except Exception:
                did = False  # unknown/unavailable codec: ship raw
            if did:
                m.compressed_frames += 1
                return Frame(
                    Tag.MESSAGE_COMPRESSED,
                    Encoder().string(algo).blob(packed).bytes(),
                )
        return Frame(Tag.MESSAGE, payload)

    async def _write_loop(self, stream: _InjectingStream) -> None:
        m = self.messenger
        q = self._send_q
        while True:
            items = [await q.get()]
            # cork: drain whatever else is already queued (bounded) and
            # ship the whole run as one write — with FRAME_BATCH, as one
            # OUTER frame whose single crc+HMAC covers every frame in it
            limit = m._cork_max
            # byte-capped on ring streams: a run that fits one shm record
            # is loaned to the receiver zero-copy, while an oversize run
            # would bounce through the chunked-reassembly path
            cap = getattr(stream, "max_run_bytes", None)
            run_bytes = _est_size(items[0])
            while len(items) < limit and (
                cap is None or run_bytes < cap
            ):
                try:
                    it = q.get_nowait()
                except asyncio.QueueEmpty:
                    break
                items.append(it)
                run_bytes += _est_size(it)
            n = len(items)
            frames = [
                self._encode_msg_frame(it, corked=n)
                if kind == "msg"
                else it
                for kind, it in items
            ]
            if n > 1 and (self.peer_features & FEATURE_FRAME_BATCH):
                m.perf.inc("batch_frames")
                m.perf.inc("batch_inner", n)
                frames = [make_batch_frame(frames)]
            await stream.send_frames(
                frames, self.session_key, coalesced=n
            )

    async def _read_loop(self, stream: _InjectingStream) -> None:
        while True:
            frame = await stream.recv(self.session_key)
            if frame.tag == Tag.BATCH:
                for inner in iter_batch(frame.payload):
                    await self._process_frame(inner, batched=True)
            else:
                await self._process_frame(frame)

    async def _process_frame(
        self, frame: Frame, batched: bool = False
    ) -> None:
        m = self.messenger
        if frame.tag == Tag.MESSAGE_COMPRESSED:
            from ceph_tpu_torch.common.compressor import factory

            d = Decoder(frame.payload)
            algo = d.string()
            frame = Frame(
                Tag.MESSAGE, factory(algo).decompress(d.blob())
            )
        if frame.tag in (Tag.MESSAGE, Tag.MESSAGE_SEG):
            if frame.tag is Tag.MESSAGE_SEG:
                msg = decode_message_seg(frame.payload)
            else:
                msg = Message.decode(frame.payload)
            if not self.policy.lossy:
                # coalesced ack-on-receipt: note what we owe and let
                # the next outgoing message piggyback it (a timer
                # covers idle connections); acks are cumulative so
                # one frame covers any number of messages
                self._note_ack_owed(msg.seq)
                if msg.ack:
                    self._apply_peer_ack(msg.ack)
                # dedup state is per (peer instance, session
                # direction): the session we dialed and the one the
                # peer dialed carry independent seq streams, and a
                # restarted peer (new nonce) starts fresh
                key = (self.peer_name, self.peer_nonce, self.outgoing)
                last = m._peer_in_seq.get(key, 0)
                if msg.seq <= last:
                    # duplicate from a resend window: the peer is
                    # replaying because it never saw our ack (the
                    # frame carrying it died with a connection) —
                    # re-ack IMMEDIATELY or its window never drains
                    self._ack_sent = 0
                    if self._ack_timer is not None:
                        self._ack_timer.cancel()
                        self._ack_timer = None
                    self._flush_ack()
                    return
                m._peer_in_seq[key] = msg.seq
            if len(msg.raw) and not isinstance(msg.raw, bytes):
                s = self._stream
                if s is not None and getattr(s, "loans_buffers", False):
                    # a ring payload is a loan that dies at the next
                    # recv(), and dispatch handlers enqueue raw past this
                    # frame's lifetime — materialize the one user-space
                    # copy here (the kernel copies are already gone)
                    msg.raw = bytes(msg.raw)
            size = max(1, len(msg.data))
            # receive-side messenger span: throttle wait + handler
            # (fast-dispatch leg); only traced messages pay anything
            dsp = None
            if m.tracer is not None and msg.trace:
                tags = {"type": msg.type, "at": m.name, "stack": self.stack}
                if batched:
                    tags["batched"] = True
                dsp = m.tracer.join(msg.trace, "msg_dispatch", tags=tags)
            await m.dispatch_throttle.get(size)
            try:
                await _call(m.dispatcher.ms_dispatch, self, msg)
            finally:
                await m.dispatch_throttle.put(size)
                if dsp is not None:
                    dsp.finish()
                _notify_dispatch()
        elif frame.tag == Tag.ACK:
            self._apply_peer_ack(Decoder(frame.payload).u64())
        elif frame.tag == Tag.KEEPALIVE:
            pass
        elif frame.tag == Tag.RESET:
            raise ConnectionResetError("peer reset")
        else:
            raise FrameError(f"unexpected tag {frame.tag}")


def _session_key(secret: bytes, nonce_c: bytes, nonce_s: bytes) -> bytes:
    return hmac_mod.new(
        secret, b"session" + nonce_c + nonce_s, hashlib.sha256
    ).digest()


class Messenger:
    """One endpoint: a name, an optional listening address, connections."""

    def __init__(
        self,
        name: str,
        config=None,
        keyring: dict[str, bytes] | None = None,
        dispatch_throttle_bytes: int = 0,
        seed: int | None = None,
    ):
        from ceph_tpu_torch.common.config import Config

        self.name = name
        self.config = config if config is not None else Config()
        self.keyring = keyring
        #: optional distributed tracer (common/tracer): when set, traced
        #: messages get msg_send/msg_dispatch spans; untraced messages
        #: cost one `msg.trace` truthiness check per hop
        self.tracer = None
        self.dispatcher: Dispatcher = Dispatcher()
        self.dispatch_throttle = AsyncThrottle(dispatch_throttle_bytes)
        self._server: asyncio.base_events.Server | None = None
        self.my_addr: tuple[str, int] | None = None
        #: pluggable transports (NetworkStack registry): a per-messenger
        #: copy so tests/backends can swap one endpoint's stack
        self.stacks = dict(STACKS)
        #: scheme-tagged local listener ("uds://<path>") once bind() has
        #: a UDS endpoint up; advertised in HELLO and cluster maps
        self.my_local_addr: str | None = None
        self._uds_server = None
        self._uds_path: str | None = None
        self._conns: dict[tuple[str, int], Connection] = {}
        self._accepted: set[Connection] = set()
        #: (peer_name, peer_nonce, session_outgoing) -> highest seq (dedup)
        self._peer_in_seq: dict[tuple, int] = {}
        #: (peer_name, peer_nonce) -> last seq sent on our accepted side
        self._peer_out_seq: dict[tuple, int] = {}
        #: (peer_name, peer_nonce) -> un-acked server->client messages,
        #: shared across accepted-connection instances (replayed on accept)
        self._peer_unacked: dict[tuple, list] = {}
        #: live accept-handler tasks (cancelled on shutdown; wait_closed
        #: blocks on handlers, so they must not outlive us)
        self._handler_tasks: set = set()
        self._rng = random.Random(seed)
        #: instance identity (entity_addr_t::nonce): a restarted daemon
        #: reusing its name/address presents a fresh nonce, so peers reset
        #: per-session seq state instead of treating the new process's
        #: low seqs as duplicates of the dead one's
        self.instance_nonce = int.from_bytes(os.urandom(8), "little")
        self.injected_failures = 0
        #: chaos-schedule faults applied (drops + delays + dups); the
        #: per-kind split rides the perf counters below
        self.chaos_injected = 0
        #: total frame bytes written (the wire-inflation diagnostic)
        self.bytes_sent = 0
        #: MESSAGE frames that went out compressed (ms_compress_mode)
        self.compressed_frames = 0
        #: feature bits advertised at HELLO; a test can zero this to
        #: simulate a pre-feature ("old-format") peer end to end
        self.local_features = LOCAL_FEATURES
        # wire fast-path counters, adopted into the owning daemon's
        # `perf dump` collection (-> the Prometheus exporter)
        from ceph_tpu_torch.common.perf_counters import PerfCounters

        self.perf = PerfCounters(f"msgr.{name}")
        for key, desc in (
            ("msgs_out", "messages queued onto the wire"),
            ("frames_out", "wire frames written (a BATCH counts once)"),
            ("corked_runs", "write wakeups that coalesced >1 frame"),
            ("corked_msgs", "frames that shared a corked run"),
            ("bytes_coalesced", "bytes written in multi-frame runs"),
            ("batch_frames", "corked runs shipped as one BATCH frame"),
            ("batch_inner", "frames wrapped inside BATCH envelopes"),
            ("env_binary", "op payloads encoded as denc-lite values"),
            ("env_json", "op payloads encoded as JSON (fallback)"),
            ("bytes_zero_copy",
             "frame bytes received via the shm ring (no kernel copy)"),
            ("chaos_drop",
             "frame runs severed by the ms_inject_chaos schedule "
             "(drops + partitions)"),
            ("chaos_delay", "frame runs stalled by the chaos schedule"),
            ("chaos_dup", "frame runs duplicated by the chaos schedule"),
        ):
            self.perf.add_u64_counter(key, desc)
        self.perf.add_histogram(
            "corked_run_len", "frames per write wakeup (power-of-two)"
        )
        # hot-path knobs are read per frame: cache them and track runtime
        # changes via config observers instead of paying the env-aware
        # Config.get on every message
        self._cork_max = max(1, int(self.config.get("ms_cork_max_frames")))
        self._env_binary = (
            self.config.get("ms_envelope_format") == "binary"
        )
        algo = self.config.get("ms_compress_mode")
        self._compress_algo = algo if algo and algo != "none" else None
        self._compress_floor = int(
            self.config.get("ms_compress_min_size")
        )
        self._inject_delay = float(
            self.config.get("ms_inject_internal_delays") or 0
        )
        self._inject_delay_prob = float(
            self.config.get("ms_inject_delay_probability") or 0
        )
        self._inject_delay_max = float(
            self.config.get("ms_inject_delay_max") or 0
        )
        self._inject_every = int(
            self.config.get("ms_inject_socket_failures") or 0
        )
        #: compiled chaos schedule (common/faults.WireFaults) or None —
        #: the armed/disarmed switch the send path checks per corked run
        self._chaos = self._build_chaos()
        self._local_stack = bool(self.config.get("ms_local_stack"))
        self._shm_ring_bytes = int(
            self.config.get("ms_shm_ring_bytes") or 0
        )
        if not self._local_stack:
            # drop the feature bit so peers never expect SHM_SETUP from
            # us and we never dial uds endpoints — bit-identical to the
            # pre-stack wire behavior
            self.local_features &= ~FEATURE_LOCAL_STACK
        self.config.observe("ms_local_stack", self._note_knobs)
        self.config.observe("ms_inject_chaos_schedule", self._note_knobs)
        self.config.observe("ms_inject_chaos_seed", self._note_knobs)
        self.config.observe("ms_shm_ring_bytes", self._note_knobs)
        self.config.observe("ms_cork_max_frames", self._note_knobs)
        self.config.observe("ms_envelope_format", self._note_knobs)
        self.config.observe("ms_compress_mode", self._note_knobs)
        self.config.observe("ms_compress_min_size", self._note_knobs)
        self.config.observe("ms_inject_internal_delays", self._note_knobs)
        self.config.observe("ms_inject_delay_probability",
                            self._note_knobs)
        self.config.observe("ms_inject_delay_max", self._note_knobs)
        self.config.observe("ms_inject_socket_failures", self._note_knobs)
        #: cephx client state: service ("osd"/"mds") -> (ticket blob,
        #: session key) obtained from the mon's auth service; when a
        #: ticket exists for a peer's service the handshake presents it
        #: instead of expecting the peer to know our entity key
        self.tickets: dict[str, tuple[bytes, bytes]] = {}
        #: cephx service state: rotating key window (epoch -> secret)
        #: fetched from the mon; enables ticket-based acceptance
        self.service_keys: dict[int, bytes] = {}
        #: async callback to refresh service_keys when a ticket arrives
        #: under an epoch we don't hold (rotation raced our timer)
        self.on_service_keys_stale = None

    def _note_knobs(self, _name=None, _value=None) -> None:
        """Config observer: refresh the cached wire knobs on runtime
        `set`/injectargs (env-only changes land at construction time)."""
        self._cork_max = max(1, int(self.config.get("ms_cork_max_frames")))
        self._env_binary = (
            self.config.get("ms_envelope_format") == "binary"
        )
        algo = self.config.get("ms_compress_mode")
        self._compress_algo = algo if algo and algo != "none" else None
        self._compress_floor = int(
            self.config.get("ms_compress_min_size")
        )
        self._inject_delay = float(
            self.config.get("ms_inject_internal_delays") or 0
        )
        self._inject_delay_prob = float(
            self.config.get("ms_inject_delay_probability") or 0
        )
        self._inject_delay_max = float(
            self.config.get("ms_inject_delay_max") or 0
        )
        self._inject_every = int(
            self.config.get("ms_inject_socket_failures") or 0
        )
        self._chaos = self._build_chaos()
        self._local_stack = bool(self.config.get("ms_local_stack"))
        self._shm_ring_bytes = int(
            self.config.get("ms_shm_ring_bytes") or 0
        )
        if not self._local_stack:
            self.local_features &= ~FEATURE_LOCAL_STACK

    def _build_chaos(self):
        """Compile ms_inject_chaos_schedule into a WireFaults engine, or
        None when the schedule is empty (the disarmed fast path). A bad
        schedule disarms loudly rather than silently injecting nothing."""
        text = self.config.get("ms_inject_chaos_schedule") or ""
        if not text.strip():
            return None
        from ceph_tpu_torch.common.faults import WireFaults

        try:
            return WireFaults(
                text, int(self.config.get("ms_inject_chaos_seed") or 0)
            )
        except ValueError as e:
            raise ValueError(f"ms_inject_chaos_schedule: {e}") from e

    def _ring_bytes_effective(self) -> int:
        """ms_shm_ring_bytes clamped to a workable window; 0 disables the
        ring (the session stays on the plain UDS socket)."""
        rb = self._shm_ring_bytes
        if rb < (1 << 14):
            return 0
        return min(rb, 1 << 30)

    def _uds_dir_path(self) -> str:
        """Directory for our UDS sockets and ring files (ms_uds_dir, or a
        per-process tmp dir). AF_UNIX paths are ~108 bytes max, so keep
        this shallow."""
        d = self.config.get("ms_uds_dir") or ""
        if not d:
            d = os.path.join(
                tempfile.gettempdir(), f"ceph-tpu-{os.getpid()}"
            )
        os.makedirs(d, exist_ok=True)
        return d

    # -- lifecycle ------------------------------------------------------------

    async def bind(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        local_path: str | None = None,
    ) -> None:
        self._server, self.my_addr = await self.stacks["tcp"].listen(
            (host, port), self._accept
        )
        if not self._local_stack:
            return
        # every daemon also listens on a Unix socket so co-located peers
        # can skip the TCP loopback; failure here is never fatal — the
        # daemon just stays TCP-only and peers fall back
        path = local_path or os.path.join(
            self._uds_dir_path(),
            f"{self.name}.{self.instance_nonce:016x}.sock",
        )
        if len(path.encode()) >= 100:
            return  # AF_UNIX sun_path limit (108); stay TCP-only
        try:
            if local_path is not None and os.path.exists(path):
                os.unlink(path)  # stale socket from a previous instance
            self._uds_server, _ = await self.stacks["uds"].listen(
                path, self._accept_local
            )
        except (OSError, NotImplementedError):
            return
        self._uds_path = path
        self.my_local_addr = format_endpoint("uds", path)

    async def shutdown(self) -> None:
        # stop accepting FIRST: peers reconnect aggressively (heartbeats,
        # resend loops) and a session accepted after we close existing
        # conns would keep wait_closed() blocked forever
        if self._server is not None:
            self._server.close()
        if self._uds_server is not None:
            self._uds_server.close()
        for t in list(self._handler_tasks):
            t.cancel()
        for t in list(self._handler_tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        self._handler_tasks.clear()
        for conn in list(self._conns.values()) + list(self._accepted):
            await conn.close()
        self._conns.clear()
        self._accepted.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        if self._uds_server is not None:
            await self._uds_server.wait_closed()
            self._uds_server = None
        if self._uds_path is not None:
            with contextlib.suppress(OSError):
                os.unlink(self._uds_path)
            self._uds_path = None
            self.my_local_addr = None

    # -- client side ----------------------------------------------------------

    def connect(
        self,
        addr: tuple[str, int],
        policy: Policy | None = None,
        local_addr: str | None = None,
    ) -> Connection:
        """Get (or lazily create) the connection to addr
        (Messenger::connect_to / get_connection). `local_addr` is an
        optional scheme-tagged local endpoint (uds://...) the peer
        advertised; the dial path tries it first and falls back to TCP."""
        addr = tuple(addr)
        conn = self._conns.get(addr)
        if conn is not None and not conn._closed:
            if local_addr and conn.local_hint is None:
                conn.local_hint = local_addr
            return conn
        conn = Connection(
            self, addr, policy or Policy.lossless_client(), outgoing=True
        )
        conn.local_hint = local_addr
        self._conns[addr] = conn
        conn._start_outgoing()
        return conn

    async def wait_connected(self, conn: Connection, timeout: float = 5.0):
        await asyncio.wait_for(conn._ready.wait(), timeout)

    # -- server side ----------------------------------------------------------

    async def _accept_local(self, reader, writer) -> None:
        await self._accept(reader, writer, local=True)

    async def _accept(self, reader, writer, local: bool = False) -> None:
        stream = _InjectingStream(reader, writer, self)
        conn = Connection(
            self, None, Policy.stateful_server(), outgoing=False
        )
        task = asyncio.current_task()
        if task is not None:
            self._handler_tasks.add(task)
            task.add_done_callback(self._handler_tasks.discard)
        try:
            if await reader.readexactly(len(BANNER)) != BANNER:
                raise FrameError("bad banner")
            writer.write(BANNER)
            await writer.drain()
            hello = await stream.recv(None)
            if hello.tag != Tag.HELLO:
                raise FrameError("expected HELLO")
            hd = Decoder(hello.payload)
            conn.peer_name = hd.string()
            conn.peer_nonce = hd.u64()
            conn.peer_features = (
                hd.u64() if hd.remaining() >= 8 else 0
            ) & self.local_features
            conn.peer_local_addr = (
                hd.string() if hd.remaining() >= 4 else ""
            )
            if local:
                # a UDS peername is an empty/raw socket path — useless in
                # dump_tracing and unstable across reconnects; key the
                # session by the peer's advertised identity instead
                conn.stack = "uds"
                conn.peer_addr = ("local", conn.peer_name)
            else:
                conn.peer_addr = writer.get_extra_info("peername")[:2]
            conn.out_seq = self._peer_out_seq.get(
                (conn.peer_name, conn.peer_nonce), 0
            )
            await stream.send(
                Frame(
                    Tag.HELLO,
                    Encoder()
                    .string(self.name)
                    .u64(self.instance_nonce)
                    .u64(self.local_features)
                    .string(self.my_local_addr or "")
                    .bytes(),
                ),
                None,
            )
            if self.keyring is not None:
                if not await self._server_auth(stream, conn):
                    writer.close()
                    return
            if local and (conn.peer_features & FEATURE_LOCAL_STACK):
                stream = await self._accept_local_upgrade(stream, conn)
            # adopt the peer instance's surviving un-acked window: the
            # previous accepted Connection died with the old socket, but
            # lossless server->client messages awaiting ACKs must replay
            # on this new session or they are silently lost
            ukey = (conn.peer_name, conn.peer_nonce)
            conn._unacked = self._peer_unacked.setdefault(ukey, [])
            # arm the chaos schedule now that the peer is identified
            # (replies we send on this accepted session are this
            # messenger's own src->dst fault stream)
            stream.chaos_peer = conn.peer_name
            conn._stream = stream
            conn._ready.set()
            self._accepted.add(conn)
            await _call(self.dispatcher.ms_handle_accept, conn)

            async def replay_then_write():
                # ordered replay before any newly queued frame; ACKs are
                # processed concurrently by the read loop below
                for m in list(conn._unacked):
                    if m not in conn._unacked:
                        continue  # acked while replaying
                    await stream.send(
                        conn._encode_msg_frame(m), conn.session_key
                    )
                await conn._write_loop(stream)

            writer_task = asyncio.create_task(replay_then_write())
            conn._tasks.append(writer_task)
            try:
                await conn._read_loop(stream)
            finally:
                writer_task.cancel()
                try:
                    await writer_task
                except (asyncio.CancelledError, Exception):
                    pass
        except asyncio.CancelledError:
            raise
        # cephlint: disable=error-taxonomy (server-side close: the client's reconnect loop recovers)
        except Exception:
            pass
        finally:
            conn._ready.clear()
            conn._stream = None
            self._accepted.discard(conn)
            stream.close()
            if not conn._closed:
                await _call(self.dispatcher.ms_handle_reset, conn)

    async def _accept_local_upgrade(
        self, stream: InjectingStream, conn: Connection
    ) -> InjectingStream:
        """Server leg of the shm ring negotiation (see
        Connection._maybe_upgrade_local). The client always sends
        SHM_SETUP on a UDS+feature session; ring_bytes=0 (or a failed
        attach here) keeps frames on the socket — never an error."""
        setup = await stream.recv(conn.session_key)
        if setup.tag != Tag.SHM_SETUP:
            raise FrameError(f"expected SHM_SETUP, got {setup.tag}")
        d = Decoder(setup.payload)
        p_c2s = d.string()
        p_s2c = d.string()
        ring_bytes = d.u64()
        tx = rx = None
        ok = 0
        if ring_bytes and p_c2s and p_s2c:
            try:
                rx = ShmRing.attach(p_c2s)
                tx = ShmRing.attach(p_s2c)
                ok = 1
            except (OSError, ValueError):
                if rx is not None:
                    rx.close()
                tx = rx = None
        if ok:
            # both sides are mapped: unlink now so the memory is anchored
            # only by the two maps and kill -9 leaves no /tmp litter
            for p in (p_c2s, p_s2c):
                with contextlib.suppress(OSError):
                    os.unlink(p)
        await stream.send(
            Frame(Tag.SHM_ACK, Encoder().u8(ok).bytes()),
            conn.session_key,
        )
        if ok:
            conn.stack = "shm"
            return ShmStream(
                stream.reader, stream.writer, self, tx=tx, rx=rx
            )
        return stream

    async def _server_auth(
        self, stream: _InjectingStream, conn: Connection
    ) -> bool:
        req = await stream.recv(None)
        if req.tag == Tag.AUTH_TICKET and self.service_keys:
            return await self._server_ticket_auth(stream, conn, req)
        if req.tag != Tag.AUTH_REQUEST:
            await stream.send(Frame(Tag.RESET, b""), None)
            return False
        d = Decoder(req.payload)
        claimed = d.string()
        nonce_c = d.blob()
        secret = self.keyring.get(claimed)
        if secret is None or claimed != conn.peer_name:
            await stream.send(Frame(Tag.RESET, b""), None)
            return False
        nonce_s = os.urandom(16)
        await stream.send(
            Frame(Tag.AUTH_CHALLENGE, Encoder().blob(nonce_s).bytes()), None
        )
        proof = await stream.recv(None)
        want = hmac_mod.new(
            secret, b"cli" + nonce_c + nonce_s, hashlib.sha256
        ).digest()
        if proof.tag != Tag.AUTH_PROOF or not hmac_mod.compare_digest(
            proof.payload, want
        ):
            await stream.send(Frame(Tag.RESET, b""), None)
            return False
        server_proof = hmac_mod.new(
            secret, b"srv" + nonce_s + nonce_c, hashlib.sha256
        ).digest()
        await stream.send(Frame(Tag.AUTH_DONE, server_proof), None)
        conn.session_key = _session_key(secret, nonce_c, nonce_s)
        return True

    async def _server_ticket_auth(
        self, stream: _InjectingStream, conn: Connection, req
    ) -> bool:
        """Verify a cephx ticket against our rotating service keys
        (CephxServiceHandler::verify_authorizer): the ticket's sealed
        entity must be who the peer claimed at HELLO, and the peer must
        prove the sealed session key."""
        import time as _time

        from ceph_tpu_torch.auth.cephx import open_ticket

        d = Decoder(req.payload)
        blob = d.blob()
        nonce_c = d.blob()
        got = open_ticket(self.service_keys, blob, _time.time())
        if got is None and self.on_service_keys_stale is not None:
            # a just-rotated epoch we haven't fetched yet: refresh the
            # window NOW instead of bouncing clients until the timer
            try:
                await self.on_service_keys_stale()
            # cephlint: disable=error-taxonomy (stale-key refresh is advisory; open_ticket below decides)
            except Exception:
                pass
            got = open_ticket(self.service_keys, blob, _time.time())
        if got is None or got[0] != conn.peer_name:
            await stream.send(Frame(Tag.RESET, b""), None)
            return False
        _entity, skey = got
        nonce_s = os.urandom(16)
        await stream.send(
            Frame(Tag.AUTH_CHALLENGE, Encoder().blob(nonce_s).bytes()),
            None,
        )
        proof = await stream.recv(None)
        want = hmac_mod.new(
            skey, b"cli" + nonce_c + nonce_s, hashlib.sha256
        ).digest()
        if proof.tag != Tag.AUTH_PROOF or not hmac_mod.compare_digest(
            proof.payload, want
        ):
            await stream.send(Frame(Tag.RESET, b""), None)
            return False
        server_proof = hmac_mod.new(
            skey, b"srv" + nonce_s + nonce_c, hashlib.sha256
        ).digest()
        await stream.send(Frame(Tag.AUTH_DONE, server_proof), None)
        conn.session_key = _session_key(skey, nonce_c, nonce_s)
        return True
