"""Pluggable network stacks — the transport seam under the Messenger.

The reference messenger is built over swappable NetworkStacks
(src/msg/async/Stack.h: PosixNetworkStack, RDMAStack, DPDKStack — picked
by `ms_async_transport_type`); the Messenger code above the seam only
sees connect/listen/read/write. Same split here:

  * `NetworkStack`   — connect/listen over some byte transport;
  * `PosixStack`     — the asyncio TCP path every daemon binds by default;
  * `LocalStack`     — Unix-domain sockets for co-located peers. After
    the handshake a UDS session can be upgraded further onto a pair of
    shared-memory rings (ceph_tpu/msg/shm.py) so frame payloads skip the
    kernel entirely — the UDS socket stays around as the doorbell and
    liveness channel.

Addresses are scheme-tagged strings (`tcp://host:port`,
`uds:///run/x.sock`); bare `(host, port)` tuples keep meaning TCP so
every existing map/config shape parses unchanged.

`InjectingStream` (the per-connection frame pump with the ms_inject_*
fault hooks) lives here too: it is a byte-stream concern, and the
shared-memory ShmStream subclasses it so fault injection and perf
accounting behave identically on every stack.
"""

from __future__ import annotations

import asyncio
import socket as socket_mod

from ceph_tpu_torch.lint import racecheck
from ceph_tpu_torch.msg.frames import Frame, read_frame


class NetworkStack:
    """One byte transport: dial and listen. Implementations return plain
    asyncio (reader, writer) pairs — everything above (framing, auth,
    resend) is stack-agnostic."""

    scheme = "?"

    async def connect(self, addr):
        raise NotImplementedError

    async def listen(self, addr, accept_cb):
        """Bind a server; returns (server, bound_addr)."""
        raise NotImplementedError


class PosixStack(NetworkStack):
    """The default asyncio TCP stack (PosixNetworkStack role)."""

    scheme = "tcp"

    async def connect(self, addr):
        host, port = addr
        return await asyncio.open_connection(host, port)

    async def listen(self, addr, accept_cb):
        host, port = addr
        server = await asyncio.start_server(accept_cb, host, port)
        bound = server.sockets[0].getsockname()[:2]
        return server, (bound[0], bound[1])


class LocalStack(NetworkStack):
    """Unix-domain sockets for same-host peers; the address is a
    filesystem path. The shm ring upgrade rides on top of a session
    dialed through this stack (Messenger negotiates it per connection)."""

    scheme = "uds"

    async def connect(self, addr):
        return await asyncio.open_unix_connection(addr)

    async def listen(self, addr, accept_cb):
        server = await asyncio.start_unix_server(accept_cb, addr)
        return server, addr


#: default stack registry; a Messenger copies this so a test (or a future
#: RDMA-style backend) can swap one endpoint's transport in isolation
STACKS: dict[str, NetworkStack] = {
    "tcp": PosixStack(),
    "uds": LocalStack(),
}


def parse_endpoint(ep):
    """`('tcp', (host, port))` or `('uds', path)` from a bare tuple or a
    scheme-tagged string. Tuples stay TCP so every pre-stack map shape
    (mon maps, osd_addrs) parses unchanged."""
    if isinstance(ep, (tuple, list)) and len(ep) == 2:
        return "tcp", (ep[0], int(ep[1]))
    if isinstance(ep, str):
        if ep.startswith("uds://"):
            return "uds", ep[len("uds://"):]
        if ep.startswith("tcp://"):
            host, _, port = ep[len("tcp://"):].rpartition(":")
            return "tcp", (host, int(port))
    raise ValueError(f"unparseable endpoint {ep!r}")


def format_endpoint(scheme: str, addr) -> str:
    if scheme == "uds":
        return f"uds://{addr}"
    return f"tcp://{addr[0]}:{addr[1]}"


class InjectingStream:
    """Wraps (reader, writer) applying config-driven fault injection to
    every frame I/O — the transport-level ms_inject_* hooks."""

    #: True when recv() hands out payload loans that die at the next
    #: recv() (the shm ring); dispatch must materialize long-lived bytes
    loans_buffers = False

    def __init__(self, reader, writer, messenger):
        self.reader = reader
        self.writer = writer
        self._m = messenger
        #: peer entity name, set by the Connection once the handshake
        #: lands — the chaos schedule (common/faults) keys fault streams
        #: by (our name, peer name), so handshake frames are never
        #: injected and the pre-handshake stream needs no identity
        self.chaos_peer: str | None = None
        # request/response sub-ops die under Nagle + delayed-ACK
        # (~200 ms per round trip); the reference sets TCP_NODELAY on
        # every messenger socket too (AsyncConnection). AF_UNIX sockets
        # reject the option — the OSError guard covers them.
        sock = writer.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(
                    socket_mod.IPPROTO_TCP, socket_mod.TCP_NODELAY, 1
                )
            except OSError:
                pass

    async def _maybe_inject(self, yield_loop: bool = True) -> None:
        # Yield once per written frame: a burst of writes whose drain()
        # completes synchronously (socket buffer has room) would otherwise
        # starve the event loop, so the reader task never sees the ACKs the
        # peer is streaming back and the resend window cannot shrink. The
        # read side skips the yield — readexactly already parks the task
        # whenever the buffer runs dry.
        if yield_loop:
            await asyncio.sleep(0)
        m = self._m
        delay = m._inject_delay
        if delay:
            await asyncio.sleep(delay * m._rng.random())
        prob = m._inject_delay_prob
        if prob and m._rng.random() < prob:
            # the reference's ms_inject_delay_probability/_max pair:
            # each frame independently risks a bounded random stall
            await asyncio.sleep(m._inject_delay_max * m._rng.random())
        every = m._inject_every
        if every and m._rng.randrange(every) == 0:
            m.injected_failures += 1
            self.writer.close()
            raise ConnectionResetError("injected socket failure")

    async def _chaos_action(self) -> str | None:
        """Consult the seeded chaos schedule for this outgoing frame
        run. Disarmed (the overwhelmingly common state) costs one
        attribute check. Delays are served here; a drop/partition
        severs the session exactly like an injected socket failure
        (lossless peers replay on reconnect, lossy peers lose the
        frames — honest TCP semantics); "dup" asks send_frames to
        write the run twice."""
        m = self._m
        ch = m._chaos
        if ch is None:
            return None
        peer = self.chaos_peer
        if not peer:
            return None
        pf = ch.pair(m.name, peer)
        if pf is None:
            return None
        act = pf.next_action()
        if act is None:
            return None
        m.chaos_injected += 1
        m.perf.inc(f"chaos_{act[0]}")
        if act[0] == "delay":
            await asyncio.sleep(act[1])
            return None
        if act[0] == "dup":
            return "dup"
        self.writer.close()
        raise ConnectionResetError(
            f"chaos: {m.name}->{peer} frame dropped"
        )

    async def send(self, frame: Frame, session_key: bytes | None) -> None:
        await self.send_frames([frame], session_key)

    async def send_frames(
        self, frames: list, session_key: bytes | None, coalesced: int = 1
    ) -> None:
        """One socket write + one drain for a whole corked run (the
        AsyncConnection write-event coalescing shape): every frame's
        buffer parts are gathered and joined once, so a run of N frames
        costs one syscall and one flow-control wait instead of N."""
        await self._maybe_inject()
        chaos = await self._chaos_action()
        parts: list = []
        for f in frames:
            parts.extend(f.encode_parts(session_key))
        data = b"".join(parts)
        m = self._m
        m.bytes_sent += len(data)
        perf = m.perf
        perf.inc("frames_out", len(frames))
        perf.hinc("corked_run_len", coalesced)
        if coalesced > 1:
            perf.inc("corked_runs")
            perf.inc("corked_msgs", coalesced)
            perf.inc("bytes_coalesced", len(data))
        self.writer.write(data)
        if chaos == "dup":
            # wire-level duplication: same bytes (same seqs) again —
            # the receiver's per-session dedup must absorb them
            self.writer.write(data)
        racecheck.note_io("msg.send")
        await self.writer.drain()

    async def recv(self, session_key: bytes | None) -> Frame:
        await self._maybe_inject(yield_loop=False)
        return await read_frame(self.reader, session_key)

    def close(self) -> None:
        self.writer.close()
