"""Shared-memory frame transport for co-located peers (LocalStack).

Two mmap'd SPSC rings per connection — one per direction — carry the
exact bytes `Frame.encode_parts` would have written to a socket, so the
wire format (and every parity/signing test) is identical on every stack.
The Unix-domain socket the session was dialed on stays open as the
doorbell + liveness channel: a single `0x00` byte means "re-check your
rings", and a waiting-flag handshake in the ring header keeps steady-state
doorbell traffic near zero (the classic futex-avoidance shape).

Ring layout (offsets in bytes):

    0   u32  magic "SHMR"
    4   u32  version
    8   u64  capacity (data region size)
    16  u64  head — monotonic producer byte counter
    24  u64  tail — monotonic consumer byte counter
    32  u32  producer-waiting flag (producer parked, wants space)
    36  u32  consumer-waiting flag (consumer parked, wants data)
    64  data region, `capacity` bytes

Records are length-prefixed frame slots: `u32 len | frame bytes`,
never wrapping the ring edge (a PAD marker skips the tail of the region
instead). One frame larger than half the ring is streamed as a CHUNKED
header record (u64 total) followed by plain chunk records the consumer
reassembles — so `ms_shm_ring_bytes` bounds memory, not message size.

The consumer side hands `read_frame` a zero-copy memoryview **loan**:
the record's ring bytes stay valid until the next `recv()` commits the
tail past them. Dispatch paths that keep a payload beyond the dispatch
call materialize it once (`Connection._process_frame`); the kernel
copies and per-frame syscalls are gone either way.

Torn reads are theoretically possible across processes on weakly-ordered
CPUs (plain mmap stores, no fences from Python) — the per-frame crc32c
(or HMAC) catches them as a FrameError, which resets the connection and
replays losslessly, the same recovery every other wire fault takes.
"""

from __future__ import annotations

import asyncio
import contextlib
import mmap
import os
import struct as struct_mod

from ceph_tpu_torch.lint import racecheck
from ceph_tpu_torch.msg.frames import Frame, read_frame
from ceph_tpu_torch.msg.stack import InjectingStream

RING_MAGIC = 0x534D4852  # "SHMR"
_HDR = struct_mod.Struct("<IIQ")  # magic, version, capacity
_U32 = struct_mod.Struct("<I")
_U64 = struct_mod.Struct("<Q")

_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_PWAIT = 32
_OFF_CWAIT = 36
DATA_OFF = 64

REC_PAD = 0xFFFFFFFF      # skip to the ring edge (record never wraps)
REC_CHUNKED = 0xFFFFFFFE  # payload: u64 total of the streamed frame

MIN_RING_BYTES = 1 << 14


class ShmRing:
    """One direction's mmap'd SPSC ring. The creator initializes the
    header; the peer attaches and validates it. Either side may be the
    producer — roles are fixed by which ring a ShmStream holds as tx."""

    def __init__(self, mm, capacity: int, path: str):
        self.mm = mm
        self.buf = memoryview(mm)
        self.capacity = capacity
        self.path = path
        #: local read cursor: runs ahead of the shared tail so a returned
        #: record stays loaned (unreclaimed) until release() commits it
        self._cursor = self._load(_OFF_TAIL)

    @classmethod
    def create(cls, path: str, capacity: int) -> "ShmRing":
        if capacity < MIN_RING_BYTES:
            raise ValueError(f"ring too small: {capacity}")
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, DATA_OFF + capacity)
            mm = mmap.mmap(fd, DATA_OFF + capacity)
        finally:
            os.close(fd)
        _HDR.pack_into(mm, 0, RING_MAGIC, 1, capacity)
        return cls(mm, capacity, path)

    @classmethod
    def attach(cls, path: str) -> "ShmRing":
        fd = os.open(path, os.O_RDWR)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, version, capacity = _HDR.unpack_from(mm, 0)
        if (magic != RING_MAGIC or version != 1
                or DATA_OFF + capacity != size
                or capacity < MIN_RING_BYTES):
            mm.close()
            raise OSError(f"not a shm ring: {path}")
        return cls(mm, capacity, path)

    def close(self, unlink: bool = False) -> None:
        with contextlib.suppress(BufferError, ValueError):
            self.buf.release()
            self.mm.close()
        if unlink:
            with contextlib.suppress(OSError):
                os.unlink(self.path)

    # -- header accessors ------------------------------------------------------

    def _load(self, off: int) -> int:
        return _U64.unpack_from(self.buf, off)[0]

    def _store(self, off: int, v: int) -> None:
        _U64.pack_into(self.buf, off, v)

    def producer_waiting(self) -> bool:
        return self.buf[_OFF_PWAIT] != 0

    def set_producer_waiting(self) -> None:
        self.buf[_OFF_PWAIT] = 1

    def clear_producer_waiting(self) -> None:
        self.buf[_OFF_PWAIT] = 0

    def consumer_waiting(self) -> bool:
        return self.buf[_OFF_CWAIT] != 0

    def set_consumer_waiting(self) -> None:
        self.buf[_OFF_CWAIT] = 1

    def clear_consumer_waiting(self) -> None:
        self.buf[_OFF_CWAIT] = 0

    @property
    def max_record(self) -> int:
        """Largest record payload ever written: at this bound an empty
        ring always has room (pad + record fit), so waiting for the
        consumer to drain is always enough to make progress."""
        return self.capacity // 2 - 4

    # -- producer --------------------------------------------------------------

    def try_write(self, data, chunked_header: bool = False) -> bool:
        """Append one record; False when the consumer must free space
        first. `data` must be at most max_record bytes."""
        need = 4 + len(data)
        head = self._load(_OFF_HEAD)
        tail = self._load(_OFF_TAIL)
        free = self.capacity - (head - tail)
        pos = head % self.capacity
        to_end = self.capacity - pos
        if to_end < need:
            if free < to_end + need:
                return False
            if to_end >= 4:
                _U32.pack_into(self.buf, DATA_OFF + pos, REC_PAD)
            head += to_end
            pos = 0
        elif free < need:
            return False
        rec = REC_CHUNKED if chunked_header else len(data)
        _U32.pack_into(self.buf, DATA_OFF + pos, rec)
        self.buf[DATA_OFF + pos + 4: DATA_OFF + pos + 4 + len(data)] = data
        self._store(_OFF_HEAD, head + need)
        return True

    def try_write_parts(self, parts: list, total: int) -> bool:
        """try_write for a pre-counted buffer list, packed sequentially
        into ONE record — the frame send path lands encode_parts output
        straight in the ring instead of joining it first (one copy
        instead of two)."""
        need = 4 + total
        head = self._load(_OFF_HEAD)
        tail = self._load(_OFF_TAIL)
        free = self.capacity - (head - tail)
        pos = head % self.capacity
        to_end = self.capacity - pos
        if to_end < need:
            if free < to_end + need:
                return False
            if to_end >= 4:
                _U32.pack_into(self.buf, DATA_OFF + pos, REC_PAD)
            head += to_end
            pos = 0
        elif free < need:
            return False
        _U32.pack_into(self.buf, DATA_OFF + pos, total)
        off = DATA_OFF + pos + 4
        for p in parts:
            self.buf[off: off + len(p)] = p
            off += len(p)
        self._store(_OFF_HEAD, head + need)
        return True

    # -- consumer --------------------------------------------------------------

    def try_read(self):
        """Next record as (is_chunked_header, memoryview), or None. The
        view is a loan into the ring — valid until release() commits the
        space back to the producer."""
        head = self._load(_OFF_HEAD)
        cur = self._cursor
        while True:
            if head - cur == 0:
                self._cursor = cur
                return None
            pos = cur % self.capacity
            to_end = self.capacity - pos
            if to_end < 4:
                cur += to_end
                continue
            (rec,) = _U32.unpack_from(self.buf, DATA_OFF + pos)
            if rec == REC_PAD:
                cur += to_end
                continue
            chunked = rec == REC_CHUNKED
            n = 8 if chunked else rec
            mv = self.buf[DATA_OFF + pos + 4: DATA_OFF + pos + 4 + n]
            self._cursor = cur + 4 + n
            return chunked, mv

    def release(self) -> None:
        """End the current loan: everything before the read cursor is
        free for the producer to reuse."""
        self._store(_OFF_TAIL, self._cursor)


class _BufReader:
    """The `readexactly` surface read_frame needs, over one in-memory
    record — slices are zero-copy views of the record buffer."""

    def __init__(self, buf):
        self._mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        self._off = 0

    async def readexactly(self, n: int):
        off = self._off
        end = off + n
        if end > len(self._mv):
            raise asyncio.IncompleteReadError(bytes(self._mv[off:]), n)
        self._off = end
        return self._mv[off:end]


class ShmStream(InjectingStream):
    """The InjectingStream interface over a pair of shm rings. Frames are
    byte-identical to what the socket path writes; the underlying UDS
    (reader, writer) pair carries only doorbell bytes and liveness."""

    loans_buffers = True

    def __init__(self, reader, writer, messenger, tx: ShmRing, rx: ShmRing):
        super().__init__(reader, writer, messenger)
        self._tx = tx
        self._rx = rx
        # cork runs that fit one ring record reach the receiver as a single
        # zero-copy loan; the slack absorbs _est_size underestimation
        # (overruns still work — they take the chunked path)
        self.max_run_bytes = max(1, tx.max_record - 65536)
        self._wake = asyncio.Event()
        self._eof = False
        self._loaned = False
        self._pump_task = asyncio.create_task(self._pump())

    async def _pump(self) -> None:
        """Drain doorbell bytes off the UDS socket; every byte (and EOF)
        wakes whichever side is parked on a ring."""
        try:
            while True:
                got = await self.reader.read(256)
                if not got:
                    break
                self._wake.set()
        except (asyncio.CancelledError, Exception):
            pass
        finally:
            self._eof = True
            self._wake.set()

    def close(self) -> None:
        self.writer.close()
        # EOF reaches _pump and wakes any parked reader/writer; ring mmaps
        # are dropped with the stream (the files are already unlinked)

    def _door(self) -> None:
        try:
            self.writer.write(b"\x00")
        except (OSError, RuntimeError):
            pass  # transport already closed; EOF wakes the peer anyway

    def _free_and_signal(self) -> None:
        """Commit consumed rx space and wake the peer if it is parked
        waiting for room to produce."""
        rx = self._rx
        rx.release()
        if rx.producer_waiting():
            rx.clear_producer_waiting()
            self._door()

    # -- send ------------------------------------------------------------------

    async def _write_avail(self, attempt) -> None:
        """Run `attempt` (a ring try_write thunk) until it lands, parking
        on the doorbell while the consumer frees space."""
        tx = self._tx
        while not attempt():
            if self._eof:
                raise ConnectionResetError("shm peer closed")
            self._wake.clear()
            tx.set_producer_waiting()
            if attempt():
                tx.clear_producer_waiting()
                break
            await self._wake.wait()
        if tx.consumer_waiting():
            tx.clear_consumer_waiting()
            self._door()

    async def _write_record(self, data, chunked_header: bool = False) -> None:
        await self._write_avail(
            lambda: self._tx.try_write(data, chunked_header)
        )

    async def _write_frame_bytes(self, data: bytes) -> None:
        limit = self._tx.max_record
        if len(data) <= limit:
            await self._write_record(data)
            return
        # oversize frame: stream it through the ring in bounded chunks
        await self._write_record(_U64.pack(len(data)), chunked_header=True)
        mv = memoryview(data)
        off = 0
        while off < len(data):
            n = min(limit, len(data) - off)
            await self._write_record(mv[off: off + n])
            off += n

    async def send_frames(
        self, frames: list, session_key: bytes | None, coalesced: int = 1
    ) -> None:
        await self._maybe_inject()
        # the chaos schedule judges shm runs too: a co-located pair is
        # still a (src, dst) fault stream (delays stall the producer,
        # drops sever the session, dups re-write the same records —
        # same seqs, absorbed by the receiver's dedup)
        chaos = await self._chaos_action()
        limit = self._tx.max_record
        total = 0
        for pass_no in range(2 if chaos == "dup" else 1):
            for f in frames:
                parts = f.encode_parts(session_key)
                n = sum(len(p) for p in parts)
                if pass_no == 0:
                    total += n
                if n <= limit:
                    await self._write_avail(
                        lambda: self._tx.try_write_parts(parts, n)
                    )
                else:
                    await self._write_frame_bytes(b"".join(parts))
        m = self._m
        m.bytes_sent += total
        perf = m.perf
        perf.inc("frames_out", len(frames))
        perf.hinc("corked_run_len", coalesced)
        if coalesced > 1:
            perf.inc("corked_runs")
            perf.inc("corked_msgs", coalesced)
            perf.inc("bytes_coalesced", total)
        racecheck.note_io("msg.send")
        await self.writer.drain()

    # -- recv ------------------------------------------------------------------

    async def _wait_record(self):
        rx = self._rx
        while True:
            got = rx.try_read()
            if got is not None:
                return got
            if self._eof:
                # the ring is fully drained (try_read above saw nothing
                # published) and the peer is gone: surface the reset
                raise ConnectionResetError("shm peer closed")
            self._wake.clear()
            rx.set_consumer_waiting()
            got = rx.try_read()
            if got is not None:
                rx.clear_consumer_waiting()
                return got
            await self._wake.wait()

    async def _next_frame_buf(self):
        chunked, mv = await self._wait_record()
        if not chunked:
            return mv  # loaned until the next recv()
        (total,) = _U64.unpack(mv)
        self._free_and_signal()
        buf = bytearray(total)
        filled = 0
        while filled < total:
            _ck, mv = await self._wait_record()
            buf[filled: filled + len(mv)] = mv
            filled += len(mv)
            self._free_and_signal()
        # a heap buffer, NOT a ring loan: recv() must not treat it as one
        return buf

    async def recv(self, session_key: bytes | None) -> Frame:
        await self._maybe_inject(yield_loop=False)
        if self._loaned:
            self._loaned = False
            self._free_and_signal()
        rec = await self._next_frame_buf()
        if isinstance(rec, memoryview):
            self._loaned = True
            self._m.perf.inc("bytes_zero_copy", len(rec))
        frame = await read_frame(_BufReader(rec), session_key)
        return frame
