"""MonClient: how daemons and clients talk to the monitor quorum.

The reference's MonClient (src/mon/MonClient.cc) hunts for a live monitor,
authenticates, keeps a session, subscribes to map updates, and relays
commands; commands that need the leader are forwarded by peons. Here:
commands go to the client's current target mon and follow explicit
`redirect` replies to the leader; subscriptions stick to whichever mon
answered and deliver OSDMap incrementals (applied client-side in order) or
full maps when too far behind.
"""

from __future__ import annotations

import asyncio
import itertools
import json

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.msg import Dispatcher, Message, Messenger, Policy
from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap


class MonClient(Dispatcher):
    def __init__(
        self,
        name: str,
        monmap,
        config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        messenger: Messenger | None = None,
    ):
        self.name = name
        self.monmap = monmap
        self.config = config if config is not None else Config()
        self.messenger = (
            messenger
            if messenger is not None
            else Messenger(name, config=self.config, keyring=keyring)
        )
        # the messenger may be shared with a daemon's own dispatcher; we
        # chain: our handler first, then the original
        self._chained = self.messenger.dispatcher
        self.messenger.dispatcher = self
        self.target_rank = 0
        self.osdmap: OSDMap | None = None
        self._tids = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        self._map_cbs: list = []
        self._map_event = asyncio.Event()

    # -- plumbing -------------------------------------------------------------

    def _conn(self, rank: int | None = None):
        rank = self.target_rank if rank is None else rank
        local = getattr(self.monmap, "local_addrs", None)
        try:
            hint = local[rank] if local else None
        except IndexError:
            hint = None
        return self.messenger.connect(
            tuple(self.monmap.addrs[rank]),
            Policy.lossless_client(),
            local_addr=hint,
        )

    async def ms_dispatch(self, conn, msg: Message) -> None:
        if msg.type == "mon_command_reply":
            p = json.loads(msg.data)
            fut = self._waiters.pop(p.get("tid"), None)
            if fut is not None and not fut.done():
                fut.set_result(p)
        elif msg.type == "osd_map":
            self._handle_map(json.loads(msg.data))
        elif msg.type == "config_map":
            # centralized config (ConfigMonitor subscription): lands in
            # the Config's mon tier, below local file/env/overrides
            p = json.loads(msg.data)
            self.config.apply_mon_values(p.get("kv", {}))
        elif self._chained is not None:
            await self._chained.ms_dispatch(conn, msg)

    async def ms_handle_reset(self, conn) -> None:
        # losing our monitor session must not freeze the map stream: hunt
        # to the next mon and resubscribe from where we are
        # (MonClient::_reopen_session on session reset)
        if conn.peer_name and conn.peer_name.startswith("mon."):
            self.target_rank = (
                self.target_rank + 1
            ) % self.monmap.size
            self.subscribe(
                from_epoch=self.osdmap.epoch if self.osdmap else 0
            )
        if self._chained is not None:
            await self._chained.ms_handle_reset(conn)

    async def ms_handle_accept(self, conn) -> None:
        if self._chained is not None:
            await self._chained.ms_handle_accept(conn)

    # -- maps -----------------------------------------------------------------

    def _handle_map(self, p: dict) -> None:
        if "full" in p:
            self.osdmap = OSDMap.decode(bytes.fromhex(p["full"]))
        elif "incs" in p and self.osdmap is not None:
            for raw in p["incs"]:
                inc = Incremental.decode(bytes.fromhex(raw))
                if inc.epoch == self.osdmap.epoch + 1:
                    self.osdmap.apply_incremental(inc)
        if self.osdmap is not None:
            self._map_event.set()
            for cb in self._map_cbs:
                cb(self.osdmap)

    def on_map_change(self, cb) -> None:
        """cb(osdmap) runs after every applied update (Objecter's
        map-epoch watch)."""
        self._map_cbs.append(cb)

    def subscribe(self, from_epoch: int = 0) -> None:
        self._conn().send_message(
            Message(
                type="sub",
                data=json.dumps({"what": "osdmap",
                                 "from": from_epoch}).encode(),
            )
        )

    async def wait_for_map(self, timeout: float = 15.0) -> OSDMap:
        """Hunt across monitors until a map arrives (MonClient::_reopen_
        session hunting): the configured target may be down — rotate and
        resubscribe instead of timing out against one dead mon."""
        if self.osdmap is None:
            self.subscribe()
        loop = asyncio.get_event_loop()
        deadline = loop.time() + timeout
        while True:
            remaining = deadline - loop.time()
            if remaining <= 0:
                raise asyncio.TimeoutError("no monitor produced a map")
            try:
                await asyncio.wait_for(
                    self._map_event.wait(), min(2.5, remaining)
                )
                return self.osdmap
            except asyncio.TimeoutError:
                self.target_rank = (
                    self.target_rank + 1
                ) % self.monmap.size
                self.subscribe()

    # -- commands + reports ---------------------------------------------------

    async def command(
        self, cmd: str, args: dict | None = None, timeout: float = 10.0
    ) -> dict:
        """Send, follow leader redirects, retry other mons on timeout."""
        payload = {"cmd": cmd, "args": args or {}}
        deadline = asyncio.get_event_loop().time() + timeout
        tried = 0
        while True:
            tid = next(self._tids)
            payload["tid"] = tid
            fut = asyncio.get_event_loop().create_future()
            self._waiters[tid] = fut
            # propagate the active trace context so the mon's command-
            # dispatch span joins the caller's tree (mgr balancer ticks,
            # traced client admin ops)
            from ceph_tpu_torch.common.tracer import current_context

            ctx = current_context()
            self._conn().send_message(
                Message(type="mon_command", tid=tid,
                        data=json.dumps(payload).encode(),
                        trace=ctx.encode()
                        if ctx is not None and ctx.sampled else "")
            )
            remain = deadline - asyncio.get_event_loop().time()
            if remain <= 0:
                raise TimeoutError(f"mon command {cmd!r} timed out")
            try:
                reply = await asyncio.wait_for(
                    fut, min(remain, 2.0 + timeout / 5)
                )
            except asyncio.TimeoutError:
                self._waiters.pop(tid, None)
                tried += 1
                self.target_rank = (self.target_rank + 1) % self.monmap.size
                continue
            if reply.get("redirect") is not None:
                self.target_rank = reply["redirect"]
                continue
            if reply.get("redirect", -1) is None:
                # leaderless moment: back off briefly and retry
                await asyncio.sleep(0.05)
                continue
            if not reply.get("ok", False):
                raise RuntimeError(reply.get("error", "command failed"))
            return reply.get("result", {})

    def report_failure(self, target_osd: int) -> None:
        """OSD-side failure report (MOSDFailure)."""
        self._conn().send_message(
            Message(type="osd_failure",
                    data=json.dumps({"target": target_osd}).encode())
        )

    def send_boot(
        self,
        osd: int,
        addr: tuple[str, int],
        location: dict | None = None,
        weight: int = 0x10000,
        local_addr: str | None = None,
    ) -> None:
        payload = {"osd": osd, "addr": list(addr)}
        if local_addr:
            # uds:// endpoint for co-located peers; published through the
            # osdmap so clients on the same host can skip TCP
            payload["local_addr"] = local_addr
        if location:
            # crush location announced at boot (CrushLocation's role):
            # lets the mon place a brand-new device in the hierarchy
            payload["location"] = location
            payload["weight"] = weight
        self._conn().send_message(
            Message(type="osd_boot", data=json.dumps(payload).encode())
        )

    def cluster_log(self, level: str, message: str) -> None:
        """Forward a warning-level daemon event to the mon cluster log
        (the clog/LogClient role; `log last <n>` reads the tail). One-way
        and best-effort, like every daemon report."""
        import time

        self._conn().send_message(
            Message(type="log",
                    data=json.dumps({
                        "level": level,
                        "message": message,
                        "stamp": time.time(),
                    }).encode())
        )

    def send_pg_temp(self, pgid: tuple[int, int], acting: list[int]) -> None:
        self._conn().send_message(
            Message(type="pg_temp",
                    data=json.dumps({"pgid": list(pgid),
                                     "acting": acting}).encode())
        )

    async def close(self) -> None:
        await self.messenger.shutdown()
