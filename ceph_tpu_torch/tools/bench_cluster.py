"""The tools' bench cluster: 3 monitors, BENCH_OSDS OSD daemons and an
admin client in this process, on one device, with a size-3 pool (REP_POOL)
and a k=2 m=2 EC pool (EC_POOL) — the shape of the reference's
`tests/test_cluster_live.Cluster`, which the reference tools' benches boot.
`ckpt_tool`, `data_tool` and `fleet_tool` share it; a tool of the port
imports nothing of the tests.
"""

from __future__ import annotations

REP_POOL = 1
EC_POOL = 2
BENCH_OSDS = 6


class BenchCluster:
    def __init__(self, device):
        from ceph_tpu_torch.common.config import Config
        from ceph_tpu_torch.mon import MonMap

        self.device = device
        self.cfg = Config()
        for key, value in (("mon_lease", 0.1), ("mon_election_timeout", 0.4),
                           ("osd_heartbeat_interval", 0.5), ("osd_heartbeat_grace", 5)):
            self.cfg.set(key, value)
        self.monmap = MonMap(addrs=[("127.0.0.1", 0)] * 3)
        self.mons, self.osds, self.rados = [], [], None

    @property
    def mon_host(self) -> str:
        """The monitors' addresses as a `--mon-host` argument."""
        return ",".join(f"{h}:{p}" for h, p in self.monmap.addrs)

    def client(self, name: str):
        from ceph_tpu_torch.rados.client import Rados

        return Rados(name, self.monmap, config=self.cfg, device=self.device)

    async def start(self, name: str = "client.bench") -> "BenchCluster":
        from ceph_tpu_torch.mon import Monitor
        from ceph_tpu_torch.osd.daemon import OSDService
        from ceph_tpu_torch.vstart import initial_osdmap

        self.mons = [Monitor(r, self.monmap, initial_osdmap(BENCH_OSDS), config=self.cfg,
                             device=self.device) for r in range(3)]
        for m in self.mons:
            await m.bind()
        for m in self.mons:
            m.go()
        for i in range(BENCH_OSDS):
            self.osds.append(OSDService(i, self.monmap, config=self.cfg, device=self.device))
            await self.osds[-1].start()
        self.rados = self.client(name)
        await self.rados.connect()
        await self.rados.mon_command("osd erasure-code-profile set", {
            "name": "k2m2", "profile": {"plugin": "tpu", "k": "2", "m": "2"}})
        await self.rados.mon_command("osd pool create", {
            "pool_id": REP_POOL, "crush_rule": 1, "size": 3, "pg_num": 8})
        await self.rados.mon_command("osd pool create", {
            "pool_id": EC_POOL, "crush_rule": 0, "erasure_code_profile": "k2m2",
            "pg_num": 8})
        return self

    async def stop(self) -> None:
        if self.rados is not None:
            await self.rados.shutdown()
        for o in self.osds:
            await o.stop()
        for m in self.mons:
            await m.stop()
