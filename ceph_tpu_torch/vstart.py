"""vstart: boot a REAL multi-process cluster.

This is the role of the reference's ``src/vstart.sh`` (1357 lines of shell
whose only job is to start N ceph-mon + M ceph-osd as separate OS
processes on one machine) together with the daemon ``main()``s it execs
(``src/ceph_osd.cc:106``, ``src/ceph_mon.cc``).  Every daemon here is a real
``fork+exec``'d Python interpreter running exactly one Monitor / OSDService
on its own event loop; they find each other over the TCP messenger
through a shared **cluster spec** file — the monmap + config the reference
distributes via ``ceph.conf`` + the monmap file.

Layout of a run directory (``--run-dir``):

    cluster_spec.json      monmap + n_osds + config overrides (+ device)
    mon.0.kv / osd.3.kv    per-daemon FileDB stores (WAL, crash-safe)
    osd.3.kv/block         raw block file when osd_objectstore=blockstore
    mon.0.log / osd.3.log  daemon stdout+stderr

The spec is deterministic: every mon builds the identical initial OSDMap
from it (the reference's ``monmaptool --create`` + ``osdmaptool
--createsimple`` seed), so independently-booted mons agree on epoch 1
without talking.

Port of the reference package's ``vstart.py``. Every daemon process runs on
the spec's device (``extras["device"]``, written when ``VStart(device=...)``
names one; absent, a daemon resolves None to cuda and raises without a
card). A card can be opened by many processes, so every OSD's
``EncodeService`` launches its kernels in its own CUDA context. The launcher
builds the CUDA and native libraries before it spawns anything, and each
daemon main creates its context and loads its libraries before its loop
starts, so neither a build nor a context creation ever stalls a heartbeat.
``start_daemon("mgr", i)`` spawns a manager, ``start_daemon("mds", i)`` a
metadata server and ``start_daemon("rgw", i)`` an S3 gateway, each on the
same device.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field

from ceph_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Cluster spec


@dataclass
class ClusterSpec:
    """Everything a daemon needs to boot: the monmap + deterministic seed.

    The reference splits this across ceph.conf, the monmap file, and the
    mon store's initial osdmap; one JSON file carries all three here.
    """

    mon_addrs: list  # [[host, port], ...] — rank r binds mon_addrs[r]
    n_osds: int
    run_dir: str
    config: dict = field(default_factory=dict)
    keyring: dict = field(default_factory=dict)  # entity -> hex secret
    #: launcher-only knobs outside the typed Config schema (the daemons'
    #: "device", ...)
    extras: dict = field(default_factory=dict)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "mon_addrs": [list(a) for a in self.mon_addrs],
                    "n_osds": self.n_osds,
                    "run_dir": self.run_dir,
                    "config": self.config,
                    "keyring": self.keyring,
                    "extras": self.extras,
                },
                f,
                indent=1,
            )

    @classmethod
    def load(cls, path: str) -> "ClusterSpec":
        with open(path) as f:
            d = json.load(f)
        return cls(
            mon_addrs=[tuple(a) for a in d["mon_addrs"]],
            n_osds=d["n_osds"],
            run_dir=d["run_dir"],
            config=d.get("config", {}),
            keyring=d.get("keyring", {}),
            extras=d.get("extras", {}),
        )

    @property
    def device(self):
        """The daemons' device as the spec names it (None = cuda)."""
        return self.extras.get("device")

    # -- deterministic seeds --------------------------------------------------

    def monmap(self):
        from ceph_tpu_torch.mon import MonMap

        # deterministic uds:// endpoints derived from run_dir: every
        # daemon and client rebuilds the same monmap from the spec, so
        # co-located peers can dial the mon's Unix socket directly. The
        # messenger falls back to TCP whenever the socket is absent (a
        # remote run_dir) or the path exceeds the AF_UNIX limit.
        local = [
            f"uds://{os.path.join(self.run_dir, f'mon.{r}.sock')}"
            for r in range(len(self.mon_addrs))
        ]
        return MonMap(
            addrs=[tuple(a) for a in self.mon_addrs],
            local_addrs=local,
        )

    def build_config(self):
        from ceph_tpu_torch.common.config import Config

        cfg = Config()
        for k, v in self.config.items():
            cfg.set(k, v)
        return cfg

    def initial_osdmap(self):
        return initial_osdmap(self.n_osds)

    def bytes_keyring(self) -> dict | None:
        if not self.keyring:
            return None
        return {k: bytes.fromhex(v) for k, v in self.keyring.items()}


def initial_osdmap(n_osds: int):
    """THE deterministic epoch-1 seed: one host per OSD (failures cross
    failure domains), straw2 root, rule 0 = indep (EC), rule 1 = firstn
    (replicated). Every mon of a cluster must build this identically from
    the spec alone, and the in-process live tier + daemon bench import it
    too, so single-process and multi-process behavior stay comparable."""
    from ceph_tpu_torch.crush import builder as cb
    from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
    from ceph_tpu_torch.osd.osdmap import OSDMap

    cmap = CrushMap(tunables=Tunables.jewel())
    host_ids, host_ws = [], []
    for h in range(n_osds):
        b = cb.make_bucket(
            cmap, -(h + 2), BucketAlg.STRAW2, 1, [h], [0x10000]
        )
        host_ids.append(b.id)
        host_ws.append(b.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, host_ids, host_ws)
    cb.make_simple_rule(cmap, 0, -1, 1, "indep", 0)
    cb.make_simple_rule(cmap, 1, -1, 1, "firstn", 0)
    return OSDMap(crush=cmap, max_osd=n_osds)


def pick_ports(n: int) -> list[int]:
    """Reserve n distinct kernel-assigned loopback ports.

    All sockets stay open until every port is collected so the kernel can't
    hand the same port out twice; the (tiny, loopback-only) close->bind race
    is accepted, as vstart.sh accepts it with its fixed port ranges.
    """
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            socks.append(s)
    finally:
        for s in socks:
            s.close()
    return ports


def prebuild(device) -> None:
    """Build every library a daemon on `device` may load, in this process:
    the CUDA kernels (one nvcc per source, all at once) and the native
    crc32c and EC plugin. A CPU device needs none of the CUDA ones, and the
    native ones build under their lock at first use, so it builds nothing."""
    if resolve_device(device).type != "cuda":
        return
    from ceph_tpu_torch.native.build import build_plugin
    from ceph_tpu_torch.ops import cuda_build

    cuda_build.build()
    import ceph_tpu_torch.common.crc  # noqa: F401  (builds libcrc32c)

    build_plugin()


def init_device(device):
    """Open `device` in this process before any loop runs: on a card, the
    CUDA context and the GF(2^8) kernels' libraries (built by the launcher
    beforehand, or here). Returns the resolved device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        from ceph_tpu_torch.ops import gf_cuda

        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        gf_cuda._lib()
        gf_cuda._xor_lib()
    return dev


class KernelCounters:
    """A `perf dump` block ("kernels.osd.N") reading this process's kernel
    wrappers' own launch counts: how a launcher sees, over `osd_admin`, what
    each daemon process launched on its card (a CPU path counts nothing). The
    block is named after its daemon, as the messenger's `msgr.osd.N` is, so
    that the manager's Prometheus scrape, which labels a series with its
    block, tells one OSD's counts from another's."""

    def __init__(self, daemon: str):
        self.name = f"kernels.{daemon}"

    @staticmethod
    def wrappers() -> dict:
        from ceph_tpu_torch.ec.interface import CodecCounters

        return CodecCounters.wrappers()

    def dump(self) -> dict:
        return {k: int(w.launches) for k, w in self.wrappers().items()}

    def schema(self) -> dict:
        return {k: {"type": "u64", "description": f"{k} kernel launches"}
                for k in self.wrappers()}


# ---------------------------------------------------------------------------
# Daemon mains (exec'd via python -m ceph_tpu_torch.mon / ceph_tpu_torch.osd)


#: in-flight SIGTERM stop tasks: referenced here so the interpreter can
#: never garbage-collect one mid-stop (cephlint task-leak rule)
_TERM_TASKS: set = set()


def _install_term_handler(loop, stopper) -> None:
    """SIGTERM -> clean daemon stop (the reference's handle_osd_signal);
    SIGKILL needs no handler — that's the crash path tests exercise."""

    def _term():
        task = asyncio.ensure_future(stopper())
        _TERM_TASKS.add(task)
        task.add_done_callback(_TERM_TASKS.discard)

    loop.add_signal_handler(signal.SIGTERM, _term)


async def _run_forever(stop_evt: asyncio.Event) -> None:
    await stop_evt.wait()


def daemon_main(kind: str, ident: int, spec_path: str) -> None:
    """Shared entry point behind
    ``python -m ceph_tpu_torch.{mon,osd,mgr,cephfs,rgw}``."""
    spec = ClusterSpec.load(spec_path)
    if kind not in ("mon", "osd", "mgr", "mds", "rgw"):
        raise SystemExit(f"unknown daemon kind {kind!r}")
    # context and kernel libraries now, never on the daemon's loop
    device = init_device(spec.device)
    from ceph_tpu_torch.common.kv import FileDB

    async def amain() -> None:
        loop = asyncio.get_event_loop()
        stop_evt = asyncio.Event()
        started = asyncio.Event()

        async def _stop(daemon):
            # the handler is in place before the daemon starts: a SIGTERM
            # that lands while it boots stops it once the boot is done
            await started.wait()
            await daemon.stop()
            stop_evt.set()

        cfg = spec.build_config()
        keyring = spec.bytes_keyring()
        if kind in ("mgr", "mds", "rgw"):
            db = None  # a manager, an mds or a gateway keeps no store
        elif kind == "osd" and cfg.get("osd_objectstore") == "memstore":
            from ceph_tpu_torch.common.kv import MemDB

            db = MemDB()
        else:
            # kstore-file AND blockstore both persist through this
            # FileDB; a blockstore OSD adds its block file inside
            # the same per-daemon dir (OSDService builds the store
            # from osd_objectstore)
            db = FileDB(os.path.join(spec.run_dir, f"{kind}.{ident}.kv"))
        if kind == "mon":
            from ceph_tpu_torch.mon import Monitor

            mon = Monitor(
                ident,
                spec.monmap(),
                spec.initial_osdmap(),
                db=db,
                config=cfg,
                keyring=keyring,
                device=device,
            )
            daemon = mon
            _install_term_handler(loop, lambda: _stop(daemon))
            await mon.start()
            started.set()
            print(f"mon.{ident} up at {spec.mon_addrs[ident]}", flush=True)
        elif kind == "mgr":
            from ceph_tpu_torch.mgr.daemon import MgrService

            mgr = MgrService(
                f"mgr.{ident}", spec.monmap(), config=cfg, keyring=keyring,
                device=device,
            )
            daemon = mgr
            _install_term_handler(loop, lambda: _stop(daemon))
            await mgr.start()
            port = await mgr.serve_http()
            # boot-time run-file write, before any IO is served
            with open(  # cephlint: disable=async-blocking
                os.path.join(spec.run_dir, f"mgr.{ident}.port"), "w"
            ) as f:
                f.write(str(port))
            started.set()
            print(f"mgr.{ident} http on :{port} on {device}", flush=True)
        elif kind == "mds":
            from ceph_tpu_torch.cephfs.mds import MDSService

            mds = MDSService(
                f"mds.{ident}", spec.monmap(),
                int(spec.extras.get("mds_data_pool", 1)),
                config=cfg, keyring=keyring, device=device,
            )
            daemon = mds
            _install_term_handler(loop, lambda: _stop(daemon))
            await mds.start()
            started.set()
            print(f"mds.{ident} up at {mds.addr} on {device}", flush=True)
        elif kind == "rgw":
            from types import SimpleNamespace

            from ceph_tpu_torch.rados.client import Rados
            from ceph_tpu_torch.rgw import ObjectGateway, S3Frontend

            rados = Rados(f"client.rgw{ident}", spec.monmap(), config=cfg,
                          keyring=keyring, device=device)
            gw = ObjectGateway(
                rados.io_ctx(int(spec.extras.get("rgw_data_pool", 2))),
                index_ioctx=rados.io_ctx(
                    int(spec.extras.get("rgw_index_pool", 1))),
            )
            front = S3Frontend(gw, users=dict(spec.extras.get("rgw_users") or {}))

            async def stop_rgw():
                await front.stop()
                await rados.shutdown()

            daemon = SimpleNamespace(stop=stop_rgw)
            _install_term_handler(loop, lambda: _stop(daemon))
            await rados.connect()
            port = await front.start()
            # the kernel-assigned port is published for the launcher; one
            # boot-time run-file write, before any IO is served
            with open(  # cephlint: disable=async-blocking
                os.path.join(spec.run_dir, f"rgw.{ident}.port"), "w"
            ) as f:
                f.write(str(port))
            started.set()
            print(f"rgw.{ident} serving S3 on :{port} on {device}", flush=True)
        else:
            from ceph_tpu_torch.osd.daemon import OSDService

            from ceph_tpu_torch.cephfs.fs import register_fs_classes
            from ceph_tpu_torch.journal.journal import (
                register_journal_classes,
            )
            from ceph_tpu_torch.rgw.gateway import register_rgw_classes

            osd = OSDService(
                ident, spec.monmap(), db=db, config=cfg, keyring=keyring,
                device=device,
            )
            # the reference OSD dlopens every cls plugin at boot: beside
            # the built-in families, a daemon-main OSD registers the
            # cephfs, journal and rgw classes
            register_fs_classes(osd)
            register_journal_classes(osd)
            register_rgw_classes(osd)
            osd.perf_collection.add(KernelCounters(osd.name))
            daemon = osd
            _install_term_handler(loop, lambda: _stop(daemon))
            await osd.start()
            started.set()
            print(f"osd.{ident} up at {osd.messenger.my_addr} on {device}",
                  flush=True)
        await _run_forever(stop_evt)

    if os.environ.get("CEPH_TPU_PROFILE"):
        import cProfile

        prof = cProfile.Profile()
        prof.enable()
        try:
            asyncio.run(amain())
        finally:
            prof.disable()
            prof.dump_stats(
                os.path.join(spec.run_dir, f"{kind}.{ident}.prof")
            )
    else:
        asyncio.run(amain())


# ---------------------------------------------------------------------------
# The launcher


class VStart:
    """Boot + manage a multi-process cluster from the test/bench process.

    ``start()`` builds the device's libraries, then spawns one interpreter
    per daemon; ``kill_osd`` delivers a real signal (default SIGKILL — the
    crash the thrasher wants); ``start_osd`` boots a fresh process for an id
    over the daemon's surviving FileDB, which is the reference's
    restart-with-intact-store path. `device` (None = cuda, which raises
    without a card) is where every daemon and `client()` run.
    """

    def __init__(
        self,
        run_dir: str,
        n_mons: int = 3,
        n_osds: int = 4,
        config: dict | None = None,
        env: dict | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        os.makedirs(run_dir, exist_ok=True)
        cfg = {
            "mon_lease": 0.25,
            "mon_election_timeout": 1.0,
            "osd_heartbeat_interval": 0.25,
            # daemons no longer share a loop: grace can be much tighter
            # than the in-process tier's jit-compile-absorbing 2s
            "osd_heartbeat_grace": 3,
            # keep every daemon's Unix sockets + ring files inside the
            # cluster's run_dir so teardown removes them with the dir
            "ms_uds_dir": run_dir,
        }
        cfg.update(config or {})
        ports = pick_ports(n_mons)
        self.spec = ClusterSpec(
            mon_addrs=[("127.0.0.1", p) for p in ports],
            n_osds=n_osds,
            run_dir=run_dir,
            config=cfg,
            extras={} if device is None else {"device": str(self.device)},
        )
        self.spec_path = os.path.join(run_dir, "cluster_spec.json")
        self.spec.save(self.spec_path)
        self.env = dict(os.environ)
        self.env.update(env or {})
        self.mons: dict[int, subprocess.Popen] = {}
        self.osds: dict[int, subprocess.Popen] = {}
        #: daemons spawned by start_daemon: (kind, id) -> process
        self.extra: dict[tuple, subprocess.Popen] = {}
        self._logs: list = []

    # -- process management ---------------------------------------------------

    #: daemon kind -> python module hosting its __main__
    _KIND_MODULE = {
        "mon": "ceph_tpu_torch.mon",
        "osd": "ceph_tpu_torch.osd",
        "mgr": "ceph_tpu_torch.mgr",
        "mds": "ceph_tpu_torch.cephfs",
        "rgw": "ceph_tpu_torch.rgw",
    }

    def _spawn(self, kind: str, ident: int) -> subprocess.Popen:
        log = open(
            os.path.join(self.spec.run_dir, f"{kind}.{ident}.log"), "ab"
        )
        self._logs.append(log)
        return subprocess.Popen(
            [
                sys.executable,
                "-m",
                self._KIND_MODULE[kind],
                "--id",
                str(ident),
                "--spec",
                self.spec_path,
            ],
            stdout=log,
            stderr=subprocess.STDOUT,
            env=self.env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )

    def start(self) -> None:
        prebuild(self.device)
        for r in range(len(self.spec.mon_addrs)):
            self.mons[r] = self._spawn("mon", r)
        for i in range(self.spec.n_osds):
            self.osds[i] = self._spawn("osd", i)

    def start_osd(self, osd_id: int) -> None:
        self.osds[osd_id] = self._spawn("osd", osd_id)

    def start_daemon(self, kind: str, ident: int) -> None:
        """Spawn a mgr, mds or rgw process on the cluster's device."""
        if kind not in self._KIND_MODULE:
            raise ValueError(f"vstart: no daemon kind {kind!r}")
        self.extra[(kind, ident)] = self._spawn(kind, ident)

    def daemon_port(self, kind: str, ident: int,
                    timeout: float = 60.0) -> int:
        """Kernel-assigned port a mgr or rgw daemon published in its run
        file (vstart.sh's out-dir convention)."""
        path = os.path.join(
            self.spec.run_dir, f"{kind}.{ident}.port"
        )
        end = time.time() + timeout
        while time.time() < end:
            try:
                with open(path) as f:
                    raw = f.read().strip()
                if raw:
                    return int(raw)
            except FileNotFoundError:
                pass
            dead = self.exited().get(f"{kind}.{ident}")
            if dead is not None:
                raise RuntimeError(
                    f"{kind}.{ident} exited {dead}; its log ends:\n"
                    + self.log_tail(f"{kind}.{ident}")
                )
            time.sleep(0.2)
        raise TimeoutError(f"{kind}.{ident} never published a port")

    def kill_osd(self, osd_id: int, sig: int = signal.SIGKILL) -> None:
        p = self.osds.pop(osd_id)
        p.send_signal(sig)
        p.wait(timeout=30)

    def kill_mon(self, rank: int, sig: int = signal.SIGKILL) -> None:
        p = self.mons.pop(rank)
        p.send_signal(sig)
        p.wait(timeout=30)

    def exited(self) -> dict:
        """{"osd.3": returncode, ...} for every tracked daemon that is no
        longer running (one that failed to boot, or crashed)."""
        out = {}
        for kind, procs in (("mon", self.mons), ("osd", self.osds)):
            for ident, p in procs.items():
                if p.poll() is not None:
                    out[f"{kind}.{ident}"] = p.returncode
        for (kind, ident), p in self.extra.items():
            if p.poll() is not None:
                out[f"{kind}.{ident}"] = p.returncode
        return out

    def wait_started(self, timeout: float = 300.0) -> float:
        """Blocks until every tracked daemon has printed its "up" line (its
        start() returned: a monitor serving, an OSD up in the map); returns
        the seconds waited. Raises, with its log's tail, if one exited."""
        t0 = time.monotonic()
        names = [f"mon.{r}" for r in self.mons] + [f"osd.{i}" for i in self.osds]
        while True:
            dead = self.exited()
            if dead:
                name = next(iter(dead))
                raise RuntimeError(f"daemon(s) exited {dead}; {name}.log ends:\n"
                                   + self.log_tail(name))
            waiting = [n for n in names if f"{n} up at" not in self.log_tail(n, 1 << 16)]
            if not waiting:
                return time.monotonic() - t0
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{waiting} not started after {timeout} s")
            time.sleep(0.2)

    def log_tail(self, name: str, nbytes: int = 2000) -> str:
        with open(os.path.join(self.spec.run_dir, f"{name}.log"), "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode(errors="replace")

    def stop(self, sig: int = signal.SIGKILL) -> dict:
        """Signal every daemon (SIGKILL by default; SIGTERM asks each for
        a clean stop) and reap it; returns {name: returncode}."""
        procs = {
            **{f"mon.{r}": p for r, p in self.mons.items()},
            **{f"osd.{i}": p for i, p in self.osds.items()},
            **{f"{k}.{i}": p for (k, i), p in self.extra.items()},
        }
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(sig)
        rcs = {}
        for name, p in procs.items():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()
                p.wait()
            rcs[name] = p.returncode
        for log in self._logs:
            log.close()
        self.mons.clear()
        self.osds.clear()
        self.extra.clear()
        return rcs

    # -- client-side helpers --------------------------------------------------

    def client(self, name: str = "client.admin"):
        from ceph_tpu_torch.rados.client import Rados

        return Rados(name, self.spec.monmap(), config=self.spec.build_config(),
                     device=self.device)

    async def wait_healthy(
        self, rados=None, osds: set | None = None, timeout: float = 60.0
    ):
        """Wait until the committed osdmap shows every expected OSD up.
        Raises at once, with its log's tail, if a daemon process exited."""
        own = rados is None
        if own:
            rados = self.client()
            await rados.connect()
        want = osds if osds is not None else set(range(self.spec.n_osds))
        loop = asyncio.get_event_loop()
        end = loop.time() + timeout
        try:
            while True:
                dead = self.exited()
                if dead:
                    name = next(iter(dead))
                    raise RuntimeError(
                        f"daemon(s) exited {dead}; {name}.log ends:\n"
                        + self.log_tail(name)
                    )
                m = rados.objecter.osdmap
                if m is not None and all(
                    i < m.max_osd and m.osd_up[i] for i in want
                ):
                    return m
                if loop.time() > end:
                    raise TimeoutError(
                        f"osds {want} not up; map={None if m is None else m.epoch}"
                    )
                await asyncio.sleep(0.1)
        finally:
            if own:
                await rados.shutdown()


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="boot a multi-process cluster (vstart.sh role)"
    )
    ap.add_argument("--run-dir", default="./vstart-run")
    ap.add_argument("--mons", type=int, default=3)
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="every daemon's device: cuda (default; raises "
                         "without a card) or cpu")
    args = ap.parse_args(argv)
    v = VStart(args.run_dir, n_mons=args.mons, n_osds=args.osds,
               device=args.device)
    v.start()
    print(f"spec: {v.spec_path}")
    print(f"mons: {[p.pid for p in v.mons.values()]}")
    print(f"osds: {[p.pid for p in v.osds.values()]}")
    try:
        asyncio.run(v.wait_healthy())
        print("HEALTH_OK: all osds up — ^C to tear down")
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        v.stop()


if __name__ == "__main__":
    main()
