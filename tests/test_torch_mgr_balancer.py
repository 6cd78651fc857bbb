"""The port's mgr BalancerModule against the JAX package's, on the CPU,
tolerance 0, through an in-process mon client (wait_for_map + command): in
upmap mode both commit the same pg-upmap-items mappings, in crush-compat mode
the same `osd crush set` text, with the same spreads, launches and perf
counters. (The live-cluster test, tests/test_mgr_balancer.py, needs daemons
the port does not have yet.)"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.common.config import Config as JConfig
from ceph_tpu.mgr import BalancerModule as JBalancerModule
from ceph_tpu.sim import build_cluster as jbuild
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.mgr import BalancerModule
from ceph_tpu_torch.sim import build_cluster

SHAPE = dict(n_osd=32, rep_pg_num=128, ec_pg_num=64, osds_per_host=4)


class FakeMon:
    """The two calls BalancerModule makes of its mon client."""

    def __init__(self, osdmap):
        self.osdmap = osdmap
        self.commands = []

    async def wait_for_map(self):
        return self.osdmap

    async def command(self, name, args):
        self.commands.append((name, args))
        return {"applied": len(args.get("mappings", {}))}


def skewed(build, **kw):
    m = build(**SHAPE, **kw)
    rng = np.random.default_rng(5)
    for o in range(0, m.max_osd, 3):
        m.osd_weight[o] = int((0.4 + 0.5 * rng.random()) * 0x10000)
    return m


def run_both(mode, port_kw=None, ref_kw=None, **run_kw):
    port_mon = FakeMon(skewed(build_cluster, device="cpu"))
    ref_mon = FakeMon(skewed(jbuild))
    port = BalancerModule(port_mon, device="cpu", **(port_kw or {}))
    ref = JBalancerModule(ref_mon, **(ref_kw or {}))
    got = asyncio.run(port.run_once(mode=mode, **run_kw))
    want = asyncio.run(ref.run_once(mode=mode, **run_kw))
    return (port, port_mon, got), (ref, ref_mon, want)


def drop_clock(d):
    return {k: v for k, v in d.items() if k != "score_seconds"}


def perf(module):
    dump = module.perf.dump()
    dump["score_lat"] = dump["score_lat"]["avgcount"]
    return dump


@pytest.mark.parametrize("pools", [None, {1}, {2}], ids=["all", "replicated", "erasure"])
def test_upmap_mode_commits_what_jax_commits(pools):
    (port, mon, got), (ref, jmon, want) = run_both(
        "upmap", pools=pools, max_deviation=0.5, max_changes=24)
    assert drop_clock(got) == drop_clock(want)
    assert got["changes"] > 0 and got["spread_after"] <= got["spread_before"]
    assert mon.commands == jmon.commands
    assert [name for name, _ in mon.commands] == ["osd pg-upmap-items"]
    assert perf(port) == perf(ref)
    # the live map is untouched: the balancer works on a decoded copy
    assert mon.osdmap.pg_upmap_items == {}


def test_crush_compat_mode_commits_what_jax_commits():
    (port, mon, got), (ref, jmon, want) = run_both("crush-compat")
    assert got == want
    assert got["changes"] > 0 and got["spread_after"] < got["spread_before"]
    assert mon.commands == jmon.commands
    (name, args), = mon.commands
    assert name == "osd crush set" and "choose_args" in args["crush_text"]
    assert perf(port) == perf(ref)


def test_config_defaults_drive_the_pass():
    settings = {"balancer_max_changes": 5, "balancer_max_deviation": 0.5}
    cfg, jcfg = Config(), JConfig()
    for key, value in settings.items():
        cfg.set(key, value)
        jcfg.set(key, value)
    (port, mon, got), (ref, jmon, want) = run_both(
        None, port_kw=dict(config=cfg), ref_kw=dict(config=jcfg))
    assert drop_clock(got) == drop_clock(want)
    assert got["changes"] == 5 and mon.commands == jmon.commands


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    mon = FakeMon(build_cluster(16, rep_pg_num=64, device="cpu"))
    for mode in ("upmap", "crush-compat"):
        with pytest.raises(RuntimeError, match="cuda"):
            asyncio.run(BalancerModule(mon).run_once(mode=mode))
    assert mon.commands == []
