"""Twins of the chaos harness: the port's sim/chaos.py, tools/chaos_tool.py
and `daemon_bench --recovery` against ceph_tpu's.

The script and the daemon-free replay are deterministic, so they must be
byte-identical to ceph_tpu's for the same seed (the replay's placements come
from the port's CRUSH mapper on the CPU here). The live run is not: which
OSD is pushing a backfill when the script kills "the backfill source", and
how many client ops fit in a step, follow the loop's interleaving. So the
live twin holds the port to the reference's oracles instead (no acked write
lost, zero scrub errors, every OSD up with no backfill in flight, client p99
within the budget) and checks that the executed events follow the script as
the reference's executor does. Every live case runs under its own
`asyncio.wait_for`.
"""

import asyncio
import json
import os
import types

import pytest

from ceph_tpu.sim import chaos as ref_chaos
from ceph_tpu_torch.sim import chaos as port_chaos



@pytest.fixture(autouse=True, scope="module")
def _port_racecheck_clean():
    from ceph_tpu_torch.lint import racecheck

    if os.environ.get("CEPH_TPU_RACECHECK", "1") in ("", "0"):
        yield
        return
    racecheck.install()
    try:
        yield
        racecheck.assert_clean()
    finally:
        racecheck.uninstall()
        racecheck.reset()


@pytest.mark.parametrize("seed", [1, 7, 12345])
def test_chaos_script_equals_ceph_tpu(seed):
    for kw in ({}, {"n_osd": 16, "steps": 12}):
        ref = json.dumps(ref_chaos.chaos_script(seed, **kw), sort_keys=True)
        assert json.dumps(port_chaos.chaos_script(seed, **kw), sort_keys=True) == ref


@pytest.mark.parametrize("seed", [1, 7])
def test_run_chaos_equals_ceph_tpu(seed):
    ref = json.dumps(ref_chaos.run_chaos(seed), sort_keys=True)
    port = json.dumps(port_chaos.run_chaos(seed, device="cpu"), sort_keys=True)
    assert port == ref
    report = json.loads(port)
    assert report["final"]["data_safe"] and report["final"]["converged"]
    assert sum(s["pgs_moved"] for s in report["steps"]) > 0


def follows_script(script: dict, executed: list) -> None:
    """The reference executor's rules: a flap kills the scripted OSD when it
    is up, a kill of the backfill source kills some OSD while fewer than two
    are down, and a partition or storm arms the scripted schedule; no event
    is executed out of order or twice."""
    it = iter(executed)
    for e in script["events"]:
        kind = e["kind"]
        if kind in ("flap", "kill_backfill_source"):
            continue  # checked below: they depend on who is down
        got = next(it)
        while got[0] in ("flap", "kill_backfill_source"):
            got = next(it)
        assert got == [kind, e["schedule"]]
    kills = [x for x in executed if x[0] in ("flap", "kill_backfill_source")]
    scripted = [e for e in script["events"] if e["kind"] in ("flap", "kill_backfill_source")]
    assert 1 <= len(kills) <= len(scripted)
    flaps = {e["osd"] for e in scripted if e["kind"] == "flap"}
    assert all(x[1] in flaps for x in kills if x[0] == "flap")
    assert all(0 <= x[1] < 6 for x in kills)


def test_chaos_live_holds_the_oracles_on_the_port():
    from ceph_tpu_torch.tools.chaos_tool import N_OSDS, run_chaos_live

    report = asyncio.run(asyncio.wait_for(
        run_chaos_live(1, steps=8, progress=lambda *_: None, device="cpu"), 180))
    script = port_chaos.chaos_script(1, n_osd=N_OSDS, steps=8)
    assert report["script_events"] == len(script["events"])
    follows_script(script, report["executed"])
    # the settle raised unless every OSD came back up with no backfill left
    assert report["lost"] == []
    assert report["scrub_errors"] == 0
    assert report["p99_s"] <= report["p99_budget_s"]
    assert report["client_ops"] > 100 and report["acked_keys"] > 0
    # step 0 starves in ceph_tpu's run of this seed too: its one-way
    # partition holds the new pools' peering for longer than the step
    assert set(report["starved_steps"]) <= {0}


@pytest.mark.slow
def test_daemon_bench_recovery_twin():
    """Both legs heal every target object (a leg returns only once the
    reborn OSD holds all of them with no backfill left), on both packages;
    the report has the reference's keys."""
    from ceph_tpu_torch.tools import daemon_bench as port_bench
    from tools import daemon_bench as ref_bench

    args = types.SimpleNamespace(recovery_objects=48)  # all main_recovery reads
    ref = asyncio.run(asyncio.wait_for(ref_bench.main_recovery(args), 300))
    port = port_bench.run(["--recovery", "--recovery-objects", "48", "--device", "cpu"])

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(port) == keys(ref)
    assert port["mode"] == "recovery" and port["objects"] == 48
    for leg, batch in (("serial", 1), ("batched", ref["batched"]["batch_max"])):
        assert port[leg]["batch_max"] == batch
        assert port[leg]["healed_objects"] > 0 and port[leg]["client_ops"] > 0


@pytest.mark.parametrize("n4", [1, 7, 64, 257])
def test_b1_at_the_chaos_pool_widths_equals_pallas(n4):
    """B1 as the chaos pool (tpu k=2 m=2, objects of 64-2047 B) calls it:
    encode r=2 and decode r=1 and r=2 at a few words a row, the port's CPU
    path against the Pallas kernel in interpret mode (tolerance 0)."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ceph_tpu.ops import gf_pallas as gp
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import gf_cuda as gc

    codec = factory("tpu", {"k": "2", "m": "2"}, device="cpu")
    words = np.random.default_rng(n4).integers(-2**31, 2**31, (2, n4), dtype=np.int64)
    words = words.astype(np.int32)
    tables = [codec._encode] + [codec.decode_bitmatrix(present, erased)
                                for present, erased in (([1, 2], [0]), ([2, 3], [0, 1]))]
    for t in tables:
        got = gc.gf_matmul_packed(t.packed_t, torch.from_numpy(words)).numpy()
        want = np.asarray(gp.gf_matmul_packed(jnp.asarray(t.packed_t.numpy()),
                                              jnp.asarray(words), interpret=True))
        assert np.array_equal(got, want)
