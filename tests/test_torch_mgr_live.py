"""Twins of the live manager and tracing tier on the port's in-process
cluster: `tests/test_mgr_live.py` and `tests/test_trace_live.py` run once
more, their own bodies and assertions, with every import of ceph_tpu (and of
the tools) pointed at the port and the daemons and clients on the CPU.

The reference's cluster helper, `tests/test_cluster_live.py`, is loaded the
same way, so `Cluster()` there builds the port's monitors and OSDs. The
port's entry points need a device, so `Monitor`, `OSDService`, `Rados` and
`MgrService` in those namespaces take `device="cpu"`; and `ceph_top` runs as
the port's module (`python -m ceph_tpu_torch.tools.ceph_top`). Each case runs
under an `asyncio.wait_for` of 180 s (the reference's allow up to 240 s).
Nothing else in the bodies changes. The failover case is the tier's one
non-slow case; the others are marked slow. The port's messenger reports into
the port's race detector, which this file installs beside conftest's and
asserts clean.
"""

import asyncio
import functools
import os
import re
import sys
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
SHIM = "tests.port_twin_test_cluster_live"

#: the port's classes that need a device; given the CPU in the twins
ON_CPU = {"Monitor": "ceph_tpu_torch.mon", "OSDService": "ceph_tpu_torch.osd.daemon",
          "Rados": "ceph_tpu_torch.rados.client", "MgrService": "ceph_tpu_torch.mgr"}

#: text of a reference body that names a path of the reference's tree
REWRITES = {
    "test_mgr_live.py": [(
        'os.path.join(repo, "tools", "ceph_top.py"),',
        '"-m", "ceph_tpu_torch.tools.ceph_top",')],
}


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


def on_the_port(fname: str, name: str) -> types.ModuleType:
    """`tests/<fname>` executed as module `name` with its imports pointed at
    the port and its device-taking classes bound to the CPU."""
    if name in sys.modules:
        return sys.modules[name]
    with open(os.path.join(TESTS, fname), encoding="utf-8") as f:
        src = f.read()
    for old, new in REWRITES.get(fname, []):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = re.sub(r"^(\s*)(from|import) ceph_tpu\.", r"\1\2 ceph_tpu_torch.", src, flags=re.M)
    src = re.sub(r"^(\s*)from tools import", r"\1from ceph_tpu_torch.tools import", src,
                 flags=re.M)
    src = re.sub(r"^(\s*)from tests\.test_cluster_live import", rf"\1from {SHIM} import", src,
                 flags=re.M)
    assert not re.search(r"^\s*(from|import) (ceph_tpu|tools)\b(?!_torch)", src, flags=re.M)
    module = types.ModuleType(name)
    module.__file__ = os.path.join(TESTS, fname)
    sys.modules[name] = module
    exec(compile(src, module.__file__, "exec"), module.__dict__)
    for cls, where in ON_CPU.items():
        if cls in module.__dict__:
            real = getattr(__import__(where, fromlist=[cls]), cls)
            setattr(module, cls, functools.partial(real, device="cpu"))
    module.run = bounded_run
    return module


def bounded_run(coro):
    return asyncio.run(asyncio.wait_for(coro, 180))


def port_case(fname: str, case: str):
    on_the_port("test_cluster_live.py", SHIM)
    return getattr(on_the_port(fname, f"tests.port_twin_{fname[:-3]}"), case)


def test_mgr_failover_keeps_prometheus_serving():
    port_case("test_mgr_live.py", "test_mgr_failover_keeps_prometheus_serving")()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["test_mon_down_raises_health_warn",
                                  "test_dashboard_http_surface",
                                  "test_ceph_top_json_matches_client_op_counts"])
def test_mgr_live_twin(case):
    port_case("test_mgr_live.py", case)()


@pytest.mark.slow
@pytest.mark.parametrize("case", ["test_traced_write_spans_client_to_blockstore",
                                  "test_traced_ec_write_shows_multi_daemon_timeline"])
def test_trace_live_twin(case):
    port_case("test_trace_live.py", case)()


@pytest.mark.slow
def test_trace_live_slow_write_renders_critical_path_twin(tmp_path):
    port_case("test_trace_live.py", "test_vstart_traced_slow_write_renders_critical_path")(
        tmp_path)
