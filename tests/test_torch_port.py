"""Rules of the PyTorch/CUDA port (ceph_tpu_torch and chip_smoke.py):
nothing imports JAX or the JAX package, and an entry point that defaults to
the card raises when there is none instead of running on the CPU."""

import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The suite runs in several processes at once (pytest -n). torch's CPU ops
# would start one intra-op thread per core in each of them; spinning on the
# shared cores, those threads slowed the codec tests' loops of small-tensor
# ops more than twenty-fold. One thread per test process: every xdist worker
# collects every test module, so this runs in each before any test does.
torch.set_num_threads(1)


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "ceph_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = port_files()
    assert len(files) > 10
    for part in ("crush/torch_mapper.py", "crush/tester.py", "ops/crush_cuda.py",
                 "tools/crushtool.py", "tools/crush_bench.py", "ec/bitmatrix.py",
                 "ec/shec.py", "ec/lrc.py", "ec/clay.py", "ops/gf_bitplane.py",
                 "ops/gf_cuda.py", "rados/cluster.py", "ec/native.py",
                 "native/build.py", "common/crc.py", "osd/daemon.py", "mon/monitor.py",
                 "rados/client.py", "msg/messenger.py", "lint/racecheck.py",
                 "tools/daemon_bench.py", "vstart.py", "parallel/sharding.py",
                 "rados/striper.py", "ckpt/layout.py", "ckpt/writer.py", "ckpt/reader.py",
                 "ckpt/store.py", "tools/ckpt_tool.py", "data/layout.py", "data/reader.py",
                 "data/writer.py", "data/store.py", "coord/lock.py", "coord/fleet.py",
                 "coord/mesh.py", "coord/driver.py", "tools/data_tool.py",
                 "tools/fleet_tool.py", "tools/bench_cluster.py", "sim/chaos.py",
                 "tools/chaos_tool.py", "mgr/metrics.py", "mgr/traces.py", "mgr/prometheus.py",
                 "mgr/autoscaler.py", "mgr/dashboard.py", "mgr/daemon.py", "mgr/__main__.py",
                 "tools/ceph_top.py", "tools/trace_tool.py", "rbd/__init__.py",
                 "rbd/image.py", "journal/__init__.py", "journal/journal.py",
                 "cephfs/__init__.py", "cephfs/__main__.py", "cephfs/fs.py",
                 "cephfs/client.py", "cephfs/mds.py", "rgw/__init__.py", "rgw/__main__.py",
                 "rgw/gateway.py", "rgw/rest.py", "rgw/swift.py", "lint/core.py",
                 "lint/checks.py", "lint/cli.py", "lint/__main__.py", "tools/lint.py"):
        assert os.path.join(REPO, "ceph_tpu_torch", *part.split("/")) in files
    bad = [
        (os.path.relpath(path, REPO), mod)
        for path in files
        for mod in imported_modules(path)
        if mod.split(".")[0] in ("jax", "jaxlib", "ceph_tpu")
    ]
    assert bad == []


def test_default_device_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops.gf_bitplane import bitplane_matrix
    from ceph_tpu_torch.osd.encode_service import EncodeService

    with pytest.raises(RuntimeError, match="cuda"):
        factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    with pytest.raises(RuntimeError, match="cuda"):
        factory("jerasure", {"k": "4", "m": "2"})
    with pytest.raises(RuntimeError, match="cuda"):
        EncodeService()
    with pytest.raises(RuntimeError, match="cuda"):
        bitplane_matrix([[1, 2]])
    for plugin, profile in (
        ("shec", {"k": "4", "m": "3", "c": "2"}),
        ("lrc", {"k": "4", "m": "2", "l": "3"}),
        ("clay", {"k": "4", "m": "2", "d": "5"}),
        ("jerasure", {"k": "4", "m": "2", "w": "7", "technique": "liberation"}),
        ("jerasure", {"k": "4", "m": "2", "technique": "blaum_roth", "w": "6"}),
        ("jerasure", {"k": "4", "technique": "liber8tion"}),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            factory(plugin, dict(profile))
        assert factory(plugin, dict(profile), device="cpu").device.type == "cpu"
    from ceph_tpu_torch.tools import ec_bench

    with pytest.raises(RuntimeError, match="cuda"):
        ec_bench.main(["-p", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3", "-s", "4096"])

    from ceph_tpu_torch.crush import torch_mapper
    from ceph_tpu_torch.crush.compiler import decompile_crushmap
    from ceph_tpu_torch.crush.tester import CrushTester
    from ceph_tpu_torch.tools import crush_bench, crushtool

    cmap = crush_bench.build_map(100)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_mapper.compile_map(cmap)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_mapper.compile_map_cached(cmap)
    with pytest.raises(RuntimeError, match="cuda"):
        CrushTester(cmap)
    path = tmp_path / "map.txt"
    path.write_text(decompile_crushmap(cmap))
    with pytest.raises(RuntimeError, match="cuda"):
        crushtool.main(["-i", str(path), "--test", "--num-rep", "3"])
    with pytest.raises(RuntimeError, match="cuda"):
        crush_bench.main(["--pgs", "16", "--osds", "100"])
    # the CPU is there when named
    assert CrushTester(cmap, device="cpu").device.type == "cpu"

    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.rados import MiniCluster
    from ceph_tpu_torch.tools import ec_non_regression

    with pytest.raises(RuntimeError, match="cuda"):
        MiniCluster(osdmap=OSDMap(crush=cmap, max_osd=cmap.max_devices))
    osdmap = OSDMap(crush=cmap, max_osd=cmap.max_devices)
    assert MiniCluster(osdmap=osdmap, device="cpu").osdmap.device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        factory("native", {"k": "4", "m": "2"})
    with pytest.raises(RuntimeError, match="cuda"):
        ec_non_regression.main(["--check"])

    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.rados.client import Rados
    from ceph_tpu_torch.tools import daemon_bench

    monmap = MonMap(addrs=[("127.0.0.1", 0)])
    with pytest.raises(RuntimeError, match="cuda"):
        OSDService(0, monmap)
    with pytest.raises(RuntimeError, match="cuda"):
        Monitor(0, monmap, osdmap)
    with pytest.raises(RuntimeError, match="cuda"):
        Rados("client.admin", monmap)
    with pytest.raises(RuntimeError, match="cuda"):
        daemon_bench.run(["--objects", "4"])
    assert OSDService(0, monmap, device="cpu").device.type == "cpu"
    assert Monitor(0, monmap, osdmap, device="cpu").device.type == "cpu"
    assert Rados("client.admin", monmap, device="cpu").objecter.device.type == "cpu"
    for flag in ("--mgr", "--recovery", "--chaos=1"):
        with pytest.raises(RuntimeError, match="cuda"):
            daemon_bench.run([flag])

    from ceph_tpu_torch.mgr import MgrService
    from ceph_tpu_torch.sim import run_chaos
    from ceph_tpu_torch.tools import chaos_tool

    with pytest.raises(RuntimeError, match="cuda"):
        run_chaos(1, steps=3)
    with pytest.raises(RuntimeError, match="cuda"):
        chaos_tool.LiveCluster(chaos_tool.chaos_config())
    with pytest.raises(RuntimeError, match="cuda"):
        chaos_tool.main(["--seed", "1", "--steps", "3"])
    with pytest.raises(RuntimeError, match="cuda"):
        MgrService("mgr.x", monmap)
    assert MgrService("mgr.x", monmap, device="cpu").device.type == "cpu"
    from ceph_tpu_torch.cephfs import MDSService

    with pytest.raises(RuntimeError, match="cuda"):
        MDSService("mds.x", monmap, 1)
    assert MDSService("mds.x", monmap, 1, device="cpu").device.type == "cpu"
    assert chaos_tool.LiveCluster(chaos_tool.chaos_config(), device="cpu").device.type == "cpu"

    import asyncio
    from types import SimpleNamespace

    from ceph_tpu_torch.ckpt import CkptStore
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.parallel import ec_mesh
    from ceph_tpu_torch.tools import ckpt_tool

    with pytest.raises(RuntimeError, match="cuda"):
        ec_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        ec_mesh(devices=["cuda:0"] * 4)
    assert ec_mesh(devices=["cpu"] * 4).shape == {"stripe": 2, "byte": 2}
    with pytest.raises(RuntimeError, match="cuda"):
        asyncio.run(CkptStore(SimpleNamespace(
            objecter=SimpleNamespace(config=Config()), pool_id=1, qos_class=None,
            read_policy=None), "x").restore())
    for cmd in (["bench", "--mb", "1"], ["restore", "x"], ["ls", "x"]):
        with pytest.raises(RuntimeError, match="cuda"):
            ckpt_tool.main(cmd)


def test_explicit_cpu_and_unknown_devices():
    from ceph_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
