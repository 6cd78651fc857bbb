"""The port's crushtool (python -m ceph_tpu_torch.tools.crushtool) and
CrushTester against tools/crushtool.py and ceph_tpu.crush.tester: the same
flags on the same text map give byte-identical standard output, with the
port mapping on the CPU (--device cpu). Also the port's crush_bench at a
small size, and the tester's scalar path for rules the batched path
refuses."""

import contextlib
import io
import json

import numpy as np
import pytest

import tools.crushtool as jax_crushtool
from ceph_tpu.crush import builder as jb
from ceph_tpu.crush.tester import CrushTester as JaxTester
from ceph_tpu.crush.types import BucketAlg as JAlg
from ceph_tpu.crush.types import CrushMap as JMap
from ceph_tpu.crush.types import Tunables as JTunables
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import Tunables
from ceph_tpu_torch.tools import crush_bench
from ceph_tpu_torch.tools import crushtool
from tests.test_device_classes import CLASSED_MAP
from tests.test_torch_crush import to_port


def text_map(n_hosts=6, per_host=3) -> str:
    """straw2 hosts under one root, a replicated and an erasure rule."""
    lines = [f"tunable {k} {v}" for k, v in (
        ("choose_local_tries", 0), ("choose_local_fallback_tries", 0),
        ("choose_total_tries", 50), ("chooseleaf_descend_once", 1),
        ("chooseleaf_vary_r", 1), ("chooseleaf_stable", 1),
        ("straw_calc_version", 1))]
    lines.append("")
    n_osds = n_hosts * per_host
    lines += [f"device {i} osd.{i}" for i in range(n_osds)]
    lines += ["", "type 0 osd", "type 1 host", "type 10 root", ""]
    rng = np.random.default_rng(7)
    host_weights = []
    for h in range(n_hosts):
        ws = [float(rng.integers(1, 5)) for _ in range(per_host)]
        host_weights.append(sum(ws))
        lines += [f"host host{h} {{", f"\tid {-2 - h}", "\talg straw2", "\thash 0"]
        lines += [f"\titem osd.{h * per_host + i} weight {w:.3f}" for i, w in enumerate(ws)]
        lines.append("}")
    lines += ["root default {", "\tid -1", "\talg straw2", "\thash 0"]
    lines += [f"\titem host{h} weight {w:.3f}" for h, w in enumerate(host_weights)]
    lines.append("}")
    for rid, (name, kind, mode) in enumerate(
            (("replicated_rule", "replicated", "firstn"), ("ec_rule", "erasure", "indep"))):
        lines += ["", f"rule {name} {{", f"\tid {rid}", f"\ttype {kind}",
                  "\tmin_size 1", "\tmax_size 10", "\tstep take default",
                  f"\tstep chooseleaf {mode} 0 type host", "\tstep emit", "}"]
    return "\n".join(lines) + "\n"


def run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


TEST_FLAGS = ["--test", "--show-statistics", "--show-mappings",
              "--show-bad-mappings", "--show-utilization",
              "--min-x", "0", "--max-x", "199", "--weight", "4", "0.5"]


@pytest.mark.parametrize("pool", [None, "5"])
@pytest.mark.parametrize("which", ["text", "classed"])
def test_crushtool_test_output_byte_identical(tmp_path, which, pool):
    path = tmp_path / "map.txt"
    path.write_text(text_map() if which == "text" else CLASSED_MAP)
    flags = ["-i", str(path), *TEST_FLAGS, "--num-rep", "4"]
    if pool:
        flags += ["--pool-id", pool]
    rc, want = run(jax_crushtool.main, flags)
    got_rc, got = run(crushtool.main, flags + ["--device", "cpu"])
    assert (got_rc, got) == (rc, want)
    assert got.count("CRUSH rule") >= 200 and "result size" in got


def test_crushtool_compile_decompile_tree(tmp_path):
    src = tmp_path / "map.txt"
    src.write_text(text_map())
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    assert run(crushtool.main, ["-c", str(src), "-o", str(ours)])[0] == 0
    assert run(jax_crushtool.main, ["-c", str(src), "-o", str(theirs)])[0] == 0
    assert ours.read_text() == theirs.read_text()
    for flags in (["-d", str(ours)], ["-i", str(ours), "--tree"]):
        assert run(crushtool.main, flags) == run(jax_crushtool.main, flags)
    # both rules mapped from the stored form, over a range of rep counts
    flags = ["-i", str(ours), "--test", "--show-statistics", "--max-x", "99",
             "--min-x", "0", "--min-rep", "2", "--max-rep", "3"]
    assert run(crushtool.main, flags + ["--device", "cpu"]) == run(jax_crushtool.main, flags)


def test_tester_sends_refused_rules_to_the_scalar_mapper():
    """A legacy (list) bucket under rule 1 only: rule 0 maps batched, rule 1
    through the scalar mapper, and the output equals the JAX package's."""
    jmap = JMap(tunables=JTunables.jewel())
    ids, ws = [], []
    for h in range(4):
        b = jb.make_bucket(jmap, -2 - h, JAlg.STRAW2, 1, [2 * h, 2 * h + 1],
                           [0x10000, 0x20000])
        ids.append(b.id)
        ws.append(b.weight)
    jb.make_bucket(jmap, -1, JAlg.STRAW2, 10, ids, ws)
    legacy = jb.make_bucket(jmap, -10, JAlg.LIST, 1, [8, 9], [0x10000] * 2)
    jb.make_bucket(jmap, -11, JAlg.STRAW2, 10, [legacy.id], [legacy.weight])
    jb.make_simple_rule(jmap, 0, -1, 1, "firstn", 0)
    jb.make_simple_rule(jmap, 1, -11, 1, "firstn", 0)
    jmap.max_devices = 10

    def tester(cls, m, **kw):
        buf = io.StringIO()
        t = cls(m, min_x=0, max_x=99, min_rep=2, max_rep=2, out=buf,
                output_mappings=True, output_statistics=True, **kw)
        t.test()
        return t, buf.getvalue()

    ours, out = tester(CrushTester, to_port(jmap), device="cpu")
    assert out == tester(JaxTester, jmap)[1]
    assert ours.scalar_rules == 1 and ours.map_seconds > 0


@pytest.mark.parametrize("mode,replicas", [("firstn", "3"), ("indep", "4")])
def test_crush_bench_runs_on_cpu(mode, replicas):
    rc, out = run(crush_bench.main, ["--pgs", "4096", "--osds", "200", "--device",
                                     "cpu", "--repeats", "1", "--mode", mode,
                                     "--replicas", replicas])
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["device"] == "cpu" and line["mode"] == mode
    assert line["value"] > 0 and line["placed"] == 4096 * int(replicas)
    cmap = crush_bench.build_map(200, mode=mode)
    assert len(cmap.buckets) == 5 and cmap.tunables == Tunables.jewel()
