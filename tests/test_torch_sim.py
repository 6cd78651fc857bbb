"""The port's placement simulator and CLIs against the JAX package's, on the
CPU, tolerance 0: `run_scenario` reports equal dict for dict; psim's
scenario mode (on test_psim.py's MINI cluster) and map-file mode, and the
osdmaptool commands (--createsimple, --print, --tree, --test-map-pgs[-dump],
--test-map-object, --mark-out, --upmap), print byte-identical output and
write byte-identical files. Entry points left on their default device raise
without a card instead of running on the CPU."""

import contextlib
import io
import json

import pytest
import torch

import tools.osdmaptool as jax_osdmaptool
import tools.psim as jax_psim
from ceph_tpu.sim import run_scenario as jax_run_scenario
from ceph_tpu_torch.sim import build_cluster, run_scenario
from ceph_tpu_torch.tools import osdmaptool, psim

MINI = ["--scenario", "--osds", "32", "--osds-per-host", "4",
        "--rep-pgs", "128", "--ec-pgs", "32", "--epochs", "2",
        "--seed", "3", "--max-changes", "64"]
CPU = ["--device", "cpu"]


def run(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


SCENARIOS = {
    "mini-balanced": dict(n_osd=32, osds_per_host=4, rep_pg_num=128, ec_pg_num=32,
                          seed=3, epochs=2, max_changes=64),
    "no-balance": dict(n_osd=16, rep_pg_num=64, ec_pg_num=0, epochs=1, seed=9,
                       balance_after=False),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_scenario_report_matches_jax(name):
    got = run_scenario(device="cpu", **SCENARIOS[name])
    want = jax_run_scenario(**SCENARIOS[name])
    assert got == want
    assert ("balance" in got) == (name == "mini-balanced")


@pytest.mark.parametrize("extra", [["--json"], []], ids=["json", "human"])
def test_psim_scenario_output_is_byte_identical(extra):
    rc, got = run(psim.main, MINI + extra + CPU)
    jrc, want = run(jax_psim.main, MINI + extra)
    assert rc == jrc == 0
    assert got == want
    if extra:
        report = json.loads(got)
        assert report["pg_instances"] == 128 * 3 + 32 * 6 and "timing" not in report


def test_psim_measure_adds_timing():
    rc, out = run(psim.main, MINI + ["--json", "--measure"] + CPU)
    timing = json.loads(out)["timing"]
    assert rc == 0 and timing["pgs_mapped"] == (128 + 32) * 3
    assert timing["pgs_mapped_per_s"] > 0 and "score_seconds" in timing


@pytest.fixture
def mapfile(tmp_path):
    path = str(tmp_path / "om.json")
    assert jax_osdmaptool.main([path, "--createsimple", "16", "--with-default-pool",
                                "--pg-bits", "3"]) == 0
    return path


def test_psim_mapfile_mode_is_byte_identical(mapfile, monkeypatch):
    monkeypatch.setattr(psim, "FILES", 200)
    monkeypatch.setattr(jax_psim, "FILES", 200)
    rc, got = run(psim.main, [mapfile] + CPU)
    jrc, want = run(jax_psim.main, [mapfile])
    assert rc == jrc == 0 and got == want
    assert got.count("osd.") == 16


@pytest.mark.parametrize("flags", [
    ["--pg-bits", "3", "--with-default-pool"],
    ["--pg-bits", "5"],
], ids=["default-pool", "no-pool"])
def test_createsimple_files_are_identical(tmp_path, flags):
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    rc, out = run(osdmaptool.main, [a, "--createsimple", "20"] + flags)
    jrc, jout = run(jax_osdmaptool.main, [b, "--createsimple", "20"] + flags)
    assert rc == jrc == 0 and out.replace(a, b) == jout
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()


OSDMAPTOOL_COMMANDS = {
    "print": ["--print"],
    "tree": ["--tree"],
    "test-map-pgs": ["--test-map-pgs"],
    "test-map-pgs-dump": ["--test-map-pgs-dump", "--pool", "1"],
    "test-map-object": ["--test-map-object", "foo"],
    "mark-out": ["--mark-out", "5", "--test-map-pgs"],
    "upmap": ["--upmap", "-", "--upmap-deviation", "2", "--upmap-max", "50"],
}


@pytest.mark.parametrize("name", list(OSDMAPTOOL_COMMANDS))
def test_osdmaptool_output_is_byte_identical(mapfile, tmp_path, name):
    twin = str(tmp_path / "twin.json")
    with open(mapfile) as f, open(twin, "w") as g:
        g.write(f.read())
    args = OSDMAPTOOL_COMMANDS[name]
    rc, got = run(osdmaptool.main, [mapfile] + args + CPU)
    jrc, want = run(jax_osdmaptool.main, [twin] + args)
    assert rc == jrc == 0
    assert got.replace(mapfile, twin) == want
    with open(mapfile) as f, open(twin) as g:
        assert f.read() == g.read()  # --mark-out saves the map: the same map
    if name == "upmap":
        assert got.startswith("ceph osd pg-upmap-items 1.")


def test_osdmaptool_upmap_save_writes_the_same_map(mapfile, tmp_path):
    twin = str(tmp_path / "twin.json")
    with open(mapfile) as f, open(twin, "w") as g:
        g.write(f.read())
    cmds, jcmds = str(tmp_path / "cmds.txt"), str(tmp_path / "jcmds.txt")
    base = ["--upmap-deviation", "1", "--upmap-max", "20", "--upmap-save"]
    assert run(osdmaptool.main, [mapfile, "--upmap", cmds] + base + CPU)[0] == 0
    assert run(jax_osdmaptool.main, [twin, "--upmap", jcmds] + base)[0] == 0
    with open(cmds) as a, open(jcmds) as b:
        text = a.read()
        assert text == b.read() and text.count("\n") > 0
    with open(mapfile) as a, open(twin) as b:
        assert a.read() == b.read()


def test_default_device_raises_without_a_card(mapfile):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    m = build_cluster(16, rep_pg_num=64)
    with pytest.raises(RuntimeError, match="cuda"):
        m.pool_mappings(1)
    with pytest.raises(RuntimeError, match="cuda"):
        m.calc_pg_upmaps()
    with pytest.raises(RuntimeError, match="cuda"):
        run_scenario(n_osd=16, rep_pg_num=64, ec_pg_num=0, epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        run(psim.main, MINI)
    with pytest.raises(RuntimeError, match="cuda"):
        run(osdmaptool.main, [mapfile, "--test-map-pgs"])
    # the CPU is there when named
    assert build_cluster(16, rep_pg_num=64, device="cpu").pool_mappings(1).shape == (64, 3)
