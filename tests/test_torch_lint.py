"""Twins of the static linter: ceph_tpu_torch.lint against ceph_tpu.lint,
and the port's own lint gate.

Each corpus case of tests/test_lint.py (its snippets, the same source text)
is laid out twice under a scratch root: at `ceph_tpu/...` for the
reference's linter and at `ceph_tpu_torch/...` for the port's, a `tests/`
path staying `tests/` in both. The two reports must agree, tolerance 0:
every finding's check, path (package prefix mapped), line, column and
message, the suppression count and the summary. So must the baseline round
trips (what is new, baselined and stale; the written baseline's entries
but their fingerprints, which hash the path) and the CLI's exit codes and
JSON summaries.

The gate: the port lints clean against its own baseline,
`ceph_tpu_torch/tools/lint_baseline.json`, which is empty; the run's time is
reported, not budgeted.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from ceph_tpu.lint import cli as ref_cli
from ceph_tpu.lint import load_baseline as ref_load
from ceph_tpu.lint import run_lint as ref_run
from ceph_tpu.lint import write_baseline as ref_write
from ceph_tpu_torch.lint import cli as port_cli
from ceph_tpu_torch.lint import load_baseline, run_lint, write_baseline
from tests.test_lint import (
    BAD_ASYNC, BAD_DISPATCH, CLEAN_ASYNC, CLEAN_DISPATCH, SCHEMA_STUB,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"ref": "ceph_tpu", "port": "ceph_tpu_torch"}
LINTERS = {"ref": (ref_run, ref_load, ref_write, ref_cli),
           "port": (run_lint, load_baseline, write_baseline, port_cli)}
#: `{pkg}` in a relative path is the package's directory
MOD = "{pkg}/mod.py"
CONFIG_STUB = (SCHEMA_STUB[0].replace("ceph_tpu/", "{pkg}/"), SCHEMA_STUB[1])

OPEN_NESTED = """
    async def save(path, data):
        with open(path, "w") as fp:
            fp.write(data)
    async def outer():
        def inner():  # sync helper: its body is NOT async context
            import time
            time.sleep(1)
        return inner
"""
TASK_LEAK = """
    import asyncio
    async def fire():
        asyncio.create_task(work())     # leaked
    async def kept():
        t = asyncio.create_task(work())
        await t
"""
CLS_WALL = """
    import time
    def lock_op(ctx):
        return time.time()
"""
CLS_CLEAN = """
    def lock_op(ctx):
        return ctx.now
"""
TEST_SLEEPS = """
    import asyncio, time
    def test_x():
        time.sleep(0.2)
    async def test_y():
        await asyncio.sleep(0)   # yield point: allowed
"""
SLOW_SLEEPS = """
    import time
    import pytest
    @pytest.mark.slow
    def test_long():
        time.sleep(1)
"""
KNOB_READS = """
    def f(config):
        config.get("declared_knob")
        config.get("mystery_knob")
"""
KNOB_OTHER = """
    def f(cache):
        cache.get("mystery_knob")
"""
PERF_BUMP = """
    def make(perf):
        perf.add_u64_counter("declared", "d")
    def f(perf):
        perf.inc("declared")
        perf.inc("never_declared")
"""
PERF_LOOP = """
    def make(perf):
        perf.add_u64_counter("plain", "d")
        for key, desc in (("looped_a", "d"), ("looped_b", "d")):
            perf.add_u64_counter(key, desc)
    def f(perf):
        perf.inc("plain")
        perf.inc("looped_a")
        perf.inc("looped_b")
"""
ERR_SWALLOW = """
    def f():
        try:
            g()
        except Exception:
            pass
"""
ERR_REPORTING = """
    import asyncio
    def f(log, errors):
        try:
            g()
        except Exception as e:
            errors.append(str(e))      # uses the exception
        try:
            g()
        except Exception:
            raise                       # re-raises
        try:
            g()
        except (asyncio.CancelledError, Exception):
            pass                        # shutdown-drain idiom
"""
ERR_FATAL = """
    def f(log):
        try:
            g()
        except StoreFatalError as e:
            log.error("fatal: %s", e)   # logged but NOT re-raised
"""
SUPPRESS_LINES = """
    import time
    async def a():
        time.sleep(1)  # cephlint: disable=async-blocking
    async def b():
        # cephlint: disable=async-blocking (boot-time write)
        time.sleep(1)
    async def c():
        time.sleep(1)
"""
SUPPRESS_FILE = """
    # cephlint: disable-file=async-blocking
    import time
    async def a():
        time.sleep(1)
"""
SUPPRESS_OTHER = """
    import time
    async def a():
        time.sleep(1)  # cephlint: disable=task-leak
"""

#: (id, source, check, path, extra files): tests/test_lint.py's corpus cases
CASES = [
    ("async-bad", BAD_ASYNC, "async-blocking", MOD, ()),
    ("async-clean", CLEAN_ASYNC, "async-blocking", MOD, ()),
    ("async-outside-the-package", BAD_ASYNC, "async-blocking", "tests/mod.py", ()),
    ("async-open-and-nested-def", OPEN_NESTED, "async-blocking", MOD, ()),
    ("task-leak", TASK_LEAK, "task-leak", MOD, ()),
    ("clock-cls-wall-clock", CLS_WALL, "clock-discipline", "{pkg}/osd/cls.py", ()),
    ("clock-cls-clean", CLS_CLEAN, "clock-discipline", "{pkg}/osd/cls.py", ()),
    ("clock-test-sleeps", TEST_SLEEPS, "clock-discipline", "tests/test_mod.py", ()),
    ("clock-slow-tests-may-sleep", SLOW_SLEEPS, "clock-discipline", "tests/test_mod.py", ()),
    ("knob-read-undeclared", KNOB_READS, "knob-registry", MOD, (CONFIG_STUB,)),
    ("knob-non-config-receiver", KNOB_OTHER, "knob-registry", MOD, (CONFIG_STUB,)),
    ("perf-bump-without-declare", PERF_BUMP, "perf-counter", MOD, ()),
    ("perf-declared-loop-idiom", PERF_LOOP, "perf-counter", MOD, ()),
    ("error-silent-swallow", ERR_SWALLOW, "error-taxonomy", MOD, ()),
    ("error-reporting-handlers", ERR_REPORTING, "error-taxonomy", MOD, ()),
    ("error-store-fatal", ERR_FATAL, "error-taxonomy", MOD, ()),
    ("error-outside-the-package", ERR_SWALLOW, "error-taxonomy", "tests/mod.py", ()),
    ("dispatch-bad", BAD_DISPATCH, "dispatch-blocking", MOD, ()),
    ("dispatch-clean", CLEAN_DISPATCH, "dispatch-blocking", MOD, ()),
    ("dispatch-outside-the-package", BAD_DISPATCH, "dispatch-blocking", "tests/mod.py", ()),
    ("suppression-inline-and-above", SUPPRESS_LINES, "async-blocking", MOD, ()),
    ("suppression-file", SUPPRESS_FILE, "async-blocking", MOD, ()),
    ("suppression-per-check", SUPPRESS_OTHER, "async-blocking", MOD, ()),
]


def lay_out(root, side: str, src: str, path: str, extra=()) -> list[str]:
    """Writes `src` at `path` (and the `extra` files) under `root`, the
    package directory named for `side`; returns the relative paths."""
    paths = []
    for rel, body in ((path, src), *extra):
        rel = rel.format(pkg=PKG[side])
        target = root / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_text(textwrap.dedent(body))
        paths.append(rel)
    return paths


def masked(side: str, value):
    """`value` with this side's package name replaced by `<pkg>`."""
    return json.loads(json.dumps(value, sort_keys=True).replace(PKG[side], "<pkg>"))


def view(side: str, rep) -> dict:
    return masked(side, {
        "findings": [(f.check, f.path, f.line, f.col, f.message) for f in rep.findings],
        "new": len(rep.new), "baselined": len(rep.baselined),
        "stale": len(rep.stale_baseline), "suppressed": rep.suppressed,
        "summary": rep.summary()})


def lint_both(tmp_path, src, check, path, extra=(), baseline=None) -> dict:
    """Each side's masked report of `src`, against that side's `baseline`
    entries (a dict side -> entries) if given."""
    out = {}
    for side, (run, *_rest) in LINTERS.items():
        root = tmp_path / side
        paths = lay_out(root, side, src, path, extra)
        rep = run(paths, root=str(root), only={check},
                  baseline=None if baseline is None else baseline[side])
        out[side] = (view(side, rep), rep)
    return out


@pytest.mark.parametrize("src,check,path,extra", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_corpus_case_matches_ceph_tpu(tmp_path, src, check, path, extra):
    both = lint_both(tmp_path, src, check, path, extra)
    assert both["port"][0] == both["ref"][0]


def baselines(tmp_path, reports: dict) -> dict:
    """Each side's report's findings written as its baseline and read back."""
    out = {}
    for side, (_view, rep) in reports.items():
        _run, load, write, _cli = LINTERS[side]
        path = tmp_path / f"{side}-baseline.json"
        write(str(path), rep.findings)
        out[side] = load(str(path))
    return out


@pytest.mark.parametrize("second", ["same", "drifted", "cleaned"])
def test_baseline_round_trip_matches_ceph_tpu(tmp_path, second):
    """tests/test_lint.py's round trip, line-drift and stale-entry cases:
    the baseline written from a bad file, then the same file, the file
    shifted two lines down, or its clean twin linted against it."""
    first = lint_both(tmp_path, BAD_ASYNC, "async-blocking", MOD)
    saved = baselines(tmp_path, first)
    entries = {side: [{k: v for k, v in e.items() if k != "fingerprint"} for e in saved[side]]
               for side in saved}
    assert masked("port", entries["port"]) == masked("ref", entries["ref"])
    assert len(entries["port"]) == 1
    src = {"same": BAD_ASYNC, "drifted": "x = 1\ny = 2\n" + textwrap.dedent(BAD_ASYNC),
           "cleaned": CLEAN_ASYNC}[second]
    again = lint_both(tmp_path, src, "async-blocking", MOD, baseline=saved)
    assert again["port"][0] == again["ref"][0]
    assert again["port"][0]["new"] == 0


@pytest.mark.parametrize("argv,src", [
    (["--no-baseline", "--json"], BAD_ASYNC),
    (["--no-baseline"], CLEAN_ASYNC),
    (["--baseline-update"], BAD_ASYNC),
], ids=["json-bad", "clean", "baseline-update"])
def test_cli_matches_ceph_tpu(tmp_path, capsys, argv, src):
    """tests/test_lint.py's CLI cases: the exit codes and the JSON summary;
    after `--baseline-update` a run against the baseline exits 0."""
    out = {}
    for side, (_run, _load, _write, cli) in LINTERS.items():
        root = tmp_path / side
        lay_out(root, side, src, MOD)
        extra = [] if "--no-baseline" in argv else ["--baseline", str(root / "baseline.json")]
        rc = cli.main([PKG[side], "--root", str(root), *argv, *extra])
        text = capsys.readouterr().out
        summary = json.loads(text) if "--json" in argv else None
        if summary:
            summary.pop("seconds")
        again = None
        if "--baseline-update" in argv:
            again = cli.main([PKG[side], "--root", str(root), *extra])
            capsys.readouterr()
        out[side] = (rc, masked(side, summary), again)
    assert out["port"] == out["ref"]
    assert out["port"][0] == (1 if src is BAD_ASYNC and "--no-baseline" in argv else 0)


def test_port_is_lint_clean():
    """The port's gate: `ceph_tpu_torch` has no new findings and no stale
    baseline entries against its own baseline, which is empty."""
    baseline = load_baseline(os.path.join(REPO, "ceph_tpu_torch", "tools", "lint_baseline.json"))
    assert baseline == []
    t0 = time.monotonic()
    rep = run_lint(["ceph_tpu_torch"], root=REPO, baseline=baseline)
    elapsed = time.monotonic() - t0
    assert rep.new == [] and rep.stale_baseline == [], (
        f"cephlint over ceph_tpu_torch ({elapsed:.1f} s): fix each finding or suppress it in "
        "place with a reason:\n" + "\n".join(f.render() for f in rep.new))
    assert rep.files > 100 and len(rep.checks) == 8


def test_lint_tool_exits_zero_on_the_port():
    proc = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.tools.lint", "--json"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout)
    assert summary["new"] == 0 and summary["baseline_size"] == 0, summary
