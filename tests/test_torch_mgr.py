"""Twins of the manager modules and their tools: the port's mgr/metrics,
mgr/traces, mgr/prometheus, mgr/autoscaler, mgr/dashboard, tools/ceph_top
and tools/trace_tool against ceph_tpu's.

Two kinds of twin. The reference's own pure cases
(`tests/test_mgr_metrics.py` and the unit tier of `tests/test_trace_tail.py`)
run once more with their imports pointed at the port. And the same seeded
inputs (daemon perf reports with counter resets, histograms and status
blocks; promoted trace fragments; perf dumps; pool stats; Jaeger span files;
top documents) go through both packages, whose outputs must be equal: SLO
verdicts, health checks, the top and SLO documents, the Prometheus text,
the trace listings, the autoscaler's proposals, the dashboard document, and
the tools' printed bytes. Nothing here touches a device or a socket.
"""

import asyncio
import contextlib
import importlib
import io
import json
import os
import re
import types

import numpy as np
import pytest

from ceph_tpu.osd.osdmap import encode_osdmap
from ceph_tpu.vstart import initial_osdmap

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
TESTS = os.path.dirname(os.path.abspath(__file__))

#: the reference's pure cases: no cluster, no socket, no fixture
REFERENCE_CASES = {
    "test_mgr_metrics.py": (
        "test_rate_oracle_full_and_windowed", "test_gauge_and_time_avg_aggregations",
        "test_ring_eviction_at_window_bound", "test_counter_reset_reprimes_no_negative_rate",
        "test_unknown_daemon_report_primes_baseline", "test_failover_baseline_reset",
        "test_histogram_percentiles_oracle", "test_slo_rule_grammar",
        "test_slo_violation_to_health_check_round_trip", "test_slo_ratio_rule",
        "test_top_document_rows_and_age_out", "test_prune_drops_long_silent_daemons",
    ),
    "test_trace_tail.py": (
        "test_slow_op_promotes_with_exemplar", "test_error_tags_promote_regardless_of_duration",
        "test_capture_predicates_budget_per_window", "test_slowest_n_promotes_on_window_roll",
        "test_relay_promote_dedups_and_adopts_foreign_spans",
        "test_collector_merges_fragments_across_daemons", "test_collector_bounds_and_ttl",
        "test_capture_predicates_from_violated_slos", "test_exemplar_attaches_to_covering_bucket",
        "test_exporter_renders_openmetrics_exemplar_line",
        "test_critical_report_aggregates_stage_contributions",
        "test_op_tracker_keeps_slowest_by_duration",
    ),
}

_PORTED: dict[str, dict] = {}


def reference_module_on_the_port(fname: str) -> dict:
    """The reference test file's namespace with every import of ceph_tpu
    (and of the tools) pointed at the port; strings and
    assertions are left as they are."""
    if fname not in _PORTED:
        with open(os.path.join(TESTS, fname), encoding="utf-8") as f:
            src = f.read()
        src = re.sub(r"^(\s*)(from|import) ceph_tpu\.", r"\1\2 ceph_tpu_torch.", src,
                     flags=re.M)
        src = re.sub(r"^(\s*)from tools\.", r"\1from ceph_tpu_torch.tools.", src, flags=re.M)
        assert not re.search(r"^\s*(from|import) (ceph_tpu|tools)\b(?!_torch)", src, flags=re.M)
        ns = {"__name__": f"tests.port_twin_{fname[:-3]}"}
        exec(compile(src, os.path.join(TESTS, fname), "exec"), ns)
        _PORTED[fname] = ns
    return _PORTED[fname]


@pytest.mark.parametrize("fname,case", [(f, c) for f, cs in REFERENCE_CASES.items()
                                        for c in cs])
def test_reference_case_on_the_port(fname, case):
    reference_module_on_the_port(fname)[case]()


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- seeded inputs ---------------------------------------------------------------

SLO_RULES = ("op_w.rate < 30 @ 4; lat_us_osd_op.p99 < 3000; osd_queue_depth.avg < 5 @ 6; "
             "read_redirected/read_balanced < 0.05; l_op_total.avg < 20ms")


def seeded_reports(seed: int, daemons: int = 4, ticks: int = 12) -> list[tuple[float, dict]]:
    """(now, report) pairs in arrival order: cumulative counters with one
    counter reset, TIME_AVG pairs, log2 latency histograms, status blocks
    with pool ops, an exemplar, and one daemon that goes silent."""
    rng = np.random.default_rng(seed)
    out = []
    totals = {d: {"op_w": 0, "op_r": 0, "op_rw": 0, "op_in_bytes": 0, "op_out_bytes": 0,
                  "read_redirected": 0, "read_balanced": 0, "cnt": 0, "sum": 0.0}
              for d in range(daemons)}
    hist = {d: {} for d in range(daemons)}
    for t in range(ticks):
        for d in range(daemons):
            if d == daemons - 1 and t > ticks // 2:
                continue  # the last daemon goes silent half way
            tot = totals[d]
            if d == 1 and t == ticks // 3:
                tot.update(op_w=0, op_in_bytes=0)  # a restart resets counters
            w = int(rng.integers(0, 60))
            tot["op_w"] += w
            tot["op_r"] += int(rng.integers(0, 40))
            tot["op_rw"] += int(rng.integers(0, 5))
            tot["op_in_bytes"] += w * int(rng.integers(512, 8192))
            tot["op_out_bytes"] += int(rng.integers(0, 1 << 20))
            tot["read_balanced"] += int(rng.integers(10, 100))
            tot["read_redirected"] += int(rng.integers(0, 8))
            tot["cnt"] += w
            tot["sum"] += float(w * rng.uniform(0.001, 0.04))
            for _ in range(w):
                b = str(1 << int(rng.integers(3, 13)))
                hist[d][b] = hist[d].get(b, 0) + 1
            name = f"osd.{d}"
            report = {
                "daemon": name, "seq": t + 1, "full": t == 0,
                "counters": {
                    name: {k: tot[k] for k in ("op_w", "op_r", "op_rw", "op_in_bytes",
                                               "op_out_bytes", "read_redirected",
                                               "read_balanced")}
                    | {"osd_queue_depth": int(rng.integers(0, 9)),
                       "l_op_total": {"avgcount": tot["cnt"], "sum": round(tot["sum"], 6)}},
                    "tracer": {"lat_us_osd_op": dict(hist[d])},
                },
                "status": {"queue_depth": int(rng.integers(0, 9)),
                           "inflight_ops": int(rng.integers(0, 4)),
                           "pool_ops": {"1": tot["op_w"], "2": tot["op_r"]},
                           "degraded_objects": int(rng.integers(0, 3)),
                           "recovering": bool(rng.integers(0, 2))},
            }
            if t == ticks - 2:
                report["exemplars"] = {"lat_us_osd_op": {"trace_id": f"tr{d}",
                                                         "value": 700 + d, "ts": float(t)}}
            out.append((float(t) + 0.1 * d, report))
    return out


def fed_metrics(pkg: str, seed: int, exemplars: bool = False):
    Config = mod(pkg, "common.config").Config
    cfg = Config()
    cfg.set("mgr_metrics_window", 8)
    cfg.set("mgr_report_interval", 1.0)
    cfg.set("mgr_slo_rules", SLO_RULES)
    cfg.set("mgr_prometheus_exemplars", exemplars)
    m = mod(pkg, "mgr.metrics").MetricsModule(cfg)
    for now, report in seeded_reports(seed):
        m.ingest(json.loads(json.dumps(report)), now=now)
    return m


def package_map(pkg: str):
    """The genesis map of 6 OSDs with a replicated and an EC pool, osd.5
    down; the port's carried across as encode_osdmap bytes."""
    from ceph_tpu.osd.types import TYPE_ERASURE, TYPE_REPLICATED, PgPool

    base = initial_osdmap(6)
    base.pools[1] = PgPool(type=TYPE_REPLICATED, size=3, pg_num=8, crush_rule=1)
    base.pools[2] = PgPool(type=TYPE_ERASURE, size=4, pg_num=8, crush_rule=0)
    base.mark_down(5)
    base.epoch = 17
    if pkg == REF:
        return base
    return mod(PORT, "osd.osdmap").decode_osdmap(encode_osdmap(base), device="cpu")


class FakeObjecter:
    """The objecter surface the modules read: a map, monitor commands and
    OSD admin commands, answered from seeded documents."""

    def __init__(self, pkg: str, seed: int, health: dict | None = None):
        rng = np.random.default_rng(seed)
        self.osdmap = package_map(pkg)
        self.sent: list = []
        self._health = health or {"status": "HEALTH_WARN", "checks": {
            "OSD_DOWN": {"severity": "HEALTH_WARN", "count": 1, "detail": ["osd.5 down"]},
            "PG_DEGRADED": {"severity": "HEALTH_WARN", "count": 3, "detail": []}}}
        self._stats = {o: {str(p): {"objects": int(rng.integers(0, 500)),
                                    "bytes": int(rng.integers(0, 1 << 30))}
                           for p in (1, 2)} for o in range(6)}
        self._perf = {o: {f"osd.{o}": {
            "op_w": int(rng.integers(0, 1000)), "op_r": int(rng.integers(0, 1000)),
            "l_op_total": {"avgcount": int(rng.integers(1, 100)), "sum": 0.25 * o},
            "lat_us_osd_op": {str(1 << b): int(rng.integers(0, 9)) for b in range(2, 9)},
            "name_str": "skipped"},
            "throttle-bytes": {"val": int(rng.integers(0, 1 << 20))}} for o in range(6)}
        self.mon = types.SimpleNamespace(command=self._mon_command)

    async def _mon_command(self, name, args=None, timeout=None):
        self.sent.append((name, args))
        docs = {
            "health": self._health,
            "status": {"epoch": self.osdmap.epoch, "quorum": [0, 1, 2]},
            "df": {"total_bytes": 6 << 30, "used_bytes": 123456},
            "fs map": {"fsmap": {"epoch": 1, "filesystems": []}},
            "mgr map": {"mgrmap": {"active": "mgr.0", "standbys": ["mgr.1"]}},
            "osd pool set": {"ok": True},
        }
        return docs[name]

    async def osd_admin(self, osd, cmd, args=None, timeout=None):
        if osd == 3 and cmd == "pool_stats":
            raise RuntimeError("osd.3 restarting")  # skipped this pass
        return {"pool_stats": self._stats, "perf dump": self._perf}[cmd][osd]


def both(fn):
    return fn(REF), fn(PORT)


# -- metrics -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 7, 12345])
def test_metrics_documents_equal_ceph_tpu(seed):
    def run(pkg):
        m = fed_metrics(pkg, seed)
        now = 11.5
        out = {"slos": m.evaluate_slos(now=now), "checks": m.health_checks(now=now),
               "top": m.top_document(now=now), "slo": m.slo_document(now=now),
               "recovery": m.recovery_status(now=now),
               "rates": list(m.series_rates()), "latest": list(m.latest_blocks()),
               "fresh": sorted(m.fresh_daemons(now=now))}
        for daemon in ("osd.0", "osd.1", "osd.3"):
            for key, agg, window in (("op_w", "rate", None), ("op_w", "rate", 3.0),
                                     ("osd_queue_depth", "avg", 4.0),
                                     ("l_op_total", "avg", None),
                                     ("lat_us_osd_op", "p50", None),
                                     ("lat_us_osd_op", "p99", 5.0)):
                out[f"{daemon} {key} {agg} {window}"] = m.aggregate(daemon, key, agg, window,
                                                                    now=now)
        out["ratio"] = m.ratio("osd.2", "read_redirected", "read_balanced", 5.0, now=now)
        m.prune(now=now + 1000.0)
        out["pruned"] = sorted(m.daemons)
        return json.dumps(out, sort_keys=True, default=repr)

    ref, port = both(run)
    assert port == ref


def test_slo_rules_parse_equal_ceph_tpu():
    text = SLO_RULES + "; garbage; x.p42 < 1; a.avg <= 250us; b.p95 >= 2s @ 30"

    def run(pkg):
        errors = []
        rules = mod(pkg, "mgr.metrics").parse_slo_rules(text, on_error=errors.append)
        return [repr(vars(r)) for r in rules], errors

    ref, port = both(run)
    assert port == ref
    assert len(ref[0]) == 7 and ref[1]  # the five SLO_RULES, a and b; two refused


# -- traces ------------------------------------------------------------------------


def seeded_fragments(seed: int) -> list[tuple[float, str, list[dict]]]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        tid = f"t{int(rng.integers(0, 14)):02d}"
        daemon = f"osd.{int(rng.integers(0, 4))}"
        spans = []
        for j in range(int(rng.integers(1, 4))):
            sid = f"{tid}-{int(rng.integers(0, 6))}"
            spans.append({"trace_id": tid, "span_id": sid,
                          "parent_id": None if j == 0 else f"{tid}-0",
                          "name": ["op_submit", "osd_op", "journal_commit"][j],
                          "service": daemon, "start": float(rng.uniform(0, 5)),
                          "duration": float(rng.uniform(0.001, 0.5)),
                          "tags": {"pool": int(rng.integers(1, 3))}, "events": []})
        reason = ["slow", "error", "slowest_n", "slo:lat rule"][int(rng.integers(0, 4))]
        out.append((float(i), daemon, [{"trace_id": tid, "reason": reason, "spans": spans}]))
    return out


@pytest.mark.parametrize("seed", [1, 7])
def test_trace_collector_equal_ceph_tpu(seed):
    def run(pkg):
        cfg = mod(pkg, "common.config").Config()
        cfg.set("mgr_trace_store_max", 9)
        cfg.set("mgr_trace_ttl", 25.0)
        tc = mod(pkg, "mgr.traces").TraceCollector(cfg)
        out = []
        for now, daemon, promoted in seeded_fragments(seed):
            tc.ingest(daemon, json.loads(json.dumps(promoted)), now=now)
        out.append(tc.ls_document())
        out.append(tc.recent())
        out.append(tc.recent(limit=3))
        for tid in sorted(t["trace_id"] for t in tc.ls_document()["traces"]):
            out.append(tc.show(tid))
        slos = fed_metrics(pkg, seed).evaluate_slos(now=11.5)
        out.append(tc.capture_predicates(slos))
        out.append(tc.capture_predicates(slos))
        out.append((tc.predicate_version, tc.predicates))
        tc.prune(now=50.0)
        out.append((len(tc), tc.ls_document()))
        tc.reset()
        out.append(tc.ls_document())
        return json.dumps(out, sort_keys=True)

    # a listing's "age" is the wall clock less the trace's ingest time
    ref, port = (re.sub(r'"age": [0-9.e+-]+', '"age": 0', t) for t in both(run))
    assert port == ref
    assert '"age"' in ref


# -- prometheus, autoscaler, dashboard -------------------------------------------------


@pytest.mark.parametrize("source", ["store", "store+exemplars", "pull", "pull, no mon"])
def test_prometheus_text_equal_ceph_tpu(source):
    def run(pkg):
        objecter = FakeObjecter(pkg, 3)
        if source == "pull, no mon":
            async def refuse(*a, **k):
                raise RuntimeError("no quorum")
            objecter.mon.command = refuse
        metrics = None
        if source.startswith("store"):
            metrics = fed_metrics(pkg, 3, exemplars="exemplars" in source)
        local = mod(pkg, "common.perf_counters").PerfCountersCollection()
        bal = mod(pkg, "mgr.balancer")._make_perf()
        bal.inc("moves", 5)
        local.add(bal)
        exp = mod(pkg, "mgr.prometheus").PrometheusExporter(
            objecter, local_perf=local, metrics=metrics,
            config=None if metrics is None else metrics.config)
        return asyncio.run(exp.collect())

    ref, port = both(run)
    assert port == ref
    assert "ceph_tpu_osdmap_epoch 17" in port


@pytest.mark.parametrize("apply", [False, True])
def test_autoscaler_proposals_equal_ceph_tpu(apply):
    def run(pkg):
        objecter = FakeObjecter(pkg, 5)
        scaler = mod(pkg, "mgr.autoscaler").PgAutoscaler(objecter, target_pg_per_osd=100)
        report = asyncio.run(scaler.run_once(apply=apply))
        full = FakeObjecter(pkg, 5, health={"status": "HEALTH_WARN", "checks": {
            "OSD_NEARFULL": {"severity": "HEALTH_WARN", "count": 1}}})
        skipped = asyncio.run(mod(pkg, "mgr.autoscaler").PgAutoscaler(full).run_once())
        return report, objecter.sent, skipped

    ref, port = both(run)
    assert port == ref
    assert any(e["action"] == "grow" for e in port[0].values())


def test_dashboard_document_equal_ceph_tpu():
    def run(pkg):
        return asyncio.run(mod(pkg, "mgr.dashboard").DashboardModule(
            FakeObjecter(pkg, 2)).status())

    ref, port = both(run)
    assert port == ref


# -- the tools -------------------------------------------------------------------


def jaeger_lines(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    lines = []
    for t in range(5):
        tid = f"{seed:04x}{t:04x}"
        for s in range(int(rng.integers(2, 7))):
            parent = None if s == 0 else f"s{int(rng.integers(0, s))}"
            start = int(rng.integers(0, 50_000)) + 1_000_000 * t
            span = {"traceID": tid, "spanID": f"s{s}", "operationName":
                    ["op_submit", "osd_op", "encode_batch", "journal_commit", "msg_send"][s % 5],
                    "references": [] if parent is None else
                    [{"refType": "CHILD_OF", "traceID": tid, "spanID": parent}],
                    "startTime": start, "duration": int(rng.integers(10, 90_000)),
                    "process": {"serviceName": f"osd.{s % 3}"},
                    "tags": [{"key": "pool", "value": int(rng.integers(1, 3))}],
                    "logs": [{"timestamp": start + 5, "fields": [{"value": "queued"}]}]}
            lines.append(json.dumps(span))
    return lines


def tool_output(module, argv, stdin: str | None = None) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    saved = None
    if stdin is not None:
        import sys

        saved, sys.stdin = sys.stdin, io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = module.main(argv)
    finally:
        if saved is not None:
            import sys

            sys.stdin = saved
    return rc, out.getvalue(), err.getvalue()


TRACE_ARGVS = (["{path}"], ["{path}", "--limit", "2"], ["{path}", "--trace", "00070002"],
               ["{path}", "--trace", "nope"], ["{path}", "--critical-report"],
               ["{dump}"], ["{show}"], ["-"])


@pytest.mark.parametrize("argv", TRACE_ARGVS, ids=lambda a: " ".join(a))
def test_trace_tool_prints_what_ceph_tpu_prints(tmp_path, argv):
    import tools.trace_tool as ref_tool
    from ceph_tpu_torch.tools import trace_tool as port_tool

    lines = jaeger_lines(7)
    path = tmp_path / "trace.jsonl"
    path.write_text("\n".join(lines) + "\n")
    spans = ref_tool.load_spans(str(path))
    dump = tmp_path / "dump.json"
    dump.write_text(json.dumps({"num_spans": len(spans), "traces": [{"spans": spans[:6]}]}))
    show = tmp_path / "show.json"
    show.write_text(json.dumps({"trace_id": spans[0]["trace_id"], "spans": spans[:4]}))
    args = [a.format(path=path, dump=dump, show=show) for a in argv]
    stdin = "\n".join(lines[:9]) if args == ["-"] else None
    ref = tool_output(ref_tool, args, stdin)
    port = tool_output(port_tool, args, stdin)
    assert port == ref
    assert ref[1] or ref[0] == 1


class _FakeTopClient:
    """Stands in for ceph_top's TopClient: the mgr's reply documents."""

    docs: dict = {}

    def __init__(self, monmap, config=None, name="client.top"):
        self.name = name

    async def fetch(self, cmd="top", timeout=10.0, **params):
        return json.loads(json.dumps(self.docs[cmd]))

    async def close(self):
        pass


@pytest.mark.parametrize("argv", [["--json"], ["--slo", "--json"], [], ["--slo"],
                                  ["--sort", "write_bps"], ["--sort", "queue_depth"]],
                         ids=lambda a: " ".join(a) or "table")
def test_ceph_top_prints_what_ceph_tpu_prints(monkeypatch, argv):
    import tools.ceph_top as ref_tool
    from ceph_tpu_torch.tools import ceph_top as port_tool

    outs = []
    for pkg, tool in ((REF, ref_tool), (PORT, port_tool)):
        m = fed_metrics(pkg, 7)
        top = m.top_document(now=11.5)
        top["traces"] = []
        client = type("TopClient", (_FakeTopClient,), {
            "docs": {"top": top, "slo": m.slo_document(now=11.5)}})
        monkeypatch.setattr(tool, "TopClient", client)
        outs.append(tool_output(tool, ["--mon-host", "127.0.0.1:6789", *argv]))
    assert outs[1] == outs[0]
    assert outs[0][0] == 0 and outs[0][1]
