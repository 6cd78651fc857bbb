"""The port's copies of the common runtime (ceph_tpu_torch/common/: config,
perf_counters, log, tracer, admin) against the JAX package's, on the CPU.

Each scenario of tests/test_log.py, tests/test_tracer.py (those that need no
messenger, mgr or trace tool) and tests/test_aux.py (those of these modules)
runs, with its original assertions, on both packages' modules; what it
observed (dumps, messages, sampling decisions, options read) must be the
same, exactly, apart from clocks and random ids. `test_knobs_are_read_the_same_way`
records every option the tracer, the loggers and the MiniCluster read from
their Config, and when: the sequences must agree.
"""

import importlib
import io
import os
import types

import pytest

PACKAGES = ("ceph_tpu", "ceph_tpu_torch")


def modules(pkg: str) -> types.SimpleNamespace:
    m = {name: importlib.import_module(f"{pkg}.common.{name}")
         for name in ("admin", "config", "log", "perf_counters", "tracer")}
    return types.SimpleNamespace(**m)


def twin(scenario):
    """The scenario's observations on both packages; they must agree."""
    jax_obs, port_obs = (scenario(modules(pkg)) for pkg in PACKAGES)
    assert port_obs == jax_obs
    return port_obs


def traced_config(ns, **overrides):
    cfg = ns.config.Config()
    cfg.set("tracer_enabled", True)
    cfg.set("tracer_sample_rate", 1.0)
    for k, v in overrides.items():
        cfg.set(k, v)
    return cfg


# -- test_log.py ---------------------------------------------------------------


def make_logger(ns, level):
    cfg = ns.config.Config()
    cfg.set("debug_osd", level)
    reg = ns.log.LogRegistry(config=cfg)
    logger = reg.get_logger("osd")
    logger._stream = io.StringIO()
    return cfg, reg, logger


def recent(reg):
    return [(r["subsys"], r["level"], r["message"]) for r in reg.dump_recent()]


def log_gate_emit_gather_and_level(ns):
    _, reg, logger = make_logger(ns, 1)
    assert logger.dout(ns.log.RING_LEVEL + 1) is None  # fully gated
    logger.dout(1)("emitted and gathered")
    logger.dout(5)("gathered only")
    emitted = logger._stream.getvalue()
    assert "emitted and gathered" in emitted and "gathered only" not in emitted
    cfg, reg2, logger2 = make_logger(ns, 1)
    assert logger2.dout(3) is not None
    cfg.set("debug_osd", 3)
    logger2.dout(3)("now emitted")
    assert "now emitted" in logger2._stream.getvalue()
    return recent(reg), recent(reg2), ns.log.RING_LEVEL


def log_ring_is_bounded(ns):
    _, reg, logger = make_logger(ns, 0)
    for i in range(ns.log.RING_SIZE + 50):
        logger.dout(5)(f"m{i}")
    out = recent(reg)
    assert len(out) == ns.log.RING_SIZE
    assert out[0][2] == "m50"
    return out


# -- test_tracer.py --------------------------------------------------------------


def tracer_disabled_is_free(ns):
    tr = ns.tracer.Tracer("osd.0", config=ns.config.Config())
    assert not tr.enabled
    assert tr.start("op_submit") is None
    assert tr.child("blockstore_read") is None
    assert tr.join("aa:bb:1", "osd_op") is None
    assert tr.use_wire("aa:bb:1") is None
    assert tr.perf.dump() == {}
    return tr.dump_tracing()


def tracer_enable_disable_is_config_observed(ns):
    cfg = ns.config.Config()
    tr = ns.tracer.Tracer("osd.0", config=cfg)
    seen = [tr.start("x") is None]
    cfg.set("tracer_enabled", True)
    sp = tr.start("x")
    seen.append(sp is not None)
    sp.finish()
    cfg.set("tracer_enabled", False)
    seen.append(tr.start("x") is None)
    assert all(seen)
    return seen


def tracer_sampling_rates(ns):
    """Rate 0 flight-records but exports nothing; per-op-type overrides,
    and flipping them at run time."""
    tr = ns.tracer.Tracer("c", config=traced_config(ns, tracer_sample_rate=0.0))
    for _ in range(50):
        sp = tr.start("op")
        assert sp is not None and sp.sampled is False
        sp.finish()
    obs = [tr.dump_tracing()["num_spans"], len(tr._flight)]
    assert obs == [0, 50]
    tr = ns.tracer.Tracer("osd.0", config=traced_config(
        ns, tracer_sample_rate=0.0, tracer_sample_rate_recovery=1.0))
    for _ in range(20):
        sp = tr.start("recovery_read", op_type="recovery")
        obs.append(sp.sampled)
        sp.finish()
        obs.append(tr.start("op_submit", op_type="read").sampled)
        obs.append(tr.start("op_submit").sampled)
    cfg = traced_config(ns, tracer_sample_rate=1.0)
    tr = ns.tracer.Tracer("osd.0", config=cfg)
    obs.append(tr.start("op", op_type="write").sampled)
    cfg.set("tracer_sample_rate_write", 0.0)
    obs.extend(tr.start("op", op_type="write").sampled for _ in range(20))
    obs.append(tr.start("op", op_type="read").sampled)
    cfg.set("tracer_sample_rate_write", -1.0)
    obs.append(tr.start("op", op_type="write").sampled)
    return obs


def tracer_ring_is_bounded_and_drained(ns):
    tr = ns.tracer.Tracer("osd.1", config=traced_config(ns, tracer_ring_size=4))
    for i in range(10):
        tr.start(f"op{i}").finish()
    out = tr.dump_tracing()
    names = sorted(s["name"] for t in out["traces"] for s in t["spans"])
    assert out["num_spans"] == 4 and names == ["op6", "op7", "op8", "op9"]
    assert tr.dump_tracing()["num_spans"] == 0
    return names


def tracer_context_roundtrip_and_parent_links(ns):
    tr = ns.tracer.Tracer("client.x", config=traced_config(ns))
    root = tr.start("op_submit", tags={"op": "write"})
    ctx = ns.tracer.SpanContext.decode(root.context().encode())
    assert (ctx.trace_id, ctx.span_id, ctx.sampled) == (root.trace_id, root.span_id, True)
    child = tr.join(root.context().encode(), "osd_op")
    assert (child.trace_id, child.parent_id) == (root.trace_id, root.span_id)
    token = tr.use(child)
    try:
        grand = tr.child("journal_commit")
        assert (grand.trace_id, grand.parent_id) == (root.trace_id, child.span_id)
    finally:
        tr.release(token)
    obs = [tr.child("orphan") is None, ns.tracer.SpanContext.decode("") is None,
           ns.tracer.SpanContext.decode("junk") is None, tr.join("::", "x") is None]
    assert all(obs)
    return obs


def tracer_latency_histogram_and_adopt(ns):
    tr = ns.tracer.Tracer("osd.2", config=traced_config(ns))
    for _ in range(3):
        tr.start("osd_op").finish()
    dump = tr.perf.dump()
    assert sum(dump["lat_us_osd_op"].values()) == 3
    schema_type = tr.perf.schema()["lat_us_osd_op"]["type"]
    assert schema_type == "hist"
    tr = ns.tracer.Tracer("osd.0", config=traced_config(ns))
    tr.adopt([{"trace_id": "t1", "span_id": "s1", "parent_id": None,
               "name": "op_submit", "service": "client.x", "start": 1.0,
               "duration": 0.5, "tags": {}, "events": []},
              {"bogus": True}])
    out = tr.dump_tracing()
    assert out["num_spans"] == 1
    return sum(dump["lat_us_osd_op"].values()), schema_type, out


def optracker_slow_warning_and_span(ns):
    warned = []
    tracker = ns.admin.OpTracker(slow_op_seconds=0.0,
                                 on_slow=lambda i, d: warned.append((i, d)))
    op_id, op = tracker.create("osd_op(write 1/obj)")
    op.mark_event("queued")
    newly = tracker.check_slow()
    assert [i for i, _ in newly] == [op_id] and warned[0][0] == op_id
    obs = [warned[0][1]["events"][-1]["event"], tracker.check_slow()]
    tracker.finish(op_id)
    obs.append(tracker.check_slow())
    tr = ns.tracer.Tracer("osd.0", config=traced_config(ns))
    sp = tr.start("osd_op")
    tracker = ns.admin.OpTracker(slow_op_seconds=0.0)
    op_id, op = tracker.create("osd_op(write)", span=sp)
    tracker.check_slow()
    assert sp.tags.get("slow") is True
    assert tracker.dump_ops_in_flight()["ops"][0]["trace_id"] == sp.trace_id
    tracker.finish(op_id)
    obs += [[e for _t, e in sp.events], tracker.dump_historic_ops()["ops"][0]["span"]["name"]]
    return obs


def dout_lines_carry_trace_prefix(ns):
    cfg = traced_config(ns)
    tr = ns.tracer.Tracer("osd.0", config=cfg)
    logs = ns.log.LogRegistry(cfg)
    log = logs.get_logger("osd")
    span = tr.start("osd_op")
    token = tr.use(span)
    try:
        log.dout(5)("applying write")
    finally:
        tr.release(token)
    log.dout(5)("untraced line")
    msgs = [e["message"] for e in logs.dump_recent()]
    assert msgs == [f"trace={span.trace_id} applying write", "untraced line"]
    return [m.split(" ", 1)[-1] for m in msgs]


# -- test_aux.py -------------------------------------------------------------


def config_layering_validation_observers(ns):
    cfg = ns.config.Config()
    obs = [(cfg.get("osd_pool_default_size"), cfg.source_of("osd_pool_default_size"))]
    cfg.load_file_values({"osd_pool_default_size": "5"})
    obs.append((cfg.get("osd_pool_default_size"), cfg.source_of("osd_pool_default_size")))
    os.environ["CEPH_TPU_OSD_POOL_DEFAULT_SIZE"] = "7"
    try:
        obs.append((cfg.get("osd_pool_default_size"), cfg.source_of("osd_pool_default_size")))
        cfg.set("osd_pool_default_size", 9)
        obs.append((cfg.get("osd_pool_default_size"), cfg.source_of("osd_pool_default_size")))
        cfg.rm("osd_pool_default_size")
        obs.append(cfg.get("osd_pool_default_size"))
    finally:
        del os.environ["CEPH_TPU_OSD_POOL_DEFAULT_SIZE"]
    assert obs == [(3, "default"), (5, "file"), (7, "env"), (9, "override"), 7]
    for name, value in (("osd_pool_default_size", -1), ("ms_inject_delay_probability", 1.5),
                        ("no_such_option", 1),  # cephlint: disable=knob-registry
                        ("osd_pool_default_size", "not-a-number")):
        with pytest.raises(ns.config.ConfigError):
            cfg.set(name, value)
    cfg.set("bench_profile", "true")
    obs.append(cfg.get("bench_profile"))
    cfg.set("bench_profile", "0")
    obs.append(cfg.get("bench_profile"))
    seen = []
    cfg.observe("ms_inject_socket_failures", lambda n, v: seen.append((n, v)))
    cfg.set("ms_inject_socket_failures", 10)
    assert seen == [("ms_inject_socket_failures", 10)]
    schema = cfg.dump_schema()
    assert len(schema) == len(ns.config.SCHEMA)
    # the two profiling knobs' descriptions name each package's own
    # profiler (jax.profiler, torch.profiler); all else must agree
    for name in ("bench_profile", "bench_profile_trace_dir"):
        assert "profiler" in schema[name].pop("description")
    return obs, seen, schema


def perf_counters_dump_and_timer(ns):
    coll = ns.perf_counters.PerfCountersCollection()
    log = coll.create("osd")
    log.add_u64_counter("ops", "client ops")
    log.add_u64("in_flight", "current in-flight")
    log.add_time_avg("latency", "op latency")
    log.add_histogram("sizes", "op sizes")
    log.inc("ops", 3)
    log.set("in_flight", 2)
    log.tinc("latency", 0.5)
    log.tinc("latency", 1.5)
    for size in (4096, 5000, 100):
        log.hinc("sizes", size)
    dump = coll.dump()["osd"]
    assert dump["latency"] == {"avgcount": 2, "sum": 2.0}
    assert dump["sizes"] == {"64": 1, "4096": 2}
    timer = ns.perf_counters.PerfCounters("x")
    timer.add_time_avg("t")
    with timer.time("t"):
        pass
    assert timer.dump()["t"]["avgcount"] == 1
    return dump, coll.schema()


def op_tracker_and_admin_hub(ns):
    tracker = ns.admin.OpTracker(history_size=2, slow_op_seconds=0.0)
    with tracker.track("put foo") as op:
        op.mark_event("encoded")
        in_flight = tracker.dump_ops_in_flight()
        obs = [in_flight["num_ops"], in_flight["num_slow_ops"],
               in_flight["ops"][0]["events"][0]["event"]]
    obs.append(tracker.dump_ops_in_flight()["num_ops"])
    hist = tracker.dump_historic_ops()
    obs += [hist["num_ops"], hist["ops"][0]["description"]]
    for i in range(5):
        with tracker.track(f"op{i}"):
            pass
    obs.append(tracker.dump_historic_ops()["num_ops"])
    assert obs == [1, 1, "encoded", 0, 1, "put foo", 2]
    admin = ns.admin.AdminCommands(perf=ns.perf_counters.PerfCountersCollection(),
                                   config=ns.config.Config(), op_tracker=ns.admin.OpTracker())
    obs.append(admin.handle("perf dump"))
    obs.append(admin.handle("config show")["osd_pool_default_size"]["value"])
    admin.handle("config set", "osd_pool_default_size", "5")
    obs.append(admin.handle("config get", "osd_pool_default_size"))
    admin.handle("config set osd_pool_default_size 7")
    obs.append(admin.handle("config get osd_pool_default_size"))
    with pytest.raises(KeyError):
        admin.handle("bogus")
    return obs


SCENARIOS = [
    log_gate_emit_gather_and_level,
    log_ring_is_bounded,
    tracer_disabled_is_free,
    tracer_enable_disable_is_config_observed,
    tracer_sampling_rates,
    tracer_ring_is_bounded_and_drained,
    tracer_context_roundtrip_and_parent_links,
    tracer_latency_histogram_and_adopt,
    optracker_slow_warning_and_span,
    dout_lines_carry_trace_prefix,
    config_layering_validation_observers,
    perf_counters_dump_and_timer,
    op_tracker_and_admin_hub,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_common_scenario_matches_jax_package(scenario):
    twin(scenario)


# -- the MiniCluster's use of them (test_aux / test_log) -----------------------


def jax_and_port_clusters():
    from tests.conftest import make_mini_cluster
    from tests.test_torch_data_path import port_twin

    jc = make_mini_cluster()
    return jc, port_twin(jc)


def cluster_counters_logs_and_injection(c):
    data = b"aux wiring" * 300
    c.put(1, "obj", data)
    assert c.get(1, "obj") == data
    dump = c.admin.handle("perf dump")["mini_cluster"]
    obs = [(dump["put_ops"], dump["get_ops"], dump["put_bytes"],
            dump["get_latency"]["avgcount"], dump["degraded_reads"])]
    pg, acting = c.acting(1, "obj")
    c.kill_osd(acting[0])
    assert c.get(1, "obj") == data
    obs.append(c.admin.handle("perf dump")["mini_cluster"]["degraded_reads"])
    obs.append(c.recover(1))
    msgs = [r["message"] for r in c.admin.handle("log dump")]
    assert any("degraded read 1/obj" in m for m in msgs)
    assert any(f"osd.{acting[0]} down" in m for m in msgs)
    assert any("recovery pool 1" in m for m in msgs)
    obs.append(msgs)
    c.admin.handle("log clear")
    assert c.admin.handle("log dump") == []
    c.admin.handle("config set", "ms_inject_socket_failures", "5")
    assert all(s.inject_transient_every == 5 for s in c.stores.values())
    for i in range(20):
        c.put(1, f"o{i}", data)
        assert c.get(1, f"o{i}") == data
    dump = c.admin.handle("perf dump")["mini_cluster"]
    assert dump["injected_failures"] > 0
    obs.append({k: v for k, v in dump.items() if not k.endswith("_latency")})
    hist = c.admin.handle("dump_historic_ops")
    events = {e["event"] for op in hist["ops"] for e in op["events"]}
    assert {"placed", "encoded", "stored"} <= events
    obs.append((hist["num_ops"], [op["description"] for op in hist["ops"]], sorted(events)))
    return obs


def test_cluster_counters_logs_and_injection_match_jax_package():
    jc, pc = jax_and_port_clusters()
    assert cluster_counters_logs_and_injection(pc) == cluster_counters_logs_and_injection(jc)


def recording(cfg, reads: list):
    """Make `cfg.get` append each option it is asked for to `reads`."""
    get = cfg.get

    def recorded(name):
        value = get(name)
        reads.append((name, value))
        return value

    cfg.get = recorded
    return cfg


def knob_reads(ns, cluster=None) -> list:
    reads: list = []
    cfg = recording(ns.config.Config(), reads)
    tr = ns.tracer.Tracer("osd.0", config=cfg)
    cfg.set("tracer_enabled", True)
    cfg.set("tracer_sample_rate_write", 0.5)
    tr.start("op", op_type="write")
    logs = ns.log.LogRegistry(config=cfg)
    logs.get_logger("osd").dout(1)
    cfg.set("debug_osd", 4)
    logs.get_logger("rados").dout(1)
    if cluster is not None:
        cluster_reads: list = []
        recording(cluster.config, cluster_reads)
        cluster.put(1, "o", b"x" * 100)
        cluster.admin.handle("config set", "ms_inject_socket_failures", "3")
        cluster.revive_osd(0)
        cluster.scrub(1, deep=True)
        reads.append(cluster_reads)
    return reads


def test_knobs_are_read_the_same_way():
    """The copied modules read their options from the port's copied Config
    with the same names, at the same moments, getting the same values."""
    jc, pc = jax_and_port_clusters()
    port = knob_reads(modules("ceph_tpu_torch"), pc)
    assert port == knob_reads(modules("ceph_tpu"), jc)
    names = {n for n, _ in port[:-1]}
    assert {"tracer_enabled", "tracer_sample_rate", "tracer_ring_size",
            "debug_osd"} <= names
    assert ("ms_inject_socket_failures", 3) in port[-1]
