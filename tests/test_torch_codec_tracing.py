"""The codec call's hot-path spans and counters on the CPU: the recorder
(`common.tracer.hot_spans`) behind the `bench_profile` knob, the spans of
the RS codec's four entries and its decode-table lookup, the decode-table
cache's hits/misses/evictions, the `ec_codec` perf block, and the ec_bench
tool's profile hook. The kernel wrappers' spans ("gf.wrapper",
"gf.launch") are taken on a CUDA tensor only: `benchmark/tests` checks
them on the card."""

import json
import tracemalloc

import pytest
import torch

from ceph_tpu_torch.common.config import Config, config
from ceph_tpu_torch.common.tracer import HotSpanRecorder, hot_spans
from ceph_tpu_torch.ec.interface import DecodeTableCache, codec_perf
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.ops import gf_bitplane, gf_cuda
from ceph_tpu_torch.tools import ec_bench, trace_tool

ENTRIES = ("ec.encode_words", "ec.decode_words", "ec.encode_array", "ec.decode_array")


@pytest.fixture
def profiling():
    """`bench_profile` on through the process's config, off again after."""
    hot_spans.drain()
    config.set("bench_profile", True)
    try:
        yield hot_spans
    finally:
        config.set("bench_profile", False)
        config.rm("bench_profile")
        hot_spans.drain()


def codec():
    return factory("isa", {"k": "4", "m": "2", "technique": "cauchy"}, device="cpu")


def call_every_entry(ec):
    """One call of each entry; a decode rebuilds chunk 1 from 0, 2, 3, 4."""
    gen = torch.Generator().manual_seed(3)
    data = torch.randint(0, 256, (1, 4, 64), generator=gen, dtype=torch.uint8)
    parity = ec.encode_array(data)
    word = torch.cat([data, parity], dim=1)
    present, targets = [0, 2, 3, 4], [1]
    got = ec.decode_array(present, targets, word[:, present])
    assert torch.equal(got, data[:, 1:2])
    words = data[0].contiguous().view(torch.int32)
    pwords = ec.encode_words(words)
    planar = torch.cat([words, pwords])
    rebuilt = ec.decode_words(present, targets, planar[present])
    assert torch.equal(rebuilt, words[1:2])


def test_off_a_span_site_checks_the_flag_and_records_nothing(monkeypatch):
    assert not hot_spans.on
    hot_spans.drain()

    def never(*args):
        raise AssertionError("a span was opened with bench_profile off")

    monkeypatch.setattr(HotSpanRecorder, "call", never)
    ec = codec()
    call_every_entry(ec)  # warm: tables built, modules loaded
    tracemalloc.start()
    try:
        call_every_entry(ec)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    from ceph_tpu_torch.common import tracer

    assert not snap.filter_traces([tracemalloc.Filter(True, tracer.__file__)]).traces
    assert hot_spans.drain() == []


def test_on_each_entry_leaves_its_span_and_the_lookup_nests_in_the_decodes(profiling):
    call_every_entry(codec())
    records = profiling.drain()
    names = [r[0] for r in records]
    assert sorted(n for n in names if n in ENTRIES) == sorted(ENTRIES)
    assert all(parent is None for name, parent, _, _ in records if name in ENTRIES)
    tables = [r for r in records if r[0] == "ec.decode_table"]
    assert len(tables) == 2
    for _, parent, start, end in tables:
        assert parent in ("ec.decode_array", "ec.decode_words")
        outer = [r for r in records if r[0] == parent and r[2] <= start and end <= r[3]]
        assert len(outer) == 1
    assert all(start <= end for _, _, start, end in records)
    # a CPU codec launches nothing: no wrapper or launch span
    assert not {"gf.wrapper", "gf.launch"} & set(names)


def test_dump_gives_trace_tool_one_trace_a_call(profiling):
    ec = codec()
    call_every_entry(ec)
    spans = HotSpanRecorder.dump(profiling.drain())
    traces = trace_tool.group_traces(spans)
    assert len(traces) == 4
    for members in traces.values():
        root = trace_tool.critical_path(members)[0]
        assert root["name"] in ENTRIES and root["parent_id"] is None
        for s in members:
            if s["name"] == "ec.decode_table":
                assert s["parent_id"] == root["span_id"]
                assert root["name"] in ("ec.decode_array", "ec.decode_words")
    assert all(s["duration"] >= 0 and s["service"] == "ec_codec" for s in spans)


def test_the_ring_stays_bounded_and_a_raising_call_is_recorded():
    cfg = Config()
    rec = HotSpanRecorder(cfg, size=4)
    assert not rec.on
    cfg.set("bench_profile", True)
    assert rec.on
    for i in range(10):
        rec.call(f"s{i}", lambda: None)
    with pytest.raises(ZeroDivisionError):
        rec.call("outer", lambda: rec.call("inner", lambda: 1 // 0))
    records = rec.drain()
    assert [r[0] for r in records] == ["s8", "s9", "inner", "outer"]
    assert records[2][1] == "outer" and records[3][1] is None
    assert rec.drain() == []
    cfg.set("bench_profile", "false")
    assert not rec.on


def test_the_cache_counts_a_miss_then_hits_then_an_eviction():
    cache = DecodeTableCache(capacity=2)
    before = (DecodeTableCache.hits, DecodeTableCache.misses, DecodeTableCache.evictions)

    def delta():
        return (DecodeTableCache.hits - before[0], DecodeTableCache.misses - before[1],
                DecodeTableCache.evictions - before[2])

    assert cache.get_or("a", lambda: 1) == 1
    assert delta() == (0, 1, 0)
    assert cache.get_or("a", lambda: 2) == 1
    assert cache.get_or("a", lambda: 3) == 1
    assert delta() == (2, 1, 0)
    cache.get_or("b", lambda: 4)
    assert delta() == (2, 2, 0)
    cache.get_or("c", lambda: 5)  # over capacity: "a", the least recent, goes
    assert delta() == (2, 3, 1)
    assert cache.get_or("a", lambda: 6) == 6
    assert delta() == (2, 4, 2)


def test_the_codec_block_reads_the_counters_and_the_launch_counts(monkeypatch):
    monkeypatch.setattr(gf_cuda.gf_matmul_packed, "launches", 7)
    monkeypatch.setattr(gf_bitplane.gf_matmul_bitplane, "launches", 5)
    monkeypatch.setattr(gf_cuda.xor_reduce_words, "launches", 0)
    monkeypatch.setattr(gf_bitplane.xor_reduce, "launches", 2)
    before = codec_perf.dump()
    ec = codec()
    present = [0, 2, 3, 4]
    survivors = torch.zeros((1, 4, 32), dtype=torch.uint8)
    for _ in range(3):
        ec.decode_array(present, [1], survivors)
    dump = codec_perf.dump()
    assert dump["decode_table_misses"] - before["decode_table_misses"] == 1
    assert dump["decode_table_hits"] - before["decode_table_hits"] == 2
    assert dump["decode_table_evictions"] == DecodeTableCache.evictions
    assert (dump["gf_matmul_packed_launches"], dump["gf_matmul_bitplane_launches"],
            dump["xor_reduce_words_launches"], dump["xor_reduce_launches"]) == (7, 5, 0, 2)
    assert codec_perf.name == "ec_codec"
    assert set(codec_perf.schema()) == set(dump)


def test_ec_bench_writes_one_trace_with_the_spans_on_its_clock(tmp_path, capsys):
    config.set("bench_profile_trace_dir", str(tmp_path))
    try:
        with_profile = ["-p", "isa", "-P", "k=4", "-P", "m=2", "-P", "technique=cauchy",
                        "-s", "16384", "-i", "2", "-w", "decode", "--batch", "2",
                        "--device", "cpu"]
        config.set("bench_profile", True)
        assert ec_bench.main(with_profile) == 0
    finally:
        config.set("bench_profile", False)
        for name in ("bench_profile", "bench_profile_trace_dir"):
            config.rm(name)
    assert "torch.profiler trace" in capsys.readouterr().err
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "hot_span"]
    others = [e for e in events if e.get("ph") == "X" and e.get("cat") != "hot_span"]
    assert {e["name"] for e in spans} == {"ec.encode_array", "ec.decode_array",
                                          "ec.decode_table"}
    assert others
    # on the profiler's clock: the spans lie within its first and last events
    first = min(e["ts"] for e in others)
    last = max(e["ts"] + e.get("dur", 0) for e in others)
    assert all(first <= e["ts"] and e["ts"] + e["dur"] <= last for e in spans)
    assert hot_spans.drain() == []


def test_spans_as_trace_events_map_the_clock():
    events = ec_bench.spans_as_trace_events(
        [("gf.launch", "gf.wrapper", 5_000, 7_500)], offset_ns=1_000_000, base_ns=900_000)
    assert events[0]["ts"] == pytest.approx(105.0) and events[0]["dur"] == pytest.approx(2.5)
    assert events[0]["args"] == {"parent": "gf.wrapper"} and events[0]["ph"] == "X"
