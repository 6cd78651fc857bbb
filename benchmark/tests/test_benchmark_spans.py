"""The span tool's arithmetic (`spans.py`) on synthetic spans, harness times
and device operations: self times, a span cut by the slice's end, the five
parts of the idle time between calls, the clock check, and each reader;
then the tool's whole flow on the CPU at a small size."""

import pytest
import torch

import devtrace
import harness
import spans
from helpers import window_of

US = 1_000  # ns
#: trace seconds less perf_counter seconds in the synthetic slices
OFFSET = -1000.0
#: perf_counter seconds at which the synthetic slice starts
T = 2000.0


def ns(us):
    """A perf_counter_ns stamp `us` microseconds after T."""
    return int(round(T * 1e9)) + int(us * US)


def trace_s(us):
    """The trace-clock second of `us` microseconds after T."""
    return T + OFFSET + us / 1e6


def one_call(at, decode=True, launch=(5, 8)):
    """The spans of one decode_words call starting `at` us after T: entry
    [0, 10], table [1, 3], wrapper [4, 9], launch inside the wrapper."""
    entry = "ec.decode_words" if decode else "ec.encode_words"
    out = [("gf.launch", "gf.wrapper", ns(at + launch[0]), ns(at + launch[1])),
           ("gf.wrapper", entry, ns(at + 4), ns(at + 9))]
    if decode:
        out.append(("ec.decode_table", entry, ns(at + 1), ns(at + 3)))
    return out + [(entry, None, ns(at), ns(at + 10))]


def traced(calls=2, decode=True, stop_us=40.0, counters=None, launch_shift_us=0.0):
    """Calls every 20 us: spans at [0, 10], the wait t1 -> t2 at [10, 14],
    the kernel at [9, 13] (it starts as the launch returns), the harness's
    step to the next call; the launch events inside the launch spans, after
    the one of the op that opens the trace."""
    records, batches, ops = [], [], []
    launches = [(trace_s(-100), trace_s(-99))]
    for c in range(calls):
        at = 20.0 * c
        records += one_call(at, decode)
        batches.append((0, T + at / 1e6, T + (at + 10) / 1e6, T + (at + 14) / 1e6))
        ops.append(("k", trace_s(at + 9), trace_s(at + 13)))
        launches.append((trace_s(at + 6 + launch_shift_us), trace_s(at + 7 + launch_shift_us)))
    window = window_of(batches)
    slice_ = devtrace.make_slice(ops, trace_s(0), trace_s(stop_us), window.jobs)
    return spans.Traced(slice_, window, records, launches, OFFSET, counters or {})


def test_self_time_is_a_span_less_its_children():
    sec = spans.span_seconds(one_call(0), OFFSET, trace_s(0), trace_s(100))
    assert sec["ec.decode_words"][0] == 1
    assert sec["ec.decode_words"][1] == pytest.approx(10e-6)
    assert sec["ec.decode_words"][2] == pytest.approx(3e-6)  # 10 - table 2 - wrapper 5
    assert sec["gf.wrapper"][2] == pytest.approx(2e-6)  # 5 - launch 3
    assert sec["gf.launch"][2] == pytest.approx(3e-6)


def test_a_span_that_straddles_the_end_of_the_slice_counts_its_inside():
    # the slice ends 6 us into the call: entry 6 us in, of which table 2 and
    # wrapper 2 (4 to 6), launch 1 (5 to 6)
    sec = spans.span_seconds(one_call(0), OFFSET, trace_s(0), trace_s(6))
    assert sec["ec.decode_words"][1] == pytest.approx(6e-6)
    assert sec["ec.decode_words"][2] == pytest.approx(2e-6)
    assert sec["gf.wrapper"][2] == pytest.approx(1e-6)
    assert sec["gf.launch"][1] == pytest.approx(1e-6)
    # a span that starts after the slice counts neither time nor a start
    late = spans.span_seconds(one_call(50), OFFSET, trace_s(0), trace_s(6))
    assert late["ec.decode_words"][:2] == [0, 0.0]


def test_the_five_parts_sum_to_the_old_entry():
    t = traced(calls=3, stop_us=60.0)
    old = dict(t.slice.idle_gaps())
    between = old["host path between calls (codec entry, launch, event wait, harness step)"]
    gaps = dict(spans.idle_gaps(t, OFFSET))
    parts = [gaps.get(name, 0.0) for name in spans.IDLE_PARTS]
    assert sum(parts) == pytest.approx(between, rel=1e-9)
    # kernels at [9, 13] of each call: between the first op (9) and the last
    # op's end (53) the device idles 44 - 12 = 32 us; per gap between
    # calls: the wait 13-14, the step 14-20, the entry's self 20-21 and
    # 23-24, the table 21-23, the wrapper 24-29
    assert parts == pytest.approx([4e-6, 4e-6, 10e-6, 2e-6, 12e-6])
    assert gaps["before the first device op"] == pytest.approx(9e-6)
    assert gaps["after the last device op"] == pytest.approx(7e-6)
    empty = devtrace.make_slice([], trace_s(0), trace_s(2), [0])
    assert spans.idle_gaps(spans.Traced(empty, t.window, [], [], OFFSET, {}), OFFSET) == \
        [["no device operation", pytest.approx(2e-6)]]


def test_the_clock_check_passes_aligned_launches_and_fails_shifted_ones():
    aligned = spans.clock(traced(calls=4, stop_us=80.0))
    assert aligned["share"] == 1.0 and not aligned["fitted"]
    assert aligned["offset_s"] == OFFSET and aligned["launches"] == 4
    shifted = traced(calls=4, stop_us=80.0, launch_shift_us=50.0)
    assert spans.launch_share(shifted.spans, shifted.launches, OFFSET) == 0.0
    check = spans.clock(shifted)
    assert check["fitted"] and check["pair_share"] == 0.0
    # the fit finds the 50 us between the two clocks (more than a call's
    # 20 us: the launches are matched to the spans in order) and puts every
    # launch back inside its span
    assert check["offset_s"] - OFFSET == pytest.approx(50e-6, abs=1e-9)
    assert check["share"] == 1.0


def test_each_reader_on_a_decode_slice():
    t = traced(calls=2, counters={"decode_table_hits": 6, "decode_table_misses": 2})
    read = {name: f(t, OFFSET) for name, f in spans.READERS.items()}
    assert read["codec_entry_us"] == pytest.approx(3.0)
    assert read["decode_table_us"] == pytest.approx(2.0)
    assert read["kernel_wrapper_us"] == pytest.approx(2.0)
    assert read["launch_call_us"] == pytest.approx(3.0)
    # idle while a span is open: [0, 9] of each call, and [29, 30] no more
    # (the next kernel starts at 29): 9 us a call
    assert read["program_idle_us"] == pytest.approx(9.0)
    assert read["decode_table_hit_pct"] == pytest.approx(75.0)
    s = spans.summary(t)
    assert s["span_sum_us"] == pytest.approx(10.0)
    assert s["host_call_us"] == pytest.approx(10.0)
    assert set(s["metrics"]) == set(spans.READERS)


def test_an_encode_slice_reads_no_decode_table():
    t = traced(calls=2, decode=False)
    assert spans.decode_table_us(t, OFFSET) is None
    assert spans.decode_table_hit_pct(t, OFFSET) is None
    assert spans.codec_entry_us(t, OFFSET) == pytest.approx(5.0)
    nothing = spans.Traced(t.slice, t.window, [], t.launches, OFFSET, {})
    assert all(f(nothing, OFFSET) is None for f in spans.READERS.values())


def test_launch_events_are_the_runtime_calls():
    assert spans.is_launch({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel"})
    assert spans.is_launch({"ph": "X", "cat": "cuda_runtime",
                            "name": "cudaLaunchKernelExC_v11060"})
    assert not spans.is_launch({"ph": "X", "cat": "cuda_runtime", "name": "cudaEventRecord"})
    assert not spans.is_launch({"ph": "X", "cat": "kernel", "name": "cudaLaunchKernel"})


def test_the_flow_on_the_cpu_at_a_small_size():
    name = "isa_k8m3.planar_decode1"
    k = int(harness.load_cell(name).config["profile"]["k"])
    small = {"object_bytes": 4 * 64 * k, "working_set_bytes": 4 * 4 * 64 * k}
    out = spans.measure(name, 2**31 + 7, 1, 0.1, torch.device("cpu"), override=small)
    assert out["correct"] and out["failed"] == 0
    assert len(out["on"]) == 1 and len(out["host_call_off_us"]) == 1
    on = out["on"][0]
    # a CPU codec has entry and table spans, no kernel; the warm-up built
    # every decode table, so the slice only hits
    assert on["metrics"]["codec_entry_us"] > 0 and on["metrics"]["decode_table_us"] > 0
    assert on["metrics"]["decode_table_hit_pct"] == 100.0
    assert "kernel_wrapper_us" not in on["metrics"]
    assert on["counters"]["decode_table_misses"] == 0 and on["calls"] > 0
    from ceph_tpu_torch.common.tracer import hot_spans

    assert not hot_spans.on and hot_spans.drain() == []
