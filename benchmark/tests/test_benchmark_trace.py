"""Reading the device trace: its operations inside the slice, the time
they kept the device busy, and the idle time by where it falls."""

import pytest

import devtrace


def event(cat, name, ts_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def test_device_ops_are_kernels_copies_and_sets():
    doc = {"traceEvents": [
        event("kernel", "k", 10, 5), event("gpu_memcpy", "c", 20, 1),
        event("gpu_memset", "s", 30, 1), event("cuda_runtime", "cudaLaunchKernel", 9, 1),
        event("cpu_op", "aten::empty", 8, 1), {"ph": "i", "cat": "kernel", "name": "x"}]}
    ops = devtrace.device_ops(doc)
    assert [o[0] for o in ops] == ["k", "c", "s"]
    assert ops[0][1] == pytest.approx(10e-6) and ops[0][2] == pytest.approx(15e-6)


def test_slice_keeps_what_falls_inside_and_names_the_idle_time():
    # the opening op before the slice is left out; one that crosses its end
    # is clipped to it
    ops = [("early", -5.0, -1.0), ("k", 15.0, 45.0), ("k", 75.0, 95.0), ("late", 98.0, 110.0)]
    s = devtrace.make_slice(ops, 0.0, 100.0, [0, 1, 0])
    assert s.window_s == 100.0 and s.busy_s == 52.0
    assert [o[0] for o in s.device_ops] == ["k", "k", "late"] and s.batches == [0, 1, 0]
    assert s.top_ops() == [["k", 50.0], ["late", 2.0]]
    gaps = dict(s.idle_gaps())
    assert gaps == {"host path between calls (codec entry, launch, event wait, harness step)":
                    33.0, "before the first device op": 15.0}
    assert sum(gaps.values()) == pytest.approx(s.window_s - s.busy_s)
    empty = devtrace.make_slice([], 0.0, 2.0, [0])
    assert empty.idle_gaps() == [["no device operation", 2.0]]
