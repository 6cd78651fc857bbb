"""gf_roofline_pct: least time from the batches' shapes over all the device's
busy time in the traced slice, whatever the operations are named."""

import pytest

import devtrace
import harness
import yardstick
from helpers import FakeJob, make_run, window_of

read = harness.metric_reader("gf_roofline_pct")
ops_read = harness.metric_reader("device_ops_per_batch")
PEAK = yardstick.HBM_BYTES_PER_S["NVIDIA H100 80GB HBM3"]


def traced(ops, batches):
    return devtrace.Slice(0.0, 1.0, ops, batches)


def test_share_counts_every_device_op_by_any_name():
    jobs = [FakeJob(1, PEAK * 1e-3), FakeJob(1, PEAK * 0.5e-3)]
    # 2 ms of least time; the device busy 1 ms in a kernel, 1 ms in a copy,
    # and 0.5 ms in a set that overlaps the kernel
    ops = [("any_kernel", 0.0, 1e-3), ("Memcpy DtoD", 0.002, 0.003),
           ("Memset", 0.0005, 0.001)]
    run = make_run(jobs, window_of([(0, 0, 0, 1)]), traced(ops, [0, 1, 1]))
    assert read(run) == pytest.approx(100.0)
    renamed = [("other_name", a, b) for _, a, b in ops]
    run2 = make_run(jobs, window_of([(0, 0, 0, 1)]), traced(renamed, [0, 1, 1]))
    assert read(run2) == read(run)
    assert ops_read(run) == pytest.approx(1.0)


def test_unknown_card_or_no_trace_reads_nothing():
    jobs = [FakeJob(1, 1)]
    ops = [("k", 0.0, 1e-3)]
    assert read(make_run(jobs, window_of([(0, 0, 0, 1)]), traced(ops, [0]), "cpu")) is None
    assert read(make_run(jobs, window_of([(0, 0, 0, 1)]))) is None
    assert ops_read(make_run(jobs, window_of([(0, 0, 0, 1)]))) is None
