"""The idle share: the union of device intervals per batch of the traced
slice, counted for every batch of the untraced window, over its seconds."""

import pytest

import devtrace
import yardstick
from helpers import FakeJob, make_run, window_of

import harness

read = harness.metric_reader("device_idle_pct")


def test_union_counts_overlaps_once():
    assert yardstick.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert yardstick.union_seconds([]) == 0


def slice_of(ops, batches=(0,), start=0.0, stop=10.0):
    return devtrace.Slice(start, stop, ops, list(batches))


def test_idle_share_counts_the_slice_busy_time_per_batch_over_the_window():
    # the slice: 2 batches, busy 6 s (overlaps counted once), so 3 s a batch;
    # the untraced window: 3 batches over 15 s, so busy 9 s of 15
    window = window_of([(0, 0, 0, 5), (0, 5, 5, 10), (0, 10, 10, 15)])
    run = make_run([FakeJob(1, 1)], window,
                   slice_of([("a", 0, 4), ("b", 2, 5), ("c", 8, 9)], batches=(0, 0)))
    assert read(run) == pytest.approx(40.0)


def test_no_trace_or_no_device_op_reads_nothing():
    run = make_run([FakeJob(1, 1)], window_of([(0, 0, 0, 1)]))
    assert read(run) is None
    assert read(make_run([FakeJob(1, 1)], window_of([(0, 0, 0, 1)]), slice_of([]))) is None
