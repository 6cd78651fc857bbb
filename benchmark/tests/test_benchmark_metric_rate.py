"""coded_gbps: all object bytes of the window over all its time."""

import pytest

import harness
import yardstick
from helpers import FakeJob, make_run, window_of

read = harness.metric_reader("coded_gbps")


def test_rate_is_total_over_time():
    assert yardstick.rate(10, 4) == 2.5
    with pytest.raises(ValueError):
        yardstick.rate(1, 0)


def test_rate_counts_every_batch_over_the_whole_window():
    jobs = [FakeJob(2e9, 1), FakeJob(1e9, 1)]
    # three batches with idle time between them: 5e9 bytes from 10 s to 15 s
    window = window_of([(0, 10.0, 10.1, 11.0), (1, 12.0, 12.1, 13.0), (0, 14.0, 14.1, 15.0)])
    assert read(make_run(jobs, window)) == pytest.approx(1.0)


def test_setup_and_host_readers():
    window = window_of([(0, 0.0, 20e-6, 1e-3), (0, 1e-3, 1e-3 + 40e-6, 2e-3)])
    run = make_run([FakeJob(1, 1)], window, setup_s=7.5)
    assert harness.metric_reader("setup_s")(run) == 7.5
    assert harness.metric_reader("call_host_us")(run) == pytest.approx(30.0)
