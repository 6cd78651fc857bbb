"""Shared builders of the benchmark's tests: a Run as the readers see it."""

import harness


class FakeJob:
    def __init__(self, user_bytes, hbm_bytes, name="job"):
        self.user_bytes, self.hbm_bytes, self.name = user_bytes, hbm_bytes, name


def make_run(jobs, window, trace=None, device_name="NVIDIA H100 80GB HBM3", setup_s=1.0):
    return harness.Run(setup_s, jobs, window, device_name, trace)


def window_of(batches):
    """A Window from (job, t0, t1, t2) tuples."""
    w = harness.Window()
    for j, t0, t1, t2 in batches:
        w.jobs.append(j)
        w.t0.append(t0)
        w.t1.append(t1)
        w.t2.append(t2)
    return w
