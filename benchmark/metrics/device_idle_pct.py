"""device_idle_pct: the share of the untraced window in which the device ran
nothing, in %. The device's busy seconds per batch are read from the traced
slice (the union of every kernel, copy and set, over its batches) and
counted for each batch of the window; the window's own seconds are not
stretched by the profiler's cost on the host."""


def read(run):
    trace = run.trace
    if trace is None or not trace.batches or not trace.device_ops:
        return None
    busy = trace.busy_s / len(trace.batches) * len(run.window.jobs)
    return 100.0 * (1.0 - busy / run.window.seconds)
