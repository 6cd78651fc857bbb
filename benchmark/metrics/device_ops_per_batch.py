"""device_ops_per_batch: kernels, copies and sets that the device trace saw
in the traced slice, over the batches run in it."""


def read(run):
    trace = run.trace
    if trace is None or not trace.batches or not trace.device_ops:
        return None
    return len(trace.device_ops) / len(trace.batches)
