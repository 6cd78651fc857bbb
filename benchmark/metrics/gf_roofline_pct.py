"""gf_roofline_pct: the least time the traced slice's batches need (each
call's k input rows read once and r output rows written once, from its
shapes, at the card's HBM peak) over the time the device was busy in the
slice (the union of every kernel, copy and set, whatever its name), in %."""

import yardstick


def read(run):
    trace = run.trace
    peak = yardstick.HBM_BYTES_PER_S.get(run.device_name)
    if trace is None or peak is None or not trace.batches:
        return None
    busy = trace.busy_s
    if busy <= 0:
        return None
    least = sum(run.jobs[j].hbm_bytes for j in trace.batches) / peak
    return 100.0 * least / busy
