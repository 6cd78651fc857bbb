"""coded_gbps: object bytes of every batch completed in the window (encoded,
or read degraded and rebuilt) over the window's seconds, in 1e9 B/s."""

import yardstick


def read(run):
    window = run.window
    total = sum(run.jobs[j].user_bytes for j in window.jobs)
    return yardstick.rate(total, window.seconds) / 1e9
