"""call_host_us: host microseconds from entering the codec call to its
return, before any wait, as the mean over the untraced window's calls: the
codec entry and the kernel wrappers' host path."""

import statistics


def read(run):
    return statistics.fmean(run.window.host_seconds()) * 1e6
