"""dout-style logging — the reference's src/log + common/debug.h.

Per-subsystem debug levels (`debug_<subsys> = N` config options, declared in
the central schema like every other knob, the `dout(N) << ...` gather/gate
idiom), an always-on in-memory ring of recent entries regardless of the
emission level (Log.cc keeps `m_recent` so crashes can dump context that was
never written out), and a `log dump` admin command that flushes the ring —
mirroring `ceph daemon <x> log dump`.

The gate is the hot-path cost: `logger.dout(level)` returns None when gated,
comparing against a CACHED level (refreshed through the config-observer
mechanism, the way the reference caches gather levels per subsystem) so
callers pay one comparison and skip message formatting entirely:

    log = cluster.logs.get_logger("rados")
    if (d := log.dout(10)) is not None:
        d(f"expensive {state}")
"""

from __future__ import annotations

import sys
import time
from collections import deque
from typing import Callable

from ceph_tpu_torch.common.config import Config, ConfigError, config as global_config
from ceph_tpu_torch.common.tracer import current_trace_id

#: default emitted level 1 / gathered (ring) level 5, like the reference's
#: "1/5"-style subsys defaults (src/common/subsys.h)
DEFAULT_LEVEL = 1
RING_LEVEL = 5
RING_SIZE = 10000


class Logger:
    """One subsystem's gate + sink (the dout side of src/log/Log.cc)."""

    def __init__(self, subsys: str, ring: deque, config: Config):
        self.subsys = subsys
        self._ring = ring
        self._stream = sys.stderr
        self._level = DEFAULT_LEVEL
        option = f"debug_{subsys}"
        try:
            self._level = int(config.get(option))
            config.observe(option, self._on_level_change)
        except ConfigError:
            # unknown subsystem in a custom schema: stay at the default
            pass

    def _on_level_change(self, _name: str, value: int) -> None:
        self._level = int(value)

    def level(self) -> int:
        return self._level

    def dout(self, level: int) -> Callable[[str], None] | None:
        """None when fully gated; else a sink the caller formats into."""
        emit = level <= self._level
        gather = level <= RING_LEVEL
        if not (emit or gather):
            return None

        def sink(message: str) -> None:
            # correlate with dump_tracing: lines logged inside a traced
            # op carry its id (the reference prefixes lttng/jaeger ids
            # the same way); one contextvar read per EMITTED line only
            tid = current_trace_id()
            if tid is not None:
                message = f"trace={tid} {message}"
            record = (time.time(), self.subsys, level, message)
            if gather:
                self._ring.append(record)
            if emit:
                print(
                    f"{record[0]:.6f} {self.subsys} {level} : {message}",
                    file=self._stream,
                )

        return sink


class LogRegistry:
    """All subsystem loggers sharing one recent-entries ring."""

    def __init__(self, config: Config | None = None):
        self._ring: deque = deque(maxlen=RING_SIZE)
        self._config = config if config is not None else global_config
        self._loggers: dict[str, Logger] = {}

    def get_logger(self, subsys: str) -> Logger:
        logger = self._loggers.get(subsys)
        if logger is None:
            logger = self._loggers[subsys] = Logger(
                subsys, self._ring, self._config
            )
        return logger

    def dump_recent(self) -> list[dict]:
        """The crash-dump / `log dump` view of the ring (Log::dump_recent)."""
        return [
            {"stamp": ts, "subsys": s, "level": lv, "message": m}
            for ts, s, lv, m in self._ring
        ]

    def clear(self) -> None:
        self._ring.clear()
