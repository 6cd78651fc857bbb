"""mgr: the manager layer — the manager daemon and its hosted modules.

`MgrService` is the ceph-mgr daemon: it beacons to the monitors, exactly one
is active in the paxos-replicated MgrMap, and the active one hosts the
modules. `BalancerModule` optimizes placement on the batched mapper and the
move-scoring kernel and commits pg_upmap_items through the mon's command
path (the reference's pybind/mgr/balancer/module.py). `MetricsModule` rings
the perf-counter reports daemons push into per-daemon time-series, serves
Prometheus and `ceph top` from them, and evaluates SLO rules into health
checks; `TraceCollector` keeps the tail-promoted traces; `PgAutoscaler`,
`PrometheusExporter` and the dashboard are the other hosted modules.

Port of ceph_tpu/mgr: `MgrService(device=)` and `BalancerModule(device=)`
take a device (None = cuda, which raises without a card).
"""

from ceph_tpu_torch.mgr.autoscaler import PgAutoscaler
from ceph_tpu_torch.mgr.balancer import BalancerModule
from ceph_tpu_torch.mgr.daemon import MgrService
from ceph_tpu_torch.mgr.metrics import MetricsModule, parse_slo_rules
from ceph_tpu_torch.mgr.prometheus import PrometheusExporter

__all__ = [
    "BalancerModule", "MetricsModule", "MgrService", "PgAutoscaler",
    "PrometheusExporter", "parse_slo_rules",
]
