"""ceph_tpu_torch.sim — the big-cluster placement simulator.

Port of ceph_tpu/sim: synthetic thousand-OSD maps with a host/rack
hierarchy (cluster.build_cluster) and deterministic seeded event scripts —
OSD flaps out/in, reweights, map churn epochs — with per-epoch
backfill-storm estimation and batched-balancer convergence reporting
(scenario.run_scenario). `python -m ceph_tpu_torch.tools.psim` is the CLI
front. The chaos harness (ceph_tpu/sim/chaos.py) is not ported yet.

Everything is seeded and wall-clock free: the same seed produces a
byte-identical report (timing fields appear only under measure=True).
"""

from ceph_tpu_torch.sim.cluster import build_cluster
from ceph_tpu_torch.sim.scenario import run_scenario

__all__ = ["build_cluster", "run_scenario"]
