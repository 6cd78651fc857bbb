"""ceph_tpu_torch.sim — the big-cluster placement simulator.

Port of ceph_tpu/sim: synthetic thousand-OSD maps with a host/rack
hierarchy (cluster.build_cluster) and deterministic seeded event scripts —
OSD flaps out/in, reweights, map churn epochs — with per-epoch
backfill-storm estimation and batched-balancer convergence reporting
(scenario.run_scenario). `python -m ceph_tpu_torch.tools.psim` is the CLI
front. The chaos harness compiles a seed into a timeline of OSD flaps,
partitions, kills and wire-fault storms (chaos.chaos_script) and replays it
daemon-free over a placement map (chaos.run_chaos); the live executor is
`python -m ceph_tpu_torch.tools.chaos_tool`.

Everything is seeded and wall-clock free: the same seed produces a
byte-identical report (timing fields appear only under measure=True).
"""

from ceph_tpu_torch.sim.chaos import chaos_script, run_chaos
from ceph_tpu_torch.sim.cluster import build_cluster
from ceph_tpu_torch.sim.scenario import run_scenario

__all__ = ["build_cluster", "chaos_script", "run_chaos", "run_scenario"]
