"""ceph_tpu_torch.coord: coordination layer over RADOS — cls_lock leases,
leader election, and the multi-host training-fleet runtime.

Layer 1 (`coord.lock`) wraps the `lock` object class (osd/cls.py):
advisory exclusive/shared locks with cookie+owner identity and lease
TTLs, a background renew loop, break-on-expired recovery, and
watch/notify wakeup so waiters never poll in the steady state — the
Chubby recipe (locks/leases/elections layered on a consistent core)
with RADOS as the core, exactly how the reference's cls_lock serves
RBD exclusive-lock and RGW.

Layer 2 (`coord.fleet` + `coord.driver` + `coord.mesh`) is the
training-side fleet runtime: rank registration against a
HEAD-CAS-published roster object, heartbeat leases, leader election,
epoch-numbered barriers (with sub-group barriers for pipeline stages
and per-save writer sets), a fleet-mesh view of the roster
(`coord.mesh`), and the driver that wires it all to CkptStore
(fleet-parallel saves where every host writes only its shards,
mesh-native zero-reassembly restore) and the data iterator
(roster-derived strided slices that re-partition exactly on
membership change).

Port of ceph_tpu/coord: the fleet mesh is a `parallel.sharding.Mesh`
(`fleet_mesh(n, devices=...)`; the visible cards by default), and the
rest is a copy.
"""

from ceph_tpu_torch.coord.driver import FleetDriver
from ceph_tpu_torch.coord.fleet import Fleet
from ceph_tpu_torch.coord.lock import Lock, make_coord_perf
from ceph_tpu_torch.coord.mesh import fleet_mesh, fleet_spec, from_fleet, shard_tree

__all__ = [
    "Fleet", "FleetDriver", "Lock", "make_coord_perf",
    "fleet_mesh", "fleet_spec", "from_fleet", "shard_tree",
]
