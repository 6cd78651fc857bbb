"""mon: the control plane (L7).

The reference's monitors hold the cluster's source of truth — every map
mutation is a Paxos-committed transaction over a quorum (src/mon/Monitor.cc,
Paxos.cc, OSDMonitor.cc), and daemons/clients subscribe for map updates via
MonClient. Same shape here: `Monitor` daemons elect a leader by rank, commit
versioned values through a collect/begin/commit Paxos round over the
messenger, persist them in a KeyValueDB, and run the OSDMonitor service
(pool/profile admin, boot + failure handling producing OSDMap
incrementals). `MonClient` finds the leader, authenticates, subscribes, and
relays commands.
"""

from ceph_tpu_torch.mon.monitor import Monitor, MonMap
from ceph_tpu_torch.mon.client import MonClient

__all__ = ["Monitor", "MonMap", "MonClient"]
