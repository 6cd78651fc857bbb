"""vstart: the deterministic genesis map and loopback port picking.

Port of the reference package's `vstart.py`, for now only the two helpers
the in-process live tier and `tools.daemon_bench` share with it:
`initial_osdmap` (every mon builds the same epoch-1 map from the OSD count)
and `pick_ports`. The multi-process launcher (cluster spec, daemon mains,
`python -m` entry points) is not ported yet.
"""

from __future__ import annotations

import socket


def initial_osdmap(n_osds: int):
    """THE deterministic epoch-1 seed: one host per OSD (failures cross
    failure domains), straw2 root, rule 0 = indep (EC), rule 1 = firstn
    (replicated). Every mon of a cluster must build this identically from
    the spec alone, and the in-process live tier + daemon bench import it
    too, so single-process and multi-process behavior stay comparable."""
    from ceph_tpu_torch.crush import builder as cb
    from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
    from ceph_tpu_torch.osd.osdmap import OSDMap

    cmap = CrushMap(tunables=Tunables.jewel())
    host_ids, host_ws = [], []
    for h in range(n_osds):
        b = cb.make_bucket(
            cmap, -(h + 2), BucketAlg.STRAW2, 1, [h], [0x10000]
        )
        host_ids.append(b.id)
        host_ws.append(b.weight)
    cb.make_bucket(cmap, -1, BucketAlg.STRAW2, 10, host_ids, host_ws)
    cb.make_simple_rule(cmap, 0, -1, 1, "indep", 0)
    cb.make_simple_rule(cmap, 1, -1, 1, "firstn", 0)
    return OSDMap(crush=cmap, max_osd=n_osds)


def pick_ports(n: int) -> list[int]:
    """Reserve n distinct kernel-assigned loopback ports.

    All sockets stay open until every port is collected so the kernel can't
    hand the same port out twice; the (tiny, loopback-only) close->bind race
    is accepted, as vstart.sh accepts it with its fixed port ranges.
    """
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            socks.append(s)
    finally:
        for s in socks:
            s.close()
    return ports
