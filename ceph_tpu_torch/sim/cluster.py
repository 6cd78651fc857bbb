"""Synthetic cluster maps for the placement simulator.

build_cluster grows the osdmaptool build_simple shape to reference
scale: OSDs under hosts under racks under one root (straw2 all the way),
a replicated chooseleaf-firstn-host rule, an erasure chooseleaf-indep-
host rule, and both pool kinds — the map a thousand-OSD production
cluster actually hands the balancer.

Copy of ceph_tpu/sim/cluster.py; `device` is the OSDMap's (None = cuda).
"""

from __future__ import annotations

from ceph_tpu_torch.crush import builder as cb
from ceph_tpu_torch.crush.types import BucketAlg, CrushMap, Tunables
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import TYPE_ERASURE, TYPE_REPLICATED, PgPool

#: CRUSH type ids (the reference's default types table)
TYPE_OSD, TYPE_HOST, TYPE_RACK, TYPE_ROOT = 0, 1, 3, 10

REP_RULE, EC_RULE = 0, 1


def build_cluster(
    n_osd: int,
    osds_per_host: int = 8,
    hosts_per_rack: int = 4,
    rep_pg_num: int = 0,
    rep_size: int = 3,
    ec_pg_num: int = 0,
    ec_k: int = 4,
    ec_m: int = 2,
    device=None,
) -> OSDMap:
    """An OSDMap with osd -> host -> rack -> root hierarchy and (when the
    pg counts are non-zero) pool 1 replicated / pool 2 erasure.

    Bucket ids: hosts -(2+h), racks then root below those — ids only
    need to be unique and negative. Every bucket is straw2 so the
    batched mapper's fast path covers the whole map. `device` is where
    the map's batched mapper and move scorer run.
    """
    cmap = CrushMap(tunables=Tunables.jewel())
    cmap.type_names = {
        TYPE_OSD: "osd", TYPE_HOST: "host",
        TYPE_RACK: "rack", TYPE_ROOT: "root",
    }
    n_hosts = max(1, (n_osd + osds_per_host - 1) // osds_per_host)
    host_ids, host_ws = [], []
    osd = 0
    for h in range(n_hosts):
        items = list(range(osd, min(osd + osds_per_host, n_osd)))
        if not items:
            break
        osd += len(items)
        b = cb.make_bucket(
            cmap, -(2 + h), BucketAlg.STRAW2, TYPE_HOST, items,
            [0x10000] * len(items),
        )
        cmap.item_names[b.id] = f"host{h}"
        host_ids.append(b.id)
        host_ws.append(b.weight)
    n_racks = max(1, (len(host_ids) + hosts_per_rack - 1) // hosts_per_rack)
    rack_ids, rack_ws = [], []
    for r in range(n_racks):
        hs = host_ids[r * hosts_per_rack : (r + 1) * hosts_per_rack]
        if not hs:
            break
        ws = host_ws[r * hosts_per_rack : (r + 1) * hosts_per_rack]
        b = cb.make_bucket(
            cmap, -(2 + n_hosts + r), BucketAlg.STRAW2, TYPE_RACK, hs, ws,
        )
        cmap.item_names[b.id] = f"rack{r}"
        rack_ids.append(b.id)
        rack_ws.append(b.weight)
    root = cb.make_bucket(
        cmap, -1, BucketAlg.STRAW2, TYPE_ROOT, rack_ids, rack_ws
    )
    cmap.item_names[root.id] = "default"
    for o in range(n_osd):
        cmap.item_names[o] = f"osd.{o}"

    # replicas spread across HOSTS (racks would cap rep_size at the rack
    # count; host is the reference's default failure domain)
    cb.make_simple_rule(cmap, REP_RULE, -1, TYPE_HOST, "firstn", 0)
    cmap.rule_names[REP_RULE] = "replicated_rule"
    cb.make_simple_rule(cmap, EC_RULE, -1, TYPE_HOST, "indep", 0)
    cmap.rule_names[EC_RULE] = "erasure_rule"

    m = OSDMap(crush=cmap, max_osd=n_osd, device=device)
    if rep_pg_num:
        m.pools[1] = PgPool(
            pg_num=rep_pg_num, size=rep_size, min_size=2,
            type=TYPE_REPLICATED, crush_rule=REP_RULE,
        )
    if ec_pg_num:
        m.pools[2] = PgPool(
            pg_num=ec_pg_num, size=ec_k + ec_m, min_size=ec_k + 1,
            type=TYPE_ERASURE, crush_rule=EC_RULE,
        )
    return m
