"""Pool/PG types and the stable-mod placement-seed math.

Mirrors the reference's `pg_pool_t` (osd_types.h:1155-1603) and the
`ceph_stable_mod` bin-split hash (include/rados.h:86-92): a PG id is
(pool, ps); `raw_pg_to_pps` folds ps and pool into the CRUSH input seed
(osd_types.cc:1640-1654) so different pools don't collide.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ceph_tpu_torch.crush.hash import crush_hash32_2, crush_hash32_2_np

# pg_pool_t::TYPE_* (osd_types.h:1156-1160)
TYPE_REPLICATED = 1
TYPE_ERASURE = 3

# pg_pool_t::FLAG_* (osd_types.h:1166+)
FLAG_HASHPSPOOL = 1 << 0


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """Stable modulo: bins can grow without reshuffling everything
    (include/rados.h:86-92)."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def ceph_stable_mod_np(x, b: int, bmask: int):
    x = np.asarray(x, dtype=np.int64)
    low = x & bmask
    return np.where(low < b, low, x & (bmask >> 1))


def pg_num_mask(pg_num: int) -> int:
    """Containing power-of-two minus one (pg_pool_t::calc_pg_masks)."""
    return (1 << max(pg_num - 1, 0).bit_length()) - 1


@dataclass
class PgPool:
    """The placement-relevant subset of pg_pool_t."""

    pg_num: int = 8
    pgp_num: int = 0  # defaults to pg_num
    size: int = 3
    min_size: int = 2
    type: int = TYPE_REPLICATED
    crush_rule: int = 0
    flags: int = FLAG_HASHPSPOOL
    # erasure profile name, carried for the data path (pg_pool_t stores the
    # profile name; the mon holds the name -> profile map)
    erasure_code_profile: str = ""
    #: self-managed snapshot allocator high-water (pg_pool_t::snap_seq);
    #: selfmanaged_snap_create returns snap_seq+1 committed via the mon
    snap_seq: int = 0
    #: deleted snap ids (pg_pool_t::removed_snaps interval_set, as a flat
    #: list at mini scale); OSDs trim clones covered only by removed snaps
    removed_snaps: list = field(default_factory=list)
    #: cache tiering (pg_pool_t::tier_of / read_tier / write_tier /
    #: cache_mode, osd_types.h): `tier_of` on the CACHE pool names its
    #: base; `read_tier`/`write_tier` on the BASE pool name the overlay
    #: the Objecter redirects to; cache_mode "" | "writeback"
    tier_of: int = -1
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = ""
    #: dirty objects a cache PG primary tolerates before the tier agent
    #: flushes to the base pool (cache_target_dirty_ratio's object-count
    #: role at mini scale)
    cache_target_dirty_max: int = 8

    def __post_init__(self):
        if not self.pgp_num:
            self.pgp_num = self.pg_num

    @property
    def pg_mask(self) -> int:
        return pg_num_mask(self.pg_num)

    @property
    def pgp_mask(self) -> int:
        return pg_num_mask(self.pgp_num)

    def is_erasure(self) -> bool:
        return self.type == TYPE_ERASURE

    def can_shift_osds(self) -> bool:
        """Replicated sets compact over gaps; EC sets are positional
        (pg_pool_t::can_shift_osds, osd_types.h)."""
        return self.type == TYPE_REPLICATED

    def raw_pg_to_pg(self, ps: int) -> int:
        """Full-precision ps -> actual pg ordinal (osd_types.cc:1628-1632)."""
        return ceph_stable_mod(ps, self.pg_num, self.pg_mask)

    def raw_pg_to_pps(self, pool_id: int, ps: int) -> int:
        """Placement seed for CRUSH (osd_types.cc:1640-1654)."""
        if self.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2(
                ceph_stable_mod(ps, self.pgp_num, self.pgp_mask), pool_id
            )
        return ceph_stable_mod(ps, self.pgp_num, self.pgp_mask) + pool_id

    def raw_pg_to_pps_np(self, pool_id: int, ps) -> np.ndarray:
        """Vectorized raw_pg_to_pps over an array of ps values."""
        stable = ceph_stable_mod_np(ps, self.pgp_num, self.pgp_mask)
        if self.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2_np(
                stable.astype(np.uint32), np.uint32(pool_id)
            ).astype(np.int64)
        return stable + pool_id
