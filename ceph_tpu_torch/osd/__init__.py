"""OSD-side modules of the port: the pool and PG types (`types`), the OSDMap
with its batched pool mappings (`osdmap`), the batching EncodeService, the
object store and the OSD daemon (`daemon`)."""

from ceph_tpu_torch.osd.types import PgPool, ceph_stable_mod, pg_num_mask
from ceph_tpu_torch.osd.osdmap import OSDMap

__all__ = ["PgPool", "OSDMap", "ceph_stable_mod", "pg_num_mask"]
