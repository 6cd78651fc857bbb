"""Client-facing data path (the librados/Objecter layer analogue)."""

from ceph_tpu_torch.rados.cluster import MiniCluster

__all__ = ["MiniCluster"]
