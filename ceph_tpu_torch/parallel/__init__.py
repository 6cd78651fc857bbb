"""Multi-device sharding layer: meshes and the sharded EC matmul.

Port of ceph_tpu/parallel: stripe batches shard over a device mesh ('stripe'
axis = data parallel over objects, 'byte' axis = a split of the chunk byte
columns), both free of communication for the GF(2^8) matmul.
"""

from ceph_tpu_torch.parallel.sharding import (
    Mesh,
    MeshArray,
    ec_mesh,
    shard_batch,
    sharded_decode,
    sharded_encode,
)

__all__ = ["Mesh", "MeshArray", "ec_mesh", "sharded_encode", "sharded_decode", "shard_batch"]
