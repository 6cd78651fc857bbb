"""coord.mesh: the fleet mesh from the live Fleet roster, the fleet-side
analogue of `jax.distributed.initialize`.

The roster document (coord/fleet.py) already gives every host the same
sorted live-member list, so every host derives the same 1-D mesh over
the axis `"fleet"`: position r on the mesh IS roster rank r. On a real
fleet each mesh position is a different host's device; in tests and on
one card the positions repeat one device (`devices=["cpu"] * N`, or
`["cuda:0"] * N`), which is what lets the chunk-cut/slab agreement
(`layout.fleet_slab` vs `device_slices`) be checked without a fleet.

`shard_tree` is the SNIPPETS.md [3] idiom: leading-axis sharding when
the axis divides the fleet, replication otherwise — the shape the
fleet-parallel save path (coord/driver.py) slab-aligns its chunk cuts
around.

Port of ceph_tpu/coord/mesh.py over `parallel.sharding`: the mesh is a
`parallel.sharding.Mesh`, a spec is a tuple of axis names (the
counterpart of `PartitionSpec`), `shard_tree` lays leaves out as
`MeshArray`s with `place`, and `rank_slab` takes entry `rank` of
`device_slices`' list (a dict keyed by device would merge the repeated
slots of a one-card fleet). With no `devices`, a fleet mesh spans the
visible cards and raises without one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree

from ceph_tpu_torch.ckpt.layout import FLEET_AXIS
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.parallel.sharding import Mesh, device_slices, place


def fleet_mesh(num_hosts: int, *, devices=None) -> Mesh:
    """A 1-D (`fleet`,) mesh over `num_hosts` positions. `devices`
    defaults to the visible cards (a real fleet passes its per-host
    device list; one card names itself once per position)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if num_hosts <= 0:
        raise ValueError("num_hosts must be positive")
    if len(devices) < num_hosts:
        raise ValueError(
            f"fleet of {num_hosts} needs {num_hosts} devices, "
            f"have {len(devices)}"
        )
    grid = np.empty(num_hosts, dtype=object)
    grid[:] = list(devices[:num_hosts])
    return Mesh(grid, (FLEET_AXIS,))


def fleet_spec(shape, num_hosts: int) -> tuple:
    """The spec a fleet of `num_hosts` gives an array of `shape`: leading
    axis sharded over `fleet` when it divides evenly (the SNIPPETS.md
    [2] rule), replicated otherwise."""
    shape = tuple(shape)
    if (num_hosts > 1 and shape and shape[0] >= num_hosts
            and shape[0] % num_hosts == 0):
        return (FLEET_AXIS,)
    return ()


def shard_tree(tree, mesh: Mesh):
    """Every leaf (numpy array, tensor or scalar) laid out on the fleet
    mesh under fleet_spec as a MeshArray — the input shape
    FleetDriver.save_async slab-aligns around. None stays None."""
    num_hosts = mesh.shape[FLEET_AXIS]

    def lay_out(leaf):
        if leaf is None:
            return None
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        return place(leaf, fleet_spec(tuple(leaf.shape), num_hosts), mesh)

    return _pytree.tree_map(lay_out, tree)


def rank_slab(shape, spec, mesh: Mesh, rank: int) -> tuple:
    """Roster rank `rank`'s index tuple of an array laid out as `spec` on
    the fleet mesh — straight from `parallel.sharding.device_slices`,
    the ground truth the chunk cutter's `layout.fleet_slab` math must
    agree with."""
    return device_slices(tuple(shape), spec, mesh)[rank]


async def from_fleet(fleet, devices=None):
    """(mesh, rank, num_hosts) for the CURRENT live roster. Every live
    host computes the same mesh from the same roster read; elastic
    reshard is just calling this again after the roster changed."""
    rank, num_hosts = await fleet.rank()
    return fleet_mesh(num_hosts, devices=devices), rank, num_hosts
