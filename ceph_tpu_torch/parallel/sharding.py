"""The sharded GF(2^8) matmul over a (stripe, byte) device mesh, and the slab
math of reshard-on-load.

Port of ceph_tpu/parallel/sharding.py. Each chunk-byte column is independent
in GF(2^8) linear algebra, so both the stripe-batch axis and the chunk-byte
axis shard with no communication: every mesh slot multiplies its own block by
the same bit-matrix.

`Mesh` is the counterpart of `jax.sharding.Mesh` for one process that drives
every device: a numpy grid of `torch.device`s with named axes. It is not
`torch.distributed`'s DeviceMesh/DTensor, which is SPMD (one process per
device and an initialised process group); the reference's mesh is a single
controller, and so is this one. A mesh may name one device more than once,
the counterpart of the virtual CPU devices the JAX tests force.

A spec is a tuple of `None | axis name | tuple of axis names`, one entry per
array axis (the counterpart of `PartitionSpec`). `MeshArray` is an array laid
out on a mesh by a spec: one tensor per slot, in mesh order, with the index
tuple of the global array it holds.

`_sharded_matmul` is the port of the reference's shard_map'd kernel (B8).
That TPU function is a map of B3 over the slots, so its CUDA form is one
launch of the hand-written B3 (`csrc/gf_matmul.cu`'s byte entry point,
through `ops.gf_bitplane.gf_matmul_bitplane`) per slot, on the current
stream of the slot's device, over a strided view of its block: B3 takes any
batch and row strides with the last axis contiguous, so the stripe/byte
split copies nothing on the card. A mesh built from the visible cards
(`ec_mesh`, `EncodeService`'s) has one slot a card, so a call is one launch
a card, and launches on different cards run concurrently. B8 moves the same
bytes as one B3 launch over the whole batch, and that launch's bound,
(k + r) bytes a column at 3.35 TB/s, is B8's. The host adds only a lookup
of the coding tables' copy on each other card (`gf_cuda.tables_to` keeps
it). There is no new CUDA source. On a CPU slot the same wrapper runs B3's
plain version. Each card launch adds one to `gf_matmul_bitplane.launches`.

The slab math follows jax's ceil-div convention (the last slabs of an axis
that the mesh does not divide run short or empty, as
`ckpt.layout.fleet_slab` states it); jax itself refuses such shapes.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ops import gf_bitplane as bp
from ceph_tpu_torch.ops import gf_cuda as gc

DATA_SPEC = ("stripe", None, "byte")


class Mesh:
    """A grid of devices with named axes; `shape[name]` is an axis' size."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-axis grid needs {grid.ndim} axis names")
        self.devices = np.empty(grid.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            dev = resolve_device(grid[pos])
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.devices[pos] = dev
        kinds = {d.type for d in self.devices.flat}
        if len(kinds) != 1:
            raise ValueError(f"a mesh holds one kind of device, got {sorted(kinds)}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def slot_devices(self) -> list[torch.device]:
        """Each slot's device, in mesh (row-major) order."""
        return list(self.devices.flat)


def ec_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """2D (stripe, byte) mesh over the first n devices: (n//2, 2) for even n,
    (n, 1) for odd. By default it spans the visible cards (and raises without
    one); `devices` names them instead, a device may repeat."""
    if devices is None:
        resolve_device("cuda")
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else n_devices
        if not 1 <= n <= visible:
            raise ValueError(f"ec_mesh({n_devices}): {visible} cards visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = list(devices)
        n = len(devs) if n_devices is None else n_devices
        if not 1 <= n <= len(devs):
            raise ValueError(f"ec_mesh({n_devices}) over {len(devs)} devices")
        devs = devs[:n]
    shape = (n // 2, 2) if n % 2 == 0 else (n, 1)
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), ("stripe", "byte"))


def _kept(spec, mesh: Mesh, ndim: int) -> tuple:
    """The spec's entries for `ndim` axes, names absent from the mesh
    dropped (an entry left with none means replicated)."""
    names = set(mesh.axis_names)
    out = []
    for entry in tuple(spec or ())[:ndim]:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in names else None)
    return tuple(out)


def device_slices(shape, spec, mesh: Mesh) -> list[tuple]:
    """Each slot's index tuple of an array of `shape` laid out as `spec` on
    `mesh`, in mesh order: jax's `addressable_devices_indices_map` as a list
    (a mesh may repeat a device).

    Spec axis names absent from the mesh degrade to replication, so a
    checkpoint saved on a ("stripe", "byte") mesh restores on a mesh with
    other axis names without edits. An axis split n > 1 ways takes
    ceil(dim / n) rows a slab; an axis split once is `slice(None)`.
    """
    shape = tuple(int(d) for d in shape)
    entries = _kept(spec, mesh, len(shape))
    entries += (None,) * (len(shape) - len(entries))
    axis_pos = {n: i for i, n in enumerate(mesh.axis_names)}
    out = []
    for coords in np.ndindex(mesh.devices.shape):
        idx = []
        for dim, entry in zip(shape, entries):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            parts, pos = 1, 0
            for a in axes:  # major to minor, in the entry's order
                size = mesh.shape[a]
                parts, pos = parts * size, pos * size + coords[axis_pos[a]]
            if parts == 1:
                idx.append(slice(None))
                continue
            slab = -(-dim // parts)
            idx.append(slice(min(dim, pos * slab), min(dim, (pos + 1) * slab)))
        out.append(tuple(idx))
    return out


def _slab_key(idx, shape) -> tuple:
    return tuple(sl.indices(dim) for sl, dim in zip(idx, shape))


class MeshArray:
    """A global array laid out on a mesh: `slots` holds (index tuple, tensor)
    per mesh slot, in mesh order, each tensor on its slot's device."""

    def __init__(self, shape, dtype: torch.dtype, spec, mesh: Mesh, slots):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.spec = tuple(spec)
        self.mesh = mesh
        self.slots = list(slots)
        if len(self.slots) != mesh.size:
            raise ValueError(f"{len(self.slots)} slots for a mesh of {mesh.size}")

    def full(self, device=None) -> torch.Tensor:
        """The whole array gathered onto `device` (cuda by default): each
        distinct slab copied once."""
        out = torch.empty(self.shape, dtype=self.dtype, device=resolve_device(device))
        seen = set()
        for idx, block in self.slots:
            key = _slab_key(idx, self.shape)
            if key not in seen:
                seen.add(key)
                out[idx].copy_(block)
        return out


def place(value, spec, mesh: Mesh) -> MeshArray:
    """Lay out a numpy array or tensor on `mesh` as `spec`. A slot on the
    device the tensor already lies on holds a view of it (no copy); every
    other slot gets a copy of its block, one per distinct (slab, device)."""
    if isinstance(value, np.ndarray):
        # not np.ascontiguousarray, which makes a 0-d array 1-d
        contiguous = value.flags.c_contiguous and value.flags.writeable
        value = torch.from_numpy(value if contiguous else value.copy())
    kept = _kept(spec, mesh, value.dim())
    slots, copies = [], {}
    for idx, dev in zip(device_slices(value.shape, kept, mesh), mesh.slot_devices()):
        view = value[idx]
        if view.device != dev:
            key = (_slab_key(idx, value.shape), dev)
            if key not in copies:
                copies[key] = view.to(dev)
            view = copies[key]
        slots.append((idx, view))
    return MeshArray(value.shape, value.dtype, kept, mesh, slots)


def shard_batch(data, mesh: Mesh) -> MeshArray:
    """Place a (batch, n, chunk) uint8 array (numpy or tensor) onto the mesh,
    batch on `stripe`, chunk bytes on `byte`."""
    return place(data, DATA_SPEC, mesh)


def _sharded_matmul(mesh: Mesh, coding, data: MeshArray) -> MeshArray:
    """B8: every slot multiplies its (B/S, k, L/Bb) block by the replicated
    bit-matrix of `coding` (a codec's `CodingTables`) with one B3 launch on
    its device's current stream; no communication. The kernel tables are
    copied to each other device the mesh names once, and kept
    (`gc.tables_to`)."""
    r8 = coding.bits_t.shape[0]
    batch, _k, length = data.shape
    slots = [(idx, bp.gf_matmul_bitplane(coding.bits_t, block,
                                         tables=gc.tables_to(coding.tables_t, block.device)))
             for idx, block in data.slots]
    return MeshArray((batch, r8 // 8, length), torch.uint8, DATA_SPEC, mesh, slots)


def sharded_encode(ec, data: MeshArray, mesh: Mesh) -> MeshArray:
    """(batch, k, chunk) sharded -> (batch, m, chunk) parity, sharded: every
    slot encodes its block with B3; no communication."""
    return _sharded_matmul(mesh, ec._encode, data)


def sharded_decode(ec, present, targets, survivors: MeshArray, mesh: Mesh) -> MeshArray:
    """Rebuild logical chunks `targets` from sharded survivors (batch, >=k,
    chunk). The decode matrix is resolved on the host from the erasure
    signature (the codec's table cache) and used by every slot."""
    coding = ec.decode_bitmatrix(list(present), list(targets))
    k = ec.k
    first_k = MeshArray(
        (survivors.shape[0], k, survivors.shape[2]), survivors.dtype, survivors.spec, mesh,
        [(idx, block[:, :k, :]) for idx, block in survivors.slots])
    return _sharded_matmul(mesh, coding, first_k)


# -- planar entry points (the EncodeService mesh path) ------------------------
#
# The batch service packs concurrent objects' chunks end to end into (k, W)
# planar rows. Byte columns are independent, so the W axis folds exactly into
# the 2D mesh: split W into `stripe` blocks whose chunks then shard on `byte`:
# one reshape, no communication, bit-exact against one device. A numpy input
# gives a numpy output (gathered to the host); a tensor input gives a tensor
# on its own device.


def _fold(planes, mesh: Mesh):
    """(k, W) -> a (S, k, W/S) view: stripe block s is columns s*W/S.."""
    k, w = planes.shape
    s = mesh.shape["stripe"]
    if w % s:
        raise ValueError(f"planar width {w} does not fold onto {s} stripe blocks")
    folded = planes.reshape(k, s, w // s)
    if isinstance(planes, np.ndarray):
        return folded.transpose(1, 0, 2)
    return folded.transpose(0, 1)


def _unfold(out: MeshArray, like, rows: int, w: int):
    if isinstance(like, np.ndarray):
        return out.full("cpu").numpy().transpose(1, 0, 2).reshape(rows, w)
    return out.full(like.device).transpose(0, 1).reshape(rows, w)


def mesh_encode_planar(ec, planes, mesh: Mesh):
    """(k, W) uint8 planar rows -> (m, W) parity through the sharded kernel.
    W must be a multiple of the stripe axis (callers pad with zero columns,
    which encode to zero parity)."""
    _k, w = planes.shape
    out = sharded_encode(ec, shard_batch(_fold(planes, mesh), mesh), mesh)
    return _unfold(out, planes, out.shape[1], w)


def mesh_decode_planar(ec, present, targets, planes, mesh: Mesh):
    """(k, W) planar survivor rows (logical ids `present`, ascending) ->
    (len(targets), W) rebuilt rows, sharded like mesh_encode_planar."""
    _k, w = planes.shape
    out = sharded_decode(ec, present, targets,
                         shard_batch(_fold(planes, mesh), mesh), mesh)
    return _unfold(out, planes, len(targets), w)


# -- reshard-on-load (the ckpt reader's mesh-independence contract) -----------


def host_slice(n: int, num_hosts: int, host: int) -> slice:
    """Balanced contiguous partition of `n` items across `num_hosts`:
    host h owns items [start, stop) with the first n % num_hosts hosts
    taking one extra. Pure and total — every process computes the same
    partition, which is what makes the dataset iterator's per-host
    record sequences deterministic without coordination (the same
    contract device_slices provides for array slabs)."""
    if num_hosts <= 0:
        raise ValueError("num_hosts must be positive")
    if not 0 <= host < num_hosts:
        raise ValueError(f"host {host} outside [0, {num_hosts})")
    base, extra = divmod(n, num_hosts)
    start = host * base + min(host, extra)
    stop = start + base + (1 if host < extra else 0)
    return slice(start, stop)


def slice_byte_runs(shape, itemsize: int, idx) -> list[tuple[int, int]]:
    """Contiguous (offset, length) byte runs of a row-major array covered
    by index-tuple `idx`, coalesced: a slab contiguous in memory (the
    common leading-axis shard) collapses to ONE run regardless of rank."""
    shape = tuple(shape)
    if not shape:
        return [(0, itemsize)]
    starts, stops = [], []
    for dim, sl in zip(shape, tuple(idx) + (slice(None),) * len(shape)):
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise ValueError("strided shards are not supported")
        starts.append(start)
        stops.append(stop)
    # trailing axes taken whole are part of one contiguous row
    row = itemsize
    tail = len(shape)
    while tail > 0 and starts[tail - 1] == 0 and stops[tail - 1] == shape[tail - 1]:
        row *= shape[tail - 1]
        tail -= 1
    if tail == 0:
        return [(0, row)] if row else []
    row_len = (stops[tail - 1] - starts[tail - 1]) * row
    if row_len <= 0:
        return []
    # iterate the remaining (outer) index space, coalescing adjacency
    runs: list[tuple[int, int]] = []
    outer = [range(starts[d], stops[d]) for d in range(tail - 1)]
    stride = [row]
    for d in range(tail - 1, 0, -1):
        stride.insert(0, stride[0] * shape[d])

    def emit(off, length):
        if runs and runs[-1][0] + runs[-1][1] == off:
            runs[-1] = (runs[-1][0], runs[-1][1] + length)
        else:
            runs.append((off, length))

    for combo in itertools.product(*outer) if outer else [()]:
        off = sum(c * s for c, s in zip(combo, stride[:-1]))
        off += starts[tail - 1] * row
        emit(off, row_len)
    return runs


def slab_shape(idx, shape) -> tuple[int, ...]:
    """The shape of the block `idx` selects from an array of `shape`."""
    return tuple(len(range(*sl.indices(dim))) for sl, dim in zip(idx, shape))


__all__ = [
    "DATA_SPEC", "Mesh", "MeshArray", "ec_mesh", "place", "shard_batch",
    "sharded_encode", "sharded_decode", "mesh_encode_planar", "mesh_decode_planar",
    "device_slices", "host_slice", "slice_byte_runs", "slab_shape",
]
