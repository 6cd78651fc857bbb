"""Twins of the device mesh layer: ceph_tpu_torch.parallel.sharding and
EncodeService's mesh path against ceph_tpu's, bit-exact.

The port's mesh here is eight slots on the CPU (a mesh may repeat a device),
where each slot runs B3's plain version; ceph_tpu's is `ec_mesh(8)` over
conftest's eight virtual CPU devices. Inputs come from numpy seeds.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from ceph_tpu.ckpt.layout import fleet_slab
from ceph_tpu.ec.registry import factory as ref_factory
from ceph_tpu.osd.encode_service import EncodeService as RefEncodeService
from ceph_tpu.parallel import sharding as ref_sh
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.osd.encode_service import EncodeService
from ceph_tpu_torch.parallel import sharding as sh

ISA = ("isa", {"k": "8", "m": "3", "technique": "cauchy"})
CODECS = [ISA, ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
          ("tpu", {"k": "6", "m": "4"})]


def cpu_mesh(shape):
    grid = np.empty(shape, dtype=object)
    grid[...] = torch.device("cpu")
    return sh.Mesh(grid, ("stripe", "byte"))


@pytest.fixture(scope="module")
def meshes():
    return ref_sh.ec_mesh(8), sh.ec_mesh(devices=["cpu"] * 8)


def codecs(plugin, profile):
    return ref_factory(plugin, dict(profile)), factory(plugin, dict(profile), device="cpu")


@pytest.mark.parametrize("plugin,profile", CODECS)
def test_sharded_encode_matches_ceph_tpu(meshes, plugin, profile):
    ref_mesh, mesh = meshes
    ref, port = codecs(plugin, profile)
    rng = np.random.default_rng(ref.k * 7 + ref.m)
    data = rng.integers(0, 256, (8, ref.k, 512), np.uint8)
    want = np.asarray(ref_sh.sharded_encode(ref, ref_sh.shard_batch(data, ref_mesh), ref_mesh))
    got = sh.sharded_encode(port, sh.shard_batch(data, mesh), mesh)
    assert got.shape == want.shape and got.spec == sh.DATA_SPEC
    assert np.array_equal(got.full("cpu").numpy(), want)
    for idx, block in got.slots:
        assert np.array_equal(block.numpy(), want[idx])
    planes = rng.integers(0, 256, (ref.k, 8 * 1024), np.uint8)
    want = ref_sh.mesh_encode_planar(ref, planes, ref_mesh)
    assert np.array_equal(sh.mesh_encode_planar(port, planes, mesh), want)
    got = sh.mesh_encode_planar(port, torch.from_numpy(planes), mesh)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("lost", [[0], [0, 1, 2], [2, 7, 10], [8, 9, 10]])
def test_sharded_decode_matches_ceph_tpu(meshes, lost):
    ref_mesh, mesh = meshes
    ref, port = codecs(*ISA)
    rng = np.random.default_rng(sum(lost))
    data = rng.integers(0, 256, (8, 8, 512), np.uint8)
    full = np.concatenate([data, np.asarray(ref.encode_array(data))], axis=1)
    present = [i for i in range(11) if i not in lost]
    survivors = full[:, present[:8], :]
    targets = [t for t in lost if t < 8] or lost
    want = np.asarray(ref_sh.sharded_decode(
        ref, present, targets, ref_sh.shard_batch(survivors, ref_mesh), ref_mesh))
    got = sh.sharded_decode(port, present, targets, sh.shard_batch(survivors, mesh), mesh)
    assert np.array_equal(got.full("cpu").numpy(), want)
    for pos, t in enumerate(targets):
        assert np.array_equal(want[:, pos, :], full[:, t, :])
    planes = np.ascontiguousarray(survivors.transpose(1, 0, 2).reshape(8, -1))
    want = ref_sh.mesh_decode_planar(ref, present, targets, planes, ref_mesh)
    assert np.array_equal(sh.mesh_decode_planar(port, present, targets, planes, mesh), want)


def _mesh_pair(shape):
    """ceph_tpu's (stripe, byte) mesh of that shape and the port's on the CPU."""
    n = int(np.prod(shape))
    ref = JaxMesh(np.array(jax.devices()[:n]).reshape(shape), ("stripe", "byte"))
    return ref, cpu_mesh(shape)


SLAB_CASES = [
    ((8, 6), ("stripe", None)), ((8, 6), (None, "byte")), ((8, 6), ["stripe"]),
    ((16, 3), (("stripe", "byte"), None)), ((8, 2), (("byte", "stripe"),)),
    ((8, 6), ("stripe", "byte")), ((8, 2, 4), ("stripe", None, "byte")),
    ((0, 3), ("stripe",)), ((5,), ("nope",)), ((8, 4), ("stripe", ("byte", "nope"))),
    ((4, 4), ()), ((), ()),
]


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2), (8, 1)])
def test_device_slices_and_byte_runs_match_ceph_tpu(mesh_shape):
    """Even layouts, replicated and absent axis names: each slot's index
    equals jax's; every slab's byte runs equal ceph_tpu's."""
    ref_mesh, mesh = _mesh_pair(mesh_shape)
    for shape, spec in SLAB_CASES:
        ref_map = ref_sh.device_slices(shape, spec, ref_mesh)
        got = sh.device_slices(shape, spec, mesh)
        assert got == [ref_map[d] for d in ref_mesh.devices.flat], (shape, spec)
        for idx in got:
            for itemsize in (1, 4):
                assert (sh.slice_byte_runs(shape, itemsize, idx)
                        == ref_sh.slice_byte_runs(shape, itemsize, idx))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 2), (8, 1)])
def test_ragged_slabs_follow_the_ceil_div_convention(mesh_shape):
    """An axis the mesh does not divide: ceil-div slabs, the last short or
    empty, as ceph_tpu's fleet_slab states the convention."""
    _ref_mesh, mesh = _mesh_pair(mesh_shape)
    stripes = mesh.shape["stripe"]
    for n in (1, 3, 10, 50257):
        for (s, _b), idx in zip(np.ndindex(mesh.devices.shape),
                                sh.device_slices((n, 3), ("stripe", None), mesh)):
            assert idx[0].indices(n) == fleet_slab(n, stripes, s).indices(n)
            assert idx[1] == slice(None)
            assert (sh.slice_byte_runs((n, 3), 2, idx)
                    == ref_sh.slice_byte_runs((n, 3), 2, idx))


def test_host_slice_matches_ceph_tpu():
    for n in (0, 1, 7, 10, 100):
        for hosts in (1, 3, 8):
            assert ([sh.host_slice(n, hosts, h) for h in range(hosts)]
                    == [ref_sh.host_slice(n, hosts, h) for h in range(hosts)])
    for bad in ((4, 0, 0), (4, 2, 2)):
        with pytest.raises(ValueError):
            sh.host_slice(*bad)


def test_place_and_full_on_a_mesh_with_repeated_devices():
    """A slot on the tensor's own device holds a view of it; full() gathers
    each distinct slab once."""
    mesh = cpu_mesh((2, 2))
    value = torch.arange(6 * 5, dtype=torch.int32).reshape(6, 5)
    arr = sh.place(value, ("stripe", "nope"), mesh)
    assert arr.spec == ("stripe", None)
    assert [idx for idx, _t in arr.slots] == [(slice(0, 3), slice(None))] * 2 + [
        (slice(3, 6), slice(None))] * 2
    assert all(t.data_ptr() == value[idx].data_ptr() for idx, t in arr.slots)
    assert torch.equal(arr.full("cpu"), value)
    with pytest.raises(ValueError):
        sh.Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("stripe", "byte"))


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 60))


async def service_round(svc, codec):
    """The scenario of test_encode_service's mesh test: 6 concurrent 20000 B
    writes, then the rebuild of logical chunk 0 of each, batched."""
    n = codec.get_chunk_count()
    rng = np.random.default_rng(41)
    payloads = [rng.integers(0, 256, 20000, np.uint8).tobytes() for _ in range(6)]
    encoded = await asyncio.gather(*(svc.encode(codec, p) for p in payloads))
    after_encode = svc.mesh_launches
    jobs = []
    for p in payloads:
        chunks = codec.encode(range(n), p)
        want = {codec.chunk_index(j) for j in range(codec.k)}
        jobs.append((want, {c: b for c, b in chunks.items() if c != codec.chunk_index(0)}))
    decoded = await asyncio.gather(*(svc.decode(codec, w, s) for w, s in jobs))
    return encoded, decoded, after_encode, svc.mesh_launches - after_encode


@pytest.mark.parametrize("slots", [8, 0])
def test_encode_service_mesh_path_matches_ceph_tpu(slots):
    """Wide batches dispatch through an explicit 8-slot CPU mesh (mesh_min_bytes
    4096), as ceph_tpu's service does over its 8 devices: equal chunks, and
    the mesh path taken both ways in both packages. With no mesh a CPU
    service has none of its own and keeps its single-device path."""
    ref_codec, codec = codecs("tpu", {"k": "3", "m": "2"})
    want = run(service_round(RefEncodeService(window=0.001, mesh_min_bytes=4096), ref_codec))
    mesh = sh.ec_mesh(devices=["cpu"] * slots) if slots else None
    got = run(service_round(
        EncodeService(window=0.001, mesh_min_bytes=4096, device="cpu", mesh=mesh), codec))
    assert got[:2] == want[:2]
    assert want[2] >= 1 and want[3] >= 1
    assert (got[2] >= 1 and got[3] >= 1) if slots else got[2:] == (0, 0)
