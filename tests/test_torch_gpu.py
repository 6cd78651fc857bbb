"""Tests that need a CUDA card: the hand-written kernels against their
plain torch versions on the card. They skip without one (deciding inside the
test). This file imports neither JAX nor the JAX package, so on a machine
that has no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ops import gf
from ceph_tpu_torch.ops import gf_cuda as gc


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """The hand-written kernel against its plain version on the card: a GF
    matrix, a non-GF bit-matrix, an aligned and a ragged width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    before = gc.gf_matmul_packed.launches
    bitmats = [gf.matrix_to_bitmatrix(rng.integers(0, 256, (3, 8), np.uint8)),
               (rng.random((24, 64)) < 0.5).astype(np.int8)]
    for bitmat in bitmats:
        packed = torch.from_numpy(gc.pack_matrix(bitmat)).cuda()
        tables = torch.from_numpy(gc.kernel_tables(bitmat)).cuda()
        for n4 in (1 << 16, (1 << 16) + 37):
            data = torch.randint(0, 256, (8, 4 * n4), dtype=torch.uint8,
                                 device="cuda", generator=gen)
            words = data.view(torch.int32)
            got = gc.gf_matmul_packed(packed, words, tables=tables)
            torch.cuda.synchronize()
            assert torch.equal(got, gc.gf_matmul_packed_plain(packed, words))
    assert gc.gf_matmul_packed.launches == before + 4


@pytest.mark.gpu
def test_gf_kernels_at_one_objects_width_match_plain_on_card():
    """B1 and B3 at the width the daemons and MiniCluster launch them (one
    4 MiB object of an RS(8,3) pool): B1 encode and decode with r = 1..3 on
    (8, 131072) words, B3 encode on (1, 8, 524288) bytes and decode from a
    strided survivors view, bit-exact; the tables' device-memory route too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import gf_bitplane as bp

    gen = torch.Generator(device="cuda").manual_seed(13)
    codec = factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    words = torch.randint(0, 256, (8, 4 * 131072), dtype=torch.uint8, device="cuda",
                          generator=gen).view(torch.int32)
    survivors = torch.randint(0, 256, (1, 11, 524288), dtype=torch.uint8, device="cuda",
                              generator=gen)
    present = list(range(3, 11))
    before = (gc.gf_matmul_packed.launches, bp.gf_matmul_bitplane.launches)
    tables = [codec._encode] + [codec.decode_bitmatrix(present, [0, 1, 2][:r])
                                for r in (1, 2, 3)]
    for t in tables:
        got = gc.gf_matmul_packed(t.packed_t, words, tables=t.tables_t)
        assert torch.equal(got, gc.gf_matmul_packed_plain(t.packed_t, words))
    enc = codec._encode
    data = survivors[:, :8].contiguous()
    got = bp.gf_matmul_bitplane(enc.bits_t, data, tables=enc.tables_t)
    assert torch.equal(got, bp.gf_matmul_bitplane_plain(enc.bits_t, data))
    view = survivors[:, 3:]  # a strided view, read in place
    dec = tables[3]
    got = bp.gf_matmul_bitplane(dec.bits_t, view, tables=dec.tables_t)
    assert torch.equal(got, bp.gf_matmul_bitplane_plain(dec.bits_t, view))
    # without the host copy of the tables the launcher reads them from
    # device memory (the route of r * k > 48)
    lib = gc._lib()
    out = words.new_empty((3, 131072))
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.gf_matmul_packed_launch(enc.tables_t.data_ptr(), None, words.data_ptr(),
                                       out.data_ptr(), 8, 3, 131072, stream) == 0
    assert torch.equal(out, gc.gf_matmul_packed_plain(enc.packed_t, words))
    torch.cuda.synchronize()
    assert (gc.gf_matmul_packed.launches, bp.gf_matmul_bitplane.launches) == \
        (before[0] + 4, before[1] + 2)


@pytest.mark.gpu
def test_live_k2m2_round_trip_on_card():
    """Monitors, OSD daemons and a client in one process with every codec on
    the card: EC writes, reads and degraded reads of a k2m2 pool launch the
    GF kernel through each primary's EncodeService."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    import asyncio
    import contextlib

    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.msg.messenger import next_dispatch_event
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.rados.client import Rados
    from ceph_tpu_torch.vstart import initial_osdmap

    async def main():
        cfg = Config()
        for key, value in (("mon_lease", 0.1), ("mon_election_timeout", 0.4),
                           ("osd_heartbeat_interval", 0.15), ("osd_heartbeat_grace", 2)):
            cfg.set(key, value)
        monmap = MonMap(addrs=[("127.0.0.1", 0)] * 3)
        mons = [Monitor(r, monmap, initial_osdmap(6), config=cfg) for r in range(3)]
        for m in mons:
            await m.bind()
        for m in mons:
            m.go()
        osds = {}
        for i in range(6):
            osds[i] = OSDService(i, monmap, config=cfg)
            await osds[i].start()
        rados = Rados("client.gpu", monmap, config=cfg)
        await rados.connect()
        await rados.mon_command("osd erasure-code-profile set", {
            "name": "k2m2", "profile": {"plugin": "tpu", "k": "2", "m": "2"}})
        await rados.mon_command("osd pool create", {
            "pool_id": 2, "crush_rule": 0, "erasure_code_profile": "k2m2", "pg_num": 8})
        io = rados.io_ctx(2)
        rng = np.random.default_rng(12)
        objects = {f"g{i}": rng.integers(0, 256, 65536 + 97 * i, np.uint8).tobytes()
                   for i in range(8)}
        writes = gc.gf_matmul_packed.launches
        for name, data in objects.items():
            await io.write_full(name, data)
        writes = gc.gf_matmul_packed.launches - writes
        for name, data in objects.items():
            assert await io.read(name) == data
        await osds.pop(0).stop()
        leader = next(m for m in mons if m.is_leader)
        while not leader.osdmap.is_down(0):
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(next_dispatch_event(), 0.25)
        for name, data in objects.items():
            assert await io.read(name) == data
        assert all(o.encode_service.device.type == "cuda" for o in osds.values())
        await rados.shutdown()
        for o in osds.values():
            await o.stop()
        for m in mons:
            await m.stop()
        return writes

    assert asyncio.run(asyncio.wait_for(main(), 120)) > 0


@pytest.mark.gpu
def test_sharded_matmul_on_a_slot_mesh_matches_one_launch():
    """B8 on a 2x2 mesh of four slots on one card: every slot's B3 launch
    over its strided block, on the card's current stream, gathered, equals
    one B3 launch over the whole batch, for an encode and a decode
    matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import gf_bitplane as bp
    from ceph_tpu_torch.parallel import sharding as sh

    codec = factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    mesh = sh.ec_mesh(devices=["cuda:0"] * 4)
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = torch.randint(0, 256, (8, 8, (1 << 16) + 24), dtype=torch.uint8, device="cuda",
                         generator=gen)
    before = bp.gf_matmul_bitplane.launches
    got = sh.sharded_encode(codec, sh.shard_batch(data, mesh), mesh).full("cuda")
    assert bp.gf_matmul_bitplane.launches == before + 4
    assert torch.equal(got, codec.encode_array(data))
    present, targets = list(range(3, 11)), [0, 1, 2]
    survivors = torch.cat([data, got], dim=1)[:, 3:, :]
    rebuilt = sh.sharded_decode(codec, present, targets, sh.shard_batch(survivors, mesh), mesh)
    assert torch.equal(rebuilt.full("cuda"), data[:, :3, :])


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [4, 8])
@pytest.mark.parametrize("case", ["even", "ragged", "survivors"])
def test_sharded_matmul_slots_match_one_launch_and_plain_on_card(slots, case):
    """B8 on a 2x2 and a 4x2 mesh of cuda:0: every slot's output equals a
    B3 launch over its block and the plain version, and the gathered result
    one B3 launch over the whole batch, bit for bit, with one launch a
    non-empty slot a call: whole 16-byte groups, a ragged (7, 8, 65,549)
    batch, and the decode's strided survivors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import gf_bitplane as bp
    from ceph_tpu_torch.parallel import sharding as sh

    codec = factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    mesh = sh.ec_mesh(devices=["cuda:0"] * slots)
    gen = torch.Generator(device="cuda").manual_seed(slots)
    shape = {"even": (8, 8, 1 << 16), "ragged": (7, 8, 65549), "survivors": (7, 11, 65549)}[case]
    data = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)
    coding = (codec.decode_bitmatrix(list(range(3, 11)), [0, 1, 2]) if case == "survivors"
              else codec._encode)
    laid = sh.shard_batch(data, mesh)
    first_k = sh.MeshArray((shape[0], 8, shape[2]), torch.uint8, sh.DATA_SPEC, mesh,
                           [(idx, block[:, :8, :]) for idx, block in laid.slots])
    before = bp.gf_matmul_bitplane.launches
    got = sh._sharded_matmul(mesh, coding, first_k)
    assert bp.gf_matmul_bitplane.launches == before + sum(
        block.numel() > 0 for _idx, block in first_k.slots)
    for (_idx, block), (_i, out) in zip(first_k.slots, got.slots):
        assert torch.equal(out, bp.gf_matmul_bitplane(coding.bits_t, block,
                                                      tables=coding.tables_t))
        assert torch.equal(out, bp.gf_matmul_bitplane_plain(coding.bits_t, block))
    whole = bp.gf_matmul_bitplane(coding.bits_t, data[:, :8, :], tables=coding.tables_t)
    assert torch.equal(got.full("cuda"), whole)


@pytest.mark.gpu
def test_mesh_across_cards_matches_one_launch():
    """On a host with several cards: the default mesh spans them, each slot
    launches B3 on its own card, and EncodeService picks that mesh up by
    itself; outputs equal one launch on card 0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    import asyncio

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.osd.encode_service import EncodeService
    from ceph_tpu_torch.parallel import sharding as sh

    codec = factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    mesh = sh.ec_mesh()
    assert {d.index for d in mesh.slot_devices()} == set(range(torch.cuda.device_count()))
    gen = torch.Generator(device="cuda").manual_seed(12)
    data = torch.randint(0, 256, (8, 8, 1 << 16), dtype=torch.uint8, device="cuda",
                         generator=gen)
    got = sh.sharded_encode(codec, sh.shard_batch(data, mesh), mesh)
    assert {block.device.index for _idx, block in got.slots} == set(range(mesh.size))
    assert torch.equal(got.full("cuda:0"), codec.encode_array(data))
    rng = np.random.default_rng(12)
    objs = [rng.bytes(1 << 20) for _ in range(8)]
    svc = EncodeService()

    async def burst():
        return await asyncio.gather(*(svc.encode(codec, o) for o in objs))

    chunks = asyncio.run(burst())
    assert svc.mesh_launches == 1
    assert chunks == [codec.encode(range(11), o) for o in objs]


@pytest.mark.gpu
def test_multiprocess_cluster_on_card(tmp_path):
    """A process per daemon on the card (vstart): 1 monitor and 4 OSDs on
    BlockStore, an isa k=2 m=2 pool; an EC round trip, one OSD process
    SIGKILLed (reads degraded) and restarted over its store, and B1 launched
    in the OSD processes (their EncodeService and wrapper counts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    import asyncio
    import contextlib
    import signal

    from ceph_tpu_torch.msg.messenger import next_dispatch_event
    from ceph_tpu_torch.vstart import VStart

    v = VStart(str(tmp_path), n_mons=1, n_osds=4, device="cuda",
               config={"osd_objectstore": "blockstore", "osd_heartbeat_grace": 60})
    rng = np.random.default_rng(21)
    objects = {f"g-{i}": rng.bytes(1 << 20) for i in range(8)}

    async def main():
        await asyncio.to_thread(v.wait_started, 300)
        r = v.client()
        await r.connect()
        await v.wait_healthy(rados=r, timeout=180)
        await r.mon_command("osd erasure-code-profile set", {
            "name": "k2m2", "profile": {"plugin": "isa", "k": "2", "m": "2"}})
        await r.mon_command("osd pool create", {
            "pool_id": 1, "crush_rule": 0, "erasure_code_profile": "k2m2", "pg_num": 8})
        io = r.io_ctx(1)
        await asyncio.gather(*(io.write_full(n, d) for n, d in objects.items()))
        victim = r.objecter._calc_target(1, "g-0")
        v.kill_osd(victim)
        await r.mon_command("osd down", {"osd": victim})
        while r.objecter.osdmap.osd_up[victim]:  # re-checked at each message
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(next_dispatch_event(), 0.25)
        for n, d in objects.items():
            assert await io.read(n) == d
        v.start_osd(victim)
        await v.wait_healthy(rados=r, timeout=180)
        for n, d in objects.items():
            assert await io.read(n) == d
        counts = []
        for osd in sorted(v.osds):
            status = await r.objecter.osd_admin(osd, "status")
            perf = await r.objecter.osd_admin(osd, "perf dump")
            counts.append((status["ec_launches"], perf[f"kernels.osd.{osd}"]["gf_matmul_packed"]))
        await r.shutdown()
        return counts

    v.start()
    try:
        counts = asyncio.run(asyncio.wait_for(main(), 600))
    finally:
        rcs = v.stop(signal.SIGTERM)
    assert sum(c[0] for c in counts) > 0 and sum(c[1] for c in counts) > 0, counts
    assert set(rcs.values()) == {0}, rcs


@pytest.mark.gpu
def test_fleet_parallel_save_and_mesh_restore_on_card():
    """Three Fleet members on an in-process cluster on the card save one
    tree collectively from a [cuda:0] * 3 fleet mesh (each rank putting only
    its slabs into the k2m2 pool, encoded by B1), then restore_mesh onto the
    same mesh: every slot equal to its slab of the source."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    import asyncio

    from ceph_tpu_torch.ckpt import CkptStore
    from ceph_tpu_torch.coord import Fleet, FleetDriver
    from ceph_tpu_torch.coord import mesh as coord_mesh
    from ceph_tpu_torch.tools.bench_cluster import EC_POOL, BenchCluster

    devices = ["cuda:0"] * 3
    gen = torch.Generator(device="cuda").manual_seed(14)
    tree = {"w": torch.randn((192, 64), generator=gen, device="cuda"),
            "emb": torch.randn((1001, 16), generator=gen, device="cuda"),
            "b": torch.arange(48, dtype=torch.int32, device="cuda")}

    async def main():
        cluster = await BenchCluster("cuda").start()
        clients, drivers = [], []
        try:
            for i in range(3):
                clients.append(cluster.client(f"client.fleet{i}"))
                await clients[-1].connect()
                io = clients[-1].io_ctx(EC_POOL)
                drivers.append(FleetDriver(Fleet(io, "gpu", f"host-{i}"),
                                           ckpt=CkptStore(io, "gpu"), devices=devices))
                await drivers[-1].fleet.join()
            assert await drivers[0].fleet.elect()
            sharded = coord_mesh.shard_tree(tree, coord_mesh.fleet_mesh(3, devices=devices))
            launches = gc.gf_matmul_packed.launches
            handles = [await d.save_async(sharded, save_id="g0", timeout=120) for d in drivers]
            assert set(await asyncio.gather(*(h.wait() for h in handles))) == {"g0"}
            launches = gc.gf_matmul_packed.launches - launches
            back = await drivers[2].restore_mesh()
            for d in drivers:
                await d.fleet.leave()
            return launches, back
        finally:
            for r in clients:
                await r.shutdown()
            await cluster.stop()

    launches, back = asyncio.run(asyncio.wait_for(main(), 180))
    assert launches > 0
    for name, src in tree.items():
        assert len(back[name].slots) == 3
        for idx, block in back[name].slots:
            assert block.device.type == "cuda" and torch.equal(block, src[idx]), name


@pytest.mark.gpu
def test_run_chaos_on_card_equals_cpu():
    """The daemon-free chaos replay maps its pools with the choose kernel on
    the card (B6): the report is byte-identical to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    import json

    from ceph_tpu_torch.ops import crush_cuda as cc
    from ceph_tpu_torch.sim import run_chaos

    before = cc.crush_choose.launches
    card = run_chaos(7)
    assert cc.crush_choose.launches > before
    assert json.dumps(card, sort_keys=True) == json.dumps(run_chaos(7, device="cpu"),
                                                          sort_keys=True)


@pytest.mark.gpu
def test_chaos_live_on_card_launches_b1():
    """A short live chaos run on the card: the EC pool's writes go through
    B1, no acked write is lost and the stores scrub clean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    import asyncio

    from ceph_tpu_torch.tools.chaos_tool import run_chaos_live

    before = gc.gf_matmul_packed.launches
    report = asyncio.run(asyncio.wait_for(run_chaos_live(
        7, steps=3, step_seconds=1.0, progress=lambda *_: None), 180))
    assert gc.gf_matmul_packed.launches > before
    assert report["lost"] == [] and report["scrub_errors"] == 0
    assert report["p99_s"] <= report["p99_budget_s"]


@pytest.mark.gpu
def test_rbd_image_on_an_ec_pool_on_card():
    """An image of order 22 on a k2m2 pool of an in-process cluster on the
    card: its 4 MiB writes, a read-modify-write, a snapshot read and the
    degraded read-back after an OSD stops launch B1 through each primary's
    EncodeService, and every read is exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    import asyncio
    import contextlib

    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.msg.messenger import next_dispatch_event
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.rados.client import Rados
    from ceph_tpu_torch.rbd import Image
    from ceph_tpu_torch.vstart import initial_osdmap

    async def main():
        cfg = Config()
        for key, value in (("mon_lease", 0.1), ("mon_election_timeout", 0.4),
                           ("osd_heartbeat_interval", 0.15), ("osd_heartbeat_grace", 2)):
            cfg.set(key, value)
        monmap = MonMap(addrs=[("127.0.0.1", 0)] * 3)
        mons = [Monitor(r, monmap, initial_osdmap(6), config=cfg) for r in range(3)]
        for m in mons:
            await m.bind()
        for m in mons:
            m.go()
        osds = {}
        for i in range(6):
            osds[i] = OSDService(i, monmap, config=cfg)
            await osds[i].start()
        rados = Rados("client.rbdgpu", monmap, config=cfg)
        await rados.connect()
        await rados.mon_command("osd erasure-code-profile set", {
            "name": "k2m2", "profile": {"plugin": "tpu", "k": "2", "m": "2"}})
        await rados.mon_command("osd pool create", {
            "pool_id": 2, "crush_rule": 0, "erasure_code_profile": "k2m2", "pg_num": 8})
        io = rados.io_ctx(2)
        obj = 4 << 20
        data = bytearray(np.random.default_rng(14).bytes(16 * obj))
        launches = [gc.gf_matmul_packed.launches]
        img = await Image.create(io, "vol", 1 << 30, order=22)
        img = await Image.open(io, "vol", exclusive=True)
        for off in range(0, len(data), obj):
            await img.write(off, bytes(data[off:off + obj]))
        await img.snap_create("s")
        before = bytes(data)
        data[obj + 100:obj + 4196] = b"\x5a" * 4096
        await img.write(obj + 100, b"\x5a" * 4096)
        launches.append(gc.gf_matmul_packed.launches)
        assert await img.read(0, len(data)) == data
        assert await img.read(0, len(data), snap_name="s") == before
        assert await img.diff("s") == [1]
        assert await img.object_map_check() == []
        await osds.pop(0).stop()
        leader = next(m for m in mons if m.is_leader)
        while not leader.osdmap.is_down(0):
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(next_dispatch_event(), 0.25)
        launches.append(gc.gf_matmul_packed.launches)
        assert await img.read(0, len(data)) == data
        launches.append(gc.gf_matmul_packed.launches)
        await img.close()
        await rados.shutdown()
        for o in osds.values():
            await o.stop()
        for m in mons:
            await m.stop()
        return launches[1] - launches[0], launches[3] - launches[2]

    writes, degraded = asyncio.run(asyncio.wait_for(main(), 180))
    assert writes > 0 and degraded > 0
