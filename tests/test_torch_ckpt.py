"""Twins of the checkpoint store: ceph_tpu_torch.ckpt against ceph_tpu.ckpt.

The same tree, made from a numpy seed, is built in each package (numpy and
jax arrays for ceph_tpu, torch tensors and MeshArrays for the port), with
dict keys out of sorted order, lists, None, a scalar and several dtypes. Its
flatten order, manifest and chunk bytes must be byte-identical; so must
every object the two stores write through live clusters, and each package's
reader must restore the other's objects.
"""

import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ceph_tpu.ckpt import gc as ref_gc
from ceph_tpu.ckpt import layout as ref_layout
from ceph_tpu.ckpt.writer import CkptWriter as RefWriter
from ceph_tpu.common.config import Config as RefConfig
from ceph_tpu_torch.ckpt import gc as port_gc
from ceph_tpu_torch.ckpt import layout as port_layout
from ceph_tpu_torch.ckpt.writer import CkptWriter as PortWriter
from ceph_tpu_torch.common.config import Config as PortConfig
from ceph_tpu_torch.parallel import sharding as sh
from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, Package, _port_racecheck_clean, twin,
)


def arrays(seed: int) -> dict:
    """Host arrays of the test tree, keys deliberately out of sorted order."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": {"w": rng.standard_normal((40, 24)).astype(np.float32),
                 "b": rng.standard_normal(24).astype(np.float16)},
        "alpha": [rng.integers(-9, 9, (30, 4), np.int32),
                  {"y": rng.integers(0, 256, 1000, np.uint8),
                   "x": rng.integers(0, 1 << 40, (2, 3), np.int64), "none": None}],
        "mid": 3.5,
        "flag": rng.random(9) < 0.5,
        "sharded": rng.standard_normal((64, 64)).astype(np.float32),
    }


def build(pkg: str, tree, axis: str, slots: int):
    """`tree`'s leaves as the package holds them; "sharded" laid out on a
    mesh of `slots` devices with spec (axis, None)."""
    if isinstance(tree, dict):
        if "sharded" in tree:
            out = {k: build(pkg, v, axis, slots) for k, v in tree.items() if k != "sharded"}
            out["sharded"] = place(pkg, tree["sharded"], axis, slots)
            return out
        return {k: build(pkg, v, axis, slots) for k, v in tree.items()}
    if isinstance(tree, list):
        return [build(pkg, v, axis, slots) for v in tree]
    if pkg == PORT and isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def mesh(pkg: str, axis: str, slots: int):
    if pkg == REF:
        return JaxMesh(np.array(jax.devices()[:slots]), (axis,))
    grid = np.empty(slots, dtype=object)
    grid[:] = torch.device("cpu")
    return sh.Mesh(grid, (axis,))


def place(pkg: str, value, axis: str, slots: int):
    if pkg == REF:
        return jax.device_put(value, NamedSharding(mesh(pkg, axis, slots), P(axis, None)))
    return sh.place(torch.from_numpy(value.copy()), (axis, None), mesh(pkg, axis, slots))


def stub_ioctx(config):
    """What CkptWriter.prepare reads of an IoCtx: config and a replicated pool."""
    osdmap = SimpleNamespace(pools={1: SimpleNamespace(erasure_code_profile="")},
                             erasure_code_profiles={})
    return SimpleNamespace(pool_id=1, objecter=SimpleNamespace(config=config, osdmap=osdmap))


def writers(axis: str = "stripe", slots: int = 4):
    out = []
    for pkg, writer, config in ((REF, RefWriter, RefConfig), (PORT, PortWriter, PortConfig)):
        cfg = config()
        cfg.set("ckpt_chunk_target_bytes", 4096)
        out.append(writer(stub_ioctx(cfg), "twin", build(pkg, arrays(3), axis, slots),
                          save_id="s0", config=cfg))
    return out


def test_flatten_order_and_specs_match_ceph_tpu():
    """Dicts flatten in sorted key order, None holds no leaf, specs come
    from the mesh layout: the records equal ceph_tpu's."""
    recs = [layout.flatten_tree(build(pkg, arrays(3), "stripe", 4))
            for pkg, layout in ((REF, ref_layout), (PORT, port_layout))]
    keys = ("path", "dtype", "shape", "spec")
    ref, port = ([tuple(r[k] for k in keys) for r in rs] for rs in recs)
    assert port == ref
    assert ref[0][0] == [["k", "alpha"], ["i", 0]]
    assert ("k", "none") not in [tuple(e) for r in ref for e in r[0]]
    assert [r[3] for r in ref if r[0] == [["k", "sharded"]]] == [["stripe", None]]


@pytest.mark.parametrize("ranks", [0, 4])
def test_manifest_and_chunk_bytes_match_ceph_tpu(ranks):
    """prepare() (or, for a fleet of `ranks` writers, prepare_parallel() and
    every rank's chunk assembly from its MeshArray slots): the encoded
    manifest and every chunk's payload and fingerprint equal ceph_tpu's."""
    ref, port = writers("fleet", ranks or 4)
    payloads = []
    for w in (ref, port):
        if not ranks:
            w.prepare()
            w._fingerprint(w.manifest["chunks"])
            payloads.append([w._payload(c) for c in w.manifest["chunks"]])
            continue
        got = {}
        for rank in range(ranks):
            w.prepare_parallel(ranks, rank)
            own = w.owned_chunks()
            w._fingerprint([c for _i, c in own])
            got.update({i: w._payload(c) for i, c in own})
            w._chunk_cache.clear()
            w._np_blocks.clear()
        payloads.append([got[i] for i in range(len(got))])
    assert len(payloads[0]) > 4
    assert payloads[1] == payloads[0]
    assert (port_layout.encode_manifest(port.manifest)
            == ref_layout.encode_manifest(ref.manifest))


def test_select_retained_matches_ceph_tpu():
    for n in (0, 1, 5, 12):
        history = [f"s{i}" for i in range(n)]
        for keep_last in (1, 2, 7):
            for nth in (0, 1, 3):
                assert (port_gc.select_retained(history, keep_last=keep_last, keep_every_nth=nth)
                        == ref_gc.select_retained(history, keep_last=keep_last,
                                                  keep_every_nth=nth))


# -- bfloat16 leaves -----------------------------------------------------------


def bf16_bits(seed: int) -> dict:
    """int16 raw bits of the bfloat16 leaves: normal float32 values from the
    seed rounded to bfloat16 (ml_dtypes' rounding, as jax casts)."""
    rng = np.random.default_rng(seed)

    def bits(shape):
        f32 = rng.standard_normal(shape).astype(np.float32)
        return f32.astype(ml_dtypes.bfloat16).view(np.int16)

    return {"emb": bits((64, 24)), "scale": bits(7), "f32": rng.standard_normal(5).astype(np.float32)}


def bf16_tree(pkg: str, seed: int, slots: int = 4) -> dict:
    """A tree holding bfloat16 leaves in each package's form (jnp.bfloat16
    for ceph_tpu, torch.bfloat16 for the port); "emb" laid out on a mesh of
    `slots` devices along `fleet`."""
    host = bf16_bits(seed)
    if pkg == REF:
        emb = host["emb"].view(ml_dtypes.bfloat16)
        return {"emb": jax.device_put(emb, NamedSharding(mesh(REF, "fleet", slots), P("fleet", None))),
                "scale": jnp.asarray(host["scale"].view(ml_dtypes.bfloat16)),
                "f32": host["f32"]}

    def bf16(a):
        return torch.from_numpy(a.copy()).view(torch.bfloat16)

    return {"emb": sh.place(bf16(host["emb"]), ("fleet", None), mesh(PORT, "fleet", slots)),
            "scale": bf16(host["scale"]), "f32": torch.from_numpy(host["f32"].copy())}


def bits_view(tree) -> dict:
    """{key: (dtype name, raw bytes)} of a restored tree: a port bfloat16
    tensor's bits, a ceph_tpu '<V2' array's bytes."""
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, sh.MeshArray):
            leaf = leaf.full("cpu")
        if isinstance(leaf, torch.Tensor):
            name = str(leaf.dtype)
            leaf = leaf.view(torch.int16) if leaf.dtype is torch.bfloat16 else leaf
            out[key] = (name, leaf.numpy().tobytes())
        else:
            out[key] = (np.asarray(leaf).dtype.str, np.asarray(leaf).tobytes())
    return out


@pytest.mark.parametrize("ranks", [0, 4])
def test_bf16_manifest_and_chunk_bytes_match_ceph_tpu(ranks):
    """A tree with bfloat16 leaves (one on a mesh): flatten_tree's records,
    the manifest and every chunk's payload and fingerprint equal ceph_tpu's,
    the leaves recorded as '<V2' with their raw bits in the stream."""
    recs = [layout.flatten_tree(bf16_tree(pkg, 4))
            for pkg, layout in ((REF, ref_layout), (PORT, port_layout))]
    keys = ("path", "dtype", "shape", "spec")
    assert [[tuple(r[k] for k in keys) for r in rs] for rs in recs][1] == \
        [tuple(r[k] for k in keys) for r in recs[0]]
    assert [r["dtype"] for r in recs[1]] == ["<V2", "<f4", "<V2"]
    payloads, manifests = [], []
    for pkg, writer, config in ((REF, RefWriter, RefConfig), (PORT, PortWriter, PortConfig)):
        cfg = config()
        cfg.set("ckpt_chunk_target_bytes", 4096)
        w = writer(stub_ioctx(cfg), "twin", bf16_tree(pkg, 4, ranks or 4), save_id="s0",
                   config=cfg)
        got = {}
        for rank in range(ranks or 1):
            if ranks:
                w.prepare_parallel(ranks, rank)
                own = w.owned_chunks()
            else:
                w.prepare()
                own = list(enumerate(w.manifest["chunks"]))
            w._fingerprint([c for _i, c in own])
            got.update({i: w._payload(c) for i, c in own})
            w._chunk_cache.clear()
            w._np_blocks.clear()
        payloads.append([got[i] for i in range(len(got))])
        manifests.append(w.manifest)
    assert payloads[1] == payloads[0]
    assert (port_layout.encode_manifest(manifests[1])
            == ref_layout.encode_manifest(manifests[0]))
    host = bf16_bits(4)
    stream = b"".join(payloads[1])
    for a in manifests[1]["arrays"]:
        want = host[a["path"][0][1]].tobytes()
        assert stream[a["offset"]:a["offset"] + a["nbytes"]] == want


def test_bf16_leaves_restore_as_bit_identical_torch_bf16():
    """The port's reader turns a '<V2' manifest entry back into a
    torch.bfloat16 tensor sharing the read bytes (a whole restore, a shard,
    a mesh slot all go through layout.to_tensor)."""
    bits = bf16_bits(5)["emb"]
    raw = np.frombuffer(bits.tobytes(), np.dtype("<V2")).reshape(bits.shape).copy()
    t = port_layout.to_tensor(raw, "<V2")
    assert t.dtype is torch.bfloat16 and tuple(t.shape) == bits.shape
    assert np.array_equal(t.view(torch.int16).numpy(), bits)
    assert port_layout.torch_dtype("<V2") is torch.bfloat16
    assert port_layout.torch_dtype("<f4") is torch.float32
    assert port_layout.dtype_str(torch.bfloat16) == np.dtype(ml_dtypes.bfloat16).str


async def bf16_round(cluster, seed: int) -> dict:
    """Save a tree with bfloat16 leaves into the EC pool, restore it whole,
    one shard of it and onto a 2-slot mesh; every object in the pool. The
    port's restores give torch.bfloat16 with the saved bits; ceph_tpu's give
    '<V2' arrays of the same bytes (a deliberate difference), so the views
    compare raw bytes. Then the OTHER package's reader restores the objects."""
    name = cluster.pkg.name
    ck = importlib.import_module(f"{name}.ckpt")
    cpu = {"device": "cpu"} if name == PORT else {}
    cluster.cfg.set("ckpt_chunk_target_bytes", 4096)
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    io = rados.io_ctx(EC_POOL)
    store = ck.CkptStore(io, "bf16")
    obs = {"s0": await store.save(bf16_tree(name, seed), save_id="s0")}
    full = await store.restore(**cpu)
    view = bits_view(full)
    host = bf16_bits(seed)
    assert {k: v[1] for k, v in view.items()} == {k: a.tobytes() for k, a in host.items()}
    obs["full"] = {k: v[1] for k, v in view.items()}
    if name == PORT:
        assert full["emb"].dtype is torch.bfloat16 and full["scale"].dtype is torch.bfloat16
        shard = await store.reader().read_shard("emb", (slice(8, 24), slice(None)), device="cpu")
        assert shard.dtype is torch.bfloat16
        assert np.array_equal(shard.view(torch.int16).numpy(), host["emb"][8:24])
        on_mesh = await store.restore(mesh=mesh(PORT, "stripe", 2))
        assert on_mesh["emb"].dtype is torch.bfloat16
        assert all(t.dtype is torch.bfloat16 for _i, t in on_mesh["emb"].slots)
        assert np.array_equal(on_mesh["emb"].full("cpu").view(torch.int16).numpy(), host["emb"])
    obs["objects"] = {o: await io.read(o) for o in await ck.gc.list_objects(io, "bf16")}
    other = Package(REF if name == PORT else PORT)
    foreign = cluster.client(other, "client.foreign")
    await foreign.connect()
    back = await importlib.import_module(f"{other.name}.ckpt").CkptStore(
        foreign.io_ctx(EC_POOL), "bf16").restore(**({} if cpu else {"device": "cpu"}))
    assert {k: v[1] for k, v in bits_view(back).items()} == obs["full"]
    await foreign.shutdown()
    await rados.shutdown()
    return obs


def test_port_ckpt_store_saves_and_restores_bf16_like_ceph_tpu():
    """On both packages' daemons: equal save results, equal objects and
    stores, and each reader restores the other's bfloat16 leaves."""
    twin(bf16_round, 9)


def host_view(tree, path="") -> dict:
    """{path: (dtype, shape, bytes)} of any package's tree."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in host_view(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in host_view(x, f"{path}/{i}").items()}
    if tree is None:  # no leaf, as the stores flatten it
        return {}
    arr = port_layout.host_array(tree) if isinstance(tree, (torch.Tensor, sh.MeshArray)) \
        else np.asarray(tree)
    return {path: (arr.dtype.str, arr.shape, arr.tobytes())}


def slot_view(tree) -> dict:
    """{path: [(slab, bytes) per mesh slot]} of a mesh restore: the sharded
    leaf and a replicated one (32-bit: jax without x64 narrows 64-bit
    leaves when it places them on a mesh)."""
    out = {}
    for path, leaf in (("sharded", tree["sharded"]), ("zeta/w", tree["zeta"]["w"])):
        if isinstance(leaf, sh.MeshArray):
            slots = [(idx, t.numpy()) for idx, t in leaf.slots]
        else:
            by_dev = {s.device: s for s in leaf.addressable_shards}
            slots = [(by_dev[d].index, np.asarray(by_dev[d].data))
                     for d in leaf.sharding.mesh.devices.flat]
        out[path] = [(tuple(sl.indices(n) for sl, n in zip(idx, leaf.shape)), a.tobytes())
                     for idx, a in slots]
    return out


async def ckpt_round(cluster, seed: int, *, background: bool) -> dict:
    """Save, change one leaf and save again (incremental; in the background
    with `background`), ls, restore whole and onto a 2-slot mesh, verify, gc
    keeping the last save; then every object in the pool and the restore of
    these objects by the OTHER package's reader."""
    name = cluster.pkg.name
    ck = importlib.import_module(f"{name}.ckpt")
    cpu = {"device": "cpu"} if name == PORT else {}
    cluster.cfg.set("ckpt_chunk_target_bytes", 4096)
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    io = rados.io_ctx(EC_POOL)
    store = ck.CkptStore(io, "twin")
    host = arrays(seed)
    obs = {"s0": await store.save(build(name, host, "stripe", 4), save_id="s0")}
    host["zeta"]["w"] = host["zeta"]["w"] + 1
    tree = build(name, host, "stripe", 4)
    if background:
        obs["s1"] = await (await store.save_async(tree, save_id="s1")).wait()
    else:
        obs["s1"] = await store.save(tree, save_id="s1")
    obs["ls"] = await store.ls()
    obs["full"] = host_view(await store.restore(**cpu))
    assert obs["full"] == host_view(tree)
    obs["mesh"] = slot_view(await store.restore(mesh=mesh(name, "stripe", 2)))
    obs["verify"] = await store.verify()
    obs["gc"] = await store.gc(keep_last=1)
    obs["objects"] = {o: await io.read(o) for o in await ck.gc.list_objects(io, "twin")}
    other = Package(REF if name == PORT else PORT)
    foreign = cluster.client(other, "client.foreign")
    await foreign.connect()
    back = await importlib.import_module(f"{other.name}.ckpt").CkptStore(
        foreign.io_ctx(EC_POOL), "twin").restore(**({} if cpu else {"device": "cpu"}))
    assert host_view(back) == obs["full"]
    await foreign.shutdown()
    await rados.shutdown()
    return obs


def test_port_ckpt_store_matches_ceph_tpu_on_live_clusters():
    """On the port's daemons and ceph_tpu's (test_torch_live's twin): equal
    observations, equal objects and equal OSD stores."""
    twin(ckpt_round, 7, background=False)


@pytest.mark.slow
def test_port_ckpt_store_matches_ceph_tpu_saving_in_the_background():
    twin(ckpt_round, 8, background=True)


def test_ckpt_tool_commands_on_a_port_cluster(tmp_path, capsys):
    """The port's ckpt_tool over TCP against the port's daemons: save and
    restore an .npz, ls, verify, gc --keep-last 1."""
    from ceph_tpu_torch.tools import ckpt_tool
    from tests.test_torch_live import Cluster, run

    src, out = tmp_path / "in.npz", tmp_path / "out.npz"
    rng = np.random.default_rng(9)
    np.savez(src, w=rng.standard_normal((300, 40)).astype(np.float32), step=np.int64(4))

    async def main():
        cluster = Cluster(Package(PORT))
        await cluster.start()
        try:
            rados = cluster.client()
            await rados.connect()
            await cluster.create_pools(rados)
            host = ",".join(f"{h}:{p}" for h, p in cluster.monmap.addrs)
            results = []
            for cmd in (["save", "--npz", str(src)], ["save", "--npz", str(src)], ["ls"],
                        ["verify"], ["restore", "--npz", str(out)], ["gc", "--keep-last", "1"],
                        ["ls"]):
                argv = ["--mon-host", host, "--pool", str(EC_POOL), "--device", "cpu",
                        cmd[0], "t", *cmd[1:]]
                assert await ckpt_tool._amain(ckpt_tool.parse_args(argv)) == 0
                results.append(json.loads(capsys.readouterr().out))
            await rados.shutdown()
            return results
        finally:
            await cluster.stop()

    first, second, ls, verify, _restored, gc, after = run(main())
    assert ls["head"] == second["save_id"] and len(ls["saves"]) == 2
    assert ls["saves"][[s["save_id"] for s in ls["saves"]].index(second["save_id"])][
        "dedup"]["dedup_ratio"] == 1.0
    assert verify["ok"] and gc["reclaimed_saves"] == [first["save_id"]]
    # the old save's manifest is gone; its chunk lives on, referenced by HEAD
    assert {s["save_id"]: s["manifest"] for s in after["saves"]} == {
        first["save_id"]: False, second["save_id"]: True}
    with np.load(src) as want, np.load(out) as got:
        assert sorted(got.files) == ["step", "w"]
        assert all(np.array_equal(got[k], want[k]) for k in want.files)


@pytest.mark.slow
def test_ckpt_tool_bench_on_its_own_cluster(capsys):
    from ceph_tpu_torch.tools import ckpt_tool

    assert ckpt_tool.main(["bench", "--device", "cpu", "--mb", "4", "--incremental",
                           "--async"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["chunks"] >= 1 and line["chunks_reused"] >= 1
