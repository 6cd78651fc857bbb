"""Twins of the dataset store: ceph_tpu_torch.data against ceph_tpu.data.

The pure layer case for case with tests/test_datastore.py: naming, the
record, index and manifest codecs, corruption detection, `locate`, run
coalescing, the deterministic shuffle and partition, and cursors — every
value (arrays as dtype, shape and bytes; errors as type and message) equal
to ceph_tpu's. The live twin ingests, verifies and iterates the same seeded
datasets on both packages' in-process clusters: the observations, the
per-host record sequences and every stored object must be byte-identical,
and each package's reader must read the other's dataset. The tools' twin
runs the port's data_tool and fleet_tool and the reference tools against
one port cluster.
"""

import asyncio
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ceph_tpu.data import layout as ref_layout
from ceph_tpu.parallel.sharding import host_slice as ref_host_slice
from ceph_tpu_torch.data import layout as port_layout
from ceph_tpu_torch.parallel.sharding import host_slice as port_host_slice
from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, REP_POOL, Cluster, Package, _port_racecheck_clean, run, twin,
)


def pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(
        layout=ref_layout if name == REF else port_layout,
        host_slice=ref_host_slice if name == REF else port_host_slice,
        compressor=importlib.import_module(f"{name}.common.compressor").factory)


def norm(x):
    """A package-free view of a value: arrays as (dtype, shape, bytes),
    errors as (type name, message), containers recursively."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)([norm(v) for v in x])
    if isinstance(x, slice):
        return ("slice", x.start, x.stop, x.step)
    return x


def outcome(fn, p):
    try:
        return norm(fn(p))
    except Exception as e:  # noqa: BLE001 - the error is the observation
        return norm(e)


def manifest(p, counts=(10, 5, 7)):
    return p.layout.build_manifest(
        "ds", "abc", [{"index": i, "records": c, "bytes": c * 100, "stored": c * 90}
                      for i, c in enumerate(counts)],
        shard_bytes=1 << 20, sub_object=1 << 17, schema={"dtype": "float32", "shape": [4]})


def corrupted(p, payload, flip, compress=""):
    stored, e = p.layout.encode_record(payload, 0, p.compressor(compress) if compress else None)
    bad = bytearray(stored)
    bad[flip] ^= 0x01 if not compress else 0xFF
    return p.layout.decode_record(bytes(bad), e, compress)


CURSOR = dict(name="ds", ingest_id="abc", seed=11, epoch=2, position=96, num_hosts=4, host=3,
              batch_size=32)
STRIDE = dict(CURSOR, partition="stride", base=40)
RUNS = ([[0, 10, 10, 0, 0], [10, 5, 5, 0, 0], [20, 5, 5, 0, 0], [25, 5, 5, 0, 0]],
        [[20, 5, 5, 0, 0], [0, 10, 10, 0, 0], [10, 10, 10, 0, 0]])

CASES = {
    "naming": lambda p: [p.layout.head_object("ds"), p.layout.manifest_object("ds", "abc"),
                         p.layout.shard_soid("ds", "abc", 3), p.layout.ingest_soid("ds", "abc"),
                         p.layout.shard_index_object("ds", "abc", 3)],
    "ingest_id_of": lambda p: [p.layout.ingest_id_of(o, "ds") for o in (
        "ds@abc/shard.00000001.0000000000000000", "ds@abc/shard.00000001.idx",
        "ds@abc.manifest", "ds@abc", "other@abc", "ds.data-head")],
    "sub_object_bytes": lambda p: [p.layout.sub_object_bytes(2 * 65536, n)
                                   for n in (4 << 20, 1000, 3 << 17)],
    "shard_layout": lambda p: vars(p.layout.shard_layout(2 * 65536, 4 << 20)),
    "record_plain": lambda p: [p.layout.encode_record(b"hello world", 7),
                               p.layout.decode_record(b"hello world",
                                                      p.layout.encode_record(b"hello world", 7)[1])],
    "record_zlib": lambda p: (lambda se: [se, p.layout.decode_record(se[0], se[1], "zlib")])(
        p.layout.encode_record(b"abc" * 5000, 0, p.compressor("zlib"))),
    "corrupt_crc": lambda p: corrupted(p, b"x" * 1000, 500),
    "corrupt_stored": lambda p: (lambda se: p.layout.decode_record(se[0][:-1], se[1]))(
        p.layout.encode_record(b"x" * 1000, 0)),
    "corrupt_zlib": lambda p: corrupted(p, b"y" * 9000, 0, "zlib"),
    "index": lambda p: [p.layout.encode_index([[0, 10, 10, 123, 0], [10, 8, 12, 456, 1]]),
                        p.layout.decode_index(p.layout.encode_index([[0, 10, 10, 123, 0]]))],
    "manifest": lambda p: [p.layout.encode_manifest(manifest(p)),
                           p.layout.decode_manifest(p.layout.encode_manifest(manifest(p)))],
    "manifest_format": lambda p: p.layout.decode_manifest(json.dumps({"format": 99}).encode()),
    "locate": lambda p: [p.layout.shard_starts(manifest(p))] + [
        p.layout.locate(manifest(p), p.layout.shard_starts(manifest(p)), r) for r in range(22)],
    "coalesce": lambda p: [p.layout.coalesce_entries(e) for e in RUNS],
    "cursor_array": lambda p: [p.layout.cursor_array(p.layout.cursor_state(**CURSOR)),
                               p.layout.cursor_from_array(
                                   p.layout.cursor_array(p.layout.cursor_state(**STRIDE)))],
    "cursor_format": lambda p: p.layout.cursor_from_array(
        np.frombuffer(json.dumps({"format": 9}).encode(), np.uint8)),
    "cursor_partition": lambda p: p.layout.cursor_state(**dict(CURSOR, partition="zigzag")),
    "rebase_cursor": lambda p: [p.layout.rebase_cursor(p.layout.cursor_state(**STRIDE),
                                                       num_hosts=n, host=h)
                                for n, h in ((1, 0), (2, 1), (5, 4))],
    "rebase_slice": lambda p: p.layout.rebase_cursor(p.layout.cursor_state(**CURSOR),
                                                     num_hosts=2, host=0),
    "permutation": lambda p: [p.layout.epoch_permutation(n, s, e) for n, s, e in (
        (997, 42, 3), (500, 1, 0), (500, 2, 0), (500, 1, 1), (1, 0, 0), (0, 5, 5),
        (65536, 20261016, 0), (100, (1 << 64) + 3, 7))],
    "host_slice": lambda p: [outcome(lambda q: q.host_slice(n, k, h), p) for n, k, h in (
        (10, 0, 0), (10, 4, 4), (10, 4, -1), (101, 8, 7), (3, 8, 5), (0, 2, 1))],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_ceph_tpu(case):
    ref, port = (outcome(CASES[case], pkg(name)) for name in (REF, PORT))
    assert port == ref


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("epoch", [0, 1, 17])
@pytest.mark.parametrize("num_hosts", [1, 2, 3, 8])
def test_per_host_sequences_match_ceph_tpu_and_partition_exactly(seed, epoch, num_hosts):
    """tests/test_datastore.py's multi-host property, twinned: each host's
    sequence is byte-identical to ceph_tpu's, and the hosts partition the
    dataset exactly and evenly."""
    n = 101

    def seqs(p):
        perm = p.layout.epoch_permutation(n, seed, epoch)
        return [perm[p.host_slice(n, num_hosts, h)] for h in range(num_hosts)]

    ref, port = seqs(pkg(REF)), seqs(pkg(PORT))
    assert [norm(s) for s in port] == [norm(s) for s in ref]
    assert sorted(np.concatenate(port).tolist()) == list(range(n))
    assert max(map(len, port)) - min(map(len, port)) <= 1


# -- the live twin --------------------------------------------------------------


def tensor_records(seed: int, n: int = 60) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50257, (8, 16), dtype=np.uint16) for _ in range(n)]


def blob_records(seed: int, n: int = 25) -> list[bytes]:
    rng = np.random.default_rng(seed + 1)
    return [rng.bytes(int(rng.integers(50, 400))) for _ in range(n)]


async def drain(it) -> list:
    """Every batch an iterator yields, as package-free values."""
    out = []
    async for batch in it:
        out.append(norm(batch) if isinstance(batch, np.ndarray) else list(batch))
    return out


async def host_sequences(store, seed: int, num_hosts: int, partition: str) -> list:
    return [await drain(await store.iterator(seed=seed, batch_size=7, num_hosts=num_hosts,
                                             host=h, partition=partition))
            for h in range(num_hosts)]


async def data_round(cluster, seed: int) -> dict:
    """Ingest uint16 token records into the EC pool (port: torch tensors)
    and bytes records into the replicated pool with fixed ingest ids; ls,
    verify, every host's sequence over 2 hosts in both partitions, a
    stride cursor resumed on one host; then the OTHER package's client
    reads the same datasets and must see the same sequences."""
    name = cluster.pkg.name
    data = importlib.import_module(f"{name}.data")
    cluster.cfg.set("data_shard_bytes", 4096)
    rados = cluster.client()
    await rados.connect()
    await cluster.create_pools(rados)
    tokens = data.DataStore(rados.io_ctx(EC_POOL), "tokens")
    blobs = data.DataStore(rados.io_ctx(REP_POOL), "blobs")
    recs = tensor_records(seed)
    obs = {"ids": [await tokens.ingest([torch.from_numpy(r) for r in recs] if name == PORT
                                       else recs, ingest_id="i0"),
                   await blobs.ingest(blob_records(seed), ingest_id="b0")]}
    obs["ls"] = [await tokens.ls(), await blobs.ls()]
    obs["verify"] = [await tokens.verify(), await blobs.verify()]
    assert obs["verify"][0]["record_count"] == len(recs) and len(obs["verify"][0]["shards"]) > 1
    for store in (tokens, blobs):
        for part in ("slice", "stride"):
            obs[f"{store.name}/{part}"] = await host_sequences(store, seed, 2, part)
    it = await tokens.iterator(seed=seed, batch_size=5, num_hosts=2, host=0, partition="stride")
    head = [norm(await it.__anext__()) for _ in range(3)]
    cursor = it.state()
    rest = await drain(await tokens.resume(data.layout.rebase_cursor(cursor, num_hosts=1,
                                                                    host=0)))
    obs["resume"] = {"cursor": cursor, "head": head, "rest": rest}
    other = Package(REF if name == PORT else PORT)
    foreign = cluster.client(other, "client.foreign")
    await foreign.connect()
    odata = importlib.import_module(f"{other.name}.data")
    for pool, ds in ((EC_POOL, "tokens"), (REP_POOL, "blobs")):
        store = odata.DataStore(foreign.io_ctx(pool), ds)
        assert await host_sequences(store, seed, 2, "stride") == obs[f"{ds}/stride"]
    await foreign.shutdown()
    await rados.shutdown()
    return obs


def test_port_datastore_matches_ceph_tpu_on_live_clusters():
    twin(data_round, 5)


# -- the tools ------------------------------------------------------------------


async def tool_json(main_fn, argv, capsys) -> dict:
    rc = await asyncio.to_thread(main_fn, argv)
    assert rc == 0
    return json.loads(capsys.readouterr().out)


def test_tools_on_a_port_cluster_match_the_reference_tools(tmp_path, capsys):
    """The port's data_tool ingests an .npz; then data_tool ls / verify /
    iterate and fleet_tool status, the port's and the reference's, against
    the same port cluster over TCP: equal output, timings left out
    (perf averages; a member's lease age and ttl)."""
    from ceph_tpu_torch.coord import Fleet
    from ceph_tpu_torch.tools import data_tool, fleet_tool
    from tools import data_tool as ref_data_tool
    from tools import fleet_tool as ref_fleet_tool

    src = tmp_path / "recs.npz"
    np.savez(src, **{f"r{i:03d}": r for i, r in enumerate(tensor_records(3, 40))})

    def untimed(out: dict) -> dict:
        perf = out.pop("perf", {})
        out["perf"] = {k: v for k, v in perf.items() if not isinstance(v, dict)}
        for m in out.get("members", {}).values():
            m.pop("lease_age")
            m.pop("lease_ttl")
            m.pop("joined")
        out.pop("leader_ttl", None)
        return out

    async def main():
        cluster = Cluster(Package(PORT))
        await cluster.start()
        try:
            rados = cluster.client()
            await rados.connect()
            await cluster.create_pools(rados)
            fleet = Fleet(rados.io_ctx(REP_POOL), "train", "host-a")
            await fleet.join()
            await fleet.elect()
            host = ",".join(f"{h}:{p}" for h, p in cluster.monmap.addrs)
            common = ["--mon-host", host, "--pool", str(EC_POOL)]
            got = await tool_json(data_tool.main, common + ["--device", "cpu", "--npz", str(src),
                                                            "ingest", "ds"], capsys)
            assert len(got["ingest_id"]) == 16
            outs = {}
            for label, argv in (("ls", ["ls", "ds"]), ("verify", ["verify", "ds"]),
                                ("iterate", ["--num-hosts", "2", "--host", "1", "--seed", "4",
                                             "--batch-size", "6", "iterate", "ds"])):
                outs[label] = [untimed(await tool_json(fn, common + extra + argv, capsys))
                               for fn, extra in ((data_tool.main, ["--device", "cpu"]),
                                                 (ref_data_tool.main, []))]
            status = ["--mon-host", host, "--pool", str(REP_POOL), "status", "train"]
            outs["status"] = [untimed(await tool_json(fleet_tool.main, ["--device", "cpu"] +
                                                      status, capsys)),
                              untimed(await tool_json(ref_fleet_tool.main, status, capsys))]
            await fleet.leave()
            await rados.shutdown()
            return outs
        finally:
            await cluster.stop()

    outs = run(main())
    for label, (port, ref) in outs.items():
        assert port == ref, label
    assert outs["verify"][0]["record_count"] == 40
    assert outs["iterate"][0]["records"] == 20
    assert list(outs["status"][0]["members"]) == ["host-a"]
    assert outs["status"][0]["leader"] == "host-a"
