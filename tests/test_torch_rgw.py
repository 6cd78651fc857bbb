"""Twins of the object gateway: ceph_tpu_torch.rgw against ceph_tpu.rgw.

Each scenario is one of the reference's rgw tests (`test_rgw_fs_live.py`'s
gateway cases, `test_rgw_lifecycle.py`, `test_rgw_multifrontend.py`,
`test_s3_auth_ext.py`, `test_s3_rest.py`, `test_swift_rest.py`), run twice
with its own body and assertions: as it stands on ceph_tpu's live cluster,
and loaded with its imports pointed at the port (`on_the_port` of
tests/test_torch_mgr_live.py: the port's monitors, OSDs and clients on the
CPU). Both runs record, and the records must be equal, tolerance 0:

  * every response of the S3 and Swift frontends: method, path, HTTP
    status, the headers the gateway sets and the body bytes;
  * every call a scenario makes on `ObjectGateway` itself: method,
    arguments, and the result or the error;
  * the index objects (bucket indexes, upload rows, the bucket registry in
    the index pool) on every OSD: omap rows and xattrs, after each recorded
    step that changed them.

Pinned in both packages: `uuid.uuid4` (version and upload ids) and
`secrets.token_hex` (Swift tokens) to one seeded sequence, and the gateway
module's clock (the mtimes of index rows) to one instant taken as the test
starts, since the lifecycle scenario ages objects against the wall clock.
Two scenarios send requests concurrently. The bucket-semantics one ends with
ten concurrent puts from two gateways, so its calls are compared as a
multiset and its index as it stands at the end. The concurrent version
pushes assign version ids in the order the two frontends interleave, so
that scenario compares invariants: every request's status, the version
count of each listing, every body read back, and each key's versions as
(size, etag, mtime, delete marker).

The cross-package case writes buckets through one package's gateway and
client onto a cluster of the other and reads them back through the
cluster's own package, both ways: the index rows are a shared format.
"""

import asyncio
import contextvars
import functools
import importlib
import inspect
import itertools
import json
import random
import secrets
import time
import urllib.parse
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_live import (  # noqa: F401 - the port's racecheck fixture
    EC_POOL, PORT, REF, REP_POOL, Cluster, Package, _port_racecheck_clean, run,
)
from tests.test_torch_mgr_live import SHIM, on_the_port, port_case

#: index-pool objects the gateway owns: bucket indexes, upload rows, registry
INDEX_PREFIXES = (".bucket.", ".buckets.")
#: inside a recorded step: calls it makes are not recorded again
IN_STEP = contextvars.ContextVar("rgw_twin_in_step", default=False)


class Recorder:
    """Pins one package's id sources and clock and records its gateway."""

    def __init__(self, name: str, monkeypatch, t0: float):
        self.records, self.states, self.clusters = [], [], []
        rng, tokens = random.Random(15), itertools.count(1)
        monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
        monkeypatch.setattr(secrets, "token_hex", lambda n=32: f"{next(tokens):0{2 * n}x}")
        gateway = importlib.import_module(f"{name}.rgw.gateway")
        monkeypatch.setattr(gateway, "time", SimpleNamespace(time=lambda: t0))
        for front in (importlib.import_module(f"{name}.rgw.rest").S3Frontend,
                      importlib.import_module(f"{name}.rgw.swift").SwiftFrontend):
            monkeypatch.setattr(front, "_handle", self.step(front._handle, front.__name__))
        for attr, fn in list(vars(gateway.ObjectGateway).items()):
            if not attr.startswith("_") and inspect.iscoroutinefunction(fn):
                monkeypatch.setattr(gateway.ObjectGateway, attr, self.step(fn))
        cluster = (importlib.import_module("tests.test_cluster_live") if name == REF
                   else on_the_port("test_cluster_live.py", SHIM)).Cluster
        start, stop = cluster.start, cluster.stop

        async def started(c, *a, **kw):
            self.clusters.append(c)
            return await start(c, *a, **kw)

        async def stopped(c, *a, **kw):
            self.snapshot()
            return await stop(c, *a, **kw)

        monkeypatch.setattr(cluster, "start", started)
        monkeypatch.setattr(cluster, "stop", stopped)

    def step(self, fn, front=None):
        @functools.wraps(fn)
        async def call(obj, *args, **kw):
            if IN_STEP.get():
                return await fn(obj, *args, **kw)
            token = IN_STEP.set(True)
            try:
                out = await fn(obj, *args, **kw)
            except Exception as e:  # noqa: BLE001 - the error is the observation
                self.note(front, fn.__name__, args, kw, ("raised", type(e).__name__, str(e)))
                raise
            finally:
                IN_STEP.reset(token)
            self.note(front, fn.__name__, args, kw, out)
            return out

        return call

    def note(self, front, name, args, kw, out) -> None:
        if front is None:
            # lifecycle_pass(now=) is aged from the scenario's wall clock
            kw = {k: v for k, v in kw.items() if k != "now"}
            self.records.append(("gateway", name, args, kw, out))
        else:
            method, target = args[0], args[1]
            status, headers, body = out
            self.records.append((front, method, urllib.parse.urlsplit(target).path, status,
                                 dict(headers), body))
        self.snapshot()

    def snapshot(self) -> None:
        view = {}
        for i, cluster in enumerate(self.clusters):
            for osd_id, osd in sorted(cluster.osds.items()):
                store = osd.store
                for coll in store.list_collections():
                    if not coll.startswith(f"pg_{REP_POOL}_"):
                        continue
                    for obj in store.list_objects(coll):
                        if obj.startswith(INDEX_PREFIXES):
                            view[(i, osd_id, coll, obj)] = (
                                store.omap_get(coll, obj), store.getattrs(coll, obj).get("xattr"))
        if not self.states or self.states[-1] != view:
            self.states.append(view)


def invariants(rec: Recorder) -> dict:
    """What concurrent version pushes fix: statuses, listing sizes, bodies
    read back, and each key's versions without their ids."""
    versions = {}
    for key, (omap, _xattr) in rec.states[-1].items():
        for row, raw in omap.items():
            meta = json.loads(raw)  # a registry row is b"1"
            versions[(key, row)] = meta if not isinstance(meta, dict) else sorted(
                (v["size"], v["etag"], v.get("mtime"), v["delete_marker"])
                for v in meta.get("versions", [meta]))
    http = [r for r in rec.records if r[0] != "gateway"]
    return {
        "requests": sorted(r[:4] for r in http),
        "listings": [r[5].count(b"<Version>") for r in http if b"<ListVersionsResult" in r[5]],
        "reads": sorted(r[5] for r in http if r[1] == "GET" and not r[5].startswith(b"<?xml")),
        "versions": versions,
    }


def run_twice(fname: str, case: str, monkeypatch) -> dict:
    t0 = time.time()
    out = {}
    for name in (REF, PORT):
        rec = Recorder(name, monkeypatch, t0)
        if name == REF:
            getattr(importlib.import_module(f"tests.{fname[:-3]}"), case)()
        else:
            port_case(fname, case)()
        assert rec.records and len(rec.states) > 1, "the scenario recorded nothing"
        out[name] = rec
    return out


#: (file, case, how the records compare): "ordered", "multiset" or "invariants"
SCENARIOS = [
    ("test_s3_rest.py", "test_s3_rest_round_trip_and_auth", "ordered"),
    ("test_swift_rest.py", "test_swift_dialect_and_s3_interop", "ordered"),
    ("test_s3_rest.py", "test_s3_versioning_round_trip", "ordered"),
    ("test_rgw_fs_live.py", "test_object_gateway_bucket_semantics", "multiset"),
    ("test_rgw_fs_live.py", "test_multipart_upload", "ordered"),
    ("test_rgw_lifecycle.py", "test_lifecycle_config_and_expiration_pass", "ordered"),
    ("test_rgw_multifrontend.py", "test_concurrent_version_pushes_across_frontends",
     "invariants"),
    ("test_s3_auth_ext.py", "test_presigned_urls", "ordered"),
    ("test_s3_auth_ext.py", "test_canned_acls_and_anonymous_get", "ordered"),
    ("test_s3_auth_ext.py", "test_streaming_chunked_upload", "ordered"),
    ("test_s3_auth_ext.py", "test_virtual_host_addressing", "ordered"),
    ("test_s3_auth_ext.py", "test_multipart_listing_dialects", "ordered"),
]


@pytest.mark.parametrize("fname,case,compare", [
    pytest.param(*s, id=f"{s[0][5:-3]}-{s[1][5:]}",
                 marks=() if i < 2 else pytest.mark.slow)
    for i, s in enumerate(SCENARIOS)])
def test_rgw_scenario_matches_ceph_tpu(fname, case, compare, monkeypatch):
    recs = run_twice(fname, case, monkeypatch)
    ref, port = recs[REF], recs[PORT]
    if compare == "invariants":
        assert invariants(port) == invariants(ref)
        return
    if compare == "multiset":
        assert sorted(map(repr, port.records)) == sorted(map(repr, ref.records))
        assert port.states[-1] == ref.states[-1]
        return
    assert len(port.records) == len(ref.records)
    for i, (mine, theirs) in enumerate(zip(port.records, ref.records)):
        assert mine == theirs, f"step {i}"
    assert port.states == ref.states


# -- the cross-package case -----------------------------------------------------------


def seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


async def write_buckets(gw) -> dict:
    """Plain objects, a multipart object and a versioned key; returns what
    a reader must see: {(bucket, key, version or None): bytes}."""
    want = {}
    await gw.create_bucket("cross")
    for i in range(4):
        data = seeded(i, 1000 + 3000 * i)
        await gw.put_object("cross", f"k/{i}", data)
        want[("cross", f"k/{i}", None)] = data
    upload = await gw.initiate_multipart("cross", "big")
    parts = [seeded(10 + n, 7000) for n in range(3)]
    for n, data in enumerate(parts, start=1):
        await gw.upload_part("cross", "big", upload, n, data)
    await gw.complete_multipart("cross", "big", upload, [1, 2, 3])
    want[("cross", "big", None)] = b"".join(parts)
    await gw.create_bucket("vers")
    await gw.set_versioning("vers", True)
    for n in range(2):
        _etag, vid = await gw.put_object2("vers", "doc", seeded(20 + n, 500))
        want[("vers", "doc", vid)] = seeded(20 + n, 500)
    want[("vers", "doc", None)] = seeded(21, 500)
    return want


async def read_buckets(gw, want: dict) -> dict:
    got = {}
    for bucket, key, vid in want:
        got[(bucket, key, vid)] = await (
            gw.get_object(bucket, key) if vid is None else gw.get_object_version(bucket, key, vid))
    got["listing"] = await gw.list_objects("cross")
    got["versions"] = await gw.list_versions("vers")
    got["buckets"] = await gw.list_buckets()
    return got


@pytest.mark.parametrize("writer,cluster_pkg", [(REF, PORT), (PORT, REF)])
def test_bucket_written_by_one_package_reads_back_through_the_other(writer, cluster_pkg):
    """The writer package's client and gateway fill buckets on a cluster of
    the other package, whose own client and gateway read them back."""

    async def main():
        cluster = Cluster(Package(cluster_pkg))
        await cluster.start()
        try:
            native_rgw = importlib.import_module(f"{cluster_pkg}.rgw")
            for osd in cluster.osds.values():
                native_rgw.register_rgw_classes(osd)
            readers = {}
            for pkg in (writer, cluster_pkg):
                rados = cluster.client(Package(pkg), f"client.{pkg}")
                await rados.connect()
                readers[pkg] = (rados, importlib.import_module(f"{pkg}.rgw").ObjectGateway(
                    rados.io_ctx(EC_POOL), index_ioctx=rados.io_ctx(REP_POOL)))
            await cluster.create_pools(readers[writer][0])
            want = await write_buckets(readers[writer][1])
            seen = await read_buckets(readers[writer][1], want)
            got = await read_buckets(readers[cluster_pkg][1], want)
            assert got == seen
            assert {k: got[k] for k in want} == want
            assert sorted(got["listing"]["entries"]) == ["big"] + [f"k/{i}" for i in range(4)]
            assert got["buckets"] == ["cross", "vers"]
            for rados, _gw in readers.values():
                await rados.shutdown()
        finally:
            await cluster.stop()

    run(main())
