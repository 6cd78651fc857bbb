"""The wire, the stores and the op layer of the port against ceph_tpu.

Each case runs the same seeded inputs through one package and returns what
it produced: frame and message encodings, sealed tickets, KV tables and WAL
files, queue orders, fault streams, compressed bytes, object-store rows,
op and object-class results. The port must produce exactly what ceph_tpu
does. Cases that hand bytes from one package to the other (tickets sealed
by one and opened by the other, a shared-memory ring written by one and
read by the other) run both ways.
"""

import importlib
import json
import os

import numpy as np
import pytest

PACKAGES = ("ceph_tpu", "ceph_tpu_torch")
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def seeded_bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def messages(fr, seed: int):
    """A seeded run of envelopes: empty and bulk raw, traces, flags."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(6):
        out.append(fr.Message(
            type=("osd_op", "ec_sub_write", "ping", "osd_map")[i % 4],
            tid=int(rng.integers(1, 1 << 40)), seq=i, epoch=int(rng.integers(1, 500)),
            data=seeded_bytes(rng, int(rng.integers(0, 200))),
            raw=seeded_bytes(rng, (0, 7, 4096)[i % 3]),
            ack=int(rng.integers(0, 1000)), trace=("", "ab12:cd34:1")[i % 2],
            flags=i % 2,
        ))
    return out


@case
def frame_message_envelopes(pkg, _tmp):
    fr = mod(pkg, "msg.frames")
    out = []
    for msg in messages(fr, 1):
        raw = msg.encode()
        back = fr.Message.decode(raw)
        out.append((raw, msg.encode(inline_raw=False), back == msg))
    return out


@case
def frame_message_segments(pkg, _tmp):
    fr = mod(pkg, "msg.frames")
    out = []
    for msg in messages(fr, 2):
        frame = fr.message_seg_frame(msg)
        back = fr.decode_message_seg(b"".join(bytes(s) for s in frame.segments))
        out.append((frame.encode(), frame.encode(b"k" * 32), bytes(back.raw), back.type,
                    back.tid, back.data, back.trace, back.flags))
    return out


@case
def frame_batches(pkg, _tmp):
    fr = mod(pkg, "msg.frames")
    frames = [fr.message_seg_frame(m) for m in messages(fr, 3)]
    frames.append(fr.Frame(fr.Tag.MESSAGE, messages(fr, 4)[0].encode()))
    batch = fr.make_batch_frame(frames)
    inner = [(int(f.tag), bytes(f.payload)) for f in fr.iter_batch(batch.encode()[9:-4])]
    return batch.encode(), batch.encode(b"s" * 32), inner


@case
def payload_envelopes_binary_and_json(pkg, _tmp):
    enc = mod(pkg, "common.encoding")
    fr = mod(pkg, "msg.frames")
    payload = {"tid": 7, "pgid": [2, 5], "ops": [{"op": "write", "off": 4096}],
               "ok": True, "why": None, "attrs": {"ver": 3, "size": 1 << 33}}
    out = []
    for flags, data in ((fr.FLAG_BIN_DATA, enc.encode_payload(payload)),
                        (0, json.dumps(payload).encode())):
        msg = fr.Message(type="osd_op_reply", tid=7, data=data, flags=flags)
        out.append((msg.encode(), fr.payload_of(fr.Message.decode(msg.encode()))))
    return out


@case
def kv_memdb_after_transactions(pkg, _tmp):
    kv = mod(pkg, "common.kv")
    db = kv.MemDB()
    encoded = []
    for txn in kv_transactions(kv, 5):
        encoded.append(txn.encode())
        db.submit_transaction(txn)
    rows = [list(db.iterate(p)) for p in (b"O", b"M", b"A")]
    return encoded, rows, db.get(b"O", b"k3")


@case
def kv_filedb_files_and_replay(pkg, tmp):
    kv = mod(pkg, "common.kv")
    path = os.path.join(tmp, pkg)
    db = kv.FileDB(path)
    txns = kv_transactions(kv, 6)
    for txn in txns[:3]:
        db.submit_transaction(txn)
    db.compact()
    for txn in txns[3:]:
        db.submit_transaction(txn)
    db.close()
    files = {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))}
    again = kv.FileDB(path)
    rows = [list(again.iterate(p)) for p in (b"O", b"M", b"A")]
    again.close()
    return files, rows


def kv_transactions(kv, seed: int):
    rng = np.random.default_rng(seed)
    txns = []
    for t in range(8):
        txn = kv.KVTransaction()
        for j in range(6):
            prefix = (b"O", b"M", b"A")[int(rng.integers(0, 3))]
            key = b"k%d" % int(rng.integers(0, 10))
            what = int(rng.integers(0, 6))
            if what < 3:
                txn.set(prefix, key, seeded_bytes(rng, int(rng.integers(0, 64))))
            elif what == 3:
                txn.set_range(prefix, key, int(rng.integers(0, 80)), seeded_bytes(rng, 9))
            elif what == 4:
                txn.rm(prefix, key)
            elif t % 4 == 3:
                txn.rm_prefix(prefix)
        txns.append(txn)
    return txns


@case
def op_queue_wpq_order(pkg, _tmp):
    oq = mod(pkg, "common.op_queue")
    rng = np.random.default_rng(7)
    q = oq.WeightedPriorityQueue()
    order = []
    for i in range(400):
        if rng.random() < 0.1:
            q.enqueue_strict(("strict", i))
        else:
            q.enqueue(int(rng.choice([1, 3, 9, 63])), int(rng.integers(1, 5)), ("op", i))
        if rng.random() < 0.4:
            order.append(q.dequeue())
    while len(q):
        order.append(q.dequeue())
    return order


@case
def op_queue_mclock_order(pkg, _tmp):
    oq = mod(pkg, "common.op_queue")
    rng = np.random.default_rng(8)
    q = oq.MClockQueue()
    q.set_profile("client", oq.ClientInfo(reservation=2.0, weight=1.0))
    q.set_profile(oq.QOS_RECOVERY, oq.recovery_profile())
    q.set_profile(oq.QOS_DATA_PREFETCH, oq.data_prefetch_profile())
    q.set_profile("capped", oq.ClientInfo(weight=2.0, limit=3.0))
    classes = ["client", oq.QOS_RECOVERY, oq.QOS_DATA_PREFETCH, "capped"]
    order = []
    for i in range(300):
        q.now += float(rng.random()) * 0.2
        q.enqueue(classes[int(rng.integers(0, 4))], i, cost=int(rng.integers(1, 4)))
        if rng.random() < 0.5:
            order.append(q.dequeue())
    for _ in range(400):
        q.now += 0.5
        order.append(q.dequeue())
    return order, len(q)


@case
def fault_schedule_replay(pkg, _tmp):
    faults = mod(pkg, "common.faults")
    schedule = ("drop:osd.1>osd.*:0.3; delay:osd.*>mon.*:0.5:0.2; dup:client.*>osd.2:0.25;"
                "partition:osd.4|osd.5")
    rules = [(r.kind, r.prob, r.param, r.both_ways) for r in faults.parse_schedule(schedule)]
    out = [rules]
    for seed in (0, 1, 42):
        wf = faults.WireFaults(schedule, seed=seed)
        for src, dst in (("osd.1", "osd.3"), ("osd.2", "mon.0"), ("client.x", "osd.2"),
                         ("osd.5", "osd.4"), ("mon.1", "mon.2")):
            pair = wf.pair(src, dst)
            out.append(None if pair is None else [pair.next_action() for _ in range(40)])
    return out


@case
def compressor_round_trips(pkg, _tmp):
    comp = mod(pkg, "common.compressor")
    rng = np.random.default_rng(9)
    blobs = [b"", b"a" * 10000, seeded_bytes(rng, 4096),
             bytes(rng.integers(0, 4, 20000, dtype=np.uint8))]
    out = [comp.registry.get_algorithms()]
    for algo in comp.registry.get_algorithms():
        c = comp.factory(algo)
        for blob in blobs:
            packed = c.compress(blob)
            out.append((algo, packed, c.decompress(packed) == blob,
                        c.maybe_compress(blob), c.maybe_compress(blob, mode="force")))
    return out


def kstore_rows(pkg):
    kv = mod(pkg, "common.kv")
    os_ = mod(pkg, "osd.objectstore")
    ecutil = mod(pkg, "osd.ecutil")
    db = kv.MemDB()
    store = os_.KStore(db)
    rng = np.random.default_rng(11)
    store.queue_transaction(os_.Transaction().create_collection("pg_2_5")
                            .create_collection("pg_1_0"))
    for i in range(6):
        data = seeded_bytes(rng, 512 * (i + 1))
        hinfo = ecutil.HashInfo.from_shards({0: data, 1: data[::-1]}, 2)
        txn = os_.Transaction().write("pg_2_5", f"obj{i}.s0", data,
                                      attrs={"ver": i + 1, "hinfo": hinfo, "size": len(data)})
        txn.omap_setkeys("pg_2_5", ".pgmeta", {b"log/%016x" % i: b"entry%d" % i})
        store.queue_transaction(txn)
    store.queue_transaction(
        os_.Transaction().write_at("pg_2_5", "obj1.s0", 100, b"patch" * 20)
        .touch("pg_1_0", "empty").setattrs("pg_1_0", "empty", {"user": b"u", "n": 7})
        .omap_rmkeys("pg_2_5", ".pgmeta", [b"log/%016x" % 2]).remove("pg_2_5", "obj4.s0")
    )
    rows = {p: list(db.iterate(p)) for p in sorted({k[0] for k in db.table})}
    view = {c: {o: (store.read(c, o), sorted(store.getattrs(c, o)))
                for o in store.list_objects(c)} for c in store.list_collections()}
    return rows, view, store.used_bytes(), store.fsck(deep=True)


@case
def kstore_kv_rows_after_transactions(pkg, _tmp):
    return kstore_rows(pkg)


def op_vectors(seed: int):
    rng = np.random.default_rng(seed)
    vectors = [
        ([{"op": "create"}, {"op": "write_full"}, {"op": "stat"}], [b"hello world"]),
        ([{"op": "write", "off": 20}, {"op": "append"}, {"op": "read", "off": 3, "length": 9}],
         [seeded_bytes(rng, 16), b"tail"]),
        ([{"op": "truncate", "size": 8}, {"op": "zero", "off": 2, "len": 3}, {"op": "read"}], []),
        ([{"op": "omap_set", "kv": {"6b31": "7631", "6b32": "7632"}},
          {"op": "omap_get", "max_return": 1}, {"op": "omap_rm", "keys": ["6b31"]},
          {"op": "omap_get"}], []),
        ([{"op": "setxattr", "name": "color", "value": "626c7565"},
          {"op": "getxattr", "name": "color"}, {"op": "getxattrs"}, {"op": "rmxattr", "name": "color"}],
         []),
        ([{"op": "getxattr", "name": "missing"}], []),
        ([{"op": "omap_clear"}, {"op": "delete"}, {"op": "stat"}], []),
        ([{"op": "bogus"}], []),
    ]
    return vectors


@case
def osd_ops_results(pkg, _tmp):
    ops = mod(pkg, "osd.ops")
    state = ops.ObjectState()
    out = []
    for vec, datas in op_vectors(12):
        try:
            res, reads = ops.execute_ops(state, vec, datas)
            out.append((res, reads, bytes(state.data), state.exists, dict(state.xattrs),
                        state.omap, state.dirty, ops.is_mutating(vec)))
        except ops.OpError as e:
            out.append(("error", e.code, str(e)))
    return out


@case
def cls_method_results(pkg, _tmp):
    cls = mod(pkg, "osd.cls")
    handler = cls.default_handler()
    ctx = cls.MethodContext(data=b"x", version=4, now=100.0)
    calls = [
        ("lock", "lock", {"name": "l", "owner": "a", "cookie": "c", "duration": 5}),
        ("lock", "lock", {"name": "l", "owner": "b", "cookie": "d"}),
        ("lock", "get_info", {"name": "l"}),
        ("lock", "lock", {"name": "s", "owner": "a", "type": "shared"}),
        ("lock", "lock", {"name": "s", "owner": "b", "type": "shared"}),
        ("lock", "break_lock", {"name": "s", "owner": "a"}),
        ("lock", "unlock", {"name": "l", "owner": "a", "cookie": "c"}),
        ("version", "read", {}),
        ("version", "check", {"ver": 4, "cond": "ge"}),
        ("version", "check", {"ver": 5}),
        ("ckpt", "read_head", {}),
        ("ckpt", "cas_head", {"expect": None, "head": {"save_id": "s1"}}),
        ("ckpt", "cas_head", {"expect": "s1", "head": {"save_id": "s2"}}),
        ("ckpt", "prune_history", {"remove": ["s1"]}),
        ("ckpt", "read_head", {}),
        ("rbd", "nothing", {}),
    ]
    out = []
    for klass, method, inp in calls:
        ctx.now += 3.0
        try:
            out.append(handler.call(klass, method, ctx, inp))
        except cls.ClsError as e:
            out.append(("error", e.code))
    return out, ctx.data, ctx.user_attrs, ctx.dirty


@case
def extent_cache_windows(pkg, _tmp):
    ec = mod(pkg, "osd.extent_cache")
    out = []
    rng = np.random.default_rng(14)
    bs, k = 8192, 3
    obj = bytearray(seeded_bytes(rng, bs * k))
    for writes in ([(0, 10)], [(4000, 9000), (20000, 300)], [(8191, 2)], [(12288, 4096)]):
        cols = ec.write_column_intervals(writes, bs, 512)
        patches = [(off, n, seeded_bytes(rng, n)) for off, n in writes]
        windows = []
        for lo, hi in cols:
            window = bytearray(b"".join(obj[c * bs + lo: c * bs + hi] for c in range(k)))
            ec.patch_window(window, (lo, hi), k, patches, bs)
            windows.append(bytes(window))
        out.append((cols, ec.overlaps(cols, [(0, 4096)]), windows))
    return out


def test_wire_cases_cover_the_issue_list():
    assert len(CASES) >= 14


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_ceph_tpu(name, tmp_path):
    ref, port = (CASES[name](pkg, str(tmp_path)) for pkg in PACKAGES)
    assert repr(port) == repr(ref)


@pytest.mark.parametrize("sealer", PACKAGES)
def test_cephx_tickets_open_across_packages(sealer, monkeypatch):
    opener = PACKAGES[1 - PACKAGES.index(sealer)]
    a, b = mod(sealer, "auth.cephx"), mod(opener, "auth.cephx")
    service, session = bytes(range(32)), bytes(range(100, 132))
    ticket = a.make_ticket(service, 3, "client.admin", session, expires=2000.0)
    assert b.open_ticket({3: service}, ticket, now=1000.0) == ("client.admin", session)
    assert b.open_ticket({3: service}, ticket, now=3000.0) is None
    assert b.open_ticket({4: service}, ticket, now=1000.0) is None
    blob = a.seal(service, b"payload" * 9)
    assert b.unseal(service, blob) == b"payload" * 9
    assert b.unseal(session, blob) is None
    # with the IV fixed, both seal to the same bytes
    monkeypatch.setattr(os, "urandom", lambda n: bytes(n))
    assert a.seal(service, b"fixed") == b.seal(service, b"fixed")


@pytest.mark.parametrize("writer", PACKAGES)
def test_shm_ring_records_cross_packages(writer, tmp_path):
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    w, r = mod(writer, "msg.shm"), mod(reader, "msg.shm")
    path = str(tmp_path / "ring")
    tx = w.ShmRing.create(path, 1 << 16)
    rx = r.ShmRing.attach(path)
    rng = np.random.default_rng(13)
    records = [seeded_bytes(rng, int(n)) for n in rng.integers(1, 5000, 30)]
    got = []
    for rec in records:
        assert tx.try_write(rec)
        chunked, view = rx.try_read()
        got.append((chunked, bytes(view)))
        del view
        rx.release()
    rx.close()
    tx.close(unlink=True)
    assert got == [(False, rec) for rec in records]
