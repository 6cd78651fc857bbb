#!/usr/bin/env python
"""monstore_tool: offline monitor-store surgery (ceph_monstore_tool role).

The reference's ceph-monstore-tool (src/tools/ceph_monstore_tool.cc)
operates on a STOPPED monitor's store: dump the paxos state, extract
maps, copy a store for disaster recovery, and surgically trim or drop
versions when a mon diverged. Same surface here over the mon's FileDB
(`mon.<rank>.kv` under a vstart run dir):

    --op dump                       paxos meta + per-version service/size
    --op get-osdmap [--spec S]      replay committed incrementals over the
                                    spec's deterministic seed; prints the
                                    map summary (or --out writes encode())
    --op export --out F             full store -> JSON (store-copy role:
                                    rebuild a dead mon from a survivor)
    --op import --file F            JSON -> a fresh store directory
    --op remove-version --version V drop one committed value (surgery for
                                    a poisoned entry; refuses the tail gap
                                    unless --force rewrites last_committed)

Surgery changes quorum history — like the reference tool, it is for a
cluster that is already down; never run it against a live mon's dir.

Port of the reference package's `tools/monstore_tool.py`; `get-osdmap`
replays over the port's `vstart.ClusterSpec` seed.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys

from ceph_tpu_torch.common.encoding import Decoder, Encoder
from ceph_tpu_torch.common.kv import FileDB, KVTransaction

_META = b"paxos_meta"
_VALS = b"paxos"


def _vkey(version: int) -> bytes:
    return b"%016x" % version


def _meta_u64(db, key: bytes, default: int = 0) -> int:
    raw = db.get(_META, key)
    return default if raw is None else Decoder(raw).u64()


def _decode_value(raw: bytes) -> tuple[str, bytes]:
    d = Decoder(raw)
    return d.string(), d.blob()


def _iter_versions(db):
    for (_p, k), v in db.iterate(_VALS):
        yield int(k, 16), v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="monstore_tool")
    ap.add_argument("--store-path", required=True,
                    help="the mon's FileDB directory (STOPPED mon only)")
    ap.add_argument("--op", required=True,
                    choices=["dump", "get-osdmap", "export", "import",
                             "remove-version"])
    ap.add_argument("--spec", help="cluster spec json (seed for replay)")
    ap.add_argument("--version", type=int)
    ap.add_argument("--out")
    ap.add_argument("--file")
    ap.add_argument("--force", action="store_true",
                    help="allow remove-version to rewrite last_committed "
                         "when dropping the tail")
    args = ap.parse_args(argv)

    if args.op == "import":
        if not args.file:
            ap.error("--op import requires --file")
        with open(args.file) as f:
            bundle = json.load(f)
        db = FileDB(args.store_path)
        txn = KVTransaction()
        for row in bundle["rows"]:
            txn.set(
                base64.b64decode(row["prefix"]),
                base64.b64decode(row["key"]),
                base64.b64decode(row["value"]),
            )
        db.submit_transaction(txn)
        print(json.dumps({"imported_rows": len(bundle["rows"])}))
        return 0

    db = FileDB(args.store_path)
    if args.op == "dump":
        versions = []
        for version, raw in sorted(_iter_versions(db)):
            service, payload = _decode_value(raw)
            versions.append({
                "version": version, "service": service,
                "bytes": len(payload),
            })
        print(json.dumps({
            "last_committed": _meta_u64(db, b"last_committed"),
            "promised_pn": _meta_u64(db, b"promised_pn"),
            "election_epoch": _meta_u64(db, b"election_epoch"),
            "has_pending": db.get(_META, b"pending") is not None,
            "versions": versions,
        }, indent=2))
        return 0

    if args.op == "get-osdmap":
        if not args.spec:
            ap.error("--op get-osdmap requires --spec (the seed)")
        from ceph_tpu_torch.vstart import ClusterSpec

        spec = ClusterSpec.load(args.spec)
        m = spec.initial_osdmap()
        from ceph_tpu_torch.osd.osdmap import Incremental

        upto = args.version or _meta_u64(db, b"last_committed")
        applied = 0
        for version, raw in sorted(_iter_versions(db)):
            if version > upto:
                break
            service, payload = _decode_value(raw)
            if service != "osdmap":
                continue
            inc = Incremental.decode(payload)
            # the mon re-stamps at apply time (Monitor._apply_value):
            # the committed payload keeps the proposing handler's epoch
            # GUESS, which concurrent proposals make stale — the
            # replayed epoch is always current+1
            inc.epoch = m.epoch + 1
            m.apply_incremental(inc)
            applied += 1
        if args.out:
            with open(args.out, "wb") as f:
                f.write(m.encode())
        print(json.dumps({
            "epoch": m.epoch,
            "applied_incrementals": applied,
            "max_osd": m.max_osd,
            "pools": sorted(m.pools),
            "up": [int(o) for o in range(m.max_osd)
                   if not m.is_down(o)],
            "blocklist": sorted(m.blocklist),
        }, indent=2))
        return 0

    if args.op == "export":
        rows = [
            {
                "prefix": base64.b64encode(p).decode(),
                "key": base64.b64encode(k).decode(),
                "value": base64.b64encode(v).decode(),
            }
            for (p, k), v in sorted(db.table.items())
        ]
        out = args.out or "monstore.export"
        with open(out, "w") as f:
            json.dump({"rows": rows}, f)
        print(json.dumps({"exported_rows": len(rows), "out": out}))
        return 0

    if args.op == "remove-version":
        if args.version is None:
            ap.error("--op remove-version requires --version")
        if db.get(_VALS, _vkey(args.version)) is None:
            print(json.dumps(
                {"error": f"no version {args.version}"}
            ))
            return 1
        last = _meta_u64(db, b"last_committed")
        txn = KVTransaction()
        txn.rm(_VALS, _vkey(args.version))
        if args.version == last:
            if not args.force:
                print(json.dumps({
                    "error": "removing the tail rewrites "
                             "last_committed; pass --force",
                }))
                return 1
            txn.set(
                _META, b"last_committed",
                Encoder().u64(last - 1).bytes(),
            )
        db.submit_transaction(txn)
        print(json.dumps({
            "removed": args.version,
            "last_committed": _meta_u64(db, b"last_committed"),
        }))
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
