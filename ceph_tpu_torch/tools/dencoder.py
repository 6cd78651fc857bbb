"""ceph-dencoder analogue: encode/decode the framework's versioned wire
structs from the shell, for golden-corpus generation and format debugging.

    python -m ceph_tpu_torch.tools.dencoder list_types
    python -m ceph_tpu_torch.tools.dencoder decode <type> < blob.bin        # -> JSON
    python -m ceph_tpu_torch.tools.dencoder encode <type> < doc.json        # -> blob
    python -m ceph_tpu_torch.tools.dencoder round_trip <type> < blob.bin    # re-encode,
                                                             # fail on drift

Types cover what travels on the wire or sits in stores: osdmap,
osdmap_incremental, kv_transaction, message, frame. The reference's
ceph-dencoder + ceph-object-corpus guard cross-version format stability
the same way (SURVEY §4 tier 2); tests/test_encoding.py holds the
committed golden blobs.

Port of the reference package's `tools/dencoder.py`; the types are the
port's copies, so a blob decodes and re-encodes byte-identically in both.
"""

from __future__ import annotations

import json
import sys


def _osdmap_to_json(m) -> dict:
    return {
        "epoch": m.epoch,
        "max_osd": m.max_osd,
        "pools": {
            str(k): {"pg_num": p.pg_num, "size": p.size, "type": p.type,
                     "crush_rule": p.crush_rule,
                     "erasure_code_profile": p.erasure_code_profile}
            for k, p in sorted(m.pools.items())
        },
        "num_up": int(m.osd_up.sum()),
        "erasure_code_profiles": m.erasure_code_profiles,
        "pg_upmap_items": {
            f"{k[0]}.{k[1]}": v for k, v in sorted(m.pg_upmap_items.items())
        },
        "osd_addrs": {str(k): list(v) for k, v in sorted(m.osd_addrs.items())},
    }


def _types():
    from ceph_tpu_torch.common.kv import KVTransaction
    from ceph_tpu_torch.msg.frames import Frame, Message, read_frame  # noqa: F401
    from ceph_tpu_torch.osd.osdmap import Incremental, OSDMap

    def dec_message(raw):
        m = Message.decode(raw)
        return {"type": m.type, "tid": m.tid, "seq": m.seq,
                "epoch": m.epoch, "data_len": len(m.data)}

    def dec_kv(raw):
        t = KVTransaction.decode(raw)
        return {"ops": [
            {"op": op, "prefix": pfx.decode(errors="replace"),
             "key": key.decode(errors="replace"), "value_len": len(val)}
            for op, pfx, key, val in t.ops
        ]}

    def dec_inc(raw):
        inc = Incremental.decode(raw)
        return {
            "epoch": inc.epoch,
            "new_up": inc.new_up, "new_down": inc.new_down,
            "new_weight": {str(k): v for k, v in inc.new_weight.items()},
            "new_pools": sorted(inc.new_pools),
            "has_crush": inc.new_crush_text is not None,
            "new_pg_temp": {
                f"{k[0]}.{k[1]}": v for k, v in inc.new_pg_temp.items()
            },
            "new_osd_addrs": {
                str(k): list(v) for k, v in inc.new_osd_addrs.items()
            },
        }

    return {
        "osdmap": (
            lambda raw: _osdmap_to_json(OSDMap.decode(raw)),
            lambda raw: OSDMap.decode(raw).encode(),
        ),
        "osdmap_incremental": (
            dec_inc,
            lambda raw: Incremental.decode(raw).encode(),
        ),
        "kv_transaction": (
            dec_kv,
            lambda raw: KVTransaction.decode(raw).encode(),
        ),
        "message": (
            dec_message,
            lambda raw: Message.decode(raw).encode(),
        ),
    }


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    types = _types()
    if cmd == "list_types":
        print(json.dumps(sorted(types)))
        return 0
    if cmd in ("decode", "round_trip"):
        tname = argv[1]
        if tname not in types:
            print(f"unknown type {tname!r}", file=sys.stderr)
            return 1
        raw = sys.stdin.buffer.read()
        to_json, reencode = types[tname]
        if cmd == "decode":
            print(json.dumps(to_json(raw), indent=2, sort_keys=True))
            return 0
        again = reencode(raw)
        if again != raw:
            print(
                f"DRIFT: {tname} re-encoded to {len(again)} bytes, "
                f"input was {len(raw)}", file=sys.stderr,
            )
            return 2
        print(json.dumps({"type": tname, "bytes": len(raw),
                          "round_trip": "exact"}))
        return 0
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
