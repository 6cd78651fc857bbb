"""gf_kernel_times — the GF(2^8) kernels' times on one CUDA card, at the
widths the port launches them at.

    python -m ceph_tpu_torch.tools.gf_kernel_times [--reps 200]
    python ceph_tpu_torch/tools/gf_kernel_times.py --root OTHER_CHECKOUT

B1 (`ops.gf_cuda.gf_matmul_packed`) at one object's width, as the daemons'
EncodeService launches it (an isa k=8 m=3 pool's 4 MiB object: 8 x 131,072
words, the encode and a one-chunk decode), and at the burst width of 64 such
objects (8 x 8,388,608 words); B3 (`ops.gf_bitplane.gf_matmul_bitplane`) at
one object's width, as MiniCluster's puts launch it ((1, 8, 524,288) bytes),
and at shec k=4 m=3's batch of 64 objects ((64, 4, 1 MiB)); B8
(`parallel.sharding._sharded_matmul`) on chip_smoke.py phase 19's batch of
64 objects' data chunks ((64, 8, 524,288) bytes) laid out on a 1x1 and a
2x2 slot mesh of the card, beside one B3 launch over the same bytes. Each
is timed
three ways with chip_smoke.py's own functions: `ms`, the call time (CUDA
events around back-to-back calls of the wrapper); `held_ms`, the device time
(a spin kernel holds the stream while the calls are enqueued); `host_us`,
the wrapper's host time per call; beside them the bytes bound at 3.35 TB/s
(each input byte read once, each output byte written once) and the shares.
Prints one JSON line with the card's name and power limit.

`--root` imports the `ceph_tpu_torch` package of another checkout (an
older commit, say) and times its kernels with this checkout's code: run the
parent's and the change's in turns (parent, change, change, parent) on one
card to compare them. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: the checkout this script lives in: its chip_smoke.py holds the timing
#: functions every kernel time of the port is taken with
HERE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
SEED = 20261018


def measure(cs, reps: int) -> dict:
    """{case: times, bound and shares} of the kernels of the
    `ceph_tpu_torch` first on sys.path, on the current CUDA device, timed
    with `cs` (the chip_smoke module)."""
    import torch

    from ceph_tpu_torch.ec.registry import factory
    from ceph_tpu_torch.ops import gf_bitplane as bp
    from ceph_tpu_torch.ops import gf_cuda as gc
    from ceph_tpu_torch.parallel import sharding as sh

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def data(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)

    isa = factory("isa", {"k": "8", "m": "3", "technique": "cauchy"})
    shec = factory("shec", {"k": "4", "m": "3", "c": "2"})
    enc, senc = isa._encode, shec._encode
    dec = isa.decode_bitmatrix(list(range(3, 11)), [0])
    obj = data(8, 4 * 131072).view(torch.int32)
    burst = data(8, 4 * (8 << 20)).view(torch.int32)
    obj_bytes = data(1, 8, 524288)
    shec_batch = data(64, 4, 1 << 20)
    mesh_batch = data(64, 8, 524288)
    laid = {label: (mesh, sh.shard_batch(mesh_batch, mesh)) for label, mesh in (
        ("1x1", sh.ec_mesh(devices=["cuda:0"])), ("2x2", sh.ec_mesh(devices=["cuda:0"] * 4)))}
    cases = {
        "B1 object width encode (8, 131072) -> (3, 131072) int32": (
            lambda: gc.gf_matmul_packed(enc.packed_t, obj, tables=enc.tables_t), 11 * 131072 * 4),
        "B1 object width decode (8, 131072) -> (1, 131072) int32": (
            lambda: gc.gf_matmul_packed(dec.packed_t, obj, tables=dec.tables_t), 9 * 131072 * 4),
        "B1 burst width encode (8, 8388608) -> (3, 8388608) int32": (
            lambda: gc.gf_matmul_packed(enc.packed_t, burst, tables=enc.tables_t),
            11 * (8 << 20) * 4),
        "B3 object width encode (1, 8, 524288) -> (1, 3, 524288)": (
            lambda: bp.gf_matmul_bitplane(enc.bits_t, obj_bytes, tables=enc.tables_t),
            11 * 524288),
        "B3 shec k=4 m=3 encode (64, 4, 1 MiB) -> (64, 3, 1 MiB)": (
            lambda: bp.gf_matmul_bitplane(senc.bits_t, shec_batch, tables=senc.tables_t),
            64 * 7 << 20),
        "B3 at B8's bytes (64, 8, 524288) -> (64, 3, 524288)": (
            lambda: bp.gf_matmul_bitplane(enc.bits_t, mesh_batch, tables=enc.tables_t),
            64 * 11 * 524288),
        "B8 1x1 mesh (64, 8, 524288) -> (64, 3, 524288)": (
            lambda: sh._sharded_matmul(laid["1x1"][0], enc, laid["1x1"][1]), 64 * 11 * 524288),
        "B8 2x2 mesh (64, 8, 524288) -> (64, 3, 524288)": (
            lambda: sh._sharded_matmul(laid["2x2"][0], enc, laid["2x2"][1]), 64 * 11 * 524288),
    }
    out = {}
    for name, (fn, moved) in cases.items():
        t = cs.kernel_times(fn, reps if "object" in name else max(1, reps // 4))
        bound = moved / cs.HBM_BYTES_PER_S * 1e3
        out[name] = {**t, "bound_ms": bound, "share": bound / t["ms"],
                     "share_of_device_time": bound / t["held_ms"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gf_kernel_times", description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose ceph_tpu_torch to time (default: this one)")
    ap.add_argument("--reps", type=int, default=200, help="calls per reading at one object's width")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("gf_kernel_times: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs  # this checkout's timing functions, whatever --root is

    sys.path.insert(0, os.path.abspath(args.root or HERE))
    for name in [m for m in sys.modules if m == "ceph_tpu_torch" or m.startswith("ceph_tpu_torch.")]:
        del sys.modules[name]
    times = measure(cs, args.reps)
    root = os.path.dirname(os.path.dirname(sys.modules["ceph_tpu_torch"].__file__))
    print(json.dumps({"root": root, "card": cs.nvidia_smi_line(), "kernels": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
