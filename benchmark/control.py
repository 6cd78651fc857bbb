"""The control of the benchmark's `correct`: the reference in the program's
place, over another field.

A configuration states that its chunks are byte-identical to the Ceph
plugin's, over GF(2^8) with the polynomial 0x11d. The control is the plain
reference codec, built the same way over AES's polynomial 0x11b: still an
MDS code of the same profile, at the same shapes and entry points, but
not the code that Ceph stores. Every run of a cell with the control in
place has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

runs the cell on the card with the control in place, once per seed in one
process, and prints each seed's compared numbers as one JSON line.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

import harness  # noqa: E402
import reference  # noqa: E402


class ControlCodec:
    """The codec entries that the runners call, computed by the reference
    over `field`."""

    def __init__(self, plugin: str, profile: dict, device,
                 field: tuple[int, int] = reference.CONTROL_FIELD):
        self.ref = reference.Codec(plugin, profile, field)
        self.k, self.m = self.ref.k, self.ref.m

    def encode_array(self, data: torch.Tensor) -> torch.Tensor:
        return self.ref.encode(data)

    def decode_array(self, present, targets, survivors: torch.Tensor) -> torch.Tensor:
        return self.ref.decode(present, targets, survivors)

    def encode_words(self, words: torch.Tensor) -> torch.Tensor:
        return self.ref.encode(words.view(torch.uint8)).view(torch.int32)

    def decode_words(self, present, targets, words: torch.Tensor) -> torch.Tensor:
        return self.ref.decode(present, targets, words.view(torch.uint8)).view(torch.int32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="runs a cell with the control in place")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        result = harness.run(args.workload, seed, args.seconds, False, device,
                             time.perf_counter(), make_codec=ControlCodec)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "field 0x11b",
                          "correct": result.get("correct"),
                          "attempted": result.get("attempted"),
                          "checks": result.get("checks")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
