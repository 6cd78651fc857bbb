"""Erasure-code non-regression corpus tool (--create / --check).

Re-expresses the reference's golden-chunk gate
(src/test/erasure-code/ceph_erasure_code_non_regression.cc:
ErasureCodeNonRegression, run_create 152 / run_check 225) — the mechanism the
reference uses, backed by its ceph-erasure-code-corpus submodule, to guarantee
that every (plugin, profile)'s encoded chunks stay bit-exact across versions.

--create writes, per profile, a directory named
  "plugin=<p> stripe-width=<w> <k=v> <k=v>..."
containing `content` (the encoded payload) and `chunk.N` golden files.
--check re-encodes `content` and fails if any chunk byte drifted, then
re-decodes every single erasure (and every pair, where the code can) and
fails if recovery is not bit-exact.

The repo commits the corpus under tests/corpus/; tests/test_torch_non_regression.py
runs `--check --device cpu` over it, so any drift in matrix construction,
padding, chunk layout, or kernel math fails CI. `--device` (default cuda,
which raises without a card) is where the codecs run:

    python -m ceph_tpu_torch.tools.ec_non_regression --check [--device cpu]
 Content payload is a deterministic 37-byte
repeating alphabet string (the reference uses a random one but stores it; we
store it too, so determinism only helps review).
"""

from __future__ import annotations

import argparse
import itertools
import os
import shutil
import sys

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.native.build import plugin_path

#: the repository's committed corpus
DEFAULT_BASE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "corpus",
)

#: the corpus profile matrix: (plugin, profile, stripe_width)
DEFAULT_PROFILES: list[tuple[str, dict, int]] = [
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"}, 4096),
    ("jerasure", {"k": "7", "m": "3", "technique": "reed_sol_van"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_r6_op"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_orig"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "w": "5", "technique": "liberation",
                  "packetsize": "32"}, 4096),
    ("jerasure", {"k": "4", "m": "2", "w": "6", "technique": "blaum_roth",
                  "packetsize": "32"}, 4096),
    ("jerasure", {"k": "6", "m": "2", "technique": "liber8tion",
                  "packetsize": "32"}, 4096),
    ("isa", {"k": "8", "m": "3", "technique": "cauchy"}, 4096),
    ("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"}, 4096),
    ("shec", {"k": "4", "m": "3", "c": "2"}, 4096),
    ("shec", {"k": "6", "m": "4", "c": "3"}, 4096),
    ("lrc", {"k": "4", "m": "2", "l": "3"}, 4096),
    ("clay", {"k": "4", "m": "2", "d": "5"}, 4096),
    ("clay", {"k": "8", "m": "4", "d": "11"}, 98304),
    ("tpu", {"k": "8", "m": "3"}, 4096),
    ("native", {"k": "6", "m": "3", "technique": "cauchy"}, 4096),
]


def plugin_available(plugin: str) -> bool:
    """The native plugin needs a C++ toolchain (or a prebuilt .so); every
    other plugin is Python and torch."""
    if plugin != "native":
        return True
    return bool(
        shutil.which("g++") or shutil.which("c++")
        or os.path.exists(plugin_path("native"))
    )


def profile_dir(base: str, plugin: str, profile: dict, stripe_width: int) -> str:
    parts = [f"plugin={plugin}", f"stripe-width={stripe_width}"]
    parts += [f"{k}={v}" for k, v in profile.items()]
    return os.path.join(base, " ".join(parts))


def payload(stripe_width: int) -> bytes:
    unit = bytes((ord("a") + i % 26) for i in range(37))
    data = (unit * (stripe_width // len(unit) + 1))[:stripe_width]
    return data


def create(
    base: str, plugin: str, profile: dict, stripe_width: int, device=None
) -> str:
    ec = factory(plugin, dict(profile), device=device)
    d = profile_dir(base, plugin, profile, stripe_width)
    os.makedirs(d, exist_ok=True)
    content = payload(stripe_width)
    with open(os.path.join(d, "content"), "wb") as f:
        f.write(content)
    encoded = ec.encode(range(ec.get_chunk_count()), content)
    for i, chunk in encoded.items():
        with open(os.path.join(d, f"chunk.{i}"), "wb") as f:
            f.write(chunk)
    return d


def check(
    base: str, plugin: str, profile: dict, stripe_width: int, device=None
) -> list[str]:
    errors: list[str] = []
    ec = factory(plugin, dict(profile), device=device)
    d = profile_dir(base, plugin, profile, stripe_width)
    if not os.path.isdir(d):
        return [f"{d}: missing corpus directory"]
    with open(os.path.join(d, "content"), "rb") as f:
        content = f.read()
    n = ec.get_chunk_count()
    golden = {}
    for i in range(n):
        with open(os.path.join(d, f"chunk.{i}"), "rb") as f:
            golden[i] = f.read()
    encoded = ec.encode(range(n), content)
    for i in range(n):
        if encoded[i] != golden[i]:
            errors.append(f"{d}: chunk {i} drifted from golden bytes")
    # recovery gate: every single erasure, and every pair the code can repair
    combos = [(i,) for i in range(n)]
    combos += list(itertools.combinations(range(n), 2))
    # only locally-repairable codes may legitimately fail on some pairs;
    # an MDS plugin failing ANY <=m-erasure decode is a regression
    lenient_pairs = plugin in ("shec", "lrc")
    for lost in combos:
        avail = {i: golden[i] for i in range(n) if i not in lost}
        try:
            decoded = ec.decode(set(lost), avail)
        except ErasureCodeError:
            if len(lost) == 1 or not lenient_pairs:
                errors.append(f"{d}: erasure {lost} unrecoverable")
            continue
        for i in lost:
            if decoded[i] != golden[i]:
                errors.append(f"{d}: erasure {lost}: chunk {i} mis-decoded")
    return errors


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--base", default=DEFAULT_BASE)
    ap.add_argument("--device", default=None,
                    help="where the codecs run (default cuda)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--create", action="store_true")
    mode.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    failures: list[str] = []
    for plugin, profile, sw in DEFAULT_PROFILES:
        if not plugin_available(plugin):
            print(f"skip plugin={plugin} (no toolchain)")
            continue
        if args.create:
            print("create", create(args.base, plugin, profile, sw, device))
        else:
            errs = check(args.base, plugin, profile, sw, device)
            failures.extend(errs)
            status = "FAIL" if errs else "ok"
            print(f"check {profile_dir(args.base, plugin, profile, sw)}: {status}")
    for e in failures:
        print(e, file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
