"""The port's ceph_erasure_code_benchmark drop-in
(python -m ceph_tpu_torch.tools.ec_bench) on the CPU: the reference's
`seconds \\t KiB` output with the right KiB for each workload and plugin
(batched and exhaustive decodes check what they rebuild)."""

import os
import re
import subprocess
import sys

import pytest

from ceph_tpu_torch.tools import ec_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^(\d+\.\d{6})\t(\d+)$")

ISA = ["-p", "isa", "-P", "k=8", "-P", "m=3", "-P", "technique=cauchy"]
LRC = ["-p", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3"]


def result_line(out: str) -> tuple[float, int]:
    last = out.strip().splitlines()[-1]
    match = LINE.match(last)
    assert match, f"not a 'seconds<TAB>KiB' line: {last!r}"
    return float(match.group(1)), int(match.group(2))


@pytest.mark.parametrize("argv,kib", [
    (ISA + ["-s", "65536", "-i", "3", "-w", "encode"], 3 * 64),
    (ISA + ["-s", "65536", "-i", "2", "-w", "encode", "--batch", "3"], 2 * 64 * 3),
    (ISA + ["-s", "32768", "-i", "2", "-w", "decode", "-e", "3"], 2 * 32),
    (["-p", "jerasure", "-P", "k=4", "-P", "m=2", "-s", "8192", "-w", "decode",
      "-E", "exhaustive", "-e", "2"], 8),
    (ISA + ["-s", "16384", "-w", "decode", "--erased", "0", "--erased", "9"], 16),
    (LRC + ["-s", "65536", "-i", "2", "-w", "encode", "--batch", "3"], 2 * 64 * 3),
    (LRC + ["-s", "65536", "-i", "2", "-w", "decode", "--batch", "3", "--erased", "0",
            "--erased", "5"], 2 * 64 * 3),
    (["-p", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2", "-s", "32768", "-i", "3",
      "-w", "decode", "--batch", "2", "-e", "2"], 3 * 32 * 2),
    (["-p", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5", "-s", "8192", "-w", "decode",
      "-E", "exhaustive", "-e", "2"], 8),
    (["-p", "jerasure", "-P", "k=4", "-P", "m=2", "-P", "w=7", "-P", "technique=liberation",
      "-P", "packetsize=32", "-s", "16384", "-w", "decode", "--batch", "2", "--erased", "1",
      "--erased", "4"], 16 * 2),
])
def test_ec_bench_prints_seconds_and_kib(capsys, argv, kib):
    assert ec_bench.main(argv + ["--device", "cpu"]) == 0
    seconds, got_kib = result_line(capsys.readouterr().out)
    assert seconds >= 0 and got_kib == kib


def test_ec_bench_runs_as_module():
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.ec_bench", *ISA,
         "-s", "4096", "-i", "2", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert result_line(proc.stdout)[1] == 8


def test_profile_parameters_without_one_equals_sign_are_ignored(capsys):
    assert ec_bench.build_profile(["k=4", "bogus", "a=b=c", "m=2"]) == {"k": "4", "m": "2"}
    assert capsys.readouterr().err.count("ignored") == 2
