"""The command without a card, and in a checkout without the program,
exits non-zero and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

import harness

ARGS = ["--workload", "isa_k8m3.planar_encode", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def run_cli(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = run_cli(harness.ROOT)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_the_command_prints_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
