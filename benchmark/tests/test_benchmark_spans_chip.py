"""On a CUDA card: the span tool (`spans.py`) on a decode cell of each API
prints every span metric, reads a 100% decode-table hit rate, maps the
program's clock onto the trace's with at least `CLOCK_SHARE` of the
launches inside their spans, and leaves the outputs correct. Skips
without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

import harness
import spans


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["isa_k8m3.planar_decode1", "jerasure_k4m2.bytes_decode1"])
def test_the_span_tool_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "spans.py"), "--workload", name,
         "--seed", str(2**31 + 101), "--turns", "1", "--slice", "0.5"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0
    (on,) = result["on"]
    assert set(on["metrics"]) == set(spans.READERS), on["metrics"]
    assert on["metrics"]["decode_table_hit_pct"] == 100.0
    assert on["clock"]["share"] >= spans.CLOCK_SHARE, on["clock"]
    assert on["clock"]["launches"] == on["calls"]
    gaps = dict(on["idle_gaps"])
    assert set(spans.IDLE_PARTS) <= set(gaps)
    assert "clock:" in out.stderr
