#!/usr/bin/env python3
"""lint: the cephlint entry point for the port (see ceph_tpu_torch/lint/).

    python -m ceph_tpu_torch.tools.lint                    # lint ceph_tpu_torch
    python -m ceph_tpu_torch.tools.lint ceph_tpu_torch/rgw # explicit paths
    python -m ceph_tpu_torch.tools.lint --json             # summary counters
    python -m ceph_tpu_torch.tools.lint --baseline-update  # regrandfather

Exits non-zero on NEW findings (not comment-suppressed, not in
ceph_tpu_torch/tools/lint_baseline.json, which is empty). Suppress in
place with `# cephlint: disable=<check>` and a reason; the runtime race
detector rides along as CEPH_TPU_RACECHECK=1 (see
ceph_tpu_torch/lint/racecheck.py).

Port of the reference package's `tools/lint.py`; it reads source files
and touches no device.
"""

import sys

from ceph_tpu_torch.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
