"""cephlint for the port: project-invariant static analysis of the
`ceph_tpu_torch` tree, and its runtime race detector.

Port of the reference package's `lint`, pointed at this package:

  * `core`      — Finding/check registry, `# cephlint: disable=` comment
                  suppressions, fingerprinted baseline file, runner;
  * `checks`    — the project checks (async-blocking, task-leak,
                  clock-discipline, dispatch-blocking, knob-registry,
                  perf-counter, error-taxonomy); the package-scoped ones
                  fire under `ceph_tpu_torch/`;
  * `cli`       — `python -m ceph_tpu_torch.lint` /
                  `python -m ceph_tpu_torch.tools.lint` (lints
                  `ceph_tpu_torch` against
                  `ceph_tpu_torch/tools/lint_baseline.json`; non-zero exit
                  on new findings, `--baseline-update`, `--json`);
  * `racecheck` — the RUNTIME half: opt-in (`CEPH_TPU_RACECHECK=1`)
                  asyncio instrumentation that the messenger and the
                  stack report into (lock-order inversions, tasks
                  garbage-collected while pending, locks held across
                  network IO awaits).

The static half reads source files only; nothing here touches a device.
"""

from ceph_tpu_torch.lint.core import (  # noqa: F401
    Finding,
    LintReport,
    load_baseline,
    run_lint,
    write_baseline,
)
from ceph_tpu_torch.lint import checks  # noqa: F401  (registers the checks)

__all__ = [
    "Finding",
    "LintReport",
    "load_baseline",
    "run_lint",
    "write_baseline",
]
