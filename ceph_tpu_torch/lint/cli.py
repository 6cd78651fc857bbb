"""cephlint CLI — `python -m ceph_tpu_torch.lint` /
`python -m ceph_tpu_torch.tools.lint`.

Exit status is the contract: 0 when no NEW findings (everything is either
clean, comment-suppressed, or grandfathered in the baseline), 1 when new
findings exist, 2 on usage errors.  `--baseline-update` rewrites the
baseline to the current finding set (pruning stale entries), which is the
only sanctioned way to grow it.  `--json` emits the summary counters
(checks run, findings, suppressions, baseline size) as one JSON object so
suppression-debt can be tracked across changes like a bench metric.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ceph_tpu_torch.lint.core import (
    all_check_names,
    load_baseline,
    run_lint,
    write_baseline,
)

DEFAULT_PATHS = ["ceph_tpu_torch"]
DEFAULT_BASELINE = "ceph_tpu_torch/tools/lint_baseline.json"


def find_repo_root(start: str | None = None) -> str:
    """Nearest ancestor that contains the ceph_tpu_torch package."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, "ceph_tpu_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cephlint",
        description="project-invariant static analysis for the "
                    "ceph_tpu_torch tree (see COMPONENTS.md 'Static "
                    "analysis & invariants')",
    )
    parser.add_argument("paths", nargs="*", default=None,
                        help=f"files/dirs to lint (default: "
                             f"{' '.join(DEFAULT_PATHS)})")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: {DEFAULT_BASELINE} "
                             "under the root)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report every finding "
                        "as new")
    parser.add_argument("--baseline-update", action="store_true",
                        help="rewrite the baseline to the current finding "
                        "set (prunes stale entries) and exit 0")
    parser.add_argument("--check", action="append", default=None,
                        metavar="NAME",
                        help="run only this check (repeatable)")
    parser.add_argument("--list-checks", action="store_true",
                        help="list registered checks and exit")
    parser.add_argument("--json", action="store_true",
                        help="emit the summary as one JSON object on "
                        "stdout (findings go to stderr)")
    args = parser.parse_args(argv)

    if args.list_checks:
        for name in all_check_names():
            print(name)
        return 0

    root = os.path.abspath(args.root) if args.root else find_repo_root()
    paths = args.paths or DEFAULT_PATHS
    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    baseline = [] if args.no_baseline else load_baseline(baseline_path)

    t0 = time.perf_counter()
    report = run_lint(paths, root=root, baseline=baseline, only=args.check)
    seconds = time.perf_counter() - t0

    if args.baseline_update:
        write_baseline(baseline_path, report.findings)
        print(f"cephlint: baseline rewritten with "
              f"{len(report.findings)} finding(s) -> {baseline_path}")
        return 0

    out = sys.stderr if args.json else sys.stdout
    for f in report.new:
        print(f.render(), file=out)
    if report.stale_baseline:
        print(f"cephlint: {len(report.stale_baseline)} stale baseline "
              "entr(ies) no longer fire — run --baseline-update to shrink "
              "the baseline", file=out)

    summary = report.summary()
    summary["seconds"] = round(seconds, 3)
    summary["baseline_size"] = len(baseline)
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        print(f"cephlint: {report.files} files, "
              f"{len(report.checks)} checks, "
              f"{len(report.new)} new / {len(report.baselined)} baselined "
              f"/ {report.suppressed} suppressed finding(s) "
              f"in {seconds:.2f}s")
    return 1 if report.new else 0


if __name__ == "__main__":
    sys.exit(main())
