"""cephlint core — findings, suppressions, baseline, check registry, runner.

The shape mirrors the tooling the reference wires around its tree
(clang-tidy with NOLINT comments and a warnings baseline): every check is
a small function over a parsed file (or over the whole project), findings
are suppressable in place with `# cephlint: disable=<check>` comments, and
a committed baseline file grandfathers pre-existing findings so the CLI
can gate on NEW findings only while the debt is paid down.

Suppression syntax (comment anywhere on the offending line, or on a
comment-only line directly above it):

    time.sleep(0.1)  # cephlint: disable=async-blocking
    # cephlint: disable=task-leak
    asyncio.create_task(fire_and_forget())

File-level (usually in the module docstring area):

    # cephlint: disable-file=clock-discipline

`disable=all` disables every check for that line/file.

Baseline entries are matched by content fingerprint — a hash of
(check, path, normalized source line, occurrence index) — so findings
survive unrelated line-number drift but die with the code they flag.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

#: suppression comment: `# cephlint: disable=check-a,check-b`
_SUPPRESS_RE = re.compile(
    r"#\s*cephlint:\s*(disable|disable-file)\s*=\s*([a-zA-Z0-9_,\- ]+)"
)

SKIP_DIRS = {"__pycache__", ".git", ".claude", "node_modules"}


@dataclass
class Finding:
    check: str
    path: str        # repo-relative, forward slashes
    line: int        # 1-based
    col: int
    message: str
    fingerprint: str = ""

    def key(self) -> tuple:
        return (self.path, self.line, self.col, self.check)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.check}] {self.message}"

    def as_dict(self) -> dict[str, Any]:
        return {
            "check": self.check,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


@dataclass
class FileContext:
    """One parsed source file as the checks see it."""

    path: str                 # repo-relative
    abspath: str
    source: str
    tree: ast.AST | None
    lines: list[str] = field(default_factory=list)
    #: line -> set of disabled check names (line-level suppressions)
    line_disables: dict[int, set[str]] = field(default_factory=dict)
    #: whole-file disabled check names
    file_disables: set[str] = field(default_factory=set)

    def line_src(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class ProjectContext:
    """Everything a cross-file check needs: every parsed file + the root."""

    root: str
    files: list[FileContext]

    def get(self, path: str) -> FileContext | None:
        for f in self.files:
            if f.path == path:
                return f
        return None


#: name -> fn(FileContext) -> Iterable[Finding]
FILE_CHECKS: dict[str, Callable[[FileContext], Iterable[Finding]]] = {}
#: name -> fn(ProjectContext) -> Iterable[Finding]
PROJECT_CHECKS: dict[str, Callable[[ProjectContext], Iterable[Finding]]] = {}


def file_check(name: str):
    def deco(fn):
        FILE_CHECKS[name] = fn
        fn.check_name = name
        return fn
    return deco


def project_check(name: str):
    def deco(fn):
        PROJECT_CHECKS[name] = fn
        fn.check_name = name
        return fn
    return deco


def all_check_names() -> list[str]:
    return sorted(set(FILE_CHECKS) | set(PROJECT_CHECKS))


# -- suppression scanning -----------------------------------------------------

def _scan_suppressions(source: str) -> tuple[dict[int, set[str]], set[str]]:
    """Comment tokens -> (line -> disabled checks, file-level checks).

    A comment on a code line suppresses that line; a comment on a line of
    its own suppresses the next line as well (the clang-tidy NOLINTNEXTLINE
    convention, without needing a second spelling).
    """
    line_disables: dict[int, set[str]] = {}
    file_disables: set[str] = set()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return line_disables, file_disables
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        checks = {c.strip() for c in m.group(2).split(",") if c.strip()}
        if m.group(1) == "disable-file":
            file_disables |= checks
            continue
        lineno = tok.start[0]
        line_disables.setdefault(lineno, set()).update(checks)
        # comment-only line: also covers the line below
        if tok.line.strip().startswith("#"):
            line_disables.setdefault(lineno + 1, set()).update(checks)
    return line_disables, file_disables


def _is_suppressed(finding: Finding, ctx: FileContext) -> bool:
    for scope in (ctx.file_disables, ctx.line_disables.get(finding.line, ())):
        if finding.check in scope or "all" in scope:
            return True
    return False


# -- fingerprints & baseline --------------------------------------------------

def _fingerprint(check: str, path: str, norm_line: str, index: int) -> str:
    blob = f"{check}|{path}|{norm_line}|{index}".encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def assign_fingerprints(findings: list[Finding],
                        files: dict[str, FileContext]) -> None:
    seen: dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.check)):
        ctx = files.get(f.path)
        norm = ctx.line_src(f.line).strip() if ctx else ""
        bucket = (f.check, f.path, norm)
        index = seen.get(bucket, 0)
        seen[bucket] = index + 1
        f.fingerprint = _fingerprint(f.check, f.path, norm, index)


def load_baseline(path: str) -> list[dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path) as fp:
        data = json.load(fp)
    return list(data.get("findings", []))


def write_baseline(path: str, findings: list[Finding]) -> None:
    data = {
        "comment": "cephlint grandfathered findings; shrink me toward "
                   "empty, never grow me by hand (python -m "
                   "ceph_tpu_torch.tools.lint --baseline-update)",
        "findings": [f.as_dict() for f in
                     sorted(findings, key=Finding.key)],
    }
    with open(path, "w") as fp:
        json.dump(data, fp, indent=1, sort_keys=True)
        fp.write("\n")


# -- runner -------------------------------------------------------------------

@dataclass
class LintReport:
    findings: list[Finding]          # every unsuppressed finding
    new: list[Finding]               # not covered by the baseline
    baselined: list[Finding]         # matched a baseline fingerprint
    stale_baseline: list[dict]       # baseline entries that no longer fire
    suppressed: int                  # findings silenced by comments
    files: int
    checks: list[str]

    @property
    def ok(self) -> bool:
        return not self.new

    def summary(self) -> dict[str, Any]:
        per_check: dict[str, int] = {}
        for f in self.findings:
            per_check[f.check] = per_check.get(f.check, 0) + 1
        return {
            "files": self.files,
            "checks_run": len(self.checks),
            "findings": len(self.findings),
            "new": len(self.new),
            "baselined": len(self.baselined),
            "stale_baseline": len(self.stale_baseline),
            "suppressed": self.suppressed,
            "per_check": dict(sorted(per_check.items())),
            "ok": self.ok,
        }


def collect_files(paths: Iterable[str], root: str) -> list[str]:
    """Expand files/dirs into a sorted list of .py paths (repo-relative)."""
    out: set[str] = set()
    for p in paths:
        absp = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(absp):
            out.add(os.path.relpath(absp, root))
            continue
        for dirpath, dirnames, filenames in os.walk(absp):
            dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
            for name in filenames:
                if name.endswith(".py"):
                    out.add(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(o.replace(os.sep, "/") for o in out)


def parse_file(relpath: str, root: str) -> FileContext:
    abspath = os.path.join(root, relpath)
    with open(abspath, encoding="utf-8", errors="replace") as fp:
        source = fp.read()
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError:
        tree = None
    line_dis, file_dis = _scan_suppressions(source)
    return FileContext(
        path=relpath.replace(os.sep, "/"), abspath=abspath, source=source,
        tree=tree, lines=source.splitlines(),
        line_disables=line_dis, file_disables=file_dis,
    )


def run_lint(paths: Iterable[str], root: str | None = None,
             baseline: list[dict[str, Any]] | None = None,
             only: Iterable[str] | None = None) -> LintReport:
    """Lint `paths` (files/dirs, relative to `root`) and diff the result
    against `baseline` entries. `only` restricts the checks run."""
    root = os.path.abspath(root or os.getcwd())
    selected = set(only) if only else None

    contexts = [parse_file(p, root) for p in collect_files(paths, root)]
    by_path = {c.path: c for c in contexts}

    raw: list[Finding] = []
    checks_run: list[str] = []
    for name, fn in sorted(FILE_CHECKS.items()):
        if selected and name not in selected:
            continue
        checks_run.append(name)
        for ctx in contexts:
            if ctx.tree is None:
                continue
            raw.extend(fn(ctx))
    project = ProjectContext(root=root, files=contexts)
    for name, fn in sorted(PROJECT_CHECKS.items()):
        if selected and name not in selected:
            continue
        checks_run.append(name)
        raw.extend(fn(project))

    for ctx in contexts:
        if ctx.tree is None and ctx.path.endswith(".py"):
            raw.append(Finding("parse", ctx.path, 1, 0,
                               "file does not parse"))

    kept: list[Finding] = []
    suppressed = 0
    for f in raw:
        ctx = by_path.get(f.path)
        if ctx is not None and _is_suppressed(f, ctx):
            suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=Finding.key)
    assign_fingerprints(kept, by_path)

    base_fps = {e.get("fingerprint"): e for e in (baseline or [])}
    new = [f for f in kept if f.fingerprint not in base_fps]
    old = [f for f in kept if f.fingerprint in base_fps]
    live_fps = {f.fingerprint for f in kept}
    stale = [e for e in (baseline or [])
             if e.get("fingerprint") not in live_fps]

    return LintReport(findings=kept, new=new, baselined=old,
                      stale_baseline=stale, suppressed=suppressed,
                      files=len(contexts), checks=checks_run)
