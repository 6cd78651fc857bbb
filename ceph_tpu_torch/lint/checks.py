"""The cephlint checks — the project's unwritten invariants, as AST passes.

Port of the reference package's `lint.checks`, pointed at this package:
the package-scoped checks fire under `ceph_tpu_torch/`, the knob registry
reads `ceph_tpu_torch/common/config.py`, and the tooling layer that keeps
a knob live is `ceph_tpu_torch/tools/`.

Every check encodes a rule this tree already lives by:

  * `async-blocking`   — no blocking calls on the event loop (the OSD is
                         single-loop; one `time.sleep` stalls every PG);
  * `task-leak`        — every `asyncio.create_task` result is stored,
                         awaited, or registered with a tracked-task
                         helper (a discarded task is GC-bait: Python may
                         collect it mid-flight and its exceptions vanish);
  * `clock-discipline` — cls methods judge time via `MethodContext.now`
                         (the primary's clock + cls_clock_offset), never
                         the wall clock, and non-slow tier-1 tests are
                         sleep-free (time travel via config, not sleep);
  * `knob-registry`    — config keys read anywhere must be declared in
                         common/config.py's SCHEMA, and every declared
                         knob must be documented (COMPONENTS.md/README)
                         and actually read somewhere (dead knobs rot);
  * `perf-counter`     — counter names bumped on the hot path must be
                         declared in the owning make_*_perf/add_* block
                         (an undeclared name KeyErrors at runtime, but
                         only when that path finally executes);
  * `error-taxonomy`   — `except Exception`/bare except inside the package
                         must re-raise, dout-log, or carry an explicit
                         suppression; `StoreFatalError` (fail-stop by
                         contract, objectstore.py) may never be swallowed.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from ceph_tpu_torch.lint.core import (
    FileContext,
    Finding,
    ProjectContext,
    file_check,
    project_check,
)

#: the package the package-scoped checks (async-blocking,
#: dispatch-blocking, error-taxonomy) and the knob registry look at
PACKAGE = "ceph_tpu_torch"
CONFIG_PATH = f"{PACKAGE}/common/config.py"

# -- shared AST helpers -------------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` for Name/Attribute chains; None for anything dynamic."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def receiver_tail(func: ast.AST) -> str | None:
    """For a call `X.Y.meth(...)`, the terminal receiver name `Y`."""
    if not isinstance(func, ast.Attribute):
        return None
    value = func.value
    if isinstance(value, ast.Name):
        return value.id
    if isinstance(value, ast.Attribute):
        return value.attr
    return None


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _walk_same_func(body: Iterable[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/lambda/class
    scopes (those run in a different execution context)."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue  # a nested scope appearing as a direct statement
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


# -- async-blocking -----------------------------------------------------------

#: dotted calls that block the event loop (unless routed through an
#: executor wrapper — calls inside lambdas/def bodies handed to
#: run_in_executor/to_thread live in another scope and are not walked)
BLOCKING_CALLS = {
    "time.sleep": "blocks the loop; await asyncio.sleep() instead",
    "os.fsync": "blocking device flush; route through run_in_executor",
    "os.fdatasync": "blocking device flush; route through run_in_executor",
    "os.system": "spawns + waits synchronously; use asyncio.create_subprocess_*",
    "subprocess.run": "blocks until the child exits; use "
                      "asyncio.create_subprocess_exec",
    "subprocess.call": "blocks until the child exits",
    "subprocess.check_call": "blocks until the child exits",
    "subprocess.check_output": "blocks until the child exits",
    "socket.create_connection": "synchronous connect; use asyncio streams",
    "socket.getaddrinfo": "synchronous resolve; use loop.getaddrinfo",
}
#: method names that are blocking when called on a raw socket
BLOCKING_SOCKET_METHODS = {"recv", "send", "sendall", "accept", "connect"}


@file_check("async-blocking")
def check_async_blocking(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.path.startswith(PACKAGE + "/"):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for sub in _walk_same_func(node.body):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func)
            if name in BLOCKING_CALLS:
                yield Finding(
                    "async-blocking", ctx.path, sub.lineno, sub.col_offset,
                    f"{name}() inside `async def {node.name}`: "
                    f"{BLOCKING_CALLS[name]}",
                )
                continue
            if name == "open" or (
                isinstance(sub.func, ast.Name) and sub.func.id == "open"
            ):
                yield Finding(
                    "async-blocking", ctx.path, sub.lineno, sub.col_offset,
                    f"open() inside `async def {node.name}`: file IO "
                    "blocks the loop; route through run_in_executor",
                )
                continue
            tail = receiver_tail(sub.func)
            if (isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in BLOCKING_SOCKET_METHODS
                    and tail is not None
                    and (tail == "sock" or tail.endswith("socket"))):
                yield Finding(
                    "async-blocking", ctx.path, sub.lineno, sub.col_offset,
                    f"synchronous socket op {tail}.{sub.func.attr}() inside "
                    f"`async def {node.name}`; use asyncio streams",
                )


# -- task-leak ----------------------------------------------------------------

@file_check("task-leak")
def check_task_leak(ctx: FileContext) -> Iterator[Finding]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Expr):
            continue
        call = node.value
        if not isinstance(call, ast.Call):
            continue
        name = dotted_name(call.func) or ""
        if name.endswith("create_task") or name.endswith("ensure_future"):
            yield Finding(
                "task-leak", ctx.path, call.lineno, call.col_offset,
                f"{name}(...) result discarded: the task can be "
                "garbage-collected mid-flight and its exception is lost — "
                "store it, await it, or use a tracked-task helper "
                "(OSD._spawn / Messenger._track style)",
            )


# -- clock-discipline ---------------------------------------------------------

def _decorator_is_slow(dec: ast.AST) -> bool:
    if isinstance(dec, ast.Call):
        dec = dec.func
    name = dotted_name(dec) or ""
    return name.split(".")[-1] == "slow"


def _module_is_slow(tree: ast.AST) -> bool:
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "pytestmark" in targets and "slow" in ast.dump(node.value):
                return True
    return False


@file_check("clock-discipline")
def check_clock_discipline(ctx: FileContext) -> Iterator[Finding]:
    # rule 1: cls method bodies never read the wall clock — lease/lock
    # arithmetic must use MethodContext.now (cls_clock_offset time travel)
    if ctx.path.endswith("osd/cls.py"):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                name = dotted_name(node.func)
                if name in ("time.time", "time.monotonic",
                            "time.perf_counter"):
                    yield Finding(
                        "clock-discipline", ctx.path, node.lineno,
                        node.col_offset,
                        f"{name}() inside osd/cls.py: cls methods must "
                        "judge time via MethodContext.now (the primary's "
                        "clock + cls_clock_offset), never the wall clock",
                    )
        return
    # rule 2: non-slow tier-1 tests are sleep-free (leases
    # time-travel via cls_clock_offset, never wall-clock waits)
    if not ctx.path.startswith("tests/"):
        return
    if _module_is_slow(ctx.tree):
        return

    def visit(body, slow: bool):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                here = slow or any(_decorator_is_slow(d)
                                   for d in node.decorator_list)
                yield from visit(node.body, here)
                continue
            if slow:
                continue
            for sub in _walk_same_func([node]):
                if not isinstance(sub, ast.Call):
                    continue
                name = dotted_name(sub.func)
                if name == "time.sleep":
                    yield Finding(
                        "clock-discipline", ctx.path, sub.lineno,
                        sub.col_offset,
                        "time.sleep() in a non-slow test: tier-1 is "
                        "sleep-free — advance time via cls_clock_offset "
                        "or mark the test @pytest.mark.slow",
                    )
                elif name == "asyncio.sleep" and sub.args:
                    arg = sub.args[0]
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, (int, float))
                            and arg.value > 0):
                        yield Finding(
                            "clock-discipline", ctx.path, sub.lineno,
                            sub.col_offset,
                            f"asyncio.sleep({arg.value}) in a non-slow "
                            "test: tier-1 is sleep-free — sleep(0) "
                            "yield-points are fine, timed waits are not",
                        )

    yield from visit(ctx.tree.body, slow=False)


# -- dispatch-blocking --------------------------------------------------------

#: dispatcher entry points: the messenger awaits these inline on the
#: connection's read loop, so anything they await on stalls EVERY later
#: message on that connection (and holds dispatch-throttle bytes)
_HANDLER_PREFIXES = ("ms_handle_", "_h_")

#: receivers whose awaited methods are client-side RADOS round trips —
#: a dispatch handler awaiting one parks this connection's stream on
#: another daemon's reply (deadlock-bait when that daemon is also
#: waiting on us)
_RADOS_IO_RECEIVERS = {"rados", "objecter", "ioctx"}


def _dispatch_handlers(tree: ast.AST) -> Iterator[ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef) and (
            node.name == "ms_dispatch"
            or node.name.startswith(_HANDLER_PREFIXES)
        ):
            yield node


@file_check("dispatch-blocking")
def check_dispatch_blocking(ctx: FileContext) -> Iterator[Finding]:
    """No lock waits or client-side RADOS IO inline in dispatch.

    `ms_dispatch` / `ms_handle_*` / `_h_*` handlers run on the
    connection's single read loop. An `await lock.acquire()` (or
    `async with lock:`) there stalls every queued message behind the
    lock holder; awaiting a RADOS round trip parks the stream on a
    peer's reply. Either belongs in a tracked task the handler spawns.
    """
    if not ctx.path.startswith(PACKAGE + "/"):
        return
    for fn in _dispatch_handlers(ctx.tree):
        for sub in _walk_same_func(fn.body):
            if isinstance(sub, ast.AsyncWith):
                for item in sub.items:
                    name = dotted_name(item.context_expr) or ""
                    tail = name.split(".")[-1].lower()
                    if "lock" in tail or "mutex" in tail:
                        yield Finding(
                            "dispatch-blocking", ctx.path,
                            sub.lineno, sub.col_offset,
                            f"`async with {name}` inside dispatch handler "
                            f"`{fn.name}`: every later message on this "
                            "connection queues behind the lock holder — "
                            "move the guarded work to a tracked task",
                        )
                continue
            if not isinstance(sub, ast.Await):
                continue
            call = sub.value
            if not isinstance(call, ast.Call):
                continue
            if (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "acquire"):
                name = dotted_name(call.func) or "lock.acquire"
                yield Finding(
                    "dispatch-blocking", ctx.path, sub.lineno,
                    sub.col_offset,
                    f"`await {name}()` inside dispatch handler "
                    f"`{fn.name}`: the connection's read loop blocks "
                    "until the lock frees — move the guarded work to a "
                    "tracked task",
                )
                continue
            tail = receiver_tail(call.func)
            if (isinstance(call.func, ast.Attribute)
                    and tail in _RADOS_IO_RECEIVERS):
                yield Finding(
                    "dispatch-blocking", ctx.path, sub.lineno,
                    sub.col_offset,
                    f"client RADOS IO `await {tail}."
                    f"{call.func.attr}(...)` inside dispatch handler "
                    f"`{fn.name}`: the stream parks on another daemon's "
                    "reply while this connection's messages queue — "
                    "spawn it as a tracked task instead",
                )


# -- knob-registry ------------------------------------------------------------

_CONFIG_RECEIVERS = ("config", "cfg", "conf")


def _is_config_receiver(tail: str | None) -> bool:
    if tail is None:
        return False
    tail = tail.lstrip("_")
    return tail in _CONFIG_RECEIVERS or tail.endswith("config") \
        or tail.endswith("cfg")


_schema_cache: dict[str, tuple[set[str], set[str]] | None] = {}


def _schema_names(ctx: FileContext) -> tuple[set[str], set[str]] | None:
    """(exact names, family prefixes) declared by the project's own
    common/config.py — parsed from ITS root (so scratch corpora under a
    tmp root see their own stub schema, not the installed one), or None
    when that root has no schema to enforce against."""
    import os
    root = (ctx.abspath[:-len(ctx.path)]
            if ctx.abspath.endswith(ctx.path) else "")
    if root in _schema_cache:
        return _schema_cache[root]
    exact: set[str] = set()
    prefixes: set[str] = set()
    cfg = os.path.join(root, PACKAGE, "common", "config.py")
    try:
        with open(cfg, encoding="utf-8", errors="replace") as fp:
            tree = ast.parse(fp.read())
    except (OSError, SyntaxError):
        tree = None
    if tree is not None:
        for node in ast.walk(tree):
            # _opt("name", ...) declarations; f-string first args are
            # templated families (debug_<subsys>, tracer_sample_rate_<op>)
            if (isinstance(node, ast.Call)
                    and dotted_name(node.func) == "_opt" and node.args):
                s = str_const(node.args[0])
                if s is not None:
                    exact.add(s)
                elif (isinstance(node.args[0], ast.JoinedStr)
                      and node.args[0].values):
                    head = str_const(node.args[0].values[0])
                    if head:
                        prefixes.add(head)
            # SCHEMA = {"name": ...} literal (corpus stubs)
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Dict):
                if any(isinstance(t, ast.Name) and t.id == "SCHEMA"
                       for t in node.targets):
                    for k in node.value.keys:
                        s = str_const(k)
                        if s is not None:
                            exact.add(s)
    result = (exact, prefixes) if (exact or prefixes) else None
    _schema_cache[root] = result
    return result


@file_check("knob-registry")
def check_knob_reads(ctx: FileContext) -> Iterator[Finding]:
    if ctx.path.endswith("common/config.py"):
        return
    schema = _schema_names(ctx)
    if schema is None:
        return  # no SCHEMA at this root: nothing to enforce against
    exact, families = schema
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                            ast.Attribute):
            continue
        meth = node.func.attr
        if meth in ("get", "source_of", "rm"):
            want_args = 1
        elif meth in ("set", "observe"):
            want_args = 2
        else:
            continue
        if len(node.args) != want_args or node.keywords:
            continue  # dict.get(k, default) etc — not the Config API
        if not _is_config_receiver(receiver_tail(node.func)):
            continue
        key = str_const(node.args[0])
        if (key is not None and key not in exact
                and not any(key.startswith(p) for p in families)):
            yield Finding(
                "knob-registry", ctx.path, node.lineno, node.col_offset,
                f"config key {key!r} is not declared in "
                "common/config.py SCHEMA — declare the knob (with "
                "type/level/default/description) before reading it",
            )


@project_check("knob-registry")
def check_knob_inventory(project: ProjectContext) -> Iterator[Finding]:
    """Declared knobs must be documented AND read somewhere (dead or
    undocumented knobs are reported at their SCHEMA declaration line)."""
    try:
        import ceph_tpu_torch
        from ceph_tpu_torch.common.config import SCHEMA
    except ImportError:
        return
    import os
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(ceph_tpu_torch.__file__)))
    if os.path.realpath(project.root) != os.path.realpath(pkg_root):
        return  # scratch corpus root: its stub schema is not importable
    config_ctx = None
    for f in project.files:
        if f.path.endswith("common/config.py"):
            config_ctx = f
            break
    if config_ctx is None or config_ctx.tree is None:
        return  # config.py not under lint — nothing to anchor to

    # where is each knob declared? exact literals + f-string families
    anchors: dict[str, int] = {}
    family_anchors: list[tuple[str, int]] = []  # (literal prefix, line)
    for node in ast.walk(config_ctx.tree):
        s = str_const(node)
        if s is not None and s in SCHEMA:
            anchors.setdefault(s, node.lineno)
        if isinstance(node, ast.JoinedStr) and node.values:
            head = str_const(node.values[0])
            if head:
                family_anchors.append((head, node.lineno))

    def anchor(name: str) -> int:
        if name in anchors:
            return anchors[name]
        best = 1
        for prefix, line in family_anchors:
            if name.startswith(prefix):
                best = line
        return best

    # everything the rest of the tree mentions: exact string literals,
    # f-string constant fragments (templated families like
    # f"tracer_sample_rate_{op}"), and CEPH_TPU_<NAME> env spellings
    exact: set[str] = set()
    prefixes: set[str] = set()

    def harvest(tree: ast.AST) -> None:
        for node in ast.walk(tree):
            s = str_const(node)
            if s is not None:
                exact.add(s)
                if s.startswith("CEPH_TPU_"):
                    exact.add(s[len("CEPH_TPU_"):].lower())
            elif isinstance(node, ast.JoinedStr):
                for part in node.values:
                    ps = str_const(part)
                    if ps and len(ps) >= 4:
                        prefixes.add(ps)

    seen_paths = set()
    for f in project.files:
        seen_paths.add(f.abspath)
        if f.tree is None or f.path.endswith("common/config.py"):
            continue
        harvest(f.tree)

    # a knob read only by the benchmark/tooling layer is still live, even
    # when the lint invocation leaves that layer out
    import glob
    import os
    for aux in (glob.glob(os.path.join(project.root, PACKAGE, "tools", "*.py"))
                + [os.path.join(project.root, PACKAGE, "bench.py")]):
        if os.path.abspath(aux) in seen_paths or not os.path.isfile(aux):
            continue
        try:
            with open(aux, encoding="utf-8", errors="replace") as fp:
                harvest(ast.parse(fp.read()))
        except (OSError, SyntaxError):
            continue

    docs = ""
    for doc in ("COMPONENTS.md", "README.md"):
        p = f"{project.root}/{doc}"
        try:
            with open(p, encoding="utf-8", errors="replace") as fp:
                docs += fp.read()
        except OSError:
            pass
    # docs may describe templated families as `prefix_<placeholder>`
    import re
    doc_families = {m.group(1) for m in
                    re.finditer(r"([a-z0-9_]+_)<[a-zA-Z]+>", docs)}

    for name in sorted(SCHEMA):
        documented = name in docs or any(name.startswith(p)
                                         for p in doc_families)
        live = name in exact or any(name.startswith(p) for p in prefixes)
        if not documented:
            yield Finding(
                "knob-registry", CONFIG_PATH, anchor(name), 0,
                f"declared knob {name!r} is undocumented — mention it in "
                "COMPONENTS.md or README.md (families may be documented "
                "as `prefix_<placeholder>`)",
            )
        if not live:
            yield Finding(
                "knob-registry", CONFIG_PATH, anchor(name), 0,
                f"declared knob {name!r} is never read anywhere under "
                "lint — dead knob: delete it or wire it up",
            )


# -- perf-counter -------------------------------------------------------------

_DECLARE_METHODS = {"add_u64", "add_u64_counter", "add_time_avg",
                    "add_histogram"}
_BUMP_METHODS = {"inc", "dec", "set", "set_max", "tinc", "hinc", "time"}


def _is_perf_receiver(tail: str | None) -> bool:
    if tail is None:
        return False
    tail = tail.lstrip("_")
    return tail == "perf" or tail.endswith("perf") or tail == "counters"


def _declared_counter_names(tree: ast.AST) -> Iterator[str]:
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _DECLARE_METHODS and node.args):
            key = str_const(node.args[0])
            if key is not None:
                yield key
        # the loop-declaration idiom: `for key, desc in ((...), ...):
        # perf.add_u64_counter(key, desc)` — harvest the iterated names
        if isinstance(node, ast.For):
            has_decl = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _DECLARE_METHODS
                for n in ast.walk(node)
            )
            if not has_decl:
                continue
            for elt in ast.walk(node.iter):
                if isinstance(elt, (ast.Tuple, ast.List)) and elt.elts:
                    first = str_const(elt.elts[0])
                    if first is not None:
                        yield first


@project_check("perf-counter")
def check_perf_counters(project: ProjectContext) -> Iterator[Finding]:
    declared: set[str] = set()
    for f in project.files:
        if f.tree is None:
            continue
        declared.update(_declared_counter_names(f.tree))
    if not declared:
        return  # corpus without any perf blocks: nothing to enforce
    for f in project.files:
        if f.tree is None or f.path.endswith("common/perf_counters.py"):
            continue
        for node in ast.walk(f.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _BUMP_METHODS and node.args):
                continue
            if not _is_perf_receiver(receiver_tail(node.func)):
                continue
            key = str_const(node.args[0])
            if key is not None and key not in declared:
                yield Finding(
                    "perf-counter", f.path, node.lineno, node.col_offset,
                    f"counter {key!r} bumped via .{node.func.attr}() but "
                    "never declared in any make_*_perf/add_* block — this "
                    "KeyErrors the first time the path executes",
                )


# -- error-taxonomy -----------------------------------------------------------

#: call names inside a handler that count as "the error was reported"
_LOG_CALL_NAMES = {"dout", "cluster_log", "warning", "error", "exception",
                   "critical", "print_exc", "format_exc", "set_exception"}


def _handler_catches(handler: ast.ExceptHandler, names: set[str]) -> bool:
    t = handler.type
    if t is None:
        return "BARE" in names
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        tail = (dotted_name(e) or "").split(".")[-1]
        if tail in names:
            return True
    return False


def _handler_reports(handler: ast.ExceptHandler) -> bool:
    """True when the handler deals with the error rather than dropping
    it: re-raise, a log/report call, an error-counter bump, or any real
    use of the bound exception (stashing it, appending it to an error
    list, folding it into a reply)."""
    for node in _walk_same_func(handler.body):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = (dotted_name(node.func) or "").split(".")[-1]
            if name in _LOG_CALL_NAMES:
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "inc"
                    and _is_perf_receiver(receiver_tail(node.func))):
                return True
        if (handler.name and isinstance(node, ast.Name)
                and node.id == handler.name
                and isinstance(node.ctx, ast.Load)):
            return True
    return False


@file_check("error-taxonomy")
def check_error_taxonomy(ctx: FileContext) -> Iterator[Finding]:
    if not ctx.path.startswith(PACKAGE + "/"):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        # StoreFatalError is fail-stop by contract: never swallowed, even
        # with logging — the handler must re-raise (fencing happens at the
        # raise site; see osd/objectstore.py's error taxonomy)
        if _handler_catches(node, {"StoreFatalError", "BARE", "Exception",
                                   "BaseException"}):
            fatal = _handler_catches(node, {"StoreFatalError"})
            has_raise = any(isinstance(n, ast.Raise)
                            for n in _walk_same_func(node.body))
            if fatal and not has_raise:
                yield Finding(
                    "error-taxonomy", ctx.path, node.lineno, node.col_offset,
                    "StoreFatalError caught without re-raise: fatal store "
                    "errors are fail-stop by contract (objectstore.py) and "
                    "may never be swallowed",
                )
                continue
            if fatal:
                continue
            # the shutdown-drain idiom: `except (asyncio.CancelledError,
            # Exception): pass` while awaiting a task being torn down.
            # Naming CancelledError (a BaseException) NEXT TO Exception is
            # deliberate — the task's outcome is irrelevant by then — and
            # is this codebase's marker for "drain, don't report"
            if _handler_catches(node, {"CancelledError"}):
                continue
            if not _handler_reports(node):
                what = "bare except" if node.type is None else \
                    "except Exception"
                yield Finding(
                    "error-taxonomy", ctx.path, node.lineno, node.col_offset,
                    f"{what} swallows the error: re-raise, log via dout/"
                    "cluster_log, or add `# cephlint: disable=error-"
                    "taxonomy` with a comment saying why",
                )
