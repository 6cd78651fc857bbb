"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: `ceph_tpu_torch` is not `ceph_tpu`."""

import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "ceph_tpu"}


def loaded_after(code: str) -> set[str]:
    """Top-level names in sys.modules of a fresh interpreter after `code`."""
    probe = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def bench_sources() -> list[str]:
    out = []
    for folder, _, files in os.walk(BENCH):
        out += [os.path.join(folder, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_harness_and_program_modules_load_no_jax():
    """Every module the run loads (the harness, its runner and readers, the
    trace reader, the control, and the program's codec registry)."""
    code = "\n".join([
        "import run, harness, devtrace, reference, yardstick, control",
        "import os",
        "for folder in ('runners', 'metrics'):",
        "    for f in sorted(os.listdir(os.path.join(harness.BENCH_DIR, folder))):",
        "        if f.endswith('.py'):",
        "            harness.load_module(os.path.join(harness.BENCH_DIR, folder, f), 'x_' + f[:-3])",
        "from ceph_tpu_torch.ec.registry import factory",
        "factory('isa', {'k': '8', 'm': '3', 'technique': 'cauchy'}, device='cpu')",
    ])
    assert not loaded_after(code) & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = loaded_after("import reference, yardstick, control")
    assert not tops & (FORBIDDEN | {"ceph_tpu_torch"})


def test_no_source_of_the_benchmark_imports_jax():
    for path in bench_sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_sources_import_nothing_of_the_program():
    for name in ("reference.py", "yardstick.py", "control.py"):
        assert "ceph_tpu_torch" not in imported_tops(os.path.join(BENCH, name)), name


def test_the_forbidden_names_are_compared_whole():
    import harness

    try:
        sys.modules["ceph_tpu_torch_probe"] = sys
        assert "ceph_tpu_torch_probe" not in harness.forbidden_modules()
        sys.modules["ceph_tpu.probe"] = sys
        assert "ceph_tpu.probe" in harness.forbidden_modules()
    finally:
        sys.modules.pop("ceph_tpu_torch_probe", None)
        sys.modules.pop("ceph_tpu.probe", None)
