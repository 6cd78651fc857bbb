"""Build script for the native components: cc/g++ -> lib<name>.so in `_build/`.

The reference ships its native codecs as autotools/cmake targets producing
libec_*.so under <libdir>/erasure-code (loaded by ErasureCodePluginRegistry
at runtime); here a single compiler invocation produces the same artifact
shape under `ceph_tpu_torch/_build/` (listed in .gitignore), on first use.
Every output is keyed on a hash of its source, its flags and the package
version, so an edited source or a new version is rebuilt and a stale
library is never loaded:

  * helpers (crc32c): `_build/lib<name>-<hash>.so`; the CPU EC baseline
    program (tools/cpu_ec_baseline.py): `_build/ec_cpu_baseline-<hash>`;
  * the plugin: `_build/ec_plugin-<hash>/libec_<name>.so` — the directory
    carries the hash, so the file keeps the reference's naming contract
    (PLUGIN_PREFIX name PLUGIN_SUFFIX) for `load_plugin(name, directory)`.

A caller's own `directory=` holds one `libec_<name>.so`; a key file beside it
records what it was built from, and a different key rebuilds it. A build
holds a lock file beside its output and writes a temporary file renamed into
place, so concurrent processes build once and never load half a library. No
compiler -> None, and callers surface the reference's dlopen error path.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

from ceph_tpu_torch import __version__

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "_build")

#: the reference's naming contract: PLUGIN_PREFIX "libec_" PLUGIN_SUFFIX ".so"
PLUGIN_PREFIX = "libec_"
PLUGIN_SUFFIX = ".so"

PLUGIN_SOURCE = os.path.join(NATIVE_DIR, "ec_plugin.cpp")
SHARED_FLAGS = ["-O3", "-shared", "-fPIC"]
PLUGIN_FLAGS = [
    "-O3", "-shared", "-fPIC", "-std=c++17",
    f'-DCEPH_TPU_PLUGIN_VERSION="ceph-tpu-{__version__}"',
]


def source_key(source: str, flags: list[str]) -> str:
    """12 hex digits of sha256(source bytes, flags, package version)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(flags).encode())
    digest.update(__version__.encode())
    return digest.hexdigest()[:12]


def plugin_dir(source: str = PLUGIN_SOURCE) -> str:
    """The default plugin directory for `source`: `_build/ec_plugin-<hash>`."""
    return os.path.join(BUILD_DIR, f"ec_plugin-{source_key(source, PLUGIN_FLAGS)}")


def plugin_path(name: str, directory: str | None = None) -> str:
    return os.path.join(
        directory or plugin_dir(), f"{PLUGIN_PREFIX}{name}{PLUGIN_SUFFIX}"
    )


def compile_into(
    cmd_head: list[str], out: str, source: str,
    is_current=os.path.exists, key_file: tuple[str, str] | None = None,
) -> None:
    """Unless `is_current(out)`, run `cmd_head -o <tmp> source`, the
    temporary file beside `out`, rename it into place and write `key_file`
    (path, text) if given; under a lock file, so that concurrent callers
    compile once. CalledProcessError on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if is_current(out):
            return
        _compile(cmd_head, out, source)
        if key_file is not None:
            with open(key_file[0], "w") as f:
                f.write(key_file[1])


def _compile(cmd_head: list[str], out: str, source: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            [*cmd_head, "-o", tmp, source],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_shared(name: str, source: str) -> str | None:
    """Compile a standalone helper .so (crc32c etc.) into
    `_build/lib<name>-<hash>.so`; returns the path, or None without a
    toolchain or when the compile fails."""
    cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
    if cc is None:
        return None
    out = os.path.join(
        BUILD_DIR, f"lib{name}-{source_key(source, SHARED_FLAGS)}.so"
    )
    if os.path.exists(out):
        return out
    try:
        compile_into([cc, *SHARED_FLAGS], out, source)
    except subprocess.CalledProcessError:
        return None
    return out


def build_plugin(
    name: str = "native",
    source: str | None = None,
    directory: str | None = None,
) -> str | None:
    """Compile `source` into libec_<name>.so; returns the path or None when
    no toolchain is available. Builds only when no library of this source,
    these flags and this version is there yet."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    source = source or PLUGIN_SOURCE
    key = source_key(source, PLUGIN_FLAGS)
    out = plugin_path(name, directory or plugin_dir(source))
    stamp = out + ".key"

    def is_current(path: str) -> bool:
        return os.path.exists(path) and (directory is None or _read(stamp) == key)

    if is_current(out):
        return out
    try:
        compile_into(
            [cxx, *PLUGIN_FLAGS], out, source, is_current,
            key_file=None if directory is None else (stamp, key),
        )
    except subprocess.CalledProcessError as e:
        # never fall back silently to a stale .so: surface the diagnostics
        raise RuntimeError(f"building {out} failed:\n{e.stderr}") from None
    return out


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None
