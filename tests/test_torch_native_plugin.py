"""The port's native plugin pipeline (ceph_tpu_torch/ec/native.py over
ceph_tpu_torch/native/), on the CPU: the dlopen ABI handshake and its load
errors (EIO, EXDEV, ENOENT, the init errno), the hash-keyed build into
`_build/`, and the C++ codec's chunks against the port's `isa` codec and
the JAX package's native plugin, tolerance 0."""

import errno
import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import factory as jax_factory
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.native import PLUGIN_VERSION, ErasureCodeNative, load_plugin
from ceph_tpu_torch.ec.registry import factory
from ceph_tpu_torch.native import build

HAVE_CXX = shutil.which("g++") or shutil.which("c++")

pytestmark = pytest.mark.skipif(not HAVE_CXX, reason="no C++ toolchain available")


def build_broken(tmp_path, name: str, source: str) -> str:
    src = tmp_path / f"{name}.cpp"
    src.write_text(source)
    subprocess.run(
        [HAVE_CXX, "-O1", "-shared", "-fPIC", "-o",
         build.plugin_path(name, str(tmp_path)), str(src)],
        check=True, capture_output=True,
    )
    return str(tmp_path)


GOOD_VERSION = (
    'extern "C" const char* __erasure_code_version() '
    f'{{ return "{PLUGIN_VERSION}"; }}\n'
)
INIT_OK = 'extern "C" int __erasure_code_init(const char*, const char*) { return 0; }\n'

#: (plugin source, errno, text the error must carry): the reference's
#: MissingVersion / version mismatch / MissingEntryPoint / FailToInitialize /
#: FailToRegister plugins (src/test/erasure-code/)
BROKEN = {
    "noversion": (INIT_OK, errno.EXDEV, "an older version"),
    "oldversion": ('extern "C" const char* __erasure_code_version() '
                   '{ return "v0.0.0-ancient"; }\n', errno.EXDEV, "v0.0.0-ancient"),
    "noinit": (GOOD_VERSION, errno.ENOENT, "__erasure_code_init"),
    "initfail": (GOOD_VERSION + 'extern "C" int __erasure_code_init(const char*, '
                 'const char*) { return -111; }\n', 111, "error -111"),
    "noregister": (GOOD_VERSION + INIT_OK
                   + 'extern "C" const void* __erasure_code_ops() { return 0; }\n',
                   errno.EIO, "did not register"),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_plugin_load_error(tmp_path, name):
    source, code, text = BROKEN[name]
    d = build_broken(tmp_path, name, source)
    with pytest.raises(ErasureCodeError) as e:
        load_plugin(name, d)
    assert e.value.code == code
    assert text in str(e.value)


def test_missing_library(tmp_path):
    with pytest.raises(ErasureCodeError) as e:
        load_plugin("no_such_plugin", str(tmp_path))
    assert e.value.code == errno.EIO


def test_wrong_version_build_in_own_directory_is_exdev(tmp_path):
    """The real plugin source built with another version string into a
    directory of its own: the handshake refuses it."""
    src = tmp_path / "ec_plugin.cpp"
    text = open(build.PLUGIN_SOURCE).read()
    src.write_text(text.replace(
        "#ifndef CEPH_TPU_PLUGIN_VERSION",
        '#undef CEPH_TPU_PLUGIN_VERSION\n#define CEPH_TPU_PLUGIN_VERSION "ceph-tpu-0.0.0"\n'
        "#ifndef CEPH_TPU_PLUGIN_VERSION",
    ))
    out = build.build_plugin("old", source=str(src), directory=str(tmp_path))
    assert out == build.plugin_path("old", str(tmp_path))
    with pytest.raises(ErasureCodeError) as e:
        load_plugin("old", str(tmp_path))
    assert e.value.code == errno.EXDEV
    assert "ceph-tpu-0.0.0" in str(e.value)


def test_build_is_hash_keyed_and_cached(tmp_path):
    p1 = build.build_plugin("native")
    assert p1 == build.plugin_path("native")
    assert os.path.dirname(p1).startswith(os.path.join(build.BUILD_DIR, "ec_plugin-"))
    key = build.source_key(build.PLUGIN_SOURCE, build.PLUGIN_FLAGS)
    assert os.path.basename(os.path.dirname(p1)) == f"ec_plugin-{key}"
    mtime = os.path.getmtime(p1)
    assert build.build_plugin("native") == p1 and os.path.getmtime(p1) == mtime
    # an edited source gets another key, so a stale library is never loaded
    src = tmp_path / "edited.cpp"
    src.write_text(open(build.PLUGIN_SOURCE).read() + "\n// edited\n")
    assert build.plugin_dir(str(src)) != build.plugin_dir()
    # a caller's directory: rebuilt when the key beside it differs
    d = str(tmp_path / "own")
    out = build.build_plugin("native", directory=d)
    mtime = os.path.getmtime(out)
    assert build.build_plugin("native", directory=d) == out
    assert os.path.getmtime(out) == mtime
    with open(out + ".key", "w") as f:
        f.write("stale")
    build.build_plugin("native", directory=d)
    with open(out + ".key") as f:
        assert f.read() == key


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_native_equals_isa_and_jax_native(k, m, technique):
    """native chunks == the port's `isa` == the JAX package's native, for
    every chunk; and the rebuild of m lost chunks agrees too."""
    profile = {"k": str(k), "m": str(m), "technique": technique}
    native = factory("native", dict(profile), device="cpu")
    isa = factory("isa", dict(profile), device="cpu")
    ref = jax_factory("native", dict(profile))
    data = np.random.default_rng(3).integers(0, 256, 40 * 1024, dtype=np.uint8).tobytes()
    got = native.encode(range(k + m), data)
    assert got == isa.encode(range(k + m), data)
    assert got == ref.encode(range(k + m), data)
    lost = set(range(1, m + 1))
    have = {i: c for i, c in got.items() if i not in lost}
    assert native.decode(lost, have) == ref.decode(lost, have)
    assert native.decode(lost, have) == isa.decode(lost, have)


def test_native_all_double_erasures():
    ec = factory("native", {"k": "5", "m": "2", "technique": "cauchy"}, device="cpu")
    data = bytes(range(256)) * 64
    encoded = ec.encode(range(7), data)
    for erase in itertools.combinations(range(7), 2):
        have = {i: c for i, c in encoded.items() if i not in erase}
        decoded = ec.decode(set(erase), have)
        for i in erase:
            assert decoded[i] == encoded[i], erase
    assert ec.decode_concat(encoded)[: len(data)] == data


def test_native_array_api_returns_cpu_tensors():
    """The host codec's arrays: CPU tensors, whatever the input's form."""
    ec = factory("native", {"k": "4", "m": "2"}, device="cpu")
    isa = factory("isa", {"k": "4", "m": "2", "technique": "cauchy"}, device="cpu")
    data = torch.from_numpy(
        np.random.default_rng(4).integers(0, 256, (3, 4, 256), np.uint8)
    )
    parity = ec.encode_array(data)
    assert isinstance(parity, torch.Tensor) and parity.device.type == "cpu"
    assert torch.equal(parity, isa.encode_array(data))
    assert torch.equal(ec.encode_array(data.numpy()), parity)
    full = torch.cat([data, parity], dim=1)
    rebuilt = ec.decode_array([2, 3, 4, 5], [0, 1], full[:, 2:])
    assert rebuilt.device.type == "cpu" and torch.equal(rebuilt, data[:, :2])


def test_native_resolves_its_device():
    assert ErasureCodeNative(device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            factory("native", {"k": "4", "m": "2"})
