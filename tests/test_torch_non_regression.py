"""The port's golden-chunk gate (ceph_tpu_torch/tools/ec_non_regression.py,
run as `python -m ceph_tpu_torch.tools.ec_non_regression --check --device
cpu`) over tests/corpus/, one case per profile of its list, which is the
JAX package's tool's list: re-encode each stored content to the golden
chunks and rebuild every single and pair erasure bit-exactly, on the CPU."""

import os

import pytest

from ceph_tpu_torch.tools import ec_non_regression as tool
from tools.ec_non_regression import DEFAULT_PROFILES as JAX_PROFILES

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus")


def profile_id(case):
    plugin, profile, _sw = case
    return f"{plugin}-{'-'.join(f'{k}{v}' for k, v in profile.items())}"


def test_profiles_are_the_jax_packages():
    assert tool.DEFAULT_PROFILES == JAX_PROFILES
    assert tool.DEFAULT_BASE == CORPUS
    assert "native" in {plugin for plugin, _, _ in tool.DEFAULT_PROFILES}


@pytest.mark.parametrize("case", tool.DEFAULT_PROFILES, ids=profile_id)
def test_corpus_profile_check_on_cpu(case, monkeypatch, capsys):
    """The tool's `--check --device cpu`, narrowed to one profile."""
    plugin, profile, sw = case
    assert tool.plugin_available(plugin)
    monkeypatch.setattr(tool, "DEFAULT_PROFILES", [case])
    assert tool.main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out == f"check {tool.profile_dir(CORPUS, plugin, profile, sw)}: ok\n"


def test_check_reports_drift(tmp_path):
    """A golden chunk that drifted by one byte fails the check (and the
    rebuilds that read it as a survivor fail with it)."""
    plugin, profile, sw = tool.DEFAULT_PROFILES[0]
    d = tool.create(str(tmp_path), plugin, profile, sw, device="cpu")
    assert tool.check(str(tmp_path), plugin, profile, sw, device="cpu") == []
    path = os.path.join(d, "chunk.1")
    blob = bytearray(open(path, "rb").read())
    blob[0] ^= 1
    with open(path, "wb") as f:
        f.write(blob)
    errors = tool.check(str(tmp_path), plugin, profile, sw, device="cpu")
    assert errors[0] == f"{d}: chunk 1 drifted from golden bytes"
