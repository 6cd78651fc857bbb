"""The upmap move-scoring kernel (csrc/upmap_score.cu, wrapper
ops/upmap_cuda.py) against its plain torch version.

`score_case` builds the scorer's inputs from a seed: random rows, rows of
massive gain ties (equal weights), all-illegal rows, NONE slots, unreachable
(-1) domains, 11-wide EC rows, 10,000- and 30,000-OSD clusters, float32
rounding ties between slots, and rows with two OSDs of one domain. The CPU
tests of tests/test_torch_balance.py hold the plain version against the JAX
package and a numpy emulation of the kernel on these cases; the `gpu` test
here holds the kernel itself against the plain version on a card (gain
compared as its float32 bits, tolerance 0) and skips without one. This file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_upmap_cuda.py -q
"""

import ctypes
import os
import re
import sys

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import balance
from ceph_tpu_torch.ops import cuda_build, upmap_cuda

SOURCE = os.path.join(cuda_build.CSRC_DIR, "upmap_score.cu")
REPO = os.path.dirname(cuda_build.PACKAGE_DIR)

#: name -> (rows, slots, osds, osds per domain, max_dev, seed, shape)
CASES = {
    "random": (96, 3, 64, 4, 1.0, 1, "random"),
    "ties": (96, 3, 64, 4, 1.0, 2, "ties"),
    "ties-max-dev-0": (64, 6, 48, 4, 0.0, 3, "ties"),
    "all-illegal": (32, 3, 40, 4, 1.0, 4, "flat"),
    "no-valid-target": (32, 3, 40, 4, 1.0, 5, "invalid"),
    "none-slots": (64, 6, 64, 4, 0.5, 6, "none"),
    "unreachable-domains": (64, 3, 64, 4, 1.0, 7, "unreachable"),
    "ec-11-wide": (48, 11, 96, 4, 1.0, 8, "ties"),
    "osds-10000": (16, 3, 10000, 50, 2.0, 9, "random"),
    # past the shared-memory staging: the kernel reads global memory
    "osds-30000": (8, 3, 30000, 50, 2.0, 10, "random"),
    # float32 rounding ties between slots: sources whose deviations differ
    # by less than one ulp of fdev - tdev, in the register instantiations
    # (S = 3, 6) and the generic kernel (S = 4, 11)
    "ulp-ties-3": (64, 3, 64, 4, 1.0, 11, "ulp"),
    "ulp-ties-6": (64, 6, 96, 4, 1.0, 12, "ulp"),
    "ulp-ties-4": (48, 4, 64, 4, 0.5, 13, "ulp"),
    "ulp-ties-11": (32, 11, 96, 4, 1.0, 14, "ulp"),
    # rows holding two OSDs of one domain (or one OSD twice): where the
    # in-row test decides, in both register instantiations
    "dup-domains-3": (64, 3, 64, 4, 1.0, 15, "dup"),
    "dup-domains-6": (64, 6, 64, 4, 0.5, 16, "dup"),
}


def score_case(name):
    """(up, dev, valid, dom, max_dev) as numpy arrays, in the scorer's
    layout: up (C, S) int32 with -1 for NONE; dev (n+1,) float32 as the
    balancer builds it (counts - float64 target, cast), sentinel 0 at n;
    valid (n+1,) bool, False at n; dom (n+1,) int32 dense ids, -2 at n."""
    c, s, n, per_dom, max_dev, seed, shape = CASES[name]
    rng = np.random.default_rng(seed)
    dom = (np.arange(n) // per_dom).astype(np.int32)
    valid = rng.random(n) > 0.1
    target = np.full(n, 10.0 + rng.random())
    counts = rng.integers(0, 21, n)
    if shape == "ties":
        # equal weights and a handful of counts: most gains tie exactly
        counts = rng.integers(8, 14, n)
        target = np.full(n, 10.5)
    elif shape == "flat":
        counts = np.full(n, 10)
        target = np.full(n, 10.0)
    elif shape == "invalid":
        valid[:] = False
    elif shape == "unreachable":
        dom[rng.random(n) < 0.3] = -1
    elif shape == "ulp":
        # half the OSDs 700 + 0..3 ulps of 700 (2^-14), half -2500 less
        # distinct multiples of 0.5: fdev - tdev is about 3200, whose ulp is
        # 2^-12, so sources a few ulps apart give the same rounded gain on
        # a row's one best target, and the lower slot must win
        high = rng.random(n) < 0.5
        ulps = np.float32(700.0) + rng.integers(0, 4, n).astype(np.float32) * np.float32(2**-14)
        low = np.float32(-2500.0) - rng.permutation(n).astype(np.float32) * np.float32(0.5)
        counts = np.where(high, ulps, low).astype(np.float64)
        target = np.zeros(n)
    n_dom = int(dom.max()) + 1
    up = np.full((c, s), -1, np.int32)
    for row in range(c):
        # one OSD per distinct domain, as a CRUSH rule places them
        doms = rng.choice(n_dom, size=min(s, n_dom), replace=False)
        for j, d in enumerate(doms):
            members = np.nonzero(dom == d)[0]
            if len(members):
                up[row, j] = rng.choice(members)
    if shape == "dup":
        for row in range(0, c, 2):
            members = np.nonzero(dom == dom[up[row, 0]])[0]
            up[row, 1] = up[row, 0] if row % 4 == 0 else rng.choice(members)
    if shape == "none":
        up[rng.random((c, s)) < 0.3] = -1
        up[0, :] = -1
        up[1, 0] = -1
    dev = np.concatenate([(counts - target).astype(np.float32), [np.float32(0.0)]])
    return (up, dev, np.concatenate([valid, [False]]),
            np.concatenate([dom, [np.int32(-2)]]).astype(np.int32), max_dev)


def rounding_ties(case) -> int:
    """Candidate pairs (row, two slots, one target) of a case whose source
    deviations differ and whose float32 gains fdev - tdev are equal."""
    up, dev, valid, dom, _ = case
    n = dev.shape[0] - 1
    fdev = dev[np.where(up >= 0, np.minimum(up, n), n)]           # (C, S)
    d = (fdev[:, :, None] - dev[None, None, :n]).astype(np.float32)  # (C, S, n)
    ties = 0
    for a in range(up.shape[1]):
        for b in range(a + 1, up.shape[1]):
            differ = (fdev[:, a] != fdev[:, b]) & (up[:, a] >= 0) & (up[:, b] >= 0)
            ties += int(((d[:, a] == d[:, b]) & differ[:, None] & valid[None, :n]).sum())
    return ties


def as_tensors(case, device):
    up, dev, valid, dom, max_dev = case
    return (torch.from_numpy(up).to(device), torch.from_numpy(dev).to(device),
            torch.from_numpy(valid).to(device), torch.from_numpy(dom).to(device),
            max_dev)


def test_kernel_source_and_binding_agree():
    """The wrapper's bounds and ctypes signature match the source."""
    with open(SOURCE) as f:
        src = f.read()
    assert int(re.search(r"#define UPMAP_MAX_SLOTS (\d+)", src).group(1)) == upmap_cuda.MAX_SLOTS
    assert int(re.search(r"#define UPMAP_STAGED_OSDS (\d+)", src).group(1)) == \
        upmap_cuda.STAGED_OSDS
    max_osds = re.search(r"#define UPMAP_MAX_OSDS \(1 << (\d+)\)", src).group(1)
    assert 1 << int(max_osds) == upmap_cuda.MAX_OSDS
    assert (upmap_cuda.MAX_SLOTS * upmap_cuda.MAX_OSDS) <= 2**31 - 1
    # the staged (tdev, tdom) pairs and the generic kernel's per-warp
    # sources fit a block's shared memory (227 KB on Hopper)
    warps = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) // 32
    assert upmap_cuda.STAGED_OSDS * 8 + warps * 32 * 12 <= 232448
    # the register instantiations take the balancer's widths, 3 and 6
    assert re.findall(r"if \(S == (\d+)\)", src) == ["3", "6"]
    assert CASES["osds-30000"][2] > upmap_cuda.STAGED_OSDS >= CASES["osds-10000"][2]
    assert "--use_fast_math" not in " ".join(cuda_build.NVCC_FLAGS)
    launch = re.search(r'extern "C" int upmap_score_launch\((.*?)\)\s*\{', src, re.S)
    params = [p for p in launch.group(1).split(",") if p.strip()]

    class FakeFn:
        argtypes = None

    class FakeLib:
        upmap_score_launch = FakeFn()
        upmap_cuda_error_string = FakeFn()

    orig = cuda_build.load
    cuda_build.load = lambda name: FakeLib()
    try:
        lib = upmap_cuda._lib()
    finally:
        cuda_build.load = orig
    argtypes = lib.upmap_score_launch.argtypes
    assert len(argtypes) == len(params)
    assert argtypes.count(ctypes.c_void_p) == len([p for p in params if "*" in p])
    assert argtypes[4] is ctypes.c_float and "float max_dev" in params[4]
    assert argtypes[-2] is ctypes.c_int and "int staged" in params[-2]


def test_wrapper_refuses_what_the_kernel_cannot_take():
    up, dev, valid, dom, max_dev = as_tensors(score_case("random"), "cpu")
    wide = torch.zeros((2, upmap_cuda.MAX_SLOTS + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside the kernel"):
        upmap_cuda.upmap_score(wide, dev, valid, dom, max_dev)
    # stride-0 views: the wrapper refuses on the shape alone
    big = [torch.zeros(1, dtype=dt).expand(upmap_cuda.MAX_OSDS + 2)
           for dt in (torch.float32, torch.bool, torch.int32)]
    with pytest.raises(ValueError, match="outside the kernel"):
        upmap_cuda.upmap_score(up, *big, max_dev)
    with pytest.raises(ValueError, match="valid_target shape"):
        upmap_cuda.upmap_score(up, dev, valid[:-1], dom, max_dev)
    with pytest.raises(ValueError, match="unsupported device"):
        upmap_cuda.upmap_score(up.to("meta"), dev, valid, dom, max_dev)
    # a CPU tensor runs the plain version and launches nothing
    before = upmap_cuda.upmap_score.launches
    got = upmap_cuda.upmap_score(up, dev, valid, dom, max_dev)
    want = balance.score_chunk_plain(up, dev, valid, dom, max_dev)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert upmap_cuda.upmap_score.launches == before


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_card():
    """The kernel against the plain version on the card, case by case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on one)")
    before = upmap_cuda.upmap_score.launches
    for name in CASES:
        args = as_tensors(score_case(name), "cuda")
        got = upmap_cuda.upmap_score(*args)
        torch.cuda.synchronize()
        want = balance.score_chunk_plain(*args)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), name
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]), name
    assert upmap_cuda.upmap_score.launches == before + len(CASES)


def test_smoke_flat_argmax_variant_applies_to_the_source():
    """chip_smoke.py times the register instantiations against a variant
    with the generic kernel's flat-index argmax, made by text replacement:
    every replaced text is in the source, and the variant keeps no per-slot
    maximum."""
    sys.path.insert(0, REPO)
    import chip_smoke

    with open(SOURCE) as f:
        src = orig = f.read()
    for old, new in chip_smoke.FLAT_ARGMAX:
        assert old in src
        src = src.replace(old, new)
    compare = "better(g, idx, best, best_idx)"
    assert "best_t" not in src and src.count(compare) == orig.count(compare) + 1
    launcher = src[src.index('extern "C" int upmap_score_launch'):]
    assert set(chip_smoke.UPMAP_INSTANTIATION.findall(launcher)) == {
        f"upmap_score_regs<{s}, {b}>" for s in (3, 6) for b in ("true", "false")} | {
        "upmap_score_generic<true>", "upmap_score_generic<false>"}
