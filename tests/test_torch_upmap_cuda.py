"""The upmap move-scoring kernel (csrc/upmap_score.cu, wrapper
ops/upmap_cuda.py) against its plain torch version.

`score_case` builds the scorer's inputs from a seed: random rows, rows of
massive gain ties (equal weights), all-illegal rows, NONE slots, unreachable
(-1) domains, 11-wide EC rows and a 10,000-OSD cluster. The CPU tests of
tests/test_torch_balance.py hold the plain version against the JAX package
and a numpy emulation of the kernel on these cases; the `gpu` test here holds
the kernel itself against the plain version on a card (gain compared as its
float32 bits, tolerance 0) and skips without one. This file imports neither
JAX nor the JAX package, so on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_upmap_cuda.py -q
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import balance
from ceph_tpu_torch.ops import cuda_build, upmap_cuda

SOURCE = os.path.join(cuda_build.CSRC_DIR, "upmap_score.cu")

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
    n_dom = int(dom.max()) + 1
    up = np.full((c, s), -1, np.int32)
    for row in range(c):
        # one OSD per distinct domain, as a CRUSH rule places them
        doms = rng.choice(n_dom, size=min(s, n_dom), replace=False)
        for j, d in enumerate(doms):
            members = np.nonzero(dom == d)[0]
            if len(members):
                up[row, j] = rng.choice(members)
    if shape == "none":
        up[rng.random((c, s)) < 0.3] = -1
        up[0, :] = -1
        up[1, 0] = -1
    dev = np.concatenate([(counts - target).astype(np.float32), [np.float32(0.0)]])
    return (up, dev, np.concatenate([valid, [False]]),
            np.concatenate([dom, [np.int32(-2)]]).astype(np.int32), max_dev)


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
    # the staged arrays and the rows' sources fit a block's shared memory
    # (227 KB on Hopper)
    assert upmap_cuda.STAGED_OSDS * 8 + 8 * 32 * 12 <= 232448
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
