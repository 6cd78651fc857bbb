"""The upmap balancer's move scorer: the CUDA kernel's wrapper and its dispatch.

Port of ceph_tpu/crush/balance.py's `_score_chunk`.
`upmap_score(up, dev, valid_target, dom, max_dev)` returns the best
(gain, from, to) move of every PG row:

  * for CUDA tensors it launches csrc/upmap_score.cu, one warp per row, on
    the current stream;
  * for CPU tensors it runs crush.balance.score_chunk_plain, the plain torch
    version of the same function.

Nothing else selects between them, and nothing falls back. Each kernel
launch adds one to `upmap_score.launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build

__all__ = ["MAX_OSDS", "MAX_SLOTS", "STAGED_OSDS", "upmap_score"]

#: the kernel's bounds (UPMAP_MAX_SLOTS, UPMAP_MAX_OSDS in csrc/upmap_score.cu):
#: a row's sources sit in per-warp shared memory, and the flat index
#: s * n + t of a candidate fits an int
MAX_SLOTS = 32
MAX_OSDS = 1 << 24
#: maps of up to this many OSDs have the targets' deviations and domains
#: staged in the block's shared memory, 8 bytes per OSD (UPMAP_STAGED_OSDS);
#: a larger map reads them from global memory
STAGED_OSDS = 28000


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("upmap_score")
    fn = lib.upmap_score_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [
            p, p, p, p,              # up dev valid dom
            ctypes.c_float, i, i, ll,  # max_dev n S C
            p, p, p, i, p,           # gain from to staged stream
        ]
        fn.restype = ctypes.c_int
        lib.upmap_cuda_error_string.argtypes = [ctypes.c_int]
        lib.upmap_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, dtype, device, what: str) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"upmap_score: {what} must be contiguous {dtype} on {device}, "
            f"got {t.dtype} on {t.device}"
        )


def upmap_score(up: torch.Tensor, dev: torch.Tensor, valid_target: torch.Tensor,
                dom: torch.Tensor, max_dev: float):
    """Best move per row: (gain (C,) float32, from (C,) int32, to (C,) int32).

    up: (C, S) int32 up-set rows, -1 for NONE; dev: (n+1,) float32 per-OSD
    deviations with the sentinel at slot n; valid_target: (n+1,) bool; dom:
    (n+1,) int32 dense failure-domain ids (-1 unreachable); max_dev: the
    deviation band, compared in float32. See score_chunk_plain for the rules.
    """
    if up.dim() != 2 or dev.dim() != 1:
        raise ValueError(f"upmap_score: up {tuple(up.shape)}, dev {tuple(dev.shape)}")
    c, s = up.shape
    n = dev.shape[0] - 1
    # one limit on both devices, so a CPU map refuses what a card would
    if not 1 <= s <= MAX_SLOTS or not 1 <= n <= MAX_OSDS:
        raise ValueError(
            f"upmap_score: {s} slots x {n} OSDs is outside the kernel's "
            f"1..{MAX_SLOTS} x 1..{MAX_OSDS} (csrc/upmap_score.cu)"
        )
    for t, what in ((valid_target, "valid_target"), (dom, "dom")):
        if t.shape != dev.shape:
            raise ValueError(f"upmap_score: {what} shape {tuple(t.shape)} != {tuple(dev.shape)}")
    if up.device.type == "cpu":
        from ceph_tpu_torch.crush import balance

        return balance.score_chunk_plain(up, dev, valid_target, dom, max_dev)
    if up.device.type != "cuda":
        raise ValueError(f"upmap_score: unsupported device {up.device}")
    device = up.device
    _check(up, torch.int32, device, "up")
    _check(dev, torch.float32, device, "dev")
    _check(valid_target, torch.bool, device, "valid_target")
    _check(dom, torch.int32, device, "dom")
    gain = torch.empty(c, dtype=torch.float32, device=device)
    frm = torch.empty(c, dtype=torch.int32, device=device)
    to = torch.empty(c, dtype=torch.int32, device=device)
    if c == 0:
        return gain, frm, to
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.upmap_score_launch(
            up.data_ptr(), dev.data_ptr(), valid_target.data_ptr(), dom.data_ptr(),
            float(np.float32(max_dev)), n, s, c,
            gain.data_ptr(), frm.data_ptr(), to.data_ptr(), int(n <= STAGED_OSDS), stream,
        )
    if err != 0:
        msg = lib.upmap_cuda_error_string(err).decode()
        raise RuntimeError(f"upmap_score launch failed: CUDA error {err} ({msg})")
    upmap_score.launches += 1
    return gain, frm, to


#: kernel launches made by the wrapper (the plain version counts none)
upmap_score.launches = 0
