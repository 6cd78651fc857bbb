"""One CRUSH choose stage: the CUDA kernel's wrapper and its dispatch.

Port of the choose stages of ceph_tpu/crush/jax_mapper.py
(_choose_firstn_static, _choose_firstn_dynamic, _choose_indep_b).
`crush_choose(cm, xs, start, weight_vec, ...)` maps every x of the batch
through one choose step of a rule:

  * for CUDA tensors it launches csrc/crush_choose.cu, one thread per x
    running the reference's per-x choose loop, on the current stream;
  * for CPU tensors it runs torch_mapper.choose_stage_plain, the plain torch
    version of the same stage.

Nothing else selects between them, and nothing falls back. Each kernel
launch adds one to `crush_choose.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ceph_tpu_torch.ops import cuda_build

__all__ = ["MAX_SLOTS", "crush_choose"]

#: the kernel's compile-time bound on a stage's slots (CRUSH_MAX_SLOTS):
#: its per-thread out/out2 arrays
MAX_SLOTS = 32


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("crush_choose")
    fn = lib.crush_choose_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [
            p, p, p, p, p, i, ll,          # offsets sizes items ids weights n_pos total
            p, i, p,                       # row_of n_row_of type_of_bucket
            p, i, i, i,                    # dev_weight n_dev_weight max_devices depth
            p,                             # ln_tables
            i, i, i, i, i, i, i, i, i,     # stage parameters
            p, p, i,                       # xs start_items static_start
            p, p, p, ll, p,                # out out2 draws n stream
        ]
        fn.restype = ctypes.c_int
        lib.crush_cuda_error_string.argtypes = [ctypes.c_int]
        lib.crush_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, dtype, device, what: str) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"crush_choose: {what} must be contiguous {dtype} on {device}, "
            f"got {t.dtype} on {t.device}"
        )


def crush_choose(cm, xs: torch.Tensor, start, weight_vec: torch.Tensor, *,
                 firstn: bool, numrep: int, want_type: int, recurse: bool,
                 tries: int, recurse_tries: int, vary_r: int, stable: int,
                 out_slots: int, rt=None, draws: torch.Tensor | None = None):
    """One choose stage for every x: (out, out2), (N, out_slots) int32.

    cm: a torch_mapper.CompiledMap on the tensors' device; xs: (N,) int32;
    start: the static TAKE item id (int) or an (N,) int32 tensor of per-lane
    start items; weight_vec: (D,) int64 16.16 reweights; rt: the (P, T)
    tensor of torch_mapper.runtime_weight_arrays, read instead of the
    compiled weights. draws (CUDA only): an (N,) int32 tensor that receives each x's
    count of straw2 draws, for the stage's operation count.
    """
    # one limit on both devices, so a CPU map refuses what a card would
    if not 1 <= out_slots <= MAX_SLOTS:
        raise ValueError(
            f"crush_choose: a stage of {out_slots} slots exceeds the kernel's "
            f"{MAX_SLOTS} (CRUSH_MAX_SLOTS in csrc/crush_choose.cu)"
        )
    if xs.device.type == "cpu":
        if draws is not None:
            raise ValueError("crush_choose: draws are counted by the kernel only")
        from ceph_tpu_torch.crush import torch_mapper

        return torch_mapper.choose_stage_plain(
            cm, xs, start, weight_vec, firstn=firstn, numrep=numrep,
            want_type=want_type, recurse=recurse, tries=tries,
            recurse_tries=recurse_tries, vary_r=vary_r, stable=stable,
            out_slots=out_slots, rt=rt)
    if xs.device.type != "cuda":
        raise ValueError(f"crush_choose: unsupported device {xs.device}")
    dev = xs.device
    if cm.device != dev:
        raise ValueError(f"crush_choose: map on {cm.device}, xs on {dev}")
    n = xs.shape[0]
    _check(xs, torch.int32, dev, "xs")
    _check(weight_vec, torch.int64, dev, "weight_vec")
    if weight_vec.numel() == 0:
        raise ValueError("crush_choose: empty weight vector")
    weights = cm.weights if rt is None else rt
    _check(weights, torch.int64, dev, "weights")
    if weights.dim() != 2 or weights.shape[1] != cm.items.shape[0]:
        raise ValueError(f"crush_choose: weights shape {tuple(weights.shape)}")
    if isinstance(start, int):
        start_items, static_start = None, start
    else:
        _check(start, torch.int32, dev, "start items")
        if start.shape != (n,):
            raise ValueError(f"crush_choose: start items shape {tuple(start.shape)}")
        start_items, static_start = start, 0
    if draws is not None:
        _check(draws, torch.int32, dev, "draws")
        if draws.shape != (n,):
            raise ValueError(f"crush_choose: draws shape {tuple(draws.shape)}")
    out = torch.empty((n, out_slots), dtype=torch.int32, device=dev)
    out2 = torch.empty_like(out)
    if n == 0:
        return out, out2

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.crush_choose_launch(
            cm.offsets.data_ptr(), cm.sizes.data_ptr(), cm.items.data_ptr(),
            cm.ids.data_ptr(), weights.data_ptr(), weights.shape[0],
            weights.shape[1],
            cm.row_of.data_ptr(), cm.row_of.shape[0], cm.type_of_bucket.data_ptr(),
            weight_vec.data_ptr(), weight_vec.shape[0], cm.max_devices, cm.depth,
            cm.ln_tables.data_ptr(),
            int(firstn), numrep, want_type, int(recurse), tries, recurse_tries,
            vary_r, stable, out_slots,
            xs.data_ptr(), ptr(start_items), static_start,
            out.data_ptr(), out2.data_ptr(), ptr(draws), n, stream,
        )
    if err != 0:
        msg = lib.crush_cuda_error_string(err).decode()
        raise RuntimeError(f"crush_choose launch failed: CUDA error {err} ({msg})")
    crush_choose.launches += 1
    return out, out2


#: kernel launches made by the wrapper (the plain version counts none)
crush_choose.launches = 0
