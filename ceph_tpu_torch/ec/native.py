"""Native plugin loading + the `native` CPU codec.

`load_plugin` re-expresses ErasureCodePluginRegistry::load
(src/erasure-code/ErasureCodePlugin.cc:126-180) over ctypes:

  * dlopen `<dir>/libec_<name>.so` — failure -> EIO;
  * `__erasure_code_version()` must equal this build's version string; a
    missing symbol reads as "an older version" and mismatches -> EXDEV
    (ErasureCodePlugin.cc:122-149);
  * `__erasure_code_init(name, dir)` — missing symbol -> ENOENT, nonzero
    return -> that errno;
  * the plugin must then actually register — here by exposing a non-NULL
    `__erasure_code_ops` vtable — or the load fails with the reference's
    "did not register" error (EIO).

`ErasureCodeNative` wraps the loaded vtable in the ErasureCode interface:
plugin=native technique=reed_sol_van|cauchy is the reference's host codec,
picked by name (it is not a fallback), whose chunks are asserted
bit-identical to the `isa` codec in tests. It computes on the host whatever
`device` it is given: that device is resolved like every codec's (None means
cuda, which raises without a card), input tensors on it are copied to the
host, and `encode_array`/`decode_array` return CPU tensors. It is the one
codec whose results are not on the requested device.

The plugin is built from this package's own ec_plugin.cpp into `_build/`
(native/build.py) at the first `prepare`.
"""

from __future__ import annotations

import ctypes
import errno
import os
from typing import Sequence

import numpy as np
import torch

from ceph_tpu_torch import __version__ as _pkg_version
from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.ec.interface import (
    SIMD_ALIGN,
    ErasureCode,
    ErasureCodeError,
    chunk_size_isa_style,
    profile_to_int,
    profile_to_string,
)
from ceph_tpu_torch.native.build import build_plugin, plugin_path

#: the handshake string; build.py injects the same value into ec_plugin.cpp
#: at compile time (the reference pins CEPH_GIT_NICE_VER the same way)
PLUGIN_VERSION = f"ceph-tpu-{_pkg_version}"

_loaded: dict[str, "NativePlugin"] = {}


class NativePlugin:
    """A dlopened plugin's bound entry points."""

    def __init__(self, lib: ctypes.CDLL, path: str):
        self.lib = lib
        self.path = path
        ops_getter = lib.__getattr__("__erasure_code_ops")
        ops_getter.restype = ctypes.c_void_p
        ops = ops_getter()
        if not ops:
            raise ErasureCodeError(
                errno.EIO,
                f"load __erasure_code_init() did not register {path}",
            )
        # struct of 4 function pointers (see ec_plugin.cpp ec_plugin_ops)
        fptr = ctypes.cast(
            ops, ctypes.POINTER(ctypes.c_void_p * 4)
        ).contents
        self.create = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int
        )(fptr[0])
        self.destroy = ctypes.CFUNCTYPE(None, ctypes.c_int)(fptr[1])
        self.encode = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_size_t,
        )(fptr[2])
        self.decode = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        )(fptr[3])


def load_plugin(name: str, directory: str | None = None) -> NativePlugin:
    """dlopen + handshake per the reference contract; memoized per path."""
    path = plugin_path(name, directory)
    cached = _loaded.get(path)
    if cached is not None:
        return cached
    if not os.path.exists(path):
        raise ErasureCodeError(errno.EIO, f"load dlopen({path}): no such file")
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise ErasureCodeError(errno.EIO, f"load dlopen({path}): {e}") from None

    try:
        version_fn = lib.__getattr__("__erasure_code_version")
        version_fn.restype = ctypes.c_char_p
        version = version_fn().decode()
    except AttributeError:
        version = "an older version"  # ErasureCodePlugin.cc:122-124
    if version != PLUGIN_VERSION:
        raise ErasureCodeError(
            errno.EXDEV,
            f"expected plugin {path} version {PLUGIN_VERSION} but it claims "
            f"to be {version} instead",
        )

    try:
        init_fn = lib.__getattr__("__erasure_code_init")
    except AttributeError:
        raise ErasureCodeError(
            errno.ENOENT, f"load dlsym({path}, __erasure_code_init): missing"
        ) from None
    init_fn.restype = ctypes.c_int
    init_fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    r = init_fn(
        name.encode(), (directory or os.path.dirname(path)).encode()
    )
    if r != 0:
        raise ErasureCodeError(
            -r if r < 0 else r,
            f"erasure_code_init({name}): error {r}",
        )
    plugin = NativePlugin(lib, path)
    _loaded[path] = plugin
    return plugin


TECHNIQUES = {"reed_sol_van": 0, "cauchy": 1}


class ErasureCodeNative(ErasureCode):
    """plugin=native: the C++ codec behind the dlopen ABI (CPU fallback)."""

    def __init__(self, directory: str | None = None, device=None):
        super().__init__()
        self._directory = directory
        self.technique = ""
        self._plugin: NativePlugin | None = None
        self._handle = -1
        self.device = resolve_device(device)

    def parse(self, profile) -> None:
        self.k = profile_to_int(profile, "k", 7)
        self.m = profile_to_int(profile, "m", 3)
        self.technique = profile_to_string(profile, "technique", "cauchy")
        if self.technique not in TECHNIQUES:
            raise ErasureCodeError(
                errno.EINVAL,
                f"technique={self.technique} must be one of "
                f"{sorted(TECHNIQUES)}",
            )
        self.sanity_check_k_m()
        if self.k + self.m > 256:
            raise ErasureCodeError(errno.EINVAL, "k+m must be <= 256")
        if self.technique == "reed_sol_van":
            # MDS safety envelope, same as the isa codec (ErasureCodeIsa.cc:
            # 325-364): the 2^i-powers Vandermonde is not MDS beyond it
            if self.k > 32 or self.m > 4 or (self.m == 4 and self.k > 21):
                raise ErasureCodeError(
                    errno.EINVAL,
                    "reed_sol_van is only MDS for k<=32, m<=4 "
                    "(k<=21 when m=4)",
                )
        self._parse_mapping(profile)

    def prepare(self) -> None:
        try:
            built = build_plugin("native", directory=self._directory)
        except RuntimeError as e:  # compile failed: surface the diagnostics
            raise ErasureCodeError(errno.EIO, str(e)) from None
        if built is None and not os.path.exists(
            plugin_path("native", self._directory)
        ):
            raise ErasureCodeError(
                errno.EIO, "no toolchain to build libec_native.so"
            )
        self._plugin = load_plugin("native", self._directory)
        self._handle = self._plugin.create(
            self.k, self.m, TECHNIQUES[self.technique]
        )
        if self._handle < 0:
            raise ErasureCodeError(-self._handle, "ec_create failed")

    def __del__(self):
        plugin, handle = getattr(self, "_plugin", None), self._handle
        if plugin is not None and handle >= 0:
            plugin.destroy(handle)

    def get_chunk_size(self, object_size: int) -> int:
        return chunk_size_isa_style(self.k, object_size, SIMD_ALIGN)

    # -- compute (host memory, C++ kernels) ---------------------------------

    def encode_array(self, data) -> torch.Tensor:
        """(B, k, L) uint8 -> (B, m, L) parity, a CPU tensor."""
        data = np.ascontiguousarray(_host_bytes(data))
        batch, k, length = data.shape
        out = np.empty((batch, self.m, length), dtype=np.uint8)
        for b in range(batch):
            r = self._plugin.encode(
                self._handle,
                ctypes.cast(data[b].ctypes.data, ctypes.c_char_p),
                ctypes.cast(out[b].ctypes.data, ctypes.c_char_p),
                length,
            )
            if r != 0:
                raise ErasureCodeError(-r, "ec_encode failed")
        return torch.from_numpy(out)

    def decode_array(
        self, present: Sequence[int], targets: Sequence[int], survivors
    ) -> torch.Tensor:
        """Rebuild logical `targets` from the first k of `present`; a CPU
        tensor (B, len(targets), L)."""
        if len(present) < self.k:
            raise ErasureCodeError(errno.EIO, "not enough survivors")
        survivors = np.ascontiguousarray(_host_bytes(survivors)[:, : self.k, :])
        batch, _, length = survivors.shape
        pres = (ctypes.c_int * self.k)(*[int(p) for p in present[: self.k]])
        targ = (ctypes.c_int * len(targets))(*[int(t) for t in targets])
        out = np.empty((batch, len(targets), length), dtype=np.uint8)
        for b in range(batch):
            r = self._plugin.decode(
                self._handle, pres, self.k, targ, len(targets),
                ctypes.cast(survivors[b].ctypes.data, ctypes.c_char_p),
                ctypes.cast(out[b].ctypes.data, ctypes.c_char_p),
                length,
            )
            if r != 0:
                raise ErasureCodeError(-r, "ec_decode failed")
        return torch.from_numpy(out)


def _host_bytes(x) -> np.ndarray:
    """`x` as a uint8 host array (a tensor on any device is copied to the
    host: this codec computes there)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"expected a torch.uint8 tensor, got {x.dtype}")
        x = x.cpu().numpy()
    return np.asarray(x, dtype=np.uint8)
