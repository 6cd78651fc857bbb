"""Erasure-code plugin registry.

Port of ceph_tpu/ec/registry.py, which mirrors the reference's
`ErasureCodePluginRegistry` (ErasureCodePlugin.{h,cc}): plugins register a
factory under a name; `factory(plugin, profile, device)` instantiates and
initializes a codec on `device` (default cuda). Composite codecs (lrc's
layers, clay's scalar MDS codes) build their inner codecs on the same
device.

Registered: `tpu`, `isa`, `jerasure` (the matrix techniques on
ErasureCodeRs, liberation / blaum_roth / liber8tion on
ErasureCodeBitmatrix), `shec`, `lrc`, `clay` and `native` (the dlopened C++
plugin, ec/native.py: it resolves its device like the others but computes on
the host and returns CPU tensors).
"""

from __future__ import annotations

import errno
from typing import Callable

from ceph_tpu_torch.ec.bitmatrix import BUILDERS, ErasureCodeBitmatrix
from ceph_tpu_torch.ec.clay import ErasureCodeClay
from ceph_tpu_torch.ec.interface import ErasureCode, ErasureCodeError, ErasureCodeProfile
from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
from ceph_tpu_torch.ec.native import ErasureCodeNative
from ceph_tpu_torch.ec.rs import ErasureCodeRs
from ceph_tpu_torch.ec.shec import ErasureCodeShec


class ErasureCodePluginRegistry:
    def __init__(self):
        self._factories: dict[str, Callable[..., ErasureCode]] = {}

    def add(self, name: str, factory: Callable[..., ErasureCode]) -> None:
        """`factory(device)` returns an uninitialized codec."""
        if name in self._factories:
            raise ErasureCodeError(errno.EEXIST, f"plugin {name} already registered")
        self._factories[name] = factory

    def remove(self, name: str) -> None:
        self._factories.pop(name, None)

    def get_plugins(self) -> list[str]:
        return sorted(self._factories)

    def factory(
        self, plugin: str, profile: ErasureCodeProfile, device=None
    ) -> ErasureCode:
        """Instantiate + init a codec from a profile; the profile's own
        `plugin=` key, if present, must agree (as when profiles are stored in
        pool metadata)."""
        declared = profile.get("plugin")
        if declared is not None and declared != plugin:
            raise ErasureCodeError(
                errno.EINVAL,
                f"profile declares plugin={declared} but {plugin} was requested",
            )
        try:
            make = self._factories[plugin]
        except KeyError:
            raise ErasureCodeError(
                errno.ENOENT,
                f"no erasure-code plugin {plugin!r}; known: {self.get_plugins()}",
            ) from None
        return make(device).init(dict(profile))


#: process-wide singleton, like ErasureCodePluginRegistry::instance()
registry = ErasureCodePluginRegistry()


class _JerasureSelector:
    """Technique-dispatching factory for plugin=jerasure: the matrix
    techniques live in ErasureCodeRs, the liberation-family pure-bitmatrix
    techniques in ErasureCodeBitmatrix (the reference's plugin factory
    similarly switches on technique, ErasureCodePluginJerasure.cc)."""

    def __init__(self, device=None):
        self.device = device

    def init(self, profile):
        technique = profile.get("technique", "reed_sol_van")
        if technique in BUILDERS:
            return ErasureCodeBitmatrix(technique, device=self.device).init(profile)
        return ErasureCodeRs("jerasure", device=self.device).init(profile)


def _register_builtin() -> None:
    registry.add("tpu", lambda device=None: ErasureCodeRs("tpu", device=device))
    registry.add("jerasure", _JerasureSelector)
    registry.add("isa", lambda device=None: ErasureCodeRs("isa", device=device))
    registry.add("shec", ErasureCodeShec)
    registry.add("lrc", ErasureCodeLrc)
    registry.add("clay", ErasureCodeClay)
    registry.add("native", lambda device=None: ErasureCodeNative(device=device))


_register_builtin()


def factory(plugin: str, profile: ErasureCodeProfile, device=None) -> ErasureCode:
    """A codec for `plugin` and `profile` on `device` (None means cuda)."""
    return registry.factory(plugin, profile, device)
