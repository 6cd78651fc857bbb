"""Compressor plugin framework — the EC registry's sibling.

Re-expresses the reference's src/compressor/: a `Compressor` interface
(Compressor.h:33 — compress/decompress over byte buffers, a COMP_* mode
enum) behind a plugin registry keyed by algorithm name, mirroring the EC
plugin registry's shape (the reference loads libceph_<alg>.so via
CompressionPlugin; here builtin codecs register over Python's own zlib /
zstd / lzma, and unavailable algorithms fail factory() with a clear error
exactly like an absent plugin .so would).

Mode semantics (Compressor.h:63-69) are honored by `maybe_compress`: NONE
never compresses, PASSIVE only when hinted compressible, AGGRESSIVE unless
hinted incompressible, FORCE always — and, like BlueStore, a result that
does not beat `required_ratio` is discarded in favor of the raw bytes.
"""

from __future__ import annotations

import errno
import zlib
from typing import Callable

from ceph_tpu_torch.ec.interface import ErasureCodeError as CompressorError

# COMP_* (Compressor.h:63-69)
COMP_NONE = "none"
COMP_PASSIVE = "passive"
COMP_AGGRESSIVE = "aggressive"
COMP_FORCE = "force"

HINT_COMPRESSIBLE = 1
HINT_INCOMPRESSIBLE = 2


class Compressor:
    """One algorithm's codec (Compressor.h:33)."""

    def __init__(self, name: str,
                 compress: Callable[[bytes], bytes],
                 decompress: Callable[[bytes], bytes]):
        self.name = name
        self._compress = compress
        self._decompress = decompress

    def compress(self, data: bytes) -> bytes:
        return self._compress(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return self._decompress(bytes(data))

    def maybe_compress(
        self,
        data: bytes,
        mode: str = COMP_AGGRESSIVE,
        hint: int = 0,
        required_ratio: float = 0.875,
    ) -> tuple[bool, bytes]:
        """(compressed?, payload) under the reference's mode/ratio policy:
        the compressed form must be <= required_ratio * len(data) (BlueStore's
        compression_required_ratio) or the raw bytes win."""
        want = (
            mode == COMP_FORCE
            or (mode == COMP_AGGRESSIVE and hint != HINT_INCOMPRESSIBLE)
            or (mode == COMP_PASSIVE and hint == HINT_COMPRESSIBLE)
        )
        if not want or not data:
            return False, bytes(data)
        out = self.compress(data)
        if len(out) > required_ratio * len(data) and mode != COMP_FORCE:
            return False, bytes(data)
        return True, out


class CompressorRegistry:
    """Algorithm name -> factory, like CompressionPluginRegistry."""

    def __init__(self):
        self._factories: dict[str, Callable[[], Compressor]] = {}

    def add(self, name: str, make: Callable[[], Compressor]) -> None:
        if name in self._factories:
            raise CompressorError(errno.EEXIST, f"{name} already registered")
        self._factories[name] = make

    def get_algorithms(self) -> list[str]:
        return sorted(self._factories)

    def factory(self, name: str) -> Compressor:
        make = self._factories.get(name)
        if make is None:
            raise CompressorError(
                errno.ENOENT,
                f"no compression algorithm {name!r}; "
                f"known: {self.get_algorithms()}",
            )
        return make()


registry = CompressorRegistry()


def _register_builtin() -> None:
    registry.add("zlib", lambda: Compressor(
        "zlib", lambda d: zlib.compress(d, 5), zlib.decompress
    ))

    try:
        import zstandard

        registry.add("zstd", lambda: Compressor(
            "zstd",
            lambda d: zstandard.ZstdCompressor(level=1).compress(d),
            lambda d: zstandard.ZstdDecompressor().decompress(d),
        ))
    except ImportError:  # the absent-plugin case
        pass

    import lzma

    registry.add("lzma", lambda: Compressor(
        "lzma", lambda d: lzma.compress(d, preset=1), lzma.decompress
    ))


_register_builtin()


def factory(name: str) -> Compressor:
    return registry.factory(name)
