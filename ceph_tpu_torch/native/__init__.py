"""Native (C++) components: the erasure-code plugin ABI and CPU codec.

The reference's native layer ships codecs as dlopened libec_*.so plugins
(ErasureCodePlugin.cc); this package holds the framework's equivalents —
ec_plugin.cpp (GF(2^8) RS codec behind the same version/init/register
handshake) and build.py (the g++ build script). Python-side loading lives in
ceph_tpu_torch.ec.native.
"""
