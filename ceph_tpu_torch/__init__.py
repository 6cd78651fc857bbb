"""ceph_tpu_torch: the PyTorch/CUDA port of ceph_tpu, for one NVIDIA Hopper card.

The layout mirrors `ceph_tpu` module for module, so each module's counterpart
is easy to find. The port imports torch, numpy and the standard library only;
the framework-free modules it needs are its own copies.

Subpackages ported so far:
  ops      — GF(2^8) math: the exact NumPy oracle (gf), the bit-plane matmul
             as torch ops (gf_bitplane), and the packed-word matmul with its
             hand-written CUDA kernel (gf_cuda, csrc/gf_matmul.cu)
  ec       — erasure-code interface, plugin registry, the RS/Cauchy codec
             (plugins tpu, isa, jerasure matrix techniques)
  osd      — EncodeService: concurrent objects coalesced into one planar launch
  crush    — CRUSH placement: the scalar mapper and the batched torch_mapper
             with its hand-written straw2 choose kernel (ops/crush_cuda,
             csrc/crush_choose.cu), and CrushTester
  rados    — MiniCluster: the single-process EC/replicated data path
             (put, degraded get, scrub, recover) over the codecs and OSDMap
  native   — C sources built into _build/ at first use: the dlopened
             erasure-code plugin (plugin=native, a host codec), crc32c and
             the CPU EC baseline
  common   — config, perf counters, logs, tracer, admin hub, crc32c
  tools    — ec_bench, the ceph_erasure_code_benchmark drop-in; crushtool
             and crush_bench; ec_non_regression and cpu_ec_baseline

Device rule: entry points run on `cuda` unless the caller passes
`device="cpu"`; asking for `cuda` where none is present raises.
"""

__version__ = "0.1.0"
