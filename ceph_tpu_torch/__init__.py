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
  osd      — EncodeService: concurrent objects coalesced into one planar
             launch; the OSDMap; the OSD daemon (daemon) on KStore
             (objectstore), with its op vector (ops), object classes (cls)
             and extent cache
  crush    — CRUSH placement: the scalar mapper and the batched torch_mapper
             with its hand-written straw2 choose kernel (ops/crush_cuda,
             csrc/crush_choose.cu), and CrushTester
  rados    — MiniCluster: the single-process EC/replicated data path
             (put, degraded get, scrub, recover) over the codecs and OSDMap;
             the RADOS client (client: Rados, Objecter, IoCtx)
  msg      — the messenger: frames, TCP and LocalStack transports, shm rings
  mon      — the monitors (paxos, the OSDMap service) and MonClient
  auth     — cephx tickets
  lint     — racecheck, the runtime asyncio race/leak detector
  native   — C sources built into _build/ at first use: the dlopened
             erasure-code plugin (plugin=native, a host codec), crc32c and
             the CPU EC baseline
  parallel — the device mesh (Mesh, MeshArray) and the sharded GF(2^8)
             matmul: one launch of the byte-layout kernel per mesh slot
  ckpt     — the checkpoint store over RADOS (manifests byte-identical to
             ceph_tpu's; restore onto a device or a mesh)
  common   — config, perf counters, logs, tracer, admin hub, crc32c, the
             KV store, op queues, watchdog, wire faults, compressors
  tools    — ec_bench, the ceph_erasure_code_benchmark drop-in; crushtool
             and crush_bench; ec_non_regression and cpu_ec_baseline;
             daemon_bench (in-process); ckpt_tool
  vstart   — the genesis OSDMap and loopback port picking

Device rule: entry points run on `cuda` unless the caller passes
`device="cpu"`; asking for `cuda` where none is present raises.
"""

__version__ = "0.1.0"
