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
             (objectstore) or BlockStore (blockstore, with its allocator),
             with its op vector (ops), object classes (cls) and extent
             cache; `python -m ceph_tpu_torch.osd` is its process
  crush    — CRUSH placement: the scalar mapper and the batched torch_mapper
             with its hand-written straw2 choose kernel (ops/crush_cuda,
             csrc/crush_choose.cu), and CrushTester
  rados    — MiniCluster: the single-process EC/replicated data path
             (put, degraded get, scrub, recover) over the codecs and OSDMap;
             the RADOS client (client: Rados, Objecter, IoCtx)
  msg      — the messenger: frames, TCP and LocalStack transports, shm rings
  mon      — the monitors (paxos, the OSDMap service) and MonClient;
             `python -m ceph_tpu_torch.mon` is a monitor's process
  auth     — cephx tickets
  lint     — racecheck, the runtime asyncio race/leak detector
  native   — C sources built into _build/ at first use: the dlopened
             erasure-code plugin (plugin=native, a host codec), crc32c and
             the CPU EC baseline
  parallel — the device mesh (Mesh, MeshArray) and the sharded GF(2^8)
             matmul: one launch of the byte-layout kernel per mesh slot
  ckpt     — the checkpoint store over RADOS (manifests byte-identical to
             ceph_tpu's; restore onto a device or a mesh)
  coord    — the training fleet over RADOS: lease locks (lock), the roster,
             elections and barriers (fleet), the fleet mesh (mesh) and the
             driver of fleet-parallel saves, mesh restores and exact data
             resume (driver)
  data     — the dataset store: sharded, crc-checked record ingest and the
             deterministic, prefetching, resumable per-host iterator
  common   — config, perf counters, logs, tracer, admin hub, crc32c, the
             KV store, op queues, throttles, watchdog, wire faults,
             compressors
  tools    — ec_bench, the ceph_erasure_code_benchmark drop-in; crushtool
             and crush_bench; osdmaptool and psim; ec_non_regression and
             cpu_ec_baseline; daemon_bench (in-process and --multiprocess);
             ckpt_tool, data_tool and fleet_tool (their benches share
             bench_cluster); rados, ceph, dencoder, objectstore_tool,
             monstore_tool and store_bench
  mgr      — the manager daemon (MgrService) and its modules: the balancer,
             metrics and SLOs, traces, Prometheus, the autoscaler, the
             dashboard; `python -m ceph_tpu_torch.mgr` is its process;
             sim — the cluster simulator behind psim and the chaos replay
  rbd      — block images over RADOS objects: sparse writes with the
             read-modify-write, object maps, snapshots, clones, fast diff,
             the cluster-side exclusive lock, live migration
  journal  — the journaling library, journaled images and the mirror's
             image replayer
  cephfs   — the file system: the fs object classes and direct library,
             the MDS daemon (sessions, caps, journal replay on failover,
             ranks, snapshots, dirfrags) and its client; `python -m
             ceph_tpu_torch.cephfs` is an mds process
  vstart   — the multi-process cluster: VStart spawns a process per monitor
             and OSD daemon from a cluster spec (the genesis OSDMap,
             loopback ports, the daemon mains), and mgr and mds daemons

Device rule: entry points run on `cuda` unless the caller passes
`device="cpu"`; asking for `cuda` where none is present raises.
"""

__version__ = "0.1.0"
