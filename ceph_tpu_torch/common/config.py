"""Typed config schema + layered resolution — the reference's option system.

Re-expresses src/common/options.cc (1535 `Option(...)` schema
entries with type/level/default/min-max/description/see_also) and
config_proxy.h/config_obs.h:

  * `Option` — one typed schema entry (TYPE_*, LEVEL_basic/advanced/dev,
    default, optional min/max, description, see_also);
  * `SCHEMA` — the framework's option inventory: every knob a subsystem
    actually reads lives here, so `config show` is the source of truth
    (the reference's EC/CRUSH/injection-relevant entries are mirrored by
    name: erasure_code_dir options.cc:533, osd_erasure_code_plugins 2519,
    osd_pool_default_erasure_code_profile, ms_inject_* 1044-1066,
    heartbeat_inject_failure 822);
  * `Config` — layered resolution: compiled default < config file values <
    environment (CEPH_TPU_<NAME>) < runtime `set` (mon/admin-socket tier);
    typed parsing + range validation on every write;
  * observers — `md_config_obs_t`-style callbacks fired on runtime changes
    (config_obs.h), keyed by option name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

TYPE_UINT = "uint"
TYPE_INT = "int"
TYPE_STR = "str"
TYPE_FLOAT = "float"
TYPE_BOOL = "bool"

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"


class ConfigError(ValueError):
    pass


@dataclass(frozen=True)
class Option:
    name: str
    type: str
    level: str
    default: Any
    description: str = ""
    min: float | None = None
    max: float | None = None
    see_also: tuple[str, ...] = ()

    def parse(self, value: Any) -> Any:
        try:
            if self.type == TYPE_BOOL:
                if isinstance(value, str):
                    if value.lower() in ("true", "1", "yes", "on"):
                        return True
                    if value.lower() in ("false", "0", "no", "off"):
                        return False
                    raise ConfigError(f"{self.name}: bad bool {value!r}")
                return bool(value)
            if self.type in (TYPE_UINT, TYPE_INT):
                v = int(value)
                if self.type == TYPE_UINT and v < 0:
                    raise ConfigError(f"{self.name}: must be >= 0")
            elif self.type == TYPE_FLOAT:
                v = float(value)
            else:
                return str(value)
        except (TypeError, ValueError) as e:
            raise ConfigError(f"{self.name}: {e}") from None
        if self.min is not None and v < self.min:
            raise ConfigError(f"{self.name}: {v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise ConfigError(f"{self.name}: {v} > max {self.max}")
        return v


def _opt(name, type_, level, default, desc="", **kw):
    return Option(name, type_, level, default, desc, **kw)


#: the option inventory (names shared with the reference where the concept
#: maps 1:1, so operators can carry their mental model over)
SCHEMA: dict[str, Option] = {
    o.name: o
    for o in [
        # erasure code (options.cc:533, 2519)
        # declared-but-dead on purpose: the reference dlopen()s plugins
        # from this dir; ours are python imports
        # cephlint: disable=knob-registry
        _opt("erasure_code_dir", TYPE_STR, LEVEL_ADVANCED, "",
             "unused placeholder: plugins are python entry points here"),
        _opt("osd_erasure_code_plugins", TYPE_STR, LEVEL_ADVANCED,
             "jerasure isa lrc shec clay tpu",
             "plugins allowed in profiles"),
        _opt("osd_pool_default_erasure_code_profile", TYPE_STR,
             LEVEL_ADVANCED,
             "plugin=tpu technique=isa_cauchy k=8 m=3",
             "default EC profile for new pools"),
        # placement / mapping
        # cephlint: disable=knob-registry (kept so the schema equals the reference's; its one reader there is jax_mapper's chunking, and the port's map_rule launches at the exact width)
        _opt("crush_chunk_size", TYPE_UINT, LEVEL_DEV, 0,
             "x-batch cap (pow2) per device launch in the vectorized "
             "mapper; 0 = backend default (2^18 on TPU, 2^16 on CPU)"),
        # fault injection (options.cc:1044-1066, 822)
        _opt("ms_compress_mode", TYPE_STR, LEVEL_ADVANCED, "none",
             "on-wire frame compression codec (none|zlib|snappy-like "
             "names from the compressor registry) — msgr2 compression"),
        _opt("ms_compress_min_size", TYPE_UINT, LEVEL_ADVANCED, 4096,
             "frames below this size are never compressed"),
        # wire fast path (the msgr2 frames_v2 / AsyncConnection
        # write-coalescing analogues)
        _opt("ms_envelope_format", TYPE_STR, LEVEL_ADVANCED, "binary",
             "op envelope encoding on feature-negotiated sessions "
             "(binary = denc-lite structs + raw as its own frame "
             "segment; json = the legacy text envelopes). Peers without "
             "the feature bit always get json regardless"),
        _opt("ms_cork_max_frames", TYPE_UINT, LEVEL_ADVANCED, 64,
             "max frames drained from the send queue per write wakeup; "
             "a corked run goes out as ONE socket write + drain (and one "
             "signed batch frame when the peer negotiated it). 1 = one "
             "write+drain per frame, the uncorked legacy behavior",
             min=1),
        _opt("ms_local_stack", TYPE_BOOL, LEVEL_ADVANCED, True,
             "negotiate the LocalStack (Unix socket + shared-memory "
             "ring) for co-located peers that advertise a uds:// "
             "endpoint; false pins every session to TCP, bit-identical "
             "to the pre-stack wire behavior"),
        _opt("ms_shm_ring_bytes", TYPE_UINT, LEVEL_ADVANCED, 8 << 20,
             "per-direction shared-memory ring capacity for upgraded "
             "local sessions; values below 16KiB disable the ring (the "
             "session stays on the Unix socket)"),
        _opt("ms_uds_dir", TYPE_STR, LEVEL_ADVANCED, "",
             "directory for messenger Unix sockets and ring files; "
             "empty = a per-process tmp dir. AF_UNIX caps socket paths "
             "at ~100 bytes, so keep it shallow"),
        _opt("ms_subop_batch", TYPE_BOOL, LEVEL_ADVANCED, True,
             "coalesce same-peer sub-ops issued within one event-loop "
             "tick into a single multi-op frame with a batched reply "
             "(the EncodeService kernel-launch coalescing shape, applied "
             "to the fan-out wire path)"),
        _opt("ms_inject_socket_failures", TYPE_UINT, LEVEL_DEV, 0,
             "inject a transient store failure every Nth op"),
        _opt("ms_inject_delay_probability", TYPE_FLOAT, LEVEL_DEV, 0.0,
             "probability of injecting a delay per op", min=0.0, max=1.0),
        _opt("ms_inject_delay_max", TYPE_FLOAT, LEVEL_DEV, 1.0,
             "max injected delay (seconds)"),
        _opt("ms_inject_internal_delays", TYPE_FLOAT, LEVEL_DEV, 0.0,
             "inject internal delays to induce races (seconds)"),
        # wire chaos schedules (common/faults.py): scripted per-peer
        # fault streams, seeded so a run replays bit-identically
        _opt("ms_inject_chaos_schedule", TYPE_STR, LEVEL_DEV, "",
             "';'-separated wire-fault rules applied per outgoing "
             "frame run: drop:SRC>DST[:prob], "
             "delay:SRC>DST[:prob[:max_s]], dup:SRC>DST[:prob], "
             "partition:A|B (both ways) or partition:A>B (one-way "
             "— DST still reaches SRC). SRC/DST are comma-separated "
             "entity-name globs (osd.1, osd.*, *). Empty disarms; "
             "armed or not, the hook is one cached attribute check "
             "per corked run",
             see_also=("ms_inject_chaos_seed",)),
        _opt("ms_inject_chaos_seed", TYPE_UINT, LEVEL_DEV, 0,
             "seed for the chaos schedule's per-(src,dst) decision "
             "streams: same seed + schedule -> the same fault "
             "sequence per peer pair, independent of global timing"),
        _opt("heartbeat_inject_failure", TYPE_UINT, LEVEL_DEV, 0,
             "inject heartbeat failures for N seconds"),
        _opt("objecter_inject_no_watch_ping", TYPE_BOOL, LEVEL_DEV, False,
             "suppress watch pings"),
        # device-fault injection (the filestore_debug_inject_read_err /
        # bluestore debug-omit family): 1-in-N rates per device IO; 0
        # disables and the hook costs one cached flag check per site
        _opt("blockstore_inject_read_eio", TYPE_UINT, LEVEL_DEV, 0,
             "raise EIO on 1-in-N BlockStore device/payload reads "
             "(self-healing read path exercise); 0 disables",
             see_also=("blockstore_inject_write_eio",)),
        _opt("blockstore_inject_write_eio", TYPE_UINT, LEVEL_DEV, 0,
             "fail 1-in-N BlockStore device writes; a write error FENCES "
             "the store (fail-stop: no further acks); 0 disables"),
        _opt("blockstore_inject_fsync_fail", TYPE_UINT, LEVEL_DEV, 0,
             "fail 1-in-N BlockStore device fsyncs; an fsync error FENCES "
             "the store — never retried-and-forgotten (Rebello et al., "
             "ATC '20); 0 disables"),
        # data path
        _opt("osd_pool_default_size", TYPE_UINT, LEVEL_BASIC, 3,
             "replicas per replicated pool"),
        _opt("osd_pool_default_pg_num", TYPE_UINT, LEVEL_BASIC, 32,
             "PGs per new pool"),
        # cephlint: disable=knob-registry (kept so the schema equals the reference's, which reads it nowhere either; osd_recovery_batch_max bounds recovery)
        _opt("osd_recovery_max_active", TYPE_UINT, LEVEL_ADVANCED, 3,
             "concurrent recovery ops per OSD"),
        _opt("osd_op_queue", TYPE_STR, LEVEL_ADVANCED, "wpq",
             "op scheduler inside each OSD op shard: wpq | mclock"),
        _opt("osd_statfs_total_bytes", TYPE_UINT, LEVEL_ADVANCED,
             1 << 34,
             "advertised store capacity per OSD (the role of the real "
             "disk size BlueStore reads; configurable so tests can fill "
             "a tiny OSD to the full ratios)"),
        _opt("osd_statfs_cache_sec", TYPE_FLOAT, LEVEL_ADVANCED, 0.5,
             "seconds a statfs scan stays cached (the used-bytes scan "
             "is O(kv rows)); 0 recomputes every call, which tier-1 "
             "full/nearfull tests use instead of sleeping the TTL out",
             min=0.0),
        _opt("mon_osd_nearfull_ratio", TYPE_FLOAT, LEVEL_BASIC, 0.85,
             "usage ratio above which an OSD is NEARFULL "
             "(OSDMonitor.cc:365)"),
        _opt("mon_osd_backfillfull_ratio", TYPE_FLOAT, LEVEL_BASIC, 0.90,
             "usage ratio above which an OSD refuses to be a backfill "
             "target"),
        _opt("mon_osd_full_ratio", TYPE_FLOAT, LEVEL_BASIC, 0.95,
             "usage ratio above which client writes are refused with "
             "ENOSPC (deletes still allowed)"),
        _opt("osd_objectstore", TYPE_STR, LEVEL_BASIC, "kstore-file",
             "backing store a daemon-main OSD boots with: kstore-file "
             "(crash-safe WAL FileDB, the default) | memstore "
             "(reference vstart.sh --memstore analogue for benching) | "
             "blockstore (allocator + block file + at-rest crc32c, "
             "the BlueStore analogue)"),
        # blockstore (the bluestore_* option family, options.cc:4252+)
        _opt("blockstore_min_alloc_size", TYPE_UINT, LEVEL_ADVANCED, 4096,
             "allocation granularity of the block file; writes below it "
             "take the deferred (KV WAL) path — bluestore_min_alloc_size",
             min=512),
        _opt("blockstore_csum_block_size", TYPE_UINT, LEVEL_ADVANCED,
             4096,
             "bytes covered by one stored crc32c "
             "(bluestore_csum_* block granularity)", min=512),
        _opt("blockstore_compression_mode", TYPE_STR, LEVEL_ADVANCED,
             "none",
             "compression-on-write policy: none | passive | aggressive "
             "| force (Compressor.h modes)",
             see_also=("blockstore_compression_algorithm",)),
        _opt("blockstore_compression_algorithm", TYPE_STR,
             LEVEL_ADVANCED, "zlib",
             "codec from the compressor registry used when "
             "blockstore_compression_mode compresses"),
        _opt("blockstore_compression_min_blob_size", TYPE_UINT,
             LEVEL_ADVANCED, 4096,
             "blobs below this size never attempt compression"),
        _opt("blockstore_deferred_batch_bytes", TYPE_UINT,
             LEVEL_ADVANCED, 65536,
             "deferred-write backlog that triggers a flush to the block "
             "file (bluestore deferred_batch role)"),
        _opt("blockstore_deferred_max_age_ms", TYPE_UINT,
             LEVEL_ADVANCED, 500,
             "oldest deferred write may sit in the KV WAL this long "
             "before the background flusher drains the backlog to the "
             "device, independent of byte pressure; 0 disables the "
             "flusher (byte-threshold-only, the PR-1 behavior)",
             see_also=("blockstore_deferred_batch_bytes",)),
        _opt("blockstore_onode_cache_size", TYPE_UINT, LEVEL_ADVANCED,
             1024,
             "decoded onodes (extent map + csums) kept in an LRU so hot "
             "objects skip the KV fetch + decode "
             "(bluestore_onode_cache_size role); 0 disables"),
        _opt("blockstore_buffer_cache_bytes", TYPE_UINT, LEVEL_ADVANCED,
             32 << 20,
             "bytes of recently read/written object data kept in a "
             "write-through LRU so re-reads skip the device and the "
             "checksum re-verify (bluestore buffer cache role); 0 "
             "disables — fsck, deep scrub, and read_verify always read "
             "device truth regardless"),
        _opt("blockstore_block_path", TYPE_STR, LEVEL_ADVANCED, "",
             "explicit block file path; empty = <kv dir>/block beside a "
             "FileDB, or an in-memory device over MemDB"),
        _opt("blockstore_block_size", TYPE_UINT, LEVEL_ADVANCED, 0,
             "hard cap on the block file size (the fixed-disk role): "
             "allocation beyond it fails cleanly with ENOSPC — never "
             "EIO, never a fence — and frees make the store writable "
             "again; 0 = grow-on-demand (unbounded)"),
        _opt("osd_min_pg_log_entries", TYPE_UINT, LEVEL_ADVANCED, 500,
             "log entries retained per PG; peers further behind than "
             "this take a full backfill instead of log recovery"),
        _opt("osd_max_backfills", TYPE_UINT, LEVEL_ADVANCED, 1,
             "concurrent backfills one OSD will source (reservations)"),
        _opt("osd_recovery_batch_max", TYPE_UINT, LEVEL_ADVANCED, 16,
             "objects pulled/pushed per recovery batch: the batch's "
             "sub-ops coalesce into subop_batch frames and its "
             "concurrent EC shard rebuilds coalesce into one batched "
             "decode launch; 1 restores one-object-at-a-time healing",
             min=1, see_also=("osd_max_backfills",)),
        _opt("osd_mon_report_interval", TYPE_FLOAT, LEVEL_ADVANCED, 2.0,
             "seconds between PG stats reports to the mon (health "
             "checks aggregate these)"),
        _opt("auth_service_ticket_ttl", TYPE_FLOAT, LEVEL_ADVANCED,
             3600.0,
             "cephx service ticket lifetime; clients renew at half-life"),
        _opt("mgr_beacon_interval", TYPE_FLOAT, LEVEL_ADVANCED, 0.5,
             "seconds between mgr liveness beacons to the mon "
             "(MgrMonitor beacon cadence)"),
        _opt("mgr_beacon_grace", TYPE_FLOAT, LEVEL_ADVANCED, 3.0,
             "silence after which the active mgr is considered dead "
             "and a standby promotes"),
        _opt("mgr_report_interval", TYPE_FLOAT, LEVEL_ADVANCED, 1.0,
             "seconds between perf-counter delta reports from each "
             "daemon to the active mgr (MgrClient report cadence)"),
        _opt("mgr_metrics_window", TYPE_UINT, LEVEL_ADVANCED, 120,
             "samples retained per counter in the mgr's per-daemon "
             "ring time-series (bounds memory; rates/percentiles are "
             "computed over this window)"),
        _opt("mgr_slo_rules", TYPE_STR, LEVEL_ADVANCED, "",
             "semicolon-separated SLO rules evaluated by the mgr "
             "metrics module, e.g. 'op_latency.p99 < 2s @ 30; "
             "read_redirected/read_balanced < 0.05'; violations "
             "surface as MGR_SLO_VIOLATION health checks"),
        _opt("mgr_recovery_slow_warn", TYPE_FLOAT, LEVEL_ADVANCED, 1.0,
             "objects/s below which the mgr raises RECOVERY_SLOW while "
             "any OSD reports degraded objects; 0 disables the check"),
        _opt("mgr_trace_store_max", TYPE_UINT, LEVEL_ADVANCED, 256,
             "promoted traces the mgr trace collector retains "
             "(oldest-first eviction; `ceph trace ls|show` serves from "
             "this bounded store)", min=1),
        _opt("mgr_trace_ttl", TYPE_FLOAT, LEVEL_ADVANCED, 600.0,
             "seconds a promoted trace stays in the mgr collector "
             "before aging out; 0 keeps traces until evicted by "
             "mgr_trace_store_max", min=0.0),
        _opt("mgr_prometheus_exemplars", TYPE_BOOL, LEVEL_ADVANCED,
             False,
             "attach OpenMetrics exemplars ({trace_id=...}) to latency "
             "histogram buckets and serve /metrics as "
             "application/openmetrics-text"),
        _opt("mds_beacon_interval", TYPE_FLOAT, LEVEL_ADVANCED, 0.5,
             "seconds between MDS beacons to the mon"),
        _opt("mds_max_active", TYPE_UINT, LEVEL_BASIC, 1,
             "active metadata daemons (FSMap max_mds): ranks partition "
             "the namespace by top-level directory hash"),
        _opt("mds_bal_split_size", TYPE_UINT, LEVEL_ADVANCED, 10000,
             "dentries in one directory fragment before the MDS splits "
             "it (CDir fragmentation, mds_bal_split_size)"),
        _opt("mds_blocklist_expire", TYPE_FLOAT, LEVEL_ADVANCED, 3600.0,
             "seconds an MDS-evicted client stays blocklisted in the "
             "OSDMap (mds_session_blacklist_on_evict + "
             "mon_osd_blacklist_default_expire)"),
        _opt("mds_beacon_grace", TYPE_FLOAT, LEVEL_ADVANCED, 3.0,
             "beacon silence before the mon fails the active MDS over"),
        _opt("osd_ec_batch_window", TYPE_FLOAT, LEVEL_ADVANCED, 0.002,
             "seconds the first EC op of a batch waits so concurrent "
             "objects share one planar device launch"),
        _opt("osd_heartbeat_grace", TYPE_UINT, LEVEL_ADVANCED, 20,
             "seconds before an unresponsive OSD is reported down"),
        _opt("osd_heartbeat_interval", TYPE_FLOAT, LEVEL_ADVANCED, 6.0,
             "seconds between peer pings"),
        # monitor (mon_lease: Paxos.cc lease_interval; the election timeout
        # plays Elector.cc's plugged election_timeout role)
        _opt("mon_lease", TYPE_FLOAT, LEVEL_ADVANCED, 5.0,
             "leader lease renewal interval (seconds)"),
        _opt("mon_lease_ack_timeout_factor", TYPE_FLOAT, LEVEL_ADVANCED,
             4.0, "lease multiples a peon waits before calling an election"),
        _opt("mon_election_timeout", TYPE_FLOAT, LEVEL_ADVANCED, 5.0,
             "seconds an election proposal waits for a quorum"),
        _opt("mon_osd_min_down_reporters", TYPE_UINT, LEVEL_ADVANCED, 2,
             "distinct reporters required to mark an OSD down (the "
             "reference's default; one stalled reporter must not be able "
             "to down a healthy daemon)"),
        # distributed tracing (src/common/tracer: jaeger_tracing_enable
        # and friends; see ceph_tpu.common.tracer)
        _opt("tracer_enabled", TYPE_BOOL, LEVEL_ADVANCED, False,
             "emit Dapper-style spans for sampled ops "
             "(jaeger_tracing_enable role); disabled cost is one cached "
             "flag check per span site",
             see_also=("tracer_sample_rate", "tracer_export_path")),
        _opt("tracer_sample_rate", TYPE_FLOAT, LEVEL_ADVANCED, 1.0,
             "fraction of root ops that start a trace; children follow "
             "the root's decision", min=0.0, max=1.0),
        _opt("tracer_ring_size", TYPE_UINT, LEVEL_ADVANCED, 1024,
             "completed spans retained per daemon for `dump_tracing`",
             min=1),
        # per-op-type sample-rate overrides: recovery reads can be traced
        # at 100% while steady-state IO stays sampled; -1 inherits the
        # base tracer_sample_rate
        *[
            _opt(f"tracer_sample_rate_{t}", TYPE_FLOAT, LEVEL_ADVANCED,
                 -1.0,
                 f"sample-rate override for {t!r} root ops; -1 inherits "
                 "tracer_sample_rate", min=-1.0, max=1.0,
                 see_also=("tracer_sample_rate",))
            for t in ("read", "write", "ops", "delete", "call", "stat",
                      "recovery", "command", "balancer")
        ],
        _opt("tracer_export_path", TYPE_STR, LEVEL_ADVANCED, "",
             "append finished spans as Jaeger-compatible JSONL here "
             "(tools/trace_tool.py renders trace trees from it); empty "
             "disables export"),
        # tail sampling (the flight recorder: Canopy-style keep/drop at
        # op COMPLETION instead of at op start; see common/tracer.py)
        _opt("tracer_flight_ring_size", TYPE_UINT, LEVEL_ADVANCED, 2048,
             "completed spans retained in the always-on flight ring "
             "(recorded for EVERY op regardless of sample rate; the "
             "tail keep/drop decision and the crash black-box read "
             "from here)", min=1,
             see_also=("tracer_tail_slow_ms",)),
        _opt("tracer_tail_slow_ms", TYPE_FLOAT, LEVEL_ADVANCED, 1000.0,
             "promote a trace at completion when its root span took "
             "longer than this many milliseconds; 0 disables the "
             "slow-duration predicate", min=0.0),
        _opt("tracer_tail_top_n", TYPE_UINT, LEVEL_ADVANCED, 0,
             "also promote the N slowest root spans per "
             "tracer_tail_window_s window even when none crossed "
             "tracer_tail_slow_ms; 0 disables slowest-N promotion"),
        _opt("tracer_tail_window_s", TYPE_FLOAT, LEVEL_ADVANCED, 10.0,
             "window length for slowest-N and SLO-capture promotion "
             "budgets", min=0.1),
        _opt("tracer_tail_errors", TYPE_BOOL, LEVEL_ADVANCED, True,
             "promote every trace whose root span carries an error, "
             "retry, or redirect tag (EIO/resend/abort: the ops an "
             "operator always wants the trace for)"),
        _opt("tracer_tail_capture_per_window", TYPE_UINT,
             LEVEL_ADVANCED, 2,
             "per-predicate promotion budget per window for mgr-pushed "
             "SLO capture predicates (bounds trace volume while a rule "
             "is in violation)", min=1),
        _opt("tracer_crash_dump_dir", TYPE_STR, LEVEL_ADVANCED, "",
             "directory for the crash black-box: on StoreFatalError/"
             "fence the daemon dumps its flight ring, in-flight ops and "
             "recent log lines to <dir>/<daemon>.blackbox.json and "
             "clogs the pointer; empty disables the dump"),
        _opt("slow_op_seconds", TYPE_FLOAT, LEVEL_ADVANCED, 30.0,
             "in-flight op age that triggers an immediate `slow "
             "request` warning line (osd_op_complaint_time role)",
             min=0.0),
        _opt("osd_scrub_auto_repair", TYPE_BOOL, LEVEL_ADVANCED, False,
             "deep scrub that finds a repairable inconsistency "
             "(digest mismatch, read EIO, missing hinfo) kicks off the "
             "primary-driven repair in place instead of only flagging "
             "it (the reference's osd_scrub_auto_repair)"),
        _opt("mon_cluster_log_entries", TYPE_UINT, LEVEL_ADVANCED, 1000,
             "cluster-log lines the mon leader retains for "
             "`log last <n>` (LogMonitor summary role)", min=1),
        # scale-out read path (the reference's Octopus balanced reads:
        # osd_read_from_replica / CEPH_OSD_FLAG_BALANCE_READS)
        _opt("rados_read_policy", TYPE_STR, LEVEL_ADVANCED, "primary",
             "client read-target policy: 'primary' sends every read to "
             "the PG primary (classic path); 'balance' spreads reads "
             "round-robin over all clean acting members; 'localize' "
             "prefers an acting member colocated on this host (its "
             "LocalStack uds endpoint exists locally), falling back to "
             "balance. A non-primary target only serves a read when its "
             "copy is provably current — anything else bounces back to "
             "the primary with a redirect, never wrong data",
             see_also=("rados_ec_direct_reads",)),
        _opt("rados_ec_direct_reads", TYPE_BOOL, LEVEL_ADVANCED, True,
             "with a non-primary rados_read_policy on an EC pool whose "
             "acting set is whole, compute the stripe layout client-side "
             "and read the k data shards directly from their home OSDs "
             "in parallel (no primary gather, no decode launch); any "
             "shard error, stale shard, or degraded interval falls back "
             "to the primary decode path",
             see_also=("rados_read_policy",)),
        _opt("rados_backfill_hint_ttl", TYPE_FLOAT, LEVEL_ADVANCED, 10.0,
             "seconds the objecter trusts a redirect reply's backfill "
             "hint and steers balanced reads past the named backfill "
             "targets; after expiry the next read probes the target "
             "again (one redirect round-trip) to learn whether the "
             "backfill drained", min=0.0,
             see_also=("rados_read_policy",)),
        # checkpoint store (ceph_tpu.ckpt: Orbax/TensorStore-style
        # manifest + chunk layout over RADOS)
        _opt("ckpt_chunk_target_bytes", TYPE_UINT, LEVEL_ADVANCED,
             1 << 20,
             "target chunk-object size for checkpoint saves; rounded "
             "up to a full EC stripe so chunk puts never read-modify-"
             "write", min=4096),
        _opt("ckpt_max_inflight", TYPE_UINT, LEVEL_ADVANCED, 8,
             "bounded window of concurrent chunk puts/gets per "
             "checkpoint save/restore", min=1),
        _opt("ckpt_compression_algorithm", TYPE_STR, LEVEL_ADVANCED, "",
             "compress checkpoint chunks with this algorithm "
             "(zlib|lzma|zstd); empty disables compression"),
        _opt("ckpt_incremental", TYPE_BOOL, LEVEL_ADVANCED, True,
             "diff each save against the previous committed manifest "
             "by chunk content fingerprint and reference unchanged "
             "chunks from the prior save instead of re-uploading them "
             "(CheckFreq-style incremental checkpointing)"),
        _opt("ckpt_async_max_pending", TYPE_UINT, LEVEL_ADVANCED, 2,
             "save_async() backpressure: at most this many snapshots "
             "may be persisting in the background; a further submit "
             "blocks until the oldest completes, so a slow cluster "
             "throttles the training loop instead of accumulating "
             "host-memory snapshots", min=1),
        _opt("ckpt_restore_readahead", TYPE_UINT, LEVEL_ADVANCED, 0,
             "bounded readahead window of in-flight chunk reads during "
             "restore (decompress/crc/placement overlap with the reads "
             "still in flight); 0 inherits ckpt_max_inflight"),
        _opt("ckpt_gc_keep_last", TYPE_UINT, LEVEL_ADVANCED, 1,
             "gc retention: keep the newest N committed saves (HEAD is "
             "always kept); chunks stay live while ANY retained "
             "manifest references them", min=1),
        _opt("ckpt_gc_keep_every_nth", TYPE_UINT, LEVEL_ADVANCED, 0,
             "gc retention: additionally keep every Nth committed save "
             "from the name's commit history (0 disables)"),
        # dataset store (ceph_tpu.data: record-sharded training-data
        # ingestion + prefetching iterator over RADOS)
        _opt("data_shard_bytes", TYPE_UINT, LEVEL_ADVANCED, 4 << 20,
             "target shard-object size for dataset ingests; each shard's "
             "striper sub-objects are rounded up to a full EC stripe so "
             "shard puts never read-modify-write", min=4096),
        _opt("data_compression_algorithm", TYPE_STR, LEVEL_ADVANCED, "",
             "compress dataset records with this algorithm "
             "(zlib|lzma|zstd); empty disables compression"),
        _opt("data_max_inflight", TYPE_UINT, LEVEL_ADVANCED, 8,
             "bounded window of concurrent shard/index puts per dataset "
             "ingest", min=1),
        _opt("data_prefetch_batches", TYPE_UINT, LEVEL_ADVANCED, 2,
             "background batch-prefetch depth of the dataset iterator: "
             "this many upcoming batches may have their ranged shard "
             "reads in flight while the training step consumes the "
             "current one; 0 disables prefetch (serial fetch-on-demand)"),
        _opt("data_cache_bytes", TYPE_UINT, LEVEL_ADVANCED, 64 << 20,
             "client-side block cache of the prefetching dataset "
             "iterator: readahead fetches whole striper sub-objects "
             "(one EC decode per block at the OSD, amortized over every "
             "record inside) and keeps up to this many bytes LRU-"
             "resident; 0 falls back to exact per-record ranged reads"),
        _opt("osd_mclock_data_weight", TYPE_FLOAT, LEVEL_ADVANCED, 0.25,
             "mclock weight of the background data-prefetch client "
             "class (op_queue.QOS_DATA_PREFETCH): bulk dataset reads get "
             "this proportional share against weight-1 foreground "
             "clients, so prefetch cannot starve ckpt/RBD traffic",
             min=0.01),
        _opt("osd_mclock_recovery_weight", TYPE_FLOAT, LEVEL_ADVANCED,
             0.25,
             "mclock weight of the recovery class "
             "(op_queue.QOS_RECOVERY): recovery pulls/rebuild reads/"
             "batched pushes get this proportional share against "
             "weight-1 client classes — a recovery storm cannot starve "
             "client ops", min=0.01,
             see_also=("osd_mclock_recovery_reservation",)),
        _opt("osd_mclock_recovery_reservation", TYPE_FLOAT,
             LEVEL_ADVANCED, 10.0,
             "mclock reservation floor (ops/s) for the recovery class: "
             "sustained client load squeezes healing down to this "
             "minimum but never to zero (dmclock phase-1)", min=0.0),
        # coordination (ceph_tpu.coord: cls_lock leases, leader election,
        # fleet roster/barriers for multi-host training)
        _opt("cls_clock_offset", TYPE_FLOAT, LEVEL_DEV, 0.0,
             "seconds added to the primary's clock when stamping "
             "MethodContext.now for object-class calls; lets tests "
             "advance lease time deterministically without sleeping"),
        _opt("coord_lease", TYPE_FLOAT, LEVEL_ADVANCED, 5.0,
             "lease duration (seconds) for coordination locks: fleet "
             "member heartbeats, leader election, and the checkpoint "
             "committer lock; an expired lease makes the lock breakable "
             "by survivors", min=0.1),
        _opt("coord_renew_factor", TYPE_FLOAT, LEVEL_ADVANCED, 0.34,
             "a Lock's renew loop re-locks every coord_lease * this "
             "fraction, so a holder survives a couple of missed renewals "
             "before its lease lapses", min=0.05, max=0.9),
        _opt("coord_barrier_poll", TYPE_FLOAT, LEVEL_ADVANCED, 1.0,
             "fallback poll interval (seconds) for barrier/lock waiters; "
             "watch/notify wakeups make this the slow path, only taken "
             "when a notify is lost to a primary change", min=0.01),
        # balancer / placement simulator (ceph_tpu.crush.balance,
        # ceph_tpu.sim, tools/psim.py; reference mgr/balancer options)
        _opt("balancer_max_deviation", TYPE_FLOAT, LEVEL_ADVANCED, 1.0,
             "PG-count deviation from the weight-proportional target "
             "every OSD must reach before a balancer pass stops "
             "(upmap_max_deviation role)", min=0.0,
             see_also=("balancer_max_changes", "balancer_mode")),
        _opt("balancer_max_changes", TYPE_UINT, LEVEL_ADVANCED, 256,
             "pg_upmap_items budget per balancer tick; the batched move "
             "scorer makes hundreds per tick affordable "
             "(upmap_max_optimizations role)", min=1),
        _opt("balancer_mode", TYPE_STR, LEVEL_ADVANCED, "upmap",
             "balancer optimization mode: upmap (per-PG exception "
             "table) or crush-compat (choose_args weight-set feedback "
             "that pre-upmap clients honor)"),
        _opt("psim_default_osds", TYPE_UINT, LEVEL_DEV, 1024,
             "cluster size tools/psim.py builds when --osds is not "
             "given", min=1),
        _opt("psim_default_seed", TYPE_UINT, LEVEL_DEV, 1,
             "event-script RNG seed tools/psim.py uses when --seed is "
             "not given"),
        _opt("psim_bytes_per_pg", TYPE_UINT, LEVEL_DEV, 8 << 30,
             "assumed bytes stored per PG for psim's backfill-storm "
             "estimate (PGs moved x this = data moved per epoch)",
             min=1),
        # bench / profiling
        # cephlint: disable=knob-registry (kept so the schema equals the reference's; read by the profile hook that comes with the port's bench, not written yet)
        _opt("bench_profile_trace_dir", TYPE_STR, LEVEL_DEV, "",
             "write jax.profiler traces here when set",
             see_also=("bench_profile",)),
        # cephlint: disable=knob-registry (as bench_profile_trace_dir above)
        _opt("bench_profile", TYPE_BOOL, LEVEL_DEV, False,
             "capture a jax.profiler trace around benchmark loops"),
        # dout subsystem levels (src/common/subsys.h-style "1/5" defaults:
        # emitted at the configured level, ring-gathered up to 5; see
        # ceph_tpu.common.log)
        *[
            _opt(f"debug_{subsys}", TYPE_INT, LEVEL_ADVANCED, 1,
                 f"emitted debug level for the {subsys} subsystem")
            for subsys in ("osd", "crush", "ec", "rados", "bench")
        ],
    ]
}


class Config:
    """Layered, observed, typed configuration (config_proxy.h analogue)."""

    ENV_PREFIX = "CEPH_TPU_"

    def __init__(self, schema: dict[str, Option] | None = None):
        self.schema = schema if schema is not None else SCHEMA
        self._file: dict[str, Any] = {}
        #: mon centralized-config tier (ConfigMonitor): below the local
        #: conf file, above compiled defaults — local settings win
        self._mon: dict[str, Any] = {}
        self._runtime: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}

    # -- reads --------------------------------------------------------------

    def _opt(self, name: str) -> Option:
        opt = self.schema.get(name)
        if opt is None:
            raise ConfigError(f"unknown option {name!r}")
        return opt

    def get(self, name: str) -> Any:
        opt = self._opt(name)
        if name in self._runtime:
            return self._runtime[name]
        env = os.environ.get(self.ENV_PREFIX + name.upper())
        if env is not None:
            return opt.parse(env)
        if name in self._file:
            return self._file[name]
        if name in self._mon:
            return self._mon[name]
        return opt.default

    def source_of(self, name: str) -> str:
        self._opt(name)
        if name in self._runtime:
            return "override"
        if os.environ.get(self.ENV_PREFIX + name.upper()) is not None:
            return "env"
        if name in self._file:
            return "file"
        if name in self._mon:
            return "mon"
        return "default"

    # -- writes -------------------------------------------------------------

    def set(self, name: str, value: Any) -> None:
        """Runtime override (the mon/injectargs tier); fires observers."""
        opt = self._opt(name)
        self._runtime[name] = opt.parse(value)
        for cb in self._observers.get(name, []):
            cb(name, self._runtime[name])

    def rm(self, name: str) -> None:
        self._opt(name)
        self._runtime.pop(name, None)

    def load_file_values(self, values: dict[str, Any]) -> None:
        """Conf-file tier (between defaults and env)."""
        for name, value in values.items():
            self._file[name] = self._opt(name).parse(value)

    def apply_mon_values(self, values: dict[str, Any]) -> None:
        """Replace the mon centralized-config tier (MonClient applies the
        committed config map); observers fire for keys whose EFFECTIVE
        value changed."""
        before = {
            name: self.get(name)
            for name in set(self._mon) | set(values)
            if name in self.schema
        }
        self._mon = {
            name: self._opt(name).parse(v)
            for name, v in values.items()
            if name in self.schema
        }
        for name, old in before.items():
            new = self.get(name)
            if new != old:
                for cb in self._observers.get(name, []):
                    cb(name, new)

    def observe(self, name: str, cb: Callable[[str, Any], None]) -> None:
        self._opt(name)
        self._observers.setdefault(name, []).append(cb)

    # -- dumps --------------------------------------------------------------

    def show(self) -> dict[str, Any]:
        """`config show`: effective value + source per option."""
        return {
            name: {"value": self.get(name), "source": self.source_of(name)}
            for name in sorted(self.schema)
        }

    def dump_schema(self) -> dict[str, Any]:
        return {
            name: {
                "type": o.type,
                "level": o.level,
                "default": o.default,
                "description": o.description,
                **({"min": o.min} if o.min is not None else {}),
                **({"max": o.max} if o.max is not None else {}),
                **({"see_also": list(o.see_also)} if o.see_also else {}),
            }
            for name, o in sorted(self.schema.items())
        }


#: process-wide config, like the CephContext-owned ConfigProxy
config = Config()
