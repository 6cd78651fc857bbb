"""Common runtime copied from ceph_tpu/common (framework-free):

  encoding      — denc-lite versioned encoders (OSDMap and Incremental bytes)
  hash          — ceph_str_hash_rjenkins (object name -> ps)
  config        — typed option schema + layered resolution
  perf_counters — PerfCounters blocks with perf-dump JSON
  crc, log, tracer, admin — crc32c, dout logs, spans, the admin hub
  kv            — MemDB/FileDB key-value stores and their transactions
  op_queue      — WPQ and mclock op queues; watchdog — shared deadlines
  faults        — seeded wire-fault schedules; compressor — the registry
"""
