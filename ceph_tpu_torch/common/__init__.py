"""Common runtime copied from ceph_tpu/common (framework-free):

  encoding      — denc-lite versioned encoders (OSDMap and Incremental bytes)
  hash          — ceph_str_hash_rjenkins (object name -> ps)
  config        — typed option schema + layered resolution (psim_* and
                  balancer_* defaults)
  perf_counters — PerfCounters blocks with perf-dump JSON
"""
