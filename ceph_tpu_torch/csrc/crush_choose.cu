// crush_choose.cu — one CRUSH choose stage over straw2 buckets, per x, on Hopper.
//
// Replaces the XLA choose stages of ceph_tpu/crush/jax_mapper.py
// (_choose_firstn_static :952, _choose_firstn_dynamic :1164,
// _choose_indep_b :1226, driven by map_rule :1472). The TPU form evaluates
// the batch in lockstep: every lane pays for every retry any lane needs, and
// a one-hot matmul stands in for the log-table gather. On this card each
// thread runs the reference's own per-x loop (mapper.c crush_choose_firstn
// :460 and crush_choose_indep :655, as ceph_tpu_torch/crush/mapper.py
// re-expresses them), so a lane retries only when it needs to, and the two
// log tables (4 KB of int64) sit in shared memory.
//
// Bound: integer operations. One straw2 draw is an rjenkins hash (five
// 9-step mixes), a table-driven crush_ln, a 64-bit division and a compare;
// a 1M-x chooseleaf-firstn stage over 200 hosts of 50 OSDs makes ~7.5e8
// draws and reads a ~0.3 MB map, so bytes are no limit. The design keeps
// the map in read-only global memory (__ldg, L1/L2-resident), the tables in
// shared memory (each thread reads its own index, which constant memory
// would serialise), and per-thread state in small local arrays.
//
// Semantics match ceph_tpu_torch/crush/torch_mapper.py's choose_stage_plain
// bit for bit: out/out2 as (n, out_slots) int32; firstn compacts placed
// items left to right (out2 = leaves, 0 for a plain choose), indep is
// positional with NONE holes (out2 NONE for a plain choose).
//
// Plain C interface for ctypes; pointers and the stream are void*-sized.

#include <cuda_runtime.h>
#include <stdint.h>

#define CRUSH_MAX_SLOTS 32
#define CRUSH_ITEM_UNDEF 0x7FFFFFFE
#define CRUSH_ITEM_NONE 0x7FFFFFFF
#define LN_RH_LH 258
#define LN_TABLES (258 + 256)
#define THREADS 128

enum { REACHED = 0, NOT_REACHED = 1, SKIP = 2 };

struct MapView {
  const int32_t* offsets;         // (B,) first flat slot of each bucket row
  const int32_t* sizes;           // (B,)
  const int32_t* items;           // (T,)
  const int32_t* ids;             // (T,) straw2 hash ids
  const int64_t* weights;         // (n_pos, T) 16.16
  int n_pos;
  long long total;                // T
  const int32_t* row_of;          // (n_row_of,) -1-id -> row or -1
  int n_row_of;
  const int32_t* type_of_bucket;  // (B,)
  const int64_t* dev_weight;      // (n_dev_weight,) 16.16 reweights
  int n_dev_weight;
  int max_devices;
  int depth;
};

struct Stage {
  int firstn, numrep, want_type, recurse, tries, recurse_tries;
  int vary_r, stable, out_slots;
};

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= (c >> 13);
  b -= c; b -= a; b ^= (a << 8);
  c -= a; c -= b; c ^= (b >> 13);
  a -= b; a -= c; a ^= (c >> 12);
  b -= c; b -= a; b ^= (a << 16);
  c -= a; c -= b; c ^= (b >> 5);
  a -= b; a -= c; a ^= (c >> 3);
  b -= c; b -= a; b ^= (a << 10);
  c -= a; c -= b; c ^= (b >> 15);
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = 1315423911u ^ a ^ b ^ c;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = 1315423911u ^ a ^ b;
  uint32_t x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

// 2^44*log2(x+1) for x in [0, 0xFFFF] (mapper.c:248); tbl = RH_LH then LL
__device__ __forceinline__ int64_t crush_ln(uint32_t xin, const int64_t* tbl) {
  uint32_t x = xin + 1;
  int iexpon = 15;
  if (!(x & 0x18000)) {
    int bits = __clz(x & 0x1FFFF) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  int index1 = (x >> 8) << 1;
  uint64_t rh = (uint64_t)tbl[index1 - 256];
  int64_t lh = tbl[index1 + 1 - 256];
  uint64_t xl64 = ((uint64_t)x * rh) >> 48;
  lh += tbl[LN_RH_LH + (xl64 & 0xFF)];
  return ((int64_t)iexpon << 44) + (lh >> 4);
}

// bucket row -> chosen item (bucket_straw2_choose, mapper.c:334)
__device__ int straw2_choose(const MapView& m, const int64_t* tbl, int row,
                             uint32_t x, int r, int pos, int& draws) {
  int off = __ldg(m.offsets + row);
  int size = __ldg(m.sizes + row);
  int p = pos < m.n_pos - 1 ? pos : m.n_pos - 1;
  const int64_t* w = m.weights + (long long)p * m.total + off;
  int best = 0;
  int64_t best_draw = 0;
  for (int i = 0; i < size; ++i) {
    int64_t wi = __ldg(w + i);
    int64_t draw = INT64_MIN;
    if (wi > 0) {
      uint32_t u = hash32_3(x, (uint32_t)__ldg(m.ids + off + i), (uint32_t)r) & 0xFFFF;
      int64_t ln = crush_ln(u, tbl) - 0x1000000000000LL;  // <= 0
      draw = -((-ln) / wi);  // C truncation, as div64_s64
    }
    if (i == 0 || draw > best_draw) {
      best = i;
      best_draw = draw;
    }
  }
  draws += size;
  return __ldg(m.items + off + best);
}

__device__ __forceinline__ int row_of_item(const MapView& m, int item) {
  if (item >= 0) return -1;
  int idx = -1 - item;
  return idx < m.n_row_of ? __ldg(m.row_of + idx) : -1;
}

// mapper.c:424; a bucket id reads weight[0], as the plain version's clamp
__device__ __forceinline__ bool is_out(const MapView& m, int item, uint32_t x) {
  if (item >= m.n_dev_weight) return true;
  int64_t w = __ldg(m.dev_weight + (item < 0 ? 0 : item));
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return (int64_t)(hash32_2(x, (uint32_t)item) & 0xFFFF) >= w;
}

// walk down from bucket `row` to an item of want_type, at most depth buckets
__device__ int descend(const MapView& m, const int64_t* tbl, int row,
                       uint32_t x, int r, int want_type, int pos,
                       int& item, int& item_row, int& draws) {
  if (row < 0) return NOT_REACHED;
  for (int level = 0; level < m.depth; ++level) {
    if (__ldg(m.sizes + row) == 0) return NOT_REACHED;
    int it = straw2_choose(m, tbl, row, x, r, pos, draws);
    if (it >= m.max_devices) return SKIP;
    int nrow = row_of_item(m, it);
    int t = it >= 0 ? 0 : (nrow >= 0 ? __ldg(m.type_of_bucket + nrow) : -1);
    if (t == want_type) {
      item = it;
      item_row = nrow;
      return REACHED;
    }
    if (nrow < 0) return SKIP;
    row = nrow;
  }
  return NOT_REACHED;
}

// chooseleaf recursion of firstn (mapper.c:565-585)
__device__ bool leaf_firstn(const MapView& m, const Stage& s, const int64_t* tbl,
                            int row, uint32_t x, int outpos, int sub_r,
                            const int* out2, int& leaf, int& draws) {
  int rep0 = s.stable ? 0 : outpos;
  for (int ft = 0; ft < s.recurse_tries; ++ft) {
    int it = 0, itrow = -1;
    int st = descend(m, tbl, row, x, rep0 + sub_r + ft, 0, outpos, it, itrow, draws);
    if (st == SKIP) return false;
    if (st != REACHED) continue;
    bool collide = false;
    for (int j = 0; j < outpos; ++j) collide |= out2[j] == it;
    if (!collide && !is_out(m, it, x)) {
      leaf = it;
      return true;
    }
  }
  return false;
}

__device__ void choose_firstn(const MapView& m, const Stage& s, const int64_t* tbl,
                              int start_row, uint32_t x, int* out, int* out2,
                              int& draws) {
  int outpos = 0;
  for (int rep = 0; rep < s.numrep; ++rep) {
    for (int ftotal = 0; ftotal < s.tries; ++ftotal) {
      int r = rep + ftotal;
      int it = 0, itrow = -1;
      int st = descend(m, tbl, start_row, x, r, s.want_type, outpos, it, itrow, draws);
      if (st == SKIP) break;  // the rep is given up
      if (st != REACHED) continue;
      bool collide = false;
      for (int j = 0; j < outpos; ++j) collide |= out[j] == it;
      if (collide) continue;
      int leaf = 0;
      if (s.recurse) {
        leaf = it;
        if (it < 0) {
          int sub_r = s.vary_r ? (r >> (s.vary_r - 1)) : 0;
          if (!leaf_firstn(m, s, tbl, itrow, x, outpos, sub_r, out2, leaf, draws))
            continue;
        }
      }
      if (s.want_type == 0 && is_out(m, it, x)) continue;
      if (outpos < s.out_slots) {
        out[outpos] = it;
        out2[outpos] = leaf;
        ++outpos;
      }
      break;
    }
  }
  for (int j = outpos; j < s.out_slots; ++j) out[j] = out2[j] = CRUSH_ITEM_NONE;
}

__device__ void choose_indep(const MapView& m, const Stage& s, const int64_t* tbl,
                             int start_row, uint32_t x, int* out, int* out2,
                             int& draws) {
  int left = s.out_slots;
  for (int j = 0; j < s.out_slots; ++j) out[j] = out2[j] = CRUSH_ITEM_UNDEF;
  for (int ftotal = 0; ftotal < s.tries && left > 0; ++ftotal) {
    for (int rep = 0; rep < s.out_slots; ++rep) {
      if (out[rep] != CRUSH_ITEM_UNDEF) continue;
      int r = rep + s.numrep * ftotal;
      int it = 0, itrow = -1;
      int st = descend(m, tbl, start_row, x, r, s.want_type, 0, it, itrow, draws);
      if (st == SKIP) {  // a bad item or type marks the slot NONE for good
        out[rep] = out2[rep] = CRUSH_ITEM_NONE;
        --left;
        continue;
      }
      if (st != REACHED) continue;
      bool collide = false;
      for (int j = 0; j < s.out_slots; ++j) collide |= out[j] == it;
      if (collide) continue;
      int leaf = it;
      if (s.recurse && it < 0) {
        bool got = false;
        for (int ft2 = 0; ft2 < s.recurse_tries && !got; ++ft2) {
          int lf = 0, lfrow = -1;
          int st2 = descend(m, tbl, itrow, x, rep + r + s.numrep * ft2, 0, rep,
                            lf, lfrow, draws);
          if (st2 == SKIP) break;
          if (st2 == REACHED && !is_out(m, lf, x)) {
            leaf = lf;
            got = true;
          }
        }
        if (!got) continue;
      }
      if (s.want_type == 0 && is_out(m, it, x)) continue;
      out[rep] = it;
      if (s.recurse) out2[rep] = leaf;
      --left;
    }
  }
  for (int j = 0; j < s.out_slots; ++j) {
    if (out[j] == CRUSH_ITEM_UNDEF) out[j] = CRUSH_ITEM_NONE;
    if (out2[j] == CRUSH_ITEM_UNDEF) out2[j] = CRUSH_ITEM_NONE;
  }
}

__global__ void __launch_bounds__(THREADS)
crush_choose_kernel(MapView m, Stage s, const int64_t* __restrict__ ln_tables,
                    const int32_t* __restrict__ xs,
                    const int32_t* __restrict__ start_items, int static_start,
                    int32_t* __restrict__ out_g, int32_t* __restrict__ out2_g,
                    int32_t* __restrict__ draws_g, long long n) {
  __shared__ int64_t tbl[LN_TABLES];
  for (int i = threadIdx.x; i < LN_TABLES; i += blockDim.x) tbl[i] = ln_tables[i];
  __syncthreads();

  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t x = (uint32_t)__ldg(xs + lane);
  int start = start_items ? __ldg(start_items + lane) : static_start;
  int start_row = row_of_item(m, start);

  int out[CRUSH_MAX_SLOTS], out2[CRUSH_MAX_SLOTS];
  int draws = 0;
  if (s.firstn)
    choose_firstn(m, s, tbl, start_row, x, out, out2, draws);
  else
    choose_indep(m, s, tbl, start_row, x, out, out2, draws);

  int32_t* o = out_g + lane * s.out_slots;
  int32_t* o2 = out2_g + lane * s.out_slots;
  for (int j = 0; j < s.out_slots; ++j) {
    o[j] = out[j];
    o2[j] = out2[j];
  }
  if (draws_g) draws_g[lane] = draws;
}

extern "C" int crush_choose_launch(
    const int32_t* offsets, const int32_t* sizes, const int32_t* items,
    const int32_t* ids, const int64_t* weights, int n_pos, long long total,
    const int32_t* row_of, int n_row_of, const int32_t* type_of_bucket,
    const int64_t* dev_weight, int n_dev_weight, int max_devices, int depth,
    const int64_t* ln_tables,
    int firstn, int numrep, int want_type, int recurse, int tries,
    int recurse_tries, int vary_r, int stable, int out_slots,
    const int32_t* xs, const int32_t* start_items, int static_start,
    int32_t* out, int32_t* out2, int32_t* draws, long long n, void* stream) {
  if (out_slots < 1 || out_slots > CRUSH_MAX_SLOTS || n_pos < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  MapView m{offsets, sizes, items, ids, weights, n_pos, total, row_of, n_row_of,
            type_of_bucket, dev_weight, n_dev_weight, max_devices, depth};
  Stage s{firstn, numrep, want_type, recurse, tries, recurse_tries, vary_r, stable,
          out_slots};
  long long blocks = (n + THREADS - 1) / THREADS;
  crush_choose_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      m, s, ln_tables, xs, start_items, static_start, out, out2, draws, n);
  return (int)cudaGetLastError();
}

extern "C" const char* crush_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
