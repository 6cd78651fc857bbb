// gf_matmul.cu — GF(2^8) matrix x chunk data, for Hopper (sm_90a). Two
// entry points over the same byte-permute arithmetic and the same body:
//
//  * gf_matmul_packed_launch replaces the TPU kernel
//    ceph_tpu/ops/gf_pallas.py:gf_matmul_packed (Pallas body `_kernel`). Same
//    contract: (k, N4) int32 words, four data bytes to a word, chunk j in row
//    j, times the coding matrix -> (r, N4) int32 words of parity or rebuilt
//    chunks. The words are the bytes of one (k, 4 N4) block.
//  * gf_matmul_bytes_launch replaces the XLA function
//    ceph_tpu/ops/gf_bitplane.py:gf_matmul_bitplane, the byte-layout batched
//    form every non-planar codec calls (shec, lrc's RS layers, clay's MDS,
//    the RS byte API): (B, k, L) uint8 -> (B, r, L) uint8, with the batch and
//    row strides of the input given (the last axis is contiguous), and any L.
//    The TPU function expands bytes to bit-planes for the MXU; this kernel
//    computes the same function from the tables instead.
//
// Any {0,1} bit-matrix is taken, not only GF-derived ones (shec's decode
// matrices are not images of GF(2^8) matrices in general).
//
// What bounds it on an H100: memory, (k + r) bytes moved per byte column at
// 3.35 TB/s. There is no multiply to count; a GF(2^8) product is three table
// lookups and two XORs. The lookups are integer work, though: about
// 13 + 5 r operations per input word, so at r = 3 the INT32 pipes take about
// as long as the bytes do, and the inner loop is kept to that count.
//
// The daemons and MiniCluster launch it at one object's width: (8, 512 KiB)
// bytes, 5.5 MiB moved, a bound of 1.7 us. There a launch is short enough
// that latencies, and not rates, decide the time: a launch of a trivial
// kernel holds the stream for about 1.8 us (chip_smoke.py phase 5 times it),
// the first loads take a round trip, and every table read a thread waits on
// before its lookups adds to its chain. So the design keeps many bytes in
// flight from the first cycle on and keeps table reads off the chain:
//
//  * Block (i, j) of the (8r, 8k) bit-matrix is a GF(2)-linear map f on a
//    byte, so f(x) is the XOR of f on x's fields: bits 0-2, 3-5 and 6-7.
//    Each field indexes a table of 8 (or 4) bytes, which one byte permute
//    (prmt) looks up at the four bytes of a word at once: three prmt and two
//    XORs per word and output row, no masks. The host derives the r*k*32
//    table bytes once per matrix (ceph_tpu_torch.ops.gf_cuda.kernel_tables);
//    a field's selector (its value in each byte, moved to the prmt nibbles)
//    is taken once per input word and reused for every output row.
//  * Tables off the critical path. Up to kParamTables blocks (k = 8, r <= 6
//    and every k * r <= 48) travel in the launch's own parameter block
//    (a __grid_constant__ struct filled by the host launcher from its copy
//    of the tables): every lane of a warp reads the same bytes through the
//    constant cache, and no block stages anything or waits at a barrier.
//    In that variant with 16-byte accesses (the one the codecs launch) the
//    row count of a pass (1..4) is compiled in, and so is k where k = 8, so
//    that no branch separates the table reads from the lookups and the
//    compiler issues them ahead. Larger matrices (up to the 48 KiB of tables
//    the wrapper takes) read each table with a read-only load of one address
//    per warp, after the data loads are issued (slower: phase 5 times k = 8,
//    r = 3 on that route beside the parameter's).
//  * Each thread owns 16 bytes of a row (four words) and issues the loads of
//    up to kLoadGroup = 8 input rows at once (32 registers) before it
//    computes: at k = 8 a whole column group is in flight at the start.
//    It keeps four output rows x four words of accumulators in registers:
//    an input word is read from memory once per group of four output rows
//    (once in all for r <= 4).
//  * A launch plan chosen by width: a thread for every 16-byte group, in
//    blocks of 256 threads, halved (to 128, then 64) while that gives fewer
//    than two blocks per SM: 512 blocks of 64 threads at one object's width,
//    where 128 blocks of 256 would leave SMs idle. A grid-stride loop covers
//    widths past the grid's limit. (The grid of two resident waves the first
//    design ran over a grid-stride loop is slower for this body at the burst
//    width.) The SM count is asked of the runtime once per device.
//  * 16-byte loads and stores where L, the strides and the bases are
//    16-byte aligned (the `vec` variants); elsewhere word loads and stores
//    for whole 4-byte-aligned groups and byte loads and stores, masked at L,
//    for the rest (clay's sub-chunk columns, strided survivor slices of any
//    width, a ragged N4).
//  * The byte form walks a flat index over (batch, 16-byte group); its batch
//    item comes from a 32-bit division wherever the index fits in 32 bits.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // block size of wide launches
constexpr int kMinThreads = 64;   // the smallest block of a narrow launch
constexpr int kRowGroup = 4;      // output rows held in registers per pass
constexpr int kLoadGroup = 8;     // input rows whose loads are in flight together
constexpr size_t kMaxTableBytes = 48 * 1024;  // r*k*32 the wrapper takes
constexpr int kParamTables = 48;  // (i, j) blocks carried in the launch parameter
constexpr int kMaxDevices = 64;
static_assert(kRowGroup == 4, "gf_matmul_body compiles row passes of 1..4 rows");

// The tables as a kernel parameter: block (i, j) at t[2 * (i * k + j)]
// (bytes 0..7: the table of bits 0-2, 8..15: of bits 3-5) and the first
// word of t[2 * (i * k + j) + 1] (the table of bits 6-7). The
// global-memory variants take a one-entry placeholder.
template <bool kParam>
struct TableParam {
  uint4 t[kParam ? 2 * kParamTables : 1];
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// `field` holds a value below 8 in each byte; the prmt selector with byte
// s's value in selector nibble s: (b0 | b1 << 4) in byte 0 and (b2 | b3 << 4)
// in byte 2 (the fields leave the high bits of each byte clear, so the fold
// is an OR), then bytes 0 and 2 side by side.
__device__ __forceinline__ uint32_t selector(uint32_t field) {
  return prmt(field | (field >> 4), 0u, 0x0020u);
}

// The selectors of a word's three fields, taken once per input word.
struct Selectors {
  uint32_t low, mid, high;
};

__device__ __forceinline__ Selectors selectors(uint32_t w) {
  return {selector(w & 0x07070707u), selector((w >> 3) & 0x07070707u),
          selector((w >> 6) & 0x03030303u)};
}

// f at the four bytes of a word: the tables of bits 0-2 (t.x, t.y), 3-5
// (t.z, t.w) and 6-7 (t67) each looked up by one prmt.
__device__ __forceinline__ uint32_t product(uint4 t, uint32_t t67, Selectors s) {
  return prmt(t.x, t.y, s.low) ^ prmt(t.z, t.w, s.mid) ^ prmt(t67, 0u, s.high);
}

// Block `b`'s tables: the 16 bytes of the two 8-entry tables, and the word
// of the 4-entry one.
template <bool kParam>
__device__ __forceinline__ uint4 tables_at(const uint4* __restrict__ gtab,
                                           const TableParam<kParam>& ptab,
                                           int b, uint32_t* t67) {
  if constexpr (kParam) {
    *t67 = ptab.t[2 * b + 1].x;
    return ptab.t[2 * b];
  } else {
    *t67 = __ldg(reinterpret_cast<const uint32_t*>(gtab + 2 * b + 1));
    return __ldg(gtab + 2 * b);
  }
}

// 16 bytes at src as four little-endian words: one 16-byte load when kVec;
// else four word loads when the 16 bytes are whole and 4-byte aligned, or
// byte loads of the first nb (< 16 at the ragged end) and zeros after.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* src, int nb) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const uint4*>(src));
  } else {
    if (nb == 16 && ((uintptr_t)src & 3) == 0) {
      const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
      return make_uint4(__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3));
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < nb) w[b >> 2] |= (uint32_t)__ldg(src + b) << (8 * (b & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* dst, uint4 v, int nb) {
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    if (nb == 16 && ((uintptr_t)dst & 3) == 0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int q = 0; q < 4; ++q) d[q] = w[q];
      return;
    }
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < nb) dst[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
  }
}

// One load group of a row pass: the products of input rows j0 .. j0 + cols
// - 1 with output rows i0 .. i0 + rows - 1 of one 16-byte column, XORed
// into acc. R (the rows) and K (k = K = kLoadGroup: one whole group) are
// compiled in where they are not 0, and then no branch per row or input row
// keeps the compiler from issuing the table reads ahead of the lookups.
template <int R, int K, bool kParam, bool kVec>
__device__ __forceinline__ void load_group(
    uint4 (&acc)[kRowGroup], const uint4* __restrict__ gtab,
    const TableParam<kParam>& ptab, const uint8_t* src, long in_sk, int nb,
    int k_run, int i0, int j0, int rows, int cols) {
  const int k = K ? K : k_run;
  // every load of the group is issued before the first lookup
  uint4 v[kLoadGroup];
#pragma unroll
  for (int jj = 0; jj < kLoadGroup; ++jj)
    if (K ? jj < K : jj < cols)
      v[jj] = load16<kVec>(src + (long)(j0 + jj) * in_sk, nb);
#pragma unroll
  for (int jj = 0; jj < kLoadGroup; ++jj) {
    if (K ? jj < K : jj < cols) {
      const Selectors s[4] = {selectors(v[jj].x), selectors(v[jj].y),
                              selectors(v[jj].z), selectors(v[jj].w)};
#pragma unroll
      for (int a = 0; a < kRowGroup; ++a) {
        if (R ? a < R : a < rows) {
          uint32_t t67;
          const uint4 t = tables_at<kParam>(gtab, ptab, (i0 + a) * k + j0 + jj, &t67);
          acc[a].x ^= product(t, t67, s[0]);
          acc[a].y ^= product(t, t67, s[1]);
          acc[a].z ^= product(t, t67, s[2]);
          acc[a].w ^= product(t, t67, s[3]);
        }
      }
    }
  }
}

// One row pass: output rows i0 .. i0 + R - 1 (R = 0: `rows`, known at run
// time) of one 16-byte column, over every input row. The variant with its
// tables in the parameter and 16-byte accesses, the one the codecs launch,
// compiles k = kLoadGroup in.
template <int R, bool kParam, bool kVec>
__device__ __forceinline__ void row_pass(
    const uint4* __restrict__ gtab, const TableParam<kParam>& ptab,
    const uint8_t* src, uint8_t* dst, long in_sk, long out_sr, int nb, int k,
    int i0, int rows) {
  uint4 acc[kRowGroup];
#pragma unroll
  for (int a = 0; a < kRowGroup; ++a) acc[a] = make_uint4(0u, 0u, 0u, 0u);
  bool done = false;
  if constexpr (kParam && kVec) {
    if (k == kLoadGroup) {
      load_group<R, kLoadGroup, kParam, kVec>(acc, gtab, ptab, src, in_sk, nb,
                                              k, i0, 0, rows, k);
      done = true;
    }
  }
  if (!done)
    for (int j0 = 0; j0 < k; j0 += kLoadGroup)
      load_group<R, 0, kParam, kVec>(acc, gtab, ptab, src, in_sk, nb, k, i0, j0,
                                     rows, k - j0 < kLoadGroup ? k - j0 : kLoadGroup);
#pragma unroll
  for (int a = 0; a < kRowGroup; ++a)
    if (R ? a < R : a < rows)
      store16<kVec>(dst + (long)(i0 + a) * out_sr, acc[a], nb);
}

// out[b, i, c] = XOR over j of f_ij(in[b, j, c]) for the 16-byte groups of a
// flat (batch, group) index; out is (batch, r, len) contiguous. The variant
// with its tables in the parameter and 16-byte accesses compiles a row pass
// for each row count 1..kRowGroup; the others take the counts at run time.
template <bool kBatched, bool kParam, bool kVec>
__device__ __forceinline__ void gf_matmul_body(
    const uint4* __restrict__ gtab, const TableParam<kParam>& ptab,
    const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int k, int r,
    long batch, long len, long in_sb, long in_sk) {
  const long groups = (len + 15) >> 4;
  const long total = kBatched ? batch * groups : groups;
  const bool narrow = total <= 0xffffffffL;
  const long step = (long)gridDim.x * blockDim.x;
  for (long g = (long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += step) {
    long b = 0, c0 = g * 16;
    if constexpr (kBatched) {
      b = narrow ? (long)((uint32_t)g / (uint32_t)groups) : g / groups;
      c0 = (g - b * groups) * 16;
    }
    const int nb = (int)(len - c0 < 16 ? len - c0 : 16);
    const uint8_t* src = in + b * in_sb + c0;
    uint8_t* dst = out + b * r * len + c0;
    for (int i0 = 0; i0 < r; i0 += kRowGroup) {
      const int rows = r - i0 < kRowGroup ? r - i0 : kRowGroup;
      if constexpr (kParam && kVec) {
        switch (rows) {
          case 1:
            row_pass<1, kParam, kVec>(gtab, ptab, src, dst, in_sk, len, nb, k, i0, rows);
            break;
          case 2:
            row_pass<2, kParam, kVec>(gtab, ptab, src, dst, in_sk, len, nb, k, i0, rows);
            break;
          case 3:
            row_pass<3, kParam, kVec>(gtab, ptab, src, dst, in_sk, len, nb, k, i0, rows);
            break;
          default:
            row_pass<kRowGroup, kParam, kVec>(gtab, ptab, src, dst, in_sk, len, nb,
                                              k, i0, rows);
        }
      } else {
        row_pass<0, kParam, kVec>(gtab, ptab, src, dst, in_sk, len, nb, k, i0, rows);
      }
    }
  }
}

// The two kernels share one signature; the packed one is the body with one
// batch item (its batch and batch stride are not read).
template <bool kParam, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
gf_matmul_packed_kernel(const uint4* __restrict__ gtab,
                        const __grid_constant__ TableParam<kParam> ptab,
                        const uint8_t* __restrict__ in,
                        uint8_t* __restrict__ out, int k, int r, long batch,
                        long len, long in_sb, long in_sk) {
  gf_matmul_body<false, kParam, kVec>(gtab, ptab, in, out, k, r, 1, len, 0,
                                      in_sk);
}

template <bool kParam, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 2)
gf_matmul_bytes_kernel(const uint4* __restrict__ gtab,
                       const __grid_constant__ TableParam<kParam> ptab,
                       const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out, int k, int r, long batch,
                       long len, long in_sb, long in_sk) {
  gf_matmul_body<true, kParam, kVec>(gtab, ptab, in, out, k, r, batch, len,
                                     in_sb, in_sk);
}

// Each device's SM count, asked of the runtime once (0: not asked yet).
// Concurrent first launches may both ask; they store the same.
std::atomic<int> g_sms[kMaxDevices];

struct Plan {
  int threads;
  unsigned blocks;
};

// The launch plan for `work` 16-byte groups: a thread each, in blocks of
// kMaxThreads threads halved down to kMinThreads while that gives fewer than
// two blocks per SM; the grid capped at its limit (the kernel's grid-stride
// loop takes the rest). 0 or a CUDA error.
int plan_for(long work, Plan* plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  int threads = kMaxThreads;
  while (threads > kMinThreads && (work + threads - 1) / threads < 2L * sms)
    threads >>= 1;
  const long blocks = (work + threads - 1) / threads;
  plan->threads = threads;
  plan->blocks = (unsigned)(blocks < INT_MAX ? blocks : INT_MAX);
  return 0;
}

template <bool kBatched, bool kParam, bool kVec>
int launch(const void* tables, const void* host_tables, const void* in,
           void* out, int k, int r, long batch, long len, long in_sb,
           long in_sk, void* stream) {
  auto kernel = kBatched ? &gf_matmul_bytes_kernel<kParam, kVec>
                         : &gf_matmul_packed_kernel<kParam, kVec>;
  Plan plan;
  const int err = plan_for(batch * ((len + 15) / 16), &plan);
  if (err != 0) return err;
  TableParam<kParam> ptab;
  if constexpr (kParam) {
    std::memcpy(ptab.t, host_tables, (size_t)r * k * 32);
  } else {
    ptab.t[0] = make_uint4(0u, 0u, 0u, 0u);
  }
  kernel<<<plan.blocks, plan.threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)tables, ptab, (const uint8_t*)in, (uint8_t*)out, k, r,
      batch, len, in_sb, in_sk);
  return (int)cudaGetLastError();
}

// The variant for these arguments: tables in the parameter block when the
// host copy is given and r * k <= kParamTables, else from global memory;
// 16-byte accesses when `vec`.
template <bool kBatched>
int dispatch(const void* tables, const void* host_tables, const void* in,
             void* out, int k, int r, long batch, long len, long in_sb,
             long in_sk, bool vec, void* stream) {
  const bool param = host_tables != nullptr && r * k <= kParamTables;
  if (param && vec)
    return launch<kBatched, true, true>(tables, host_tables, in, out, k, r,
                                        batch, len, in_sb, in_sk, stream);
  if (param)
    return launch<kBatched, true, false>(tables, host_tables, in, out, k, r,
                                         batch, len, in_sb, in_sk, stream);
  if (vec)
    return launch<kBatched, false, true>(tables, host_tables, in, out, k, r,
                                         batch, len, in_sb, in_sk, stream);
  return launch<kBatched, false, false>(tables, host_tables, in, out, k, r,
                                        batch, len, in_sb, in_sk, stream);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch, 0 on success. tables is (r, k, 32) uint8 on the device, 16-byte
// aligned; host_tables the same bytes on the host (or null: the tables are
// then read from device memory whatever their size); in is (k, n4) int32,
// out is (r, n4) int32, both contiguous on the device.
extern "C" int gf_matmul_packed_launch(const void* tables,
                                       const void* host_tables, const void* in,
                                       void* out, int k, int r, long n4,
                                       void* stream) {
  if (k <= 0 || r <= 0 || n4 < 0) return (int)cudaErrorInvalidValue;
  if ((size_t)r * k * 32 > kMaxTableBytes) return (int)cudaErrorInvalidValue;
  if (n4 == 0) return 0;
  const bool vec = n4 % 4 == 0 && aligned16(in) && aligned16(out);
  return dispatch<false>(tables, host_tables, in, out, k, r, 1, 4 * n4, 0,
                         4 * n4, vec, stream);
}

// Launch on `stream`; returns cudaGetLastError() after the launch, 0 on
// success. tables and host_tables as above; in is (batch, k, len) uint8
// whose item b, row j starts at in + b * in_sb + j * in_sk (bytes; the last
// axis is contiguous); out is (batch, r, len) uint8, contiguous.
extern "C" int gf_matmul_bytes_launch(const void* tables,
                                      const void* host_tables, const void* in,
                                      void* out, int k, int r, long batch,
                                      long len, long in_sb, long in_sk,
                                      void* stream) {
  if (k <= 0 || r <= 0 || batch < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if ((size_t)r * k * 32 > kMaxTableBytes) return (int)cudaErrorInvalidValue;
  if (batch == 0 || len == 0) return 0;
  const bool vec = len % 16 == 0 && in_sb % 16 == 0 && in_sk % 16 == 0 &&
                   aligned16(in) && aligned16(out);
  return dispatch<true>(tables, host_tables, in, out, k, r, batch, len, in_sb,
                        in_sk, vec, stream);
}

// The launch plan of `work` 16-byte groups on the current device, as a
// launch takes it: *threads per block and *blocks. 0 or a CUDA error.
extern "C" int gf_matmul_plan(long work, int* threads, long* blocks) {
  if (work <= 0) return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = plan_for(work, &plan);
  if (err != 0) return err;
  *threads = plan.threads;
  *blocks = (long)plan.blocks;
  return 0;
}

extern "C" const char* gf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
