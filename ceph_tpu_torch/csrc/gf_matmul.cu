// gf_matmul.cu — GF(2^8) matrix x chunk data, for Hopper (sm_90a). Two
// entry points over the same split-nibble arithmetic:
//
//  * gf_matmul_packed_launch replaces the TPU kernel
//    ceph_tpu/ops/gf_pallas.py:gf_matmul_packed (Pallas body `_kernel`). Same
//    contract: (k, N4) int32 words, four data bytes to a word, chunk j in row
//    j, times the coding matrix -> (r, N4) int32 words of parity or rebuilt
//    chunks.
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
// What bounds it on an H100: memory. Every input byte is read once and every
// output byte written once: (k + r) * N4 * 4 bytes at 3.35 TB/s for the
// packed form, B * (k + r) * L bytes for the byte form. There is no multiply
// to count; a GF(2^8) product is two table lookups and an XOR.
//
// What the design does about it:
//  * Block (i, j) of the (8r, 8k) bit-matrix is a GF(2)-linear map on a byte,
//    so it splits into two 16-entry tables (ISA-L's split-nibble form):
//    f(x) = T_lo[x & 15] ^ T_hi[x >> 4]. The host derives the r*k*32 table
//    bytes once per matrix (ceph_tpu_torch.ops.gf_cuda.nibble_tables).
//  * A block stages the tables in shared memory. All lanes of a warp read the
//    same 16-byte table at once (one broadcast 16-byte load), and hold it in
//    four registers. A lookup of all four bytes of a word is then register
//    work, ISA-L's pshufb done with __byte_perm: one byte permute picks
//    entries 0..7, one picks 8..15, and bit 3 of each nibble selects between
//    them. No byte-wise shared-memory loads.
//  * The nibbles of an input word become __byte_perm selectors once and are
//    reused for every output row.
//  * Each thread owns four consecutive word columns, read as one 16-byte load
//    per input row where rows are 16-byte aligned, and keeps four output rows
//    x four words of accumulators in registers: an input word is read from
//    memory once per group of four output rows (once in all for r <= 4). The
//    next row's load is issued before the current row is computed.
//  * The ragged end of N4 (and unaligned rows) take masked scalar loads.
//  * A grid-stride loop amortizes the table staging over a grid of two
//    waves of resident blocks (the occupancy calculator's blocks per SM,
//    4 at 64 registers, times the SMs, times two). On an H100 at (8, 8 Mi)
//    words that ran 4% faster than one wave: blocks of the second wave
//    fill the SMs as the first ones finish.
//  * The byte form runs the same inner loop on 16 bytes (four words) of one
//    batch item per thread; a flat index over (batch, 16-byte group) walks
//    the grid, so one launch covers the whole batch. 16-byte loads and
//    stores where L, the strides and the bases are 16-byte aligned; byte
//    loads and stores, masked at L, everywhere else (clay's sub-chunk
//    columns, strided survivor slices of any width).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;      // word columns per thread
constexpr int kRowGroup = 4;  // output rows held in registers per pass
constexpr int kWaves = 2;     // waves of resident blocks in the grid
constexpr size_t kMaxTableBytes = 48 * 1024;  // dynamic shared memory, no opt-in

// One nibble of each of the four bytes of a word, as a __byte_perm selector
// (nibble s of the low 16 bits picks entry n_s & 7 of an 8-byte half-table)
// and a byte mask of bit 3 of each nibble (which half-table: 0..7 or 8..15).
struct Nibbles {
  uint32_t sel, mask;
};

__device__ __forceinline__ Nibbles nibbles(uint32_t n4x8, uint32_t bit3) {
  // n4x8 holds one nibble value (0..15) in each byte; fold bytes 0..3 into
  // selector nibbles 0..3: (b0 | b1 << 4) in byte 0, (b2 | b3 << 4) in byte 2
  const uint32_t folded = n4x8 | (n4x8 >> 4);
  return {__byte_perm(folded, 0u, 0x0020u), bit3 * 0xffu};
}

// 16-entry byte table t (entries 0..3 in t.x, ..., 12..15 in t.w) looked up
// at four nibbles at once: byte s of the result is t[n_s].
__device__ __forceinline__ uint32_t lookup16(uint4 t, Nibbles n) {
  const uint32_t low = __byte_perm(t.x, t.y, n.sel);   // entries 0..7
  const uint32_t high = __byte_perm(t.z, t.w, n.sel);  // entries 8..15
  return (low & ~n.mask) | (high & n.mask);
}

__device__ __forceinline__ uint4 load_cols(const uint32_t* src, int vec,
                                           int ncols) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  return make_uint4(ncols > 0 ? src[0] : 0u, ncols > 1 ? src[1] : 0u,
                    ncols > 2 ? src[2] : 0u, ncols > 3 ? src[3] : 0u);
}

__global__ void __launch_bounds__(kThreads)
gf_matmul_packed_kernel(const uint8_t* __restrict__ tables,  // (r, k, 32)
                        const uint32_t* __restrict__ in,     // (k, n4)
                        uint32_t* __restrict__ out,          // (r, n4)
                        int k, int r, long n4, int vec) {
  // table (i, j) is s_tab[2*(i*k + j)] (T_lo) and s_tab[2*(i*k + j) + 1] (T_hi)
  extern __shared__ uint4 s_tab[];
  uint8_t* s_bytes = reinterpret_cast<uint8_t*>(s_tab);
  const int ntab = r * k * 32;
  for (int t = threadIdx.x; t < ntab; t += blockDim.x) s_bytes[t] = tables[t];
  __syncthreads();

  const long step = (long)gridDim.x * blockDim.x * kCols;
  for (long c0 = ((long)blockIdx.x * blockDim.x + threadIdx.x) * kCols;
       c0 < n4; c0 += step) {
    // vec: n4 % kCols == 0 and 16-byte aligned bases, so c0 + kCols <= n4
    const int ncols = (int)(n4 - c0 < kCols ? n4 - c0 : kCols);
    for (int i0 = 0; i0 < r; i0 += kRowGroup) {
      uint32_t acc[kRowGroup][kCols];
#pragma unroll
      for (int a = 0; a < kRowGroup; ++a)
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[a][q] = 0u;

      uint4 next = load_cols(in + c0, vec, ncols);
      for (int j = 0; j < k; ++j) {
        const uint4 cur = next;
        if (j + 1 < k) next = load_cols(in + (long)(j + 1) * n4 + c0, vec, ncols);
        const uint32_t w[kCols] = {cur.x, cur.y, cur.z, cur.w};
        Nibbles lo[kCols], hi[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          lo[q] = nibbles(w[q] & 0x0f0f0f0fu, (w[q] >> 3) & 0x01010101u);
          hi[q] = nibbles((w[q] >> 4) & 0x0f0f0f0fu, (w[q] >> 7) & 0x01010101u);
        }
#pragma unroll
        for (int a = 0; a < kRowGroup; ++a) {
          const int i = i0 + a;
          if (i < r) {
            const uint4 t_lo = s_tab[2 * (i * k + j)];
            const uint4 t_hi = s_tab[2 * (i * k + j) + 1];
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              acc[a][q] ^= lookup16(t_lo, lo[q]) ^ lookup16(t_hi, hi[q]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < kRowGroup; ++a) {
        const int i = i0 + a;
        if (i < r) {
          uint32_t* dst = out + (long)i * n4 + c0;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
          } else {
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              if (q < ncols) dst[q] = acc[a][q];
          }
        }
      }
    }
  }
}


// 16 bytes at src as four little-endian words: one 16-byte load when `vec`,
// else byte loads of the first nb (< 16 at the ragged end) and zeros after.
__device__ __forceinline__ uint4 load_bytes16(const uint8_t* src, int vec,
                                              int nb) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < nb) w[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_bytes16(uint8_t* dst, uint4 v, int vec,
                                              int nb) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < nb) dst[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

__global__ void __launch_bounds__(kThreads)
gf_matmul_bytes_kernel(const uint8_t* __restrict__ tables,  // (r, k, 32)
                       const uint8_t* __restrict__ in,      // (B, k, L) strided
                       uint8_t* __restrict__ out,           // (B, r, L)
                       int k, int r, long batch, long len, long in_sb,
                       long in_sk, int vec) {
  extern __shared__ uint4 s_tab[];
  uint8_t* s_bytes = reinterpret_cast<uint8_t*>(s_tab);
  const int ntab = r * k * 32;
  for (int t = threadIdx.x; t < ntab; t += blockDim.x) s_bytes[t] = tables[t];
  __syncthreads();

  const long groups = (len + 15) / 16;
  const long total = batch * groups;
  const long step = (long)gridDim.x * blockDim.x;
  for (long g = (long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += step) {
    const long b = g / groups;
    const long c0 = (g - b * groups) * 16;
    const int nb = (int)(len - c0 < 16 ? len - c0 : 16);
    const uint8_t* src = in + b * in_sb + c0;
    for (int i0 = 0; i0 < r; i0 += kRowGroup) {
      uint32_t acc[kRowGroup][kCols];
#pragma unroll
      for (int a = 0; a < kRowGroup; ++a)
#pragma unroll
        for (int q = 0; q < kCols; ++q) acc[a][q] = 0u;

      uint4 next = load_bytes16(src, vec, nb);
      for (int j = 0; j < k; ++j) {
        const uint4 cur = next;
        if (j + 1 < k) next = load_bytes16(src + (long)(j + 1) * in_sk, vec, nb);
        const uint32_t w[kCols] = {cur.x, cur.y, cur.z, cur.w};
        Nibbles lo[kCols], hi[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          lo[q] = nibbles(w[q] & 0x0f0f0f0fu, (w[q] >> 3) & 0x01010101u);
          hi[q] = nibbles((w[q] >> 4) & 0x0f0f0f0fu, (w[q] >> 7) & 0x01010101u);
        }
#pragma unroll
        for (int a = 0; a < kRowGroup; ++a) {
          const int i = i0 + a;
          if (i < r) {
            const uint4 t_lo = s_tab[2 * (i * k + j)];
            const uint4 t_hi = s_tab[2 * (i * k + j) + 1];
#pragma unroll
            for (int q = 0; q < kCols; ++q)
              acc[a][q] ^= lookup16(t_lo, lo[q]) ^ lookup16(t_hi, hi[q]);
          }
        }
      }

#pragma unroll
      for (int a = 0; a < kRowGroup; ++a) {
        const int i = i0 + a;
        if (i < r)
          store_bytes16(out + (b * r + i) * len + c0,
                        make_uint4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]),
                        vec, nb);
      }
    }
  }
}

// Grid of `work` items of kThreads threads, capped at kWaves waves of the
// blocks the occupancy calculator lets reside; 0 or a CUDA error.
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, long work, long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  long n = (work + kThreads - 1) / kThreads;
  const long cap = (long)sms * (per_sm > 0 ? per_sm : 1) * kWaves;
  *blocks = n > cap ? cap : n;
  return 0;
}

}  // namespace

// Launch on `stream` (a cudaStream_t); returns cudaGetLastError() after the
// launch, 0 on success. Pointers are device pointers; tables is (r, k, 32)
// uint8, in is (k, n4) int32, out is (r, n4) int32, all contiguous.
extern "C" int gf_matmul_packed_launch(const void* tables, const void* in,
                                       void* out, int k, int r, long n4,
                                       void* stream) {
  if (k <= 0 || r <= 0 || n4 < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)r * k * 32;
  if (smem > kMaxTableBytes) return (int)cudaErrorInvalidValue;
  if (n4 == 0) return 0;
  long blocks = 0;
  const int err = grid_for(gf_matmul_packed_kernel, smem,
                           (n4 + kCols - 1) / kCols, &blocks);
  if (err != 0) return err;
  const int vec = n4 % kCols == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  gf_matmul_packed_kernel<<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)tables, (const uint32_t*)in, (uint32_t*)out, k, r, n4,
      vec);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() after the launch, 0 on
// success. tables is (r, k, 32) uint8; in is (batch, k, len) uint8 whose item
// b, row j starts at in + b * in_sb + j * in_sk (bytes; the last axis is
// contiguous); out is (batch, r, len) uint8, contiguous.
extern "C" int gf_matmul_bytes_launch(const void* tables, const void* in,
                                      void* out, int k, int r, long batch,
                                      long len, long in_sb, long in_sk,
                                      void* stream) {
  if (k <= 0 || r <= 0 || batch < 0 || len < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)r * k * 32;
  if (smem > kMaxTableBytes) return (int)cudaErrorInvalidValue;
  if (batch == 0 || len == 0) return 0;
  long blocks = 0;
  const int err = grid_for(gf_matmul_bytes_kernel, smem,
                           batch * ((len + 15) / 16), &blocks);
  if (err != 0) return err;
  const int vec = len % 16 == 0 && in_sb % 16 == 0 && in_sk % 16 == 0 &&
                  (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  gf_matmul_bytes_kernel<<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)tables, (const uint8_t*)in, (uint8_t*)out, k, r, batch,
      len, in_sb, in_sk, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* gf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
