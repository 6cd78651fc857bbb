// xor_rowmatmul.cu — XOR kernels for Hopper (sm_90a): the mod-2 row product
// of a {0,1} matrix with byte rows, and the XOR of k whole rows.
//
// xor_rowmatmul_launch replaces the XLA function
// ceph_tpu/ec/bitmatrix.py:xor_rowmatmul, the encode and decode of
// jerasure's liberation, blaum_roth and liber8tion techniques: an (R, C)
// {0,1} bit-matrix times (B, C, P) uint8 packet rows -> (B, R, P), where
// output row i is the XOR of the input rows its matrix row selects. The TPU
// function bit-slices the bytes and runs one int8 contraction per bit plane
// on the MXU; this kernel XORs the selected rows.
//
// xor_rows_launch replaces the two XLA functions that compute the m=1
// parity, the XOR of rows 0..k-1: ceph_tpu/ops/gf_bitplane.py:xor_reduce,
// (B, k, L) uint8 chunks -> (B, 1, L) (lrc's local layers, an m=1 codec's
// byte API), and ceph_tpu/ops/gf_pallas.py:xor_reduce_words, (k, N4) int32
// planar words -> (1, N4), whose bytes are a (1, k, 4 N4) block
// (EncodeService's m=1 batch). Each wrapper counts its own launches.
//
// What bounds both on an H100: memory. Every input byte is read once and
// every output byte written once: B * (C + R) * P bytes, and B * (k + 1) * L
// for the XOR of rows, at 3.35 TB/s. The XORs are one operation per 4 bytes
// of a selected row, far below the integer rate.
//
// What xor_rowmatmul_kernel does about it:
//  * The host turns the matrix into per-output-row lists of input rows
//    (CSR: R + 1 offsets, then the selected row indices, all int32), which
//    each block stages in shared memory: every thread walks the same list,
//    so each list read is a broadcast. No bit of the matrix is tested per
//    byte of data.
//  * Each thread owns 16 bytes of one batch item and produces all R output
//    rows for them: one 16-byte load per selected row (the rows an output
//    row shares with the previous ones are re-read from L1), one 16-byte
//    store per output row. Neighbouring threads read neighbouring 16 bytes.
//  * A grid-stride loop over (batch item, 16-byte group), the grid capped at
//    two waves of resident blocks.
//  * Lists longer than the default 48 KB of shared memory opt in to more, up
//    to the 227 KB a block can have (kMaxListWords); the wrapper refuses a
//    longer list, on either device. C itself is not capped.
//
// Why the XOR of rows has a kernel of its own: given the one-row list
// [0, k, 0..k-1], the row-list kernel lost to torch.bitwise_xor on the m=1
// batch. Per 16-byte group it paid a 64-bit division (g / groups), each
// row's address waited on a list entry read from shared memory, a thread
// had only k x 16 bytes in flight, the grid was capped at two waves, and
// data read once was allocated in L1. xor_rows_kernel takes the batch item
// from blockIdx.y and its 16-byte group from blockIdx.x in 32 bits, with no
// division; it issues the loads of kRowsStep rows before it XORs them;
// loads take the read-only path (ld.global.nc) and stores the streaming
// hint (st.global.cs); the grid covers the whole row, with no cap. On the
// H100, 2 or 4 groups per thread, 128 to 1024 threads a block and an L2
// prefetch hint were no faster than one group per thread of 256 threads,
// and streaming loads (ld.global.cs, ld.global.nc.L1::no_allocate) were
// slower than ld.global.nc at lrc's local layer (and .cs loads slower
// still on a first launch after other work).
//
// In both kernels a ragged end (a length not a multiple of 16) or unaligned
// rows take masked byte loads and stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWaves = 2;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr long kMaxListWords = 232448 / 4;  // 227 KB of int32

__device__ __forceinline__ uint4 load16(const uint8_t* src, int vec, int nb) {
  if (vec) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < nb) w[b >> 2] |= (uint32_t)src[b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* dst, uint4 v, int vec,
                                        int nb) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < nb) dst[i] = (uint8_t)(w[i >> 2] >> (8 * (i & 3)));
}

__global__ void __launch_bounds__(kThreads)
xor_rowmatmul_kernel(const int* __restrict__ lists,  // R + 1 offsets, entries
                     int rows_out, int n_words,
                     const uint8_t* __restrict__ in,  // (B, C, P) strided
                     uint8_t* __restrict__ out,       // (B, R, P)
                     long batch, long len, long in_sb, long in_sc, int vec) {
  extern __shared__ int s_lists[];
  for (int t = threadIdx.x; t < n_words; t += blockDim.x) s_lists[t] = lists[t];
  __syncthreads();
  const int* s_cols = s_lists + rows_out + 1;

  const long groups = (len + 15) / 16;
  const long total = batch * groups;
  const long step = (long)gridDim.x * blockDim.x;
  for (long g = (long)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += step) {
    const long b = g / groups;
    const long c0 = (g - b * groups) * 16;
    const int nb = (int)(len - c0 < 16 ? len - c0 : 16);
    const uint8_t* src = in + b * in_sb + c0;
    uint8_t* dst = out + b * rows_out * len + c0;
    for (int i = 0; i < rows_out; ++i) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      const int end = s_lists[i + 1];
#pragma unroll 4
      for (int e = s_lists[i]; e < end; ++e) {
        const uint4 v = load16(src + (long)s_cols[e] * in_sc, vec, nb);
        acc.x ^= v.x;
        acc.y ^= v.y;
        acc.z ^= v.z;
        acc.w ^= v.w;
      }
      store16(dst + (long)i * len, acc, vec, nb);
    }
  }
}

constexpr int kRowsThreads = 256;
constexpr int kRowsStep = 4;  // rows whose loads are in flight together

__device__ __forceinline__ void xor16(uint4& acc, uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// out[b, 0, :] = XOR of in[b, j, :] for j < k. Thread i of block (x, y)
// takes the 16-byte group x * kRowsThreads + i of items y, y + gridDim.y,
// ..., so each load instruction of a warp reads 512 contiguous bytes.
__global__ void __launch_bounds__(kRowsThreads)
xor_rows_kernel(const uint8_t* __restrict__ in,  // (B, k, L) strided
                uint8_t* __restrict__ out,       // (B, 1, L)
                int k, long batch, long len, long in_sb, long in_sc,
                int groups, int vec) {
  const int g = blockIdx.x * kRowsThreads + threadIdx.x;
  if (g >= groups) return;
  const long c0 = (long)g * 16;
  for (long b = blockIdx.y; b < batch; b += gridDim.y) {
    const uint8_t* src = in + b * in_sb + c0;
    uint8_t* dst = out + b * len + c0;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    if (vec) {
      for (int j0 = 0; j0 < k; j0 += kRowsStep) {
        uint4 v[kRowsStep];
#pragma unroll
        for (int r = 0; r < kRowsStep; ++r)
          v[r] = j0 + r < k ? __ldg(reinterpret_cast<const uint4*>(
                                  src + (long)(j0 + r) * in_sc))
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int r = 0; r < kRowsStep; ++r) xor16(acc, v[r]);
      }
      __stcs(reinterpret_cast<uint4*>(dst), acc);
    } else {
      const int nb = (int)(len - c0 < 16 ? len - c0 : 16);
      for (int j = 0; j < k; ++j) xor16(acc, load16(src + (long)j * in_sc, 0, nb));
      store16(dst, acc, 0, nb);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch, 0 on
// success. lists is n_words int32 on the device: rows_out + 1 offsets, then
// the selected input rows of output row i at entries [off[i], off[i + 1]).
// in is (batch, C, len) bytes whose item b, row c starts at
// in + b * in_sb + c * in_sc (the last axis contiguous); out is
// (batch, rows_out, len) bytes, contiguous.
extern "C" int xor_rowmatmul_launch(const void* lists, int rows_out,
                                    int n_words, const void* in, void* out,
                                    long batch, long len, long in_sb,
                                    long in_sc, void* stream) {
  if (rows_out <= 0 || n_words < rows_out + 1 || n_words > kMaxListWords ||
      batch < 0 || len < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || len == 0) return 0;
  const size_t smem = (size_t)n_words * sizeof(int);
  cudaError_t err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(xor_rowmatmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, xor_rowmatmul_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long work = batch * ((len + 15) / 16);
  long blocks = (work + kThreads - 1) / kThreads;
  const long cap = (long)sms * (per_sm > 0 ? per_sm : 1) * kWaves;
  if (blocks > cap) blocks = cap;
  const int vec = len % 16 == 0 && in_sb % 16 == 0 && in_sc % 16 == 0 &&
                  (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  xor_rowmatmul_kernel<<<(unsigned)blocks, kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const int*)lists, rows_out, n_words, (const uint8_t*)in,
      (uint8_t*)out, batch, len, in_sb, in_sc, vec);
  return (int)cudaGetLastError();
}

// Launch on `stream`; returns cudaGetLastError() after the launch, 0 on
// success. Writes the XOR of rows 0..k-1 of in, (batch, k, len) bytes whose
// item b, row j starts at in + b * in_sb + j * in_sc (the last axis
// contiguous), to out, (batch, 1, len) bytes, contiguous. Rows of up to
// 2^31 - 256 16-byte groups (32 GiB); a longer row is refused.
extern "C" int xor_rows_launch(const void* in, void* out, int k, long batch,
                               long len, long in_sb, long in_sc,
                               void* stream) {
  if (k <= 0 || batch < 0 || len < 0 ||
      (len + 15) / 16 > 0x7FFFFFFFL - kRowsThreads)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || len == 0) return 0;
  const int groups = (int)((len + 15) / 16);
  const unsigned blocks_x = (unsigned)((groups + kRowsThreads - 1) / kRowsThreads);
  const unsigned blocks_y = (unsigned)(batch < 65535 ? batch : 65535);
  const int vec = len % 16 == 0 && in_sb % 16 == 0 && in_sc % 16 == 0 &&
                  (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  xor_rows_kernel<<<dim3(blocks_x, blocks_y), kRowsThreads, 0,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, k, batch, len, in_sb, in_sc, groups,
      vec);
  return (int)cudaGetLastError();
}

extern "C" const char* xor_rowmatmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
