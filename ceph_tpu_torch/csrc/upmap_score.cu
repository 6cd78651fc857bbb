// upmap_score.cu — the upmap balancer's move scorer, one warp per PG row, on Hopper.
//
// Replaces the XLA device function ceph_tpu/crush/balance.py:_score_chunk
// (:130-198). For every PG row of a pool (its up set, S <= 32 OSDs) and every
// candidate move (slot s, target OSD t), it decides whether replacing up[s]
// with t is legal and improving, scores it by the deviation gain, and keeps
// the best per row:
//
//   legal:  up[s] is placed and reachable (domain >= 0); t is a valid target
//           (weight, exists, up, reachable); t is not in the row; t's failure
//           domain is up[s]'s own or one the row does not occupy;
//           fdev - tdev > 1; and fdev > max_dev or tdev < -max_dev.
//   gain:   (fdev - tdev) - 1.0f in float32 (two subtractions, no FMA can
//           form; built without --use_fast_math), -inf where illegal.
//   result: the first maximum in flat s * n + t order (jnp.argmax's and
//           torch.argmax's rule): (gain, from = up[row, s], to = t). An
//           all-illegal row gives (-inf, up[row, 0], 0).
//
// The TPU form materialises (rows, S, n) gain and mask tensors, which is why
// the JAX package scores in chunks of at most 2^24 candidates. Here nothing
// of that size exists: a warp walks its row's S x n candidates in registers,
// so a whole pool is one launch.
//
// Bound: operations. One round at 1024 OSDs scores ~1e9 candidates, of
// which the function needs ~6.5 integer and ~3 float32 operations each; the
// inputs are a few MB (the up rows in, three (C,) outputs back), so bytes
// are no limit. The per-target arrays (deviation, and the domain folded
// with validity) are staged in shared memory once per block of 8 rows, for
// maps of up to UPMAP_STAGED_OSDS OSDs (8 bytes each): at 1024 OSDs that
// round takes 1.86 ms against 2.23 ms reading them from global memory
// through the read-only cache (H100 SXM, chip_smoke.py phase 12). A larger
// map, or staged = 0, takes the global-memory variant. The row's sources,
// their deviations and domains sit in per-warp shared memory (broadcast
// reads); each lane strides over the targets keeping its own best (gain,
// flat index); a warp-shuffle reduction ordered by gain descending, then
// flat index ascending, gives the first maximum.
//
// Semantics match ceph_tpu_torch/crush/balance.py's score_chunk_plain bit for
// bit (gain compared as its float32 bits). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define UPMAP_MAX_SLOTS 32
#define UPMAP_STAGED_OSDS 28000
#define UPMAP_MAX_OSDS (1 << 24)  // keeps the flat index s * n + t in an int
#define ROWS_PER_BLOCK 8
#define THREADS (ROWS_PER_BLOCK * 32)
#define NO_INDEX 0x7FFFFFFF

__device__ __forceinline__ bool better(float g, int idx, float best, int best_idx) {
  return g > best || (g == best && idx < best_idx);
}

template <bool kStaged>
__global__ void __launch_bounds__(THREADS)
upmap_score_kernel(const int32_t* __restrict__ up, const float* __restrict__ dev,
                   const uint8_t* __restrict__ valid, const int32_t* __restrict__ dom,
                   float max_dev, int n, int S, long long C,
                   float* __restrict__ gain_out, int32_t* __restrict__ from_out,
                   int32_t* __restrict__ to_out) {
  // (n,) target deviations, then (n,) target domains with -1 for targets
  // that are not valid or not reachable: no move to them is ever legal
  extern __shared__ unsigned char smem[];
  float* s_tdev = reinterpret_cast<float*>(smem);
  int32_t* s_tdom = reinterpret_cast<int32_t*>(s_tdev + n);
  __shared__ int32_t s_frm[ROWS_PER_BLOCK][UPMAP_MAX_SLOTS];
  __shared__ int32_t s_fdom[ROWS_PER_BLOCK][UPMAP_MAX_SLOTS];
  __shared__ float s_fdev[ROWS_PER_BLOCK][UPMAP_MAX_SLOTS];

  if (kStaged) {
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const int d = __ldg(dom + t);
      s_tdev[t] = __ldg(dev + t);
      s_tdom[t] = (__ldg(valid + t) != 0 && d >= 0) ? d : -1;
    }
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row < C && lane < S) {
    // sources read the raw arrays: NONE (-1) and ids past n take slot n,
    // the sentinel, as the plain version's clamped gather does
    const int f = __ldg(up + row * S + lane);
    const int fc = f >= 0 ? min(f, n) : n;
    s_frm[warp][lane] = f;
    s_fdev[warp][lane] = __ldg(dev + fc);
    s_fdom[warp][lane] = __ldg(dom + fc);
  }
  __syncthreads();
  if (row >= C) return;  // whole warps leave together

  const int32_t* frm = s_frm[warp];
  const int32_t* fdom = s_fdom[warp];
  const float* fdev = s_fdev[warp];
  float best = -INFINITY;
  int best_idx = NO_INDEX;
  for (int t = lane; t < n; t += 32) {
    int tdom;
    if (kStaged) {
      tdom = s_tdom[t];
    } else {
      const int d = __ldg(dom + t);
      tdom = (__ldg(valid + t) != 0 && d >= 0) ? d : -1;
    }
    if (tdom < 0) continue;
    const float tdev = kStaged ? s_tdev[t] : __ldg(dev + t);
    bool in_up = false, occ = false;
    for (int s = 0; s < S; ++s) {
      in_up |= frm[s] == t;
      occ |= frm[s] >= 0 && fdom[s] == tdom;
    }
    if (in_up) continue;
    const bool t_under = tdev < -max_dev;
    for (int s = 0; s < S; ++s) {
      if (frm[s] < 0 || fdom[s] < 0) continue;
      if (occ && fdom[s] != tdom) continue;
      const float d = fdev[s] - tdev;
      if (!(d > 1.0f)) continue;
      if (!(fdev[s] > max_dev || t_under)) continue;
      const float g = d - 1.0f;
      const int idx = s * n + t;
      if (better(g, idx, best, best_idx)) {
        best = g;
        best_idx = idx;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float g = __shfl_down_sync(0xffffffffu, best, off);
    const int idx = __shfl_down_sync(0xffffffffu, best_idx, off);
    if (better(g, idx, best, best_idx)) {
      best = g;
      best_idx = idx;
    }
  }
  if (lane == 0) {
    if (best_idx == NO_INDEX) best_idx = 0;  // every gain -inf: argmax is 0
    gain_out[row] = best;
    from_out[row] = frm[best_idx / n];
    to_out[row] = best_idx % n;
  }
}

// Scores C rows of S slots against n OSDs on `stream`; returns the CUDA error
// of the launch, 0 on success. dev, valid and dom are (n + 1,) with the
// sentinel at slot n; gain, from and to are (C,). staged = 1 stages the
// per-target arrays in shared memory (n <= UPMAP_STAGED_OSDS), 0 reads them
// from global memory.
extern "C" int upmap_score_launch(const int32_t* up, const float* dev,
                                  const uint8_t* valid, const int32_t* dom,
                                  float max_dev, int n, int S, long long C,
                                  float* gain, int32_t* from, int32_t* to,
                                  int staged, void* stream) {
  if (n < 1 || n > UPMAP_MAX_OSDS || S < 1 || S > UPMAP_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (staged && n > UPMAP_STAGED_OSDS) return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  const long long blocks = (C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (!staged) {
    upmap_score_kernel<false><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        up, dev, valid, dom, max_dev, n, S, C, gain, from, to);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)n * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        upmap_score_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  upmap_score_kernel<true><<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      up, dev, valid, dom, max_dev, n, S, C, gain, from, to);
  return (int)cudaGetLastError();
}

extern "C" const char* upmap_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
