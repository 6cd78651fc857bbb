// upmap_score.cu — the upmap balancer's move scorer on Hopper: persistent
// blocks, one warp per PG row, the row's sources in registers.
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
// Bound: operations. One round at the balancer cell (1024 OSDs, 262,144
// rows of 3 and 32,768 of 6) scores 1.007e9 candidates, of which the
// function needs ~6.5 integer and ~2.9 float32 operations each: 0.390 ms at
// the H100's INT32 rate (chip_smoke.py SCORE_OPS). The inputs are a few MB,
// so bytes are no limit.
//
// The design, against the three costs of the first kernel (one warp per
// row of a block of 8, sources in per-warp shared memory, at 0.21 of that
// bound):
//  * Sources in registers. The kernel is instantiated on S for the widths
//    the balancer makes, S = 3 (a replicated size-3 pool) and S = 6
//    (EC(4,2)): lanes 0..S-1 load one slot each and a shuffle hands every
//    lane all S, fully unrolled, so the target loop reads no shared memory
//    for the sources. Any other S up to 32 takes the generic kernel, whose
//    sources stay in per-warp shared memory (same hoisting, the band bits
//    as one ballot mask).
//  * Row-invariant work hoisted out of the target loop. Once per row: a
//    slot that is not placed and reachable gets the source deviation -inf
//    (then fdev - tdev is never > 1); each slot's occupied domain (-1 for
//    NONE, which no valid target has); its "over the band" bit. A target
//    that is not valid or not reachable is staged with tdev = +inf and
//    domain -1, so no move to it is ever legal, and a target in the row
//    takes tdev = +inf for that row. Per target what is left is S compares
//    for the in-row test, S for the occupied-domain test, the band test of
//    the target, and per slot the two subtractions, the `> 1` test on the
//    rounded d, the domain and band tests and the argmax compare. The
//    register instantiations also drop the in-row test on rows whose
//    placed slots sit in distinct domains (every row CRUSH places), where
//    it cannot change the result (upmap_score_regs says why).
//  * Persistent blocks. The grid is the number of blocks that fit on the
//    card at once; each stages the per-target (tdev, tdom) pairs once, 8
//    bytes per OSD read as one 64-bit shared load, and its warps walk rows
//    in a grid-stride loop. 512 threads and two blocks per SM keep 32 warps
//    resident even at 10,000 OSDs (80 KB staged per block). Maps of more
//    than UPMAP_STAGED_OSDS OSDs, or staged = 0, read the targets from
//    global memory through the read-only cache, with the same structure.
//
// Order: each lane keeps, per slot, the first maximum over its targets
// (t ascending, strict >); across its slots the first maximum (s
// ascending, strict >), so its pick is the first maximum of its candidates
// in s * n + t order; a warp-shuffle reduction ordered by gain descending,
// then flat index ascending, gives the row's. The choice is never narrowed
// to one slot per target: fdev_a - tdev and fdev_b - tdev can round to the
// same float32 with fdev_a != fdev_b, and then the lower slot wins.
// The generic kernel keeps one running best compared by flat index, as its
// S is not known at compile time. Put into the register instantiations,
// that compare took 1.11 ms a balancer-cell round against 0.62 ms for the
// per-slot maxima, and 8.4 ms against 4.3 ms at 10,000 OSDs (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py phase 12 times the two side by side).
//
// Semantics match ceph_tpu_torch/crush/balance.py's score_chunk_plain bit for
// bit (gain compared as its float32 bits). Plain C interface for ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define UPMAP_MAX_SLOTS 32
#define UPMAP_STAGED_OSDS 28000
#define UPMAP_MAX_OSDS (1 << 24)  // keeps the flat index s * n + t in an int
#define NO_INDEX 0x7FFFFFFF

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float g, int idx, float best, int best_idx) {
  return g > best || (g == best && idx < best_idx);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (tdev, tdom) of target t: tdom -1 and tdev +inf where t is not valid or
// not reachable, so that no move to it is ever legal
__device__ __forceinline__ int2 target_entry(const float* __restrict__ dev,
                                             const uint8_t* __restrict__ valid,
                                             const int32_t* __restrict__ dom, int t) {
  const int d = __ldg(dom + t);
  const bool ok = __ldg(valid + t) != 0 && d >= 0;
  return make_int2(ok ? __float_as_int(__ldg(dev + t)) : 0x7f800000, ok ? d : -1);
}

template <bool kStaged>
__device__ __forceinline__ int2 target(const int2* s_tgt, const float* __restrict__ dev,
                                       const uint8_t* __restrict__ valid,
                                       const int32_t* __restrict__ dom, int t) {
  return kStaged ? s_tgt[t] : target_entry(dev, valid, dom, t);
}

template <bool kStaged>
__device__ __forceinline__ void stage(int2* s_tgt, const float* __restrict__ dev,
                                      const uint8_t* __restrict__ valid,
                                      const int32_t* __restrict__ dom, int n) {
  if (kStaged) {
    for (int t = threadIdx.x; t < n; t += kThreads) s_tgt[t] = target_entry(dev, valid, dom, t);
    __syncthreads();
  }
}

// Lane `lane` < S of a warp: slot `lane` of the row, raw id, deviation and
// domain as the plain version's clamped gather reads them (NONE and ids
// past n take slot n, the sentinel).
__device__ __forceinline__ void load_slot(const int32_t* __restrict__ up,
                                          const float* __restrict__ dev,
                                          const int32_t* __restrict__ dom, int n, int S,
                                          long long row, int lane, int& f, float& fdev,
                                          int& fdom) {
  f = -1;
  fdev = 0.0f;
  fdom = -1;
  if (lane < S) {
    f = __ldg(up + row * S + lane);
    const int fc = f >= 0 ? min(f, n) : n;
    fdev = __ldg(dev + fc);
    fdom = __ldg(dom + fc);
  }
}

// The warp's best (gain, flat index) into lane 0, first maximum on ties.
__device__ __forceinline__ void warp_best(float& best, int& best_idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float g = __shfl_down_sync(kFull, best, off);
    const int idx = __shfl_down_sync(kFull, best_idx, off);
    if (better(g, idx, best, best_idx)) {
      best = g;
      best_idx = idx;
    }
  }
}

// One lane's walk over its targets t = lane, lane + 32, ... for one row whose
// sources are in registers, keeping per slot the first maximum (t
// ascending, strict >). kInRowTest = false leaves out the in-row test,
// for rows where it cannot change the result (see upmap_score_regs).
template <int S, bool kStaged, bool kInRowTest>
__device__ __forceinline__ void walk_targets(
    const int2* s_tgt, const float* __restrict__ dev, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ dom, float max_dev, int n, int lane, const int (&frm)[S],
    const int (&odom)[S], const float (&src)[S], const bool (&over)[S], float (&best)[S],
    int (&best_t)[S]) {
  const float inf = pos_inf();
#pragma unroll 1
  for (int t = lane; t < n; t += 32) {
    const int2 e = target<kStaged>(s_tgt, dev, valid, dom, t);
    const int tdom = e.y;
    float tdev = __int_as_float(e.x);
    bool occ = false;
#pragma unroll
    for (int s = 0; s < S; ++s) occ |= odom[s] == tdom;
    if (kInRowTest) {
      bool in_up = false;
#pragma unroll
      for (int s = 0; s < S; ++s) in_up |= frm[s] == t;
      if (in_up) tdev = inf;
    }
    const bool under = tdev < -max_dev;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float d = src[s] - tdev;
      const float g = d - 1.0f;
      const bool ok = d > 1.0f && (over[s] || under) && (!occ || odom[s] == tdom);
      if (ok && g > best[s]) {
        best[s] = g;
        best_t[s] = t;
      }
    }
  }
}

// S = 3 or 6: the row's sources in registers.
template <int S, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
upmap_score_regs(const int32_t* __restrict__ up, const float* __restrict__ dev,
                 const uint8_t* __restrict__ valid, const int32_t* __restrict__ dom,
                 float max_dev, int n, long long C, float* __restrict__ gain_out,
                 int32_t* __restrict__ from_out, int32_t* __restrict__ to_out) {
  extern __shared__ int2 s_tgt[];
  stage<kStaged>(s_tgt, dev, valid, dom, n);
  const int lane = threadIdx.x & 31;
  const float inf = pos_inf();
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < C;
       row += stride) {
    int f, fdom;
    float fdev;
    load_slot(up, dev, dom, n, S, row, lane, f, fdev, fdom);
    int frm[S], odom[S];
    float src[S];
    bool over[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      frm[s] = __shfl_sync(kFull, f, s);
      const float fd = __shfl_sync(kFull, fdev, s);
      const int fm = __shfl_sync(kFull, fdom, s);
      odom[s] = frm[s] >= 0 ? fm : -1;
      src[s] = frm[s] >= 0 && fm >= 0 ? fd : -inf;  // placed and reachable
      over[s] = fd > max_dev;
    }
    // Where the row's placed slots sit in distinct domains (as CRUSH places
    // them), the in-row test cannot change the result: a target in the row
    // occupies its own slot's domain and no other slot's, so only that slot
    // passes the domain rule, and there d = fdev - fdev is 0 (NaN for an
    // infinite deviation), never > 1. Uniform across the warp.
    bool distinct = true;
#pragma unroll
    for (int a = 0; a < S; ++a)
#pragma unroll
      for (int b = a + 1; b < S; ++b) distinct &= odom[a] < 0 || odom[a] != odom[b];
    float best[S];
    int best_t[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      best[s] = -inf;
      best_t[s] = 0;
    }
    if (distinct)
      walk_targets<S, kStaged, false>(s_tgt, dev, valid, dom, max_dev, n, lane, frm, odom, src,
                                      over, best, best_t);
    else
      walk_targets<S, kStaged, true>(s_tgt, dev, valid, dom, max_dev, n, lane, frm, odom, src,
                                     over, best, best_t);
    float bg = -inf;
    int bi = NO_INDEX;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (best[s] > bg) {
        bg = best[s];
        bi = s * n + best_t[s];
      }
    }
    warp_best(bg, bi);
    if (lane == 0) {
      if (bi == NO_INDEX) bi = 0;  // every gain -inf: argmax is 0
      const int bs = bi / n;
      int from = frm[0];
#pragma unroll
      for (int s = 1; s < S; ++s)
        if (s == bs) from = frm[s];
      gain_out[row] = bg;
      from_out[row] = from;
      to_out[row] = bi - bs * n;
    }
  }
}

// Any S up to 32: the row's sources in per-warp shared memory, the
// row-invariant bits hoisted as for the register instantiations.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
upmap_score_generic(const int32_t* __restrict__ up, const float* __restrict__ dev,
                    const uint8_t* __restrict__ valid, const int32_t* __restrict__ dom,
                    float max_dev, int n, int S, long long C,
                    float* __restrict__ gain_out, int32_t* __restrict__ from_out,
                    int32_t* __restrict__ to_out) {
  extern __shared__ int2 s_tgt[];
  __shared__ int32_t s_frm[kWarps][UPMAP_MAX_SLOTS];
  __shared__ int32_t s_odom[kWarps][UPMAP_MAX_SLOTS];
  __shared__ float s_src[kWarps][UPMAP_MAX_SLOTS];
  stage<kStaged>(s_tgt, dev, valid, dom, n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inf = pos_inf();
  const int32_t* frm = s_frm[warp];
  const int32_t* odom = s_odom[warp];
  const float* src = s_src[warp];
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < C; row += stride) {
    int f, fdom;
    float fdev;
    load_slot(up, dev, dom, n, S, row, lane, f, fdev, fdom);
    if (lane < S) {
      s_frm[warp][lane] = f;
      s_odom[warp][lane] = f >= 0 ? fdom : -1;
      s_src[warp][lane] = f >= 0 && fdom >= 0 ? fdev : -inf;
    }
    const unsigned over = __ballot_sync(kFull, lane < S && fdev > max_dev);
    __syncwarp();
    float best = -inf;
    int best_idx = NO_INDEX;
    for (int t = lane; t < n; t += 32) {
      const int2 e = target<kStaged>(s_tgt, dev, valid, dom, t);
      const int tdom = e.y;
      bool in_up = false, occ = false;
      for (int s = 0; s < S; ++s) {
        in_up |= frm[s] == t;
        occ |= odom[s] == tdom;
      }
      const float tdev = in_up ? inf : __int_as_float(e.x);
      const bool under = tdev < -max_dev;
      for (int s = 0; s < S; ++s) {
        const float d = src[s] - tdev;
        const float g = d - 1.0f;
        const bool ok = d > 1.0f && (((over >> s) & 1u) || under) && (!occ || odom[s] == tdom);
        const int idx = s * n + t;
        if (ok && better(g, idx, best, best_idx)) {
          best = g;
          best_idx = idx;
        }
      }
    }
    warp_best(best, best_idx);
    if (lane == 0) {
      if (best_idx == NO_INDEX) best_idx = 0;  // every gain -inf: argmax is 0
      const int bs = best_idx / n;
      gain_out[row] = best;
      from_out[row] = frm[bs];
      to_out[row] = best_idx - bs * n;
    }
    __syncwarp();  // the row's sources are read before the next row's land
  }
}

// Launches `kernel` persistently: as many blocks as fit on the card at
// once, no more than the rows need.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), bool staged, int n, long long C, cudaStream_t stream,
           A... args) {
  const size_t smem = staged ? (size_t)n * sizeof(int2) : 0;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long needed = (C + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * per_sm;
  kernel<<<(unsigned)(needed < resident ? needed : resident), kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Scores C rows of S slots against n OSDs on `stream`; returns the CUDA error
// of the launch, 0 on success. dev, valid and dom are (n + 1,) with the
// sentinel at slot n; gain, from and to are (C,). staged = 1 stages the
// per-target arrays in shared memory (n <= UPMAP_STAGED_OSDS), 0 reads them
// from global memory. S = 3 and S = 6 take the register instantiations,
// any other S the generic one.
extern "C" int upmap_score_launch(const int32_t* up, const float* dev,
                                  const uint8_t* valid, const int32_t* dom,
                                  float max_dev, int n, int S, long long C,
                                  float* gain, int32_t* from, int32_t* to,
                                  int staged, void* stream) {
  if (n < 1 || n > UPMAP_MAX_OSDS || S < 1 || S > UPMAP_MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (staged && n > UPMAP_STAGED_OSDS) return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool stg = staged != 0;
  if (S == 3)
    return launch(stg ? upmap_score_regs<3, true> : upmap_score_regs<3, false>, stg, n, C, st,
                  up, dev, valid, dom, max_dev, n, C, gain, from, to);
  if (S == 6)
    return launch(stg ? upmap_score_regs<6, true> : upmap_score_regs<6, false>, stg, n, C, st,
                  up, dev, valid, dom, max_dev, n, C, gain, from, to);
  return launch(stg ? upmap_score_generic<true> : upmap_score_generic<false>, stg, n, C, st,
                up, dev, valid, dom, max_dev, n, S, C, gain, from, to);
}

extern "C" const char* upmap_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
