// Brute-force k-nearest-neighbour selection over the whole target, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel B3 of the JAX package,
// probabilistic_point_clouds_registration_tpu/ops/neighbors_pallas.py::_kernel
// (launched by pallas_radius_search). The contract, per source row: over all
// valid targets, the k of smallest matmul-expansion squared distance
//   d2 = max((s2 + t2) - 2 * cross, 0),   cross = (sx*tx + sy*ty) + sz*tz,
//   s2 = (sx*sx + sy*sy) + sz*sz,         t2 likewise,
// in float32, one rounded operation at a time in exactly this order (the
// round-to-nearest intrinsics keep nvcc from contracting it into FMAs, so the
// plain PyTorch twin, which spells out the same order, selects bit-equal
// sets). Ties go to the lowest target index: a later equal distance never
// replaces an earlier one, as in the TPU kernel (`row_min < row_max`, strict).
// The result comes out in ascending (d2, index) order; a row with fewer than
// k valid targets fills up with (inf, m). There is no radius here: the
// wrapper recomputes exact distances of the selected targets and masks.
//
// Design. Keys are 64 bits, float_bits(d2) << 32 | target index (bits of a
// non-negative float order like the float).
//   k <= 32: a block of 8 warps takes 32 source rows, 4 per warp, and streams
//   the target through shared memory in tiles of 1024 points stored as
//   (x, y, z, t2), t2 = +inf for an invalid target (its d2 is then +inf and
//   never selected). Each lane evaluates one target of a 32-target chunk for
//   each of the warp's 4 rows (one 16-byte shared-memory read feeds 4
//   evaluations). Per row the lanes hold a running ascending top 32 of keys.
//   Targets arrive in ascending index order, so a candidate beats the running
//   k-th key exactly when its d2 is below that key's d2: the chunk is skipped
//   by a warp vote on `d2 < threshold` (the TPU kernel's tile early-out, per
//   row and per 32 targets); otherwise its live keys are sorted descending
//   across the warp (bitonic network through __shfl_xor_sync), the lane-wise
//   minimum with the running list is the bitonic sequence of the 32 smallest
//   of both, and a 5-stage clean-up sorts it ascending again.
//   k > 32: one warp per row; round r takes the smallest key above round
//   r-1's in one pass over the target (k passes: slow, and right).
//
// What bounds it on the card: operations. n * m distance evaluations of ~12
// float32 operations each on the CUDA cores (K = 3: nothing for the tensor
// cores), plus the network for the chunks that still contribute; the target's
// 16 bytes per point are read from device memory once per block and the
// output is k * 8 bytes per row.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;         // warps per block
constexpr int kRowsPerWarp = 4;   // source rows per warp (k <= 32)
constexpr int kTile = 1024;       // targets per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The expansion distance, one rounded operation at a time.
__device__ __forceinline__ float expansion_d2(float sx, float sy, float sz, float s2,
                                              float tx, float ty, float tz, float t2) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)), __fmul_rn(sz, tz));
  return fmaxf(__fsub_rn(__fadd_rn(s2, t2), __fmul_rn(2.0f, cross)), 0.0f);
}

__device__ __forceinline__ unsigned long long make_key(float d2, int idx) {
  return ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)idx;
}

// Compare-exchange with the partner at XOR distance `stride`: the lane keeps
// the smaller key when `keep_min`, else the larger.
__device__ __forceinline__ unsigned long long cmp_swap(unsigned long long v, int stride,
                                                       bool keep_min) {
  const unsigned long long o = __shfl_xor_sync(kFull, v, stride);
  return keep_min ? (o < v ? o : v) : (o > v ? o : v);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Merge a chunk's 32 keys (one per lane, ~0 = none) into the running
// ascending top 32 `run`.
__device__ __forceinline__ unsigned long long merge_chunk(unsigned long long run,
                                                          unsigned long long key, int lane) {
  // 1. bitonic sort of the chunk, descending at the last merge.
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    const bool desc = (lane & size) == 0;  // run direction at this size
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
      key = cmp_swap(key, stride, lower != desc);
    }
  }
  // 2. lane-wise min of ascending `run` and the descending chunk.
  run = key < run ? key : run;
  // 3. bitonic clean-up, ascending.
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    run = cmp_swap(run, stride, (lane & stride) == 0);
  }
  return run;
}

__global__ void __launch_bounds__(kWarps * 32)
brute_knn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 const unsigned char* __restrict__ tvalid, int* __restrict__ out_i,
                 float* __restrict__ out_d, int n, int m, int k) {
  __shared__ float4 tile[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 =
      ((long long)blockIdx.x * kWarps + warp) * kRowsPerWarp;

  float sx[kRowsPerWarp], sy[kRowsPerWarp], sz[kRowsPerWarp], s2[kRowsPerWarp];
  float thr[kRowsPerWarp];             // d2 of the running k-th key
  unsigned long long run[kRowsPerWarp];  // running top 32, ascending over lanes
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + r;
    const bool in_range = row < n;
    sx[r] = in_range ? src[row * 3 + 0] : 0.0f;
    sy[r] = in_range ? src[row * 3 + 1] : 0.0f;
    sz[r] = in_range ? src[row * 3 + 2] : 0.0f;
    s2[r] = sum_sq(sx[r], sy[r], sz[r]);
    thr[r] = in_range ? CUDART_INF_F : -1.0f;  // rows past n take nothing
    run[r] = kNone;
  }

  for (int t0 = 0; t0 < m; t0 += kTile) {
    for (int i = threadIdx.x; i < kTile; i += kWarps * 32) {
      const int j = t0 + i;
      float4 t = make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
      if (j < m && tvalid[j]) {
        t.x = tgt[(long long)j * 3 + 0];
        t.y = tgt[(long long)j * 3 + 1];
        t.z = tgt[(long long)j * 3 + 2];
        t.w = sum_sq(t.x, t.y, t.z);
      }
      tile[i] = t;
    }
    __syncthreads();
    const int count = min(kTile, m - t0);
    for (int c = 0; c < count; c += 32) {
      const float4 t = tile[c + lane];
      const int j = t0 + c + lane;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float d2 = expansion_d2(sx[r], sy[r], sz[r], s2[r], t.x, t.y, t.z, t.w);
        const bool live = d2 < thr[r];
        if (__any_sync(kFull, live)) {
          run[r] = merge_chunk(run[r], live ? make_key(d2, j) : kNone, lane);
          const unsigned long long kth = __shfl_sync(kFull, run[r], k - 1);
          thr[r] = kth == kNone ? CUDART_INF_F : __uint_as_float((unsigned)(kth >> 32));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + r;
    if (row < n && lane < k) {
      const bool filled = run[r] != kNone;
      out_i[row * k + lane] = filled ? (int)(run[r] & 0xffffffffull) : m;
      out_d[row * k + lane] =
          filled ? __uint_as_float((unsigned)(run[r] >> 32)) : CUDART_INF_F;
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
brute_knn_rounds_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                        const unsigned char* __restrict__ tvalid,
                        int* __restrict__ out_i, float* __restrict__ out_d, int n,
                        int m, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const float sx = src[row * 3 + 0];
  const float sy = src[row * 3 + 1];
  const float sz = src[row * 3 + 2];
  const float s2 = sum_sq(sx, sy, sz);
  int* oi = out_i + row * k;
  float* od = out_d + row * k;

  unsigned long long floor_key = 0;  // smallest key the round may take
  int found = 0;
  for (; found < k; ++found) {
    unsigned long long best = kNone;
    for (int j = lane; j < m; j += 32) {
      if (!tvalid[j]) continue;
      const float tx = tgt[(long long)j * 3 + 0];
      const float ty = tgt[(long long)j * 3 + 1];
      const float tz = tgt[(long long)j * 3 + 2];
      const float d2 = expansion_d2(sx, sy, sz, s2, tx, ty, tz, sum_sq(tx, ty, tz));
      if (d2 < CUDART_INF_F) {
        const unsigned long long key = make_key(d2, j);
        if (key >= floor_key && key < best) best = key;
      }
    }
    best = warp_min(best);
    if (best == kNone) break;
    floor_key = best + 1;
    if (lane == 0) {
      oi[found] = (int)(best & 0xffffffffull);
      od[found] = __uint_as_float((unsigned)(best >> 32));
    }
  }
  for (int s = found + lane; s < k; s += 32) {
    oi[s] = m;
    od[s] = CUDART_INF_F;
  }
}

}  // namespace

// Launch over n source rows (n, 3) against m targets (m, 3) with validity
// bytes (m,) on `stream`; returns the launch's cudaError_t (0 = launched).
// Outputs are (n, k) row-major: target index (m = none) and expansion d2.
extern "C" int brute_knn_launch(const float* src, const float* tgt,
                                const unsigned char* tvalid, int* out_i, float* out_d,
                                int n, int m, int k, void* stream) {
  if (n == 0) return 0;
  if (k <= 32) {
    const int rows = kWarps * kRowsPerWarp;
    brute_knn_kernel<<<(n + rows - 1) / rows, kWarps * 32, 0, (cudaStream_t)stream>>>(
        src, tgt, tvalid, out_i, out_d, n, m, k);
  } else {
    brute_knn_rounds_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
                              (cudaStream_t)stream>>>(src, tgt, tvalid, out_i, out_d,
                                                      n, m, k);
  }
  return (int)cudaGetLastError();
}
