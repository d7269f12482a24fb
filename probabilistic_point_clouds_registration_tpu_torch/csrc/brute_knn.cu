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
// What bounds it on the card: operations, and under this contract not the
// FMA rate. Without contraction a pair costs 3 multiplies, 3 adds or
// subtracts, the multiply by 2, the clamp and the compare: about 10 unfused
// float32 operations on the CUDA cores, so n * m * 10 over the rate at which
// the card starts them is the floor, above the 9-flop bound at the FMA rate. The
// tensor cores are not used: the product has depth 3, and TF32 (or any
// split of the float32 product) would round the distances differently and
// change which neighbour wins the k-th slot. What the kernel can lose beyond
// the floor is the selection (sorting networks), waiting for targets, and
// warps with too little independent work.
//
// Design (keys and the merge are topk_merge.cuh's), k <= 32:
//   1. A pre-kernel packs the target once per search as float4
//      (x, y, z, t2), t2 = +inf for an invalid target (its d2 is +inf and
//      never selected), padded with such entries to a whole tile, into a
//      scratch buffer the caller allocates. Blocks no longer rebuild it.
//   2. A block streams the packed target through a ring of kStages tiles in
//      shared memory. One thread starts the TMA's 1-D bulk copy
//      (cp.async.bulk) of a tile onto the stage's "full" mbarrier; each warp
//      arrives on the stage's "empty" mbarrier when it is done with a tile,
//      and the same thread refills the stage that was freed one tile ago, so
//      no warp waits for another and loads overlap the arithmetic.
//   3. A warp takes kRows source rows; each lane evaluates one target of a
//      32-target group for all of them (one 16-byte shared-memory read feeds
//      kRows evaluations, which are independent and run back to back).
//   4. Filter first, sort rarely. Targets arrive in ascending index, so a
//      candidate beats the running k-th key exactly when its d2 is below
//      that key's d2: one float compare (on the distance before the clamp,
//      which is never larger, so it only admits more). One warp vote covers
//      the group's kRows rows; only when it finds a candidate do the rows
//      vote one by one (all votes before any branch), and the survivors are
//      compacted into the row's staging buffer and merged into the running
//      list, which also lives in shared memory, only when the buffer fills
//      (see topk_merge.cuh). Rows past n carry a threshold of -inf and take
//      nothing.
//   Measured on an H100 (tools/bench_select_kernels.py --no-candidates):
//   with thresholds that admit nothing the loop alone takes 0.55 ms of the
//   0.94 ms for 35,840 x 35,840 and 6.6 of the 8.3 ms for 131,072 x 131,072
//   (11 machine operations per row and group: 8 float32 operations, the
//   compare, and a share of the shared-memory read, the vote and the
//   branch); the candidates' votes, appends and merges are the rest, about
//   250-300 staged keys and 9-10 merges a row.
//   The multiply by 2 is not folded into pre-scaled source coordinates: it
//   is exact except where a product is subnormal, and there the twin would
//   differ.
//   k > 32: one warp per row; round r takes the smallest key above round
//   r-1's in one pass over the target (k passes: slow, and right).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

using topk::kFull;
using topk::kNone;

constexpr int kWarps = 8;          // warps per block (k <= 32)
constexpr int kRows = 4;           // source rows per warp (k <= 32)
constexpr int kTile = 512;         // targets per shared-memory tile (8 KB)
constexpr int kStages = 3;         // tiles in the ring
constexpr int kTileBytes = kTile * (int)sizeof(float4);
// Resident warps per SM the search kernel is compiled for: 64 registers a
// thread. Left to itself ptxas takes 93, and the loop alone runs 7-13% slower.
constexpr int kWarpsPerSM = 32;
constexpr int kRoundsWarps = 8;    // warps per block of the k > 32 kernel

__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The expansion distance before the clamp, one rounded operation at a time.
__device__ __forceinline__ float expansion_raw(float sx, float sy, float sz, float s2,
                                               float tx, float ty, float tz, float t2) {
  const float cross =
      __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)), __fmul_rn(sz, tz));
  return __fsub_rn(__fadd_rn(s2, t2), __fmul_rn(2.0f, cross));
}

__device__ __forceinline__ float expansion_d2(float sx, float sy, float sz, float s2,
                                              float tx, float ty, float tz, float t2) {
  return fmaxf(expansion_raw(sx, sy, sz, s2, tx, ty, tz, t2), 0.0f);
}

// -- mbarriers and the bulk copy (PTX) ---------------------------------------

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: expect `bytes` on `bar`, then copy them from global to shared
// memory asynchronously. Addresses and size are multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- the pre-kernel ------------------------------------------------------------

__global__ void __launch_bounds__(256)
brute_knn_pack_kernel(const float* __restrict__ tgt, const unsigned char* __restrict__ tvalid,
                      float4* __restrict__ packed, int m, int m_padded) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m_padded) return;
  float4 t = make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
  if (j < m && tvalid[j]) {
    t.x = tgt[(long long)j * 3 + 0];
    t.y = tgt[(long long)j * 3 + 1];
    t.z = tgt[(long long)j * 3 + 2];
    t.w = sum_sq(t.x, t.y, t.z);
  }
  packed[j] = t;
}

// -- k <= 32 -----------------------------------------------------------------

// Merge a row's staging buffer into its running list; returns the new
// threshold, the d2 of the k-th key (+inf while fewer than k are held).
__device__ __noinline__ float merge_row(unsigned long long* run, const unsigned long long* stage,
                                        int count, int k) {
  const int lane = threadIdx.x & 31;
  const unsigned long long merged = topk::merge_staged(run[lane], stage, count, lane);
  run[lane] = merged;
  const unsigned long long kth = __shfl_sync(kFull, merged, k - 1);
  return kth == kNone ? CUDART_INF_F : __uint_as_float(topk::key_bits(kth));
}

// Dynamic shared memory: the ring, every row's running list and staging
// buffer, and the ring's mbarriers.
constexpr int kSharedBytes = kStages * kTileBytes +
                             2 * kWarps * kRows * topk::kStage * (int)sizeof(unsigned long long) +
                             2 * kStages * (int)sizeof(unsigned long long);

__global__ void __launch_bounds__(kWarps * 32, kWarpsPerSM / kWarps)
brute_knn_kernel(const float* __restrict__ src, const float4* __restrict__ packed,
                 int* __restrict__ out_i, float* __restrict__ out_d, int n, int m,
                 int n_tiles, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  unsigned long long* run_s = reinterpret_cast<unsigned long long*>(smem + kStages * kTileBytes);
  unsigned long long* stage_s = run_s + kWarps * kRows * topk::kStage;
  unsigned long long* bars = stage_s + kWarps * kRows * topk::kStage;
  const uint32_t ring_a = shared_addr(ring);
  const uint32_t full_a = shared_addr(bars);             // kStages "tile has arrived"
  const uint32_t empty_a = shared_addr(bars + kStages);  // kStages "every warp is done"

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = ((long long)blockIdx.x * kWarps + warp) * kRows;
  unsigned long long* run_w = run_s + warp * kRows * topk::kStage;
  unsigned long long* stage_w = stage_s + warp * kRows * topk::kStage;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages && s < n_tiles; ++s) {
      bulk_load(ring_a + s * kTileBytes, packed + (long long)s * kTile, kTileBytes,
                full_a + 8 * s);
    }
  }

  float sx[kRows], sy[kRows], sz[kRows], s2[kRows];
  float thr[kRows];  // d2 of the running k-th key
  int count[kRows];  // keys in the row's staging buffer
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = row0 + r;
    const bool in_range = row < n;
    sx[r] = in_range ? src[row * 3 + 0] : 0.0f;
    sy[r] = in_range ? src[row * 3 + 1] : 0.0f;
    sz[r] = in_range ? src[row * 3 + 2] : 0.0f;
    s2[r] = sum_sq(sx[r], sy[r], sz[r]);
    thr[r] = in_range ? CUDART_INF_F : -CUDART_INF_F;  // rows past n take nothing
    count[r] = 0;
    run_w[r * topk::kStage + lane] = kNone;
  }
  __syncwarp();

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full_a + 8 * s, (t / kStages) & 1);
    const float4* tile = ring + s * kTile + lane;  // this lane's target of each group
#pragma unroll 2
    for (int c = 0; c < kTile; c += 32) {
      const float4 tg = tile[c];
      const int j = t * kTile + c + lane;
      float raw[kRows];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        raw[r] = expansion_raw(sx[r], sy[r], sz[r], s2[r], tg.x, tg.y, tg.z, tg.w);
        any |= raw[r] < thr[r];
      }
      // One vote for the group: most groups hold no candidate for any row.
      if (!__any_sync(kFull, any)) continue;
      unsigned ballots[kRows];  // all votes first: they do not wait for each other
#pragma unroll
      for (int r = 0; r < kRows; ++r) ballots[r] = __ballot_sync(kFull, raw[r] < thr[r]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        unsigned ballot = ballots[r];
        if (ballot == 0) continue;
        bool live = raw[r] < thr[r];
        unsigned long long* run = run_w + r * topk::kStage;
        unsigned long long* stage = stage_w + r * topk::kStage;
        if (count[r] + __popc(ballot) > topk::kStage) {
          // Make room, and test again against the fresh threshold: the list
          // still holds lower indices only.
          thr[r] = merge_row(run, stage, count[r], k);
          count[r] = 0;
          live = raw[r] < thr[r];
          ballot = __ballot_sync(kFull, live);
        }
        const unsigned long long key =
            topk::make_key(__float_as_uint(fmaxf(raw[r], 0.0f)), j);
        count[r] = topk::stage_append(stage, count[r], ballot, live, key, lane);
        if (count[r] == topk::kStage) {
          thr[r] = merge_row(run, stage, count[r], k);
          count[r] = 0;
        }
      }
    }
    // This warp is done with the tile.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_a + 8 * s);
    // Refill the stage that was freed one tile ago: by now every warp has
    // most likely left it.
    if (threadIdx.x == 0 && t >= 1 && t - 1 + kStages < n_tiles) {
      const int ps = (t - 1) % kStages;
      mbar_wait(empty_a + 8 * ps, ((t - 1) / kStages) & 1);
      bulk_load(ring_a + ps * kTileBytes, packed + (long long)(t - 1 + kStages) * kTile,
                kTileBytes, full_a + 8 * ps);
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    unsigned long long* run = run_w + r * topk::kStage;
    if (count[r] > 0) merge_row(run, stage_w + r * topk::kStage, count[r], k);
    const long long row = row0 + r;
    if (row < n && lane < k) {
      const unsigned long long key = run[lane];
      const bool filled = key != kNone;
      out_i[row * k + lane] = filled ? topk::key_index(key) : m;
      out_d[row * k + lane] = filled ? __uint_as_float(topk::key_bits(key)) : CUDART_INF_F;
    }
  }
}

// -- k > 32 --------------------------------------------------------------------

__global__ void __launch_bounds__(kRoundsWarps * 32)
brute_knn_rounds_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                        const unsigned char* __restrict__ tvalid,
                        int* __restrict__ out_i, float* __restrict__ out_d, int n,
                        int m, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRoundsWarps + (threadIdx.x >> 5);
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
        const unsigned long long key = topk::make_key(__float_as_uint(d2), j);
        if (key >= floor_key && key < best) best = key;
      }
    }
    best = topk::warp_min(best);
    if (best == kNone) break;
    floor_key = best + 1;
    if (lane == 0) {
      oi[found] = topk::key_index(best);
      od[found] = __uint_as_float(topk::key_bits(best));
    }
  }
  for (int s = found + lane; s < k; s += 32) {
    oi[s] = m;
    od[s] = CUDART_INF_F;
  }
}

}  // namespace

// Launch over n source rows (n, 3) against m targets (m, 3) with validity
// bytes (m,) on `stream`; returns the cudaError_t of the launches (0 =
// launched). `packed` is scratch of `m_padded` x 4 floats, 16-byte aligned,
// m_padded = m rounded up to a whole tile of 512 targets (checked; used for
// k <= 32).
// Outputs are (n, k) row-major: target index (m = none) and expansion d2.
extern "C" int brute_knn_launch(const float* src, const float* tgt,
                                const unsigned char* tvalid, float* packed, int m_padded,
                                int* out_i, float* out_d, int n, int m, int k, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k > 32) {
    brute_knn_rounds_kernel<<<(n + kRoundsWarps - 1) / kRoundsWarps, kRoundsWarps * 32, 0, st>>>(
        src, tgt, tvalid, out_i, out_d, n, m, k);
    return (int)cudaGetLastError();
  }
  const int n_tiles = (m + kTile - 1) / kTile;
  if (m_padded != n_tiles * kTile || ((size_t)packed & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_tiles > 0) {
    brute_knn_pack_kernel<<<(m_padded + 255) / 256, 256, 0, st>>>(
        tgt, tvalid, reinterpret_cast<float4*>(packed), m, m_padded);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // Granted explicitly: with larger constants it passes the 48 KB a kernel
  // gets unasked.
  const cudaError_t err = cudaFuncSetAttribute(
      brute_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = kWarps * kRows;
  brute_knn_kernel<<<(n + rows - 1) / rows, kWarps * 32, kSharedBytes, st>>>(
      src, reinterpret_cast<const float4*>(packed), out_i, out_d, n, m, n_tiles, k);
  return (int)cudaGetLastError();
}
