// One-pass k-select over a group's candidate window, shared by the two window
// selects: select_windows.cu (the TPU kernel B1,
// probabilistic_point_clouds_registration_tpu/ops/fused_grid.py::_select_kernel)
// and select_bitonic.cu (the TPU kernel B4,
// probabilistic_point_clouds_registration_tpu/ops/select_bitonic.py::_bitonic_select_kernel).
//
// The JAX package has two kernels for one function because a loop of k
// minimum rounds and a sorting network are different programs on a TPU. On
// Hopper one filter-then-merge design serves both, so for k <= 32 both entry
// points run the code below; they stay two because the port keeps the JAX
// package's structure, fused_pool.class_select's rule and a launch counter
// each. Only select_windows.cu also keeps a rounds kernel, for k > 32.
//
// The contract, per source row of `padded` (8 rows, one group, share a
// window): d2 = (cx-sx)^2 + (cy-sy)^2 + (cz-sz)^2 against every lane of the
// window; a lane is live when its target id is >= 0, the row is valid,
// d2 <= r2, d2 < 3e38 and lo <= lane < min(hi, width_lut[window]); the k
// smallest live lanes come out in ascending (d2, lane) order as distance,
// target id and x/y/z, 32 slots a row, empty slots 3e38 / -1 / 0. d2 uses the
// round-to-nearest intrinsics, one rounded operation at a time, so that nvcc
// cannot contract it into FMAs and the plain PyTorch twin selects the same
// bits. Dead lanes carry 1e30 coordinates, whose d2 overflows to +inf.
//
// What bounds it on the card: bytes, and most of them the output (32 slots x
// 20 B a row, whatever the row found; a pass that only stored its empty slots
// would take about half of what the eight pooled passes take). What a kernel
// loses beyond that is the time a row's warp spends waiting: for its window,
// and in the dependent steps of compaction and merging. 64 registers a thread
// leave 32 warps on a multiprocessor to hide that, and a build that spills
// even a few words in the group loop runs a third slower, so every constant
// below is the one that kept the walk in registers (tools/
// bench_select_kernels.py --variants; PERF.md, section 6, has the numbers and
// what lost).
//
// Design (keys, the merge network and the staging buffer are
// topk_merge.cuh's). One warp per row.
//   1. Each lane's d2 is computed once. A warp step covers kLoads x 128
//      lanes: a thread takes 4 neighbouring lanes' x, y and z as three
//      16-byte loads and their ids as a fourth, all started before any test.
//      Segments start on multiples of 16 lanes; where the window's width or
//      base does not allow 16-byte loads, or a scan ends off a multiple of 4,
//      the same walk uses 4-byte loads (`kWide` false), so any width is
//      taken. No storage grows with the window: a 5,120-lane window is more
//      steps.
//   2. Filter first, sort rarely. A lane is tested by one float compare,
//      d2 <= thr, with thr = min(r2, d2 of the row's k-th key): the radius
//      is the first filter (most lanes of a 27-cell union lie outside the
//      sphere), then the k-th key, not the 32nd. The compare is not strict,
//      so it is right in whatever order lanes are tested; a tie with the
//      k-th key is staged and dropped by the merge.
//   3. A step's survivors are compacted, one warp vote per load slot (all
//      votes before any branch), into the row's 32-key staging buffer in
//      shared memory, and the buffer is merged into the running list only
//      when it fills and once at the end (topk::merge_staged_by_rank: most
//      rows merge once, a handful of keys into an empty list, which a sort by
//      rank through shared memory does without one shuffle; the bitonic merge
//      network runs where a list already stands). Between merges the
//      threshold is stale, which only admits extras; where a slot's survivors
//      do not fit, the buffer is merged first and they are tested again.
//   4. The result is one slot per lane, written once as five 128-byte rows.
//      A group on the dead window (every group of another width class in a
//      pooled pass) is written by the whole block with 16-byte stores, at the
//      rate of a plain fill, and nothing is read for it but its window row
//      and width. A block takes groups kBlocksPerSM x SMs apart, so those
//      groups cost no block launch each and a class's own groups, which are
//      neighbours, spread over the card; the next group's window row and
//      source row are read while this one is walked.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace wsel {

using topk::kFull;
using topk::kNone;

constexpr int kGroup = 8;         // source rows per group (= warps per block)
constexpr int kSlots = 32;        // output slots per row
constexpr float kEmptyD = 3e38f;  // outd of an empty slot
constexpr int kLoads = 1;         // sets of 16-byte loads per thread in flight
constexpr int kStep = 128 * kLoads;  // lanes per warp step
constexpr int kRankSort = 1;      // sort a staging buffer by rank, not by the shuffle network
constexpr int kBlocksPerSM = 8;   // grid size, in blocks per multiprocessor
constexpr int kMinBlocksPerSM = 4;  // resident blocks the kernels are compiled for

struct Args {
  const float* padded;
  const float* cand_xyz;
  const int* cand_idx;
  const int* step_rows;
  const int* width_lut;
  float* outd;
  int* outi;
  float* outx;
  float* outy;
  float* outz;
  int n_groups;
  int n_lanes;
  int k;
  float r2;
  int wide;  // 16-byte loads of the window are possible (set by plan())
};

// One window of the table: the x, y and z planes, n_lanes floats each and one
// behind the other, and the ids.
struct Window {
  const float* xyz;
  const int* id;
  int n_lanes;
};

__device__ __forceinline__ float dist2(float cx, float cy, float cz, float sx, float sy,
                                       float sz) {
  const float dx = __fsub_rn(cx, sx);
  const float dy = __fsub_rn(cy, sy);
  const float dz = __fsub_rn(cz, sz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Lanes [j, j + 4) of a plane; +inf (a d2 that passes no threshold) past
// `end`. kWide: j and end are multiples of 4 and the plane is 16-byte aligned.
template <bool kWide>
__device__ __forceinline__ void load4(const float* p, int j, int end, float (&v)[4]) {
  if (kWide) {
    const float4 q = j < end ? __ldg(reinterpret_cast<const float4*>(p + j))
                             : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                           CUDART_INF_F);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = j + c < end ? __ldg(p + j + c) : CUDART_INF_F;
  }
}

// The same for the ids; -1 (dead) past `end`.
template <bool kWide>
__device__ __forceinline__ void load_ids4(const int* p, int j, int end, int (&v)[4]) {
  if (kWide) {
    const int4 q = j < end ? __ldg(reinterpret_cast<const int4*>(p + j))
                           : make_int4(-1, -1, -1, -1);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = j + c < end ? __ldg(p + j + c) : -1;
  }
}

__device__ __forceinline__ Window window_of(const Args& a, int win) {
  return {a.cand_xyz + (long long)win * 3 * a.n_lanes,
          a.cand_idx + (long long)win * a.n_lanes, a.n_lanes};
}

struct Merged {
  unsigned long long run;  // the lane's slot of the merged list
  float thr;               // d2 of the k-th key (unchanged while fewer than k are held)
};

// Merge a row's staging buffer into its running list (`first`: the list is
// still empty). Not inlined: the walk calls it from every unrolled test.
static __device__ __noinline__ Merged merge_row(unsigned long long run, bool first,
                                                unsigned long long* stage, int count, int k,
                                                float thr) {
  const int lane = threadIdx.x & 31;
  run = kRankSort ? topk::merge_staged_by_rank(run, first, stage, count, lane)
                  : topk::merge_staged(run, stage, count, lane);
  const unsigned long long kth = __shfl_sync(kFull, run, k - 1);
  return {run, kth == kNone ? thr : __uint_as_float(topk::key_bits(kth))};
}

// The k smallest live lanes of [lo, end) for the warp's row: the lane's slot
// of the ascending list (kNone = empty). `thr` is min(r2, largest d2 below
// 3e38); `stage` is the warp's staging buffer.
template <bool kWide>
__device__ __forceinline__ unsigned long long select_row(const Window& w, float sx, float sy,
                                                         float sz, int lo, int end, int k,
                                                         float thr, unsigned long long* stage,
                                                         int lane) {
  unsigned long long run = kNone;  // running top 32, ascending across the lanes
  int count = 0;                   // keys in the staging buffer
  bool first = true;               // no merge yet: the list is empty

  auto flush = [&]() {
    const Merged merged = merge_row(run, first, stage, count, k, thr);
    run = merged.run;
    thr = merged.thr;
    count = 0;
    first = false;
  };

  for (int base = lo; base < end; base += kStep) {
    float d2[kLoads][4];
    int id[kLoads][4];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = base + (u * 32 + lane) * 4;
      float x[4], y[4], z[4];
      load4<kWide>(w.xyz, j, end, x);
      load4<kWide>(w.xyz + w.n_lanes, j, end, y);
      load4<kWide>(w.xyz + 2 * w.n_lanes, j, end, z);
      load_ids4<kWide>(w.id, j, end, id[u]);
#pragma unroll
      for (int c = 0; c < 4; ++c) d2[u][c] = dist2(x[c], y[c], z[c], sx, sy, sz);
    }
    // All votes first (they do not wait for each other); most steps hold no
    // candidate.
    unsigned votes[kLoads][4];
    unsigned any = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        votes[u][c] = __ballot_sync(kFull, d2[u][c] <= thr && id[u][c] >= 0);
        any |= votes[u][c];
      }
    }
    if (any == 0) continue;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned ballot = votes[u][c];
        if (ballot == 0) continue;
        bool live = (ballot >> lane) & 1u;
        if (count + __popc(ballot) > topk::kStage) {
          // Make room, and test again against the fresh threshold.
          flush();
          live = live && d2[u][c] <= thr;
          ballot = __ballot_sync(kFull, live);
        }
        count = topk::stage_append(
            stage, count, ballot, live,
            topk::make_key(__float_as_uint(d2[u][c]), base + (u * 32 + lane) * 4 + c), lane);
        if (count == topk::kStage) flush();
      }
    }
  }
  if (count > 0) flush();
  return run;
}

// A row's 32 slots: lane j writes slot j, the payload read from the window
// at the key's lane.
__device__ __forceinline__ void write_row(const Args& a, const Window& w,
                                          unsigned long long run, long long row, int lane) {
  const long long o = row * kSlots + lane;
  if (lane < a.k && run != kNone) {
    const int j = topk::key_index(run);
    a.outd[o] = __uint_as_float(topk::key_bits(run));
    a.outi[o] = w.id[j];
    a.outx[o] = w.xyz[j];
    a.outy[o] = w.xyz[w.n_lanes + j];
    a.outz[o] = w.xyz[2 * w.n_lanes + j];
  } else {
    a.outd[o] = kEmptyD;
    a.outi[o] = -1;
    a.outx[o] = 0.0f;
    a.outy[o] = 0.0f;
    a.outz[o] = 0.0f;
  }
}

// The empty slots of a whole group, by the block: per plane 8 rows x 128 B
// are contiguous, 64 stores of 16 bytes.
__device__ __forceinline__ void write_empty_group(const Args& a, int g) {
  const int plane = threadIdx.x >> 6;  // d, i, x, y; z by the first 64 threads
  const long long at = (long long)g * (kGroup * kSlots / 4) + (threadIdx.x & 63);
  const float minus_one = __int_as_float(-1);
  const float4 empty_d = make_float4(kEmptyD, kEmptyD, kEmptyD, kEmptyD);
  const float4 empty_i = make_float4(minus_one, minus_one, minus_one, minus_one);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (plane == 0) {
    reinterpret_cast<float4*>(a.outd)[at] = empty_d;
    reinterpret_cast<float4*>(a.outz)[at] = zero;
  } else if (plane == 1) {
    reinterpret_cast<float4*>(a.outi)[at] = empty_i;
  } else {
    reinterpret_cast<float4*>(plane == 2 ? a.outx : a.outy)[at] = zero;
  }
}

// Row meta (fused_grid.py::_unpack_row_meta): valid | lo/16 << 1 | hi/16 << 10.
__device__ __forceinline__ int meta_lo(int meta) { return ((meta >> 1) & 511) << 4; }
__device__ __forceinline__ int meta_hi(int meta) { return (meta >> 10) << 4; }

// The kernel's body: the block walks groups blockIdx.x, blockIdx.x +
// gridDim.x, ...; warp w takes row w of each. Warps do not wait for each
// other (a staging buffer belongs to one warp). A group's window row and
// source row are read one group ahead, so that a walk waits only for the
// width table and the window itself. `stage`: the warp's buffer of
// topk::kStage keys in shared memory.
__device__ __forceinline__ void select_groups(const Args& a, unsigned long long* stage) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // d2 <= r2 and d2 < 3e38 as one threshold (a NaN radius admits nothing).
  const float below_empty = __uint_as_float(__float_as_uint(kEmptyD) - 1u);
  const float thr0 = a.r2 >= below_empty ? below_empty : a.r2;
  int g = blockIdx.x;
  if (g >= a.n_groups) return;
  int win = a.step_rows[g];
  const float* src = a.padded + ((long long)g * kGroup + warp) * 4;
  float sx = src[0], sy = src[1], sz = src[2], fmeta = src[3];
  for (; g < a.n_groups; g += gridDim.x) {
    const int width = min(a.width_lut[win], a.n_lanes);
    int next_win = 0;
    float next_x = 0.0f, next_y = 0.0f, next_z = 0.0f, next_meta = 0.0f;
    if (g + gridDim.x < a.n_groups) {
      next_win = a.step_rows[g + gridDim.x];
      src = a.padded + ((long long)(g + gridDim.x) * kGroup + warp) * 4;
      next_x = src[0], next_y = src[1], next_z = src[2], next_meta = src[3];
    }
    if (width <= 0) {  // the dead window: nothing to scan for any row
      write_empty_group(a, g);
    } else {
      const Window w = window_of(a, win);
      const int meta = (int)fmeta;
      const int lo = meta_lo(meta);
      const int end = min(width, meta_hi(meta));
      unsigned long long run = kNone;
      if ((meta & 1) != 0 && lo < end) {
        run = (a.wide && (end & 3) == 0)
                  ? select_row<true>(w, sx, sy, sz, lo, end, a.k, thr0, stage, lane)
                  : select_row<false>(w, sx, sy, sz, lo, end, a.k, thr0, stage, lane);
      }
      write_row(a, w, run, (long long)g * kGroup + warp, lane);
    }
    win = next_win;
    sx = next_x, sy = next_y, sz = next_z, fmeta = next_meta;
  }
}

// Host side: whether the window table allows 16-byte loads, and the grid.
// The outputs must be 16-byte aligned (write_empty_group).
inline cudaError_t plan(Args& a, int* blocks) {
  const uintptr_t out = (uintptr_t)a.outd | (uintptr_t)a.outi | (uintptr_t)a.outx |
                        (uintptr_t)a.outy | (uintptr_t)a.outz;
  if ((out & 15u) != 0 || a.k < 1 || a.k > kSlots) return cudaErrorInvalidValue;
  a.wide = a.n_lanes % 4 == 0 &&
           (((uintptr_t)a.cand_xyz | (uintptr_t)a.cand_idx) & 15u) == 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = a.n_groups < kBlocksPerSM * sms ? a.n_groups : kBlocksPerSM * sms;
  return cudaSuccess;
}

}  // namespace wsel
