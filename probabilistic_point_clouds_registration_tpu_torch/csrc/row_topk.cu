// Row-wise top-k-smallest selection, for Hopper (sm_90a).
//
// Replaces the TPU kernel B2 of the JAX package,
// probabilistic_point_clouds_registration_tpu/ops/select_pallas.py::_select_kernel
// (launched by pallas_row_topk). The contract, per row of the (n, w) float32
// matrix `d2` (every entry >= +0 or +inf; +inf marks a masked entry; NaN is
// outside the contract): the k smallest entries, ascending, as value and
// column, ties broken by the lowest column, 1 <= k <= w. A row with fewer
// than k finite entries fills up with its lowest +inf columns, which is what
// a stable sort of the row gives, so kernel and twin agree in every slot;
// callers still mask by isfinite(value).
//
// What bounds it on the card: bytes. Each entry is read once (4 bytes) and
// k * 8 bytes per row are written, so the kernel is as fast as it keeps
// device memory busy. A warp that reads 128 bytes, votes, and only then
// reads the next 128 has too few bytes in flight to do that, and sorting
// every group of 32 that holds one survivor keeps the warp from its loads.
//
// Design (keys and the merge are topk_merge.cuh's). One warp per row, 8 rows
// per block.
//   k <= 32: the row is read as float4, kLoads independent 16-byte loads per
//   lane started before any test (kLoads * 512 bytes per warp in flight). The
//   row's 0-3 columns before the first 16-byte boundary and its last 0-3
//   columns go through 4-byte loads, so any row length and any
//   4-byte-aligned base are taken. An entry is tested
//   as a float: the columns of a batch of loads lie above every column in
//   the running list, so "beats the k-th key" is `bits(value) < bits(k-th
//   value)`, one unsigned compare (valid for values >= +0 and +inf), and
//   keys are built only for survivors. Until the list holds k keys the
//   threshold is +inf's bits, so only finite entries ever pass; a row that
//   ends with fewer than k finite entries then takes its lowest +inf
//   columns in a short second pass over its first columns (most entries are
//   +inf, so that is one or two 128-byte reads), which gives an all-+inf
//   row its lowest columns without sorting any +inf. A batch with no
//   survivor costs its loads, 4 * kLoads compares and one vote. Survivors
//   are few and scattered: each lane counts its own, a warp scan gives it
//   its place in the row's staging buffer, and it appends them without
//   further votes; the buffer is merged when it fills (see topk_merge.cuh).
//   Where a batch holds more survivors than the buffer has room for (a
//   row's first batch), one vote per load slot compacts them and merges on
//   the way. All tests of a batch use the threshold from before the batch:
//   a merge inside it brings in columns above some the batch has yet to
//   test, for which the float compare is no longer the key compare (there
//   `<=` against the fresh threshold is still safe, and is used).
//   k > 32: round r takes the smallest key above round r-1's (one pass over
//   the row per round, a warp minimum), as the window-select kernel does.

#include <cuda_runtime.h>

#include "topk_merge.cuh"

namespace {

using topk::kFull;
using topk::kNone;

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kLoads = 4;         // float4 loads per lane in flight (k <= 32)
constexpr unsigned kInf = 0x7f800000u;    // bits of +inf: the threshold until k finite keys are held
constexpr unsigned kNever = 0xffffffffu;  // bits that pass no threshold

struct Merged {
  unsigned long long run;  // the lane's slot of the merged list
  unsigned thr;            // bits of the k-th key's value (+inf: not yet k keys)
};

// Merge a row's staging buffer into its running list. Not inlined: the
// kernel calls it from every unrolled test, and the network is long.
__device__ __noinline__ Merged merge_row(unsigned long long run, const unsigned long long* stage,
                                         int count, int k) {
  const int lane = threadIdx.x & 31;
  run = topk::merge_staged(run, stage, count, lane);
  const unsigned long long kth = __shfl_sync(kFull, run, k - 1);
  return {run, kth == kNone ? kInf : topk::key_bits(kth)};
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
row_topk_kernel(const float* __restrict__ d2, float* __restrict__ out_v,
                int* __restrict__ out_i, int n, int w, int k) {
  __shared__ unsigned long long stage_s[kRowsPerBlock][topk::kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= n) return;  // the whole warp leaves together
  const float* x = d2 + row * w;
  unsigned long long* stage = stage_s[warp];

  unsigned long long run = kNone;  // running top 32, ascending across the lanes
  unsigned thr = kInf;             // bits of the k-th key's value
  int count = 0;                   // keys in the staging buffer

  auto flush = [&]() {
    const Merged merged = merge_row(run, stage, count, k);
    run = merged.run;
    thr = merged.thr;
    count = 0;
  };
  // One entry per lane (`live`: it passed the batch's threshold).
  auto take = [&](bool live, unsigned bits, int col) {
    const unsigned ballot = __ballot_sync(kFull, live);
    if (ballot == 0) return;
    if (count + __popc(ballot) > topk::kStage) flush();
    count = topk::stage_append(stage, count, ballot, live, topk::make_key(bits, col), lane);
    if (count == topk::kStage) flush();
  };
  // 32 columns from `c0` through 4-byte loads, columns >= `end` left out.
  auto take_scalar = [&](int c0, int end) {
    const int col = c0 + lane;
    const unsigned bits = col < end ? __float_as_uint(x[col]) : kNever;
    take(bits < thr, bits, col);
  };

  // Head: the 0-3 columns before the first 16-byte boundary.
  const int head = min(w, (int)((16u - (unsigned)((size_t)x & 15u)) & 15u) >> 2);
  if (head > 0) take_scalar(0, head);

  // Body: float4 batches.
  const uint4* x4 = reinterpret_cast<const uint4*>(x + head);
  const int n4 = (w - head) >> 2;
  for (int v0 = 0; v0 < n4; v0 += 32 * kLoads) {
    uint4 q[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = v0 + u * 32 + lane;
      q[u] = v < n4 ? __ldg(x4 + v) : make_uint4(kNever, kNever, kNever, kNever);
    }
    const unsigned t = thr;  // the whole batch is tested against this
    bool any = false;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      any |= (q[u].x < t) | (q[u].y < t) | (q[u].z < t) | (q[u].w < t);
    }
    if (!__any_sync(kFull, any)) continue;
    // Survivors are few and scattered: each lane counts its own, a warp
    // scan gives it its place in the staging buffer, and it appends them
    // without further votes.
    int mine = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      mine += (q[u].x < t) + (q[u].y < t) + (q[u].z < t) + (q[u].w < t);
    }
    int upto = mine;  // inclusive scan over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int below = __shfl_up_sync(kFull, upto, off);
      if (lane >= off) upto += below;
    }
    const int total = __shfl_sync(kFull, upto, 31);
    if (count + total <= topk::kStage) {
      int at = count + upto - mine;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int col = head + ((v0 + u * 32 + lane) << 2);
        if (q[u].x < t) stage[at++] = topk::make_key(q[u].x, col);
        if (q[u].y < t) stage[at++] = topk::make_key(q[u].y, col + 1);
        if (q[u].z < t) stage[at++] = topk::make_key(q[u].z, col + 2);
        if (q[u].w < t) stage[at++] = topk::make_key(q[u].w, col + 3);
      }
      count += total;
      if (count == topk::kStage) flush();
      continue;
    }
    // More than the buffer has room for (the row's first batches): one vote
    // per load slot, merging as the buffer fills.
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int col = head + ((v0 + u * 32 + lane) << 2);
      // `<= thr`: a merge inside the batch tightens the test, ties kept.
      take(q[u].x < t && q[u].x <= thr, q[u].x, col);
      take(q[u].y < t && q[u].y <= thr, q[u].y, col + 1);
      take(q[u].z < t && q[u].z <= thr, q[u].z, col + 2);
      take(q[u].w < t && q[u].w <= thr, q[u].w, col + 3);
    }
  }

  // Tail: the last 0-3 columns.
  const int tail = head + (n4 << 2);
  if (tail < w) take_scalar(tail, w);
  if (count > 0) flush();

  float* ov = out_v + row * k;
  int* oi = out_i + row * k;
  if (lane < k && run != kNone) {
    ov[lane] = __uint_as_float(topk::key_bits(run));
    oi[lane] = topk::key_index(run);
  }
  // Fewer than k finite entries: the slots behind them take the row's
  // lowest +inf columns, in column order (k <= w, so there are enough).
  int filled = __popc(__ballot_sync(kFull, run != kNone));
  for (int c0 = 0; filled < k && c0 < w; c0 += 32) {
    const int col = c0 + lane;
    const bool masked = col < w && __float_as_uint(x[col]) == kInf;
    const unsigned ballot = __ballot_sync(kFull, masked);
    const int slot = filled + __popc(ballot & ((1u << lane) - 1u));
    if (masked && slot < k) {
      ov[slot] = __uint_as_float(kInf);
      oi[slot] = col;
    }
    filled += __popc(ballot);
  }
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
row_topk_rounds_kernel(const float* __restrict__ d2, float* __restrict__ out_v,
                       int* __restrict__ out_i, int n, int w, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const float* x = d2 + row * w;
  float* ov = out_v + row * k;
  int* oi = out_i + row * k;

  unsigned long long floor_key = 0;  // smallest key the round may take
  for (int r = 0; r < k; ++r) {
    unsigned long long best = kNone;
    for (int j = lane; j < w; j += 32) {
      const unsigned long long key = topk::make_key(__float_as_uint(x[j]), j);
      if (key >= floor_key && key < best) best = key;
    }
    best = topk::warp_min(best);
    floor_key = best + 1;
    if (lane == 0) {
      ov[r] = __uint_as_float(topk::key_bits(best));
      oi[r] = topk::key_index(best);
    }
  }
}

}  // namespace

// Launch over the n rows of the row-major (n, w) matrix `d2` (any 4-byte
// aligned base) on `stream`; returns the launch's cudaError_t (0 =
// launched). Outputs are (n, k) row-major. The caller guarantees
// 1 <= k <= w.
extern "C" int row_topk_launch(const float* d2, float* out_v, int* out_i, int n,
                               int w, int k, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (k <= 32) {
    row_topk_kernel<<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        d2, out_v, out_i, n, w, k);
  } else {
    row_topk_rounds_kernel<<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        d2, out_v, out_i, n, w, k);
  }
  return (int)cudaGetLastError();
}
