// Warp-level running top 32 of 64-bit keys, shared by the exact selections
// that stream their candidates past a warp: the brute-force KNN kernel
// (brute_knn.cu, the TPU kernel B3,
// probabilistic_point_clouds_registration_tpu/ops/neighbors_pallas.py::_kernel),
// the row top-k kernel (row_topk.cu, the TPU kernel B2,
// probabilistic_point_clouds_registration_tpu/ops/select_pallas.py::_select_kernel)
// and, through window_select.cuh, the two window selects (select_windows.cu
// and select_bitonic.cu, the TPU kernels B1 and B4).
//
// A key is float_bits(value) << 32 | index. The bits of a non-negative float
// (and of +inf) order like the float, so key order is exactly (value, index)
// order and all keys of a row differ. A row's running list lives one slot
// per lane, ascending over the lanes, ~0 = slot not filled.
//
// What bounds a selection on this card is not the sorting network but how
// often it runs: one merge is 15 + 5 compare-exchange stages, each two
// shuffles, a 64-bit compare and selects (about 150 warp operations), and
// after a row's first candidates almost every group of 32 candidates holds
// none or one that can still enter. So both kernels filter first and sort
// rarely: a candidate is tested against the value of the row's k-th key by
// one compare; the survivors of a group are compacted (a warp ballot and
// popc in brute_knn.cu, a warp scan of per-lane counts in row_topk.cu) into
// the row's staging buffer of 32 keys in shared memory; the network runs only
// when that buffer is full, and once at the end of the stream. The threshold
// is refreshed after each merge. Between merges it is stale, which means
// looser: it admits candidates a fresh one would reject and never rejects one
// that belongs, and the merge drops the extra ones. The result is the same
// keys in the same order as merging every group.

#pragma once

#include <cuda_runtime.h>

namespace topk {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
constexpr int kStage = 32;  // keys per staging buffer (one per lane at a merge)

__device__ __forceinline__ unsigned long long make_key(unsigned value_bits, int idx) {
  return ((unsigned long long)value_bits << 32) | (unsigned)idx;
}

__device__ __forceinline__ unsigned key_bits(unsigned long long key) {
  return (unsigned)(key >> 32);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(key & 0xffffffffull);
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

// Merge 32 keys (one per lane, ~0 = none) into the running ascending top 32
// `run`.
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
  // 2. lane-wise min of ascending `run` and the descending chunk: the
  // bitonic sequence of the 32 smallest of both.
  run = key < run ? key : run;
  // 3. bitonic clean-up, ascending.
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    run = cmp_swap(run, stride, (lane & stride) == 0);
  }
  return run;
}

// Compaction: the lanes with `live` set append their keys to the staging
// buffer behind its `count` keys, in lane order; `ballot` is the warp's vote
// on `live`. The caller has made room (count + popc(ballot) <= kStage).
// Returns the new count.
__device__ __forceinline__ int stage_append(unsigned long long* stage, int count,
                                            unsigned ballot, bool live,
                                            unsigned long long key, int lane) {
  if (live) stage[count + __popc(ballot & ((1u << lane) - 1u))] = key;
  return count + __popc(ballot);
}

// Merge the staging buffer's `count` keys into `run`. The warp barriers
// order the appends before the reads and the reads before later appends.
__device__ __forceinline__ unsigned long long merge_staged(unsigned long long run,
                                                           const unsigned long long* stage,
                                                           int count, int lane) {
  __syncwarp();
  const unsigned long long key = lane < count ? stage[lane] : kNone;
  __syncwarp();
  return merge_chunk(run, key, lane);
}

// The same merge for callers whose buffers are rarely full and whose rows
// mostly merge once (the window selects): the buffer is sorted by rank, not
// by the network. Each lane counts the staged keys below its own (keys
// differ, so ranks do), the keys change places in shared memory, and the
// lanes read them back in order. `run_empty` (the same for the whole warp):
// nothing was merged yet, and the sorted buffer is the list. Otherwise the
// buffer is read back descending and the bitonic merge (lane-wise minimum,
// 5 compare-exchange stages) joins it to the list. A handful of staged keys
// costs a handful of shared-memory reads a lane and no shuffle, where the
// network takes 15 dependent stages whatever the count.
__device__ __forceinline__ unsigned long long merge_staged_by_rank(unsigned long long run,
                                                                   bool run_empty,
                                                                   unsigned long long* stage,
                                                                   int count, int lane) {
  __syncwarp();
  const unsigned long long mine = lane < count ? stage[lane] : kNone;
  int rank = 0;
  for (int i = 0; i < count; ++i) rank += stage[i] < mine ? 1 : 0;
  __syncwarp();
  if (lane < count) stage[rank] = mine;
  __syncwarp();
  const int from = run_empty ? lane : kStage - 1 - lane;
  const unsigned long long key = from < count ? stage[from] : kNone;
  __syncwarp();
  if (run_empty) return key;
  run = key < run ? key : run;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    run = cmp_swap(run, stride, (lane & stride) == 0);
  }
  return run;
}

}  // namespace topk
