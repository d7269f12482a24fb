// Bitonic k-select for the pooled search, for Hopper (sm_90a).
//
// Replaces the TPU kernel B4 of the JAX package,
// probabilistic_point_clouds_registration_tpu/ops/select_bitonic.py::_bitonic_select_kernel
// (launched by run_select_bitonic). Its contract is B1's
// (csrc/select_windows.cu), per source row of `padded`: the k smallest live
// lanes of the row's group window in ascending (d2, lane) order as distance,
// target id and x/y/z, with k <= 32 and 32 output slots, empty slots
// 3e38 / -1 / 0. window_select.cuh states it in full.
//
// What bounds it on the card, and the design: window_select.cuh. The kernel
// is that header's one-pass walk, which B1 runs too for k <= 32: each lane's
// d2 once, one float compare against min(r2, the k-th key's d2), survivors
// compacted into a 32-key staging buffer, and the bitonic merge network
// (topk_merge.cuh: 15 + 5 compare-exchange stages through __shfl_xor_sync)
// only when the buffer fills and once at the end. The network is what is
// left of the TPU kernel's scheme, a bitonic sort of every 32-lane chunk
// merged into a running top 32: on this card the sort is the expensive part
// and the filter makes it rare. This entry point stays beside B1's because
// the pooled search picks its select per width class
// (fused_pool.class_select: power-of-two widths and k <= 32 come here) and
// counts this kernel's launches apart.

#include <cuda_runtime.h>

#include "window_select.cuh"

namespace {

__global__ void __launch_bounds__(wsel::kGroup * 32, wsel::kMinBlocksPerSM)
select_bitonic_kernel(const wsel::Args a) {
  __shared__ unsigned long long stage_s[wsel::kGroup][topk::kStage];
  wsel::select_groups(a, stage_s[threadIdx.x >> 5]);
}

}  // namespace

// Launch over n_groups groups of 8 rows on `stream`; returns the launch's
// cudaError_t (0 = launched). Outputs are (n_groups * 8, 32) row-major and
// 16-byte aligned; 1 <= k <= 32 (checked).
extern "C" int select_bitonic_launch(const float* padded, const float* cand_xyz,
                                     const int* cand_idx, const int* step_rows,
                                     const int* width_lut, float* outd, int* outi,
                                     float* outx, float* outy, float* outz,
                                     int n_groups, int n_lanes, int k, float r2,
                                     void* stream) {
  if (n_groups == 0) return 0;
  wsel::Args a = {padded, cand_xyz, cand_idx, step_rows, width_lut, outd, outi, outx,
                  outy,   outz,     n_groups, n_lanes,   k,         r2,   0};
  int blocks = 0;
  const cudaError_t err = wsel::plan(a, &blocks);
  if (err != cudaSuccess) return (int)err;
  select_bitonic_kernel<<<blocks, wsel::kGroup * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
