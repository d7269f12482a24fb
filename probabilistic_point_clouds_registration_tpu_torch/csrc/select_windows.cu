// Window select for the fused grouped search, for Hopper (sm_90a).
//
// Replaces the TPU kernel B1 of the JAX package,
// probabilistic_point_clouds_registration_tpu/ops/fused_grid.py::_select_kernel
// (launched by _run_select). The contract, per source row of `padded`:
//   d2 = (cx-sx)^2 + (cy-sy)^2 + (cz-sz)^2 against every lane of the row's
//   group window; a lane is live when its target id is >= 0, the row is
//   valid, d2 <= r2 and lo <= lane < hi (the row-meta segment); the k
//   smallest live lanes come out in ascending (d2, lane) order as distance,
//   target id and x/y/z. Empty slots hold 3e38 / -1 / 0. Any window width;
//   kp output slots a row, 32 for k <= 32.
//
// The kernels read the window straight from the prepacked table,
// cand_xyz[step_rows[g]], instead of a per-group gathered copy, and scan only
// [0, width_lut[window]) lanes: lanes past a window's union are dead by
// construction. No storage grows with the window width (dense windows may
// exceed 4096 lanes).
//
// k <= 32: window_select.cuh's one-pass walk, the same code the bitonic
// select B4 (select_bitonic.cu) runs: each lane's d2 is computed once, a lane
// is tested by one float compare against min(r2, the k-th key's d2), the
// survivors are merged rarely, and each row's slots are written once. That
// header says what bounds it on the card (bytes, most of them the output) and
// what the design does about it. The two entry points remain because the
// port keeps the JAX package's structure: this one takes any width and is
// the select of the dense engine and of a pooled class B4 does not take.
//
// k > 32: one warp per row; round r takes the smallest 64-bit key
// (float_bits(d2) << 32 | lane) not below the previous round's key + 1 (bits
// of a non-negative float order like the float), so the rounds emit exactly
// the (d2, lane) order and the loop stops when no live lane is left. It
// recomputes every lane's d2 in each of the k rounds (k passes: slow, and
// right), as the k > 32 kernels of row_topk.cu and brute_knn.cu do.

#include <cuda_runtime.h>

#include "window_select.cuh"

namespace {

using topk::kNone;
using wsel::kEmptyD;
using wsel::kGroup;

__global__ void __launch_bounds__(kGroup * 32, wsel::kMinBlocksPerSM)
select_windows_kernel(const wsel::Args a) {
  __shared__ unsigned long long stage_s[kGroup][topk::kStage];
  wsel::select_groups(a, stage_s[threadIdx.x >> 5]);
}

__global__ void __launch_bounds__(kGroup * 32)
select_windows_rounds_kernel(const float* __restrict__ padded,
                             const float* __restrict__ cand_xyz,
                             const int* __restrict__ cand_idx,
                             const int* __restrict__ step_rows,
                             const int* __restrict__ width_lut,
                             float* __restrict__ outd, int* __restrict__ outi,
                             float* __restrict__ outx, float* __restrict__ outy,
                             float* __restrict__ outz,
                             int n_lanes, int k, int kp, float r2) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kGroup + (threadIdx.x >> 5);
  const int win = step_rows[blockIdx.x];
  const float* cx = cand_xyz + (long long)win * 3 * n_lanes;
  const float* cy = cx + n_lanes;
  const float* cz = cy + n_lanes;
  const int* ci = cand_idx + (long long)win * n_lanes;

  const float sx = padded[row * 4 + 0];
  const float sy = padded[row * 4 + 1];
  const float sz = padded[row * 4 + 2];
  // Row meta (fused_grid.py::_unpack_row_meta): valid | lo/16 << 1 | hi/16 << 10.
  const int meta = (int)padded[row * 4 + 3];
  const bool valid = (meta & 1) != 0;
  const int lo = ((meta >> 1) & 511) << 4;
  const int hi = (meta >> 10) << 4;
  const int end = min(min(width_lut[win], hi), n_lanes);

  float* od = outd + row * kp;
  int* oi = outi + row * kp;
  float* ox = outx + row * kp;
  float* oy = outy + row * kp;
  float* oz = outz + row * kp;

  int found = 0;
  if (valid) {
    unsigned long long floor_key = 0;  // smallest key the round may take
    for (; found < k; ++found) {
      unsigned long long best = kNone;
      for (int j = lo + lane; j < end; j += 32) {
        const int id = ci[j];
        const float d2 = wsel::dist2(cx[j], cy[j], cz[j], sx, sy, sz);
        if (id >= 0 && d2 <= r2 && d2 < kEmptyD) {
          const unsigned long long key = topk::make_key(__float_as_uint(d2), j);
          if (key >= floor_key && key < best) best = key;
        }
      }
      best = topk::warp_min(best);
      if (best == kNone) break;
      floor_key = best + 1;
      if (lane == 0) {
        const int j = topk::key_index(best);
        od[found] = __uint_as_float(topk::key_bits(best));
        oi[found] = ci[j];
        ox[found] = cx[j];
        oy[found] = cy[j];
        oz[found] = cz[j];
      }
    }
  }
  for (int s = found + lane; s < kp; s += 32) {
    od[s] = kEmptyD;
    oi[s] = -1;
    ox[s] = 0.0f;
    oy[s] = 0.0f;
    oz[s] = 0.0f;
  }
}

}  // namespace

// Launch over n_groups groups of 8 rows on `stream`; returns the launch's
// cudaError_t (0 = launched). Outputs are (n_groups * 8, kp) row-major; for
// k <= 32, kp is 32 and the outputs are 16-byte aligned (checked).
extern "C" int select_windows_launch(const float* padded, const float* cand_xyz,
                                     const int* cand_idx, const int* step_rows,
                                     const int* width_lut, float* outd, int* outi,
                                     float* outx, float* outy, float* outz,
                                     int n_groups, int n_lanes, int k, int kp,
                                     float r2, void* stream) {
  if (n_groups == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (k > wsel::kSlots) {
    select_windows_rounds_kernel<<<n_groups, kGroup * 32, 0, st>>>(
        padded, cand_xyz, cand_idx, step_rows, width_lut, outd, outi, outx, outy,
        outz, n_lanes, k, kp, r2);
    return (int)cudaGetLastError();
  }
  if (kp != wsel::kSlots) return (int)cudaErrorInvalidValue;
  wsel::Args a = {padded, cand_xyz, cand_idx, step_rows, width_lut, outd, outi, outx,
                  outy,   outz,     n_groups, n_lanes,   k,         r2,   0};
  int blocks = 0;
  const cudaError_t err = wsel::plan(a, &blocks);
  if (err != cudaSuccess) return (int)err;
  select_windows_kernel<<<blocks, kGroup * 32, 0, st>>>(a);
  return (int)cudaGetLastError();
}
