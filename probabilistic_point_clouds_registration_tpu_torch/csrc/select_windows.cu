// Window select for the fused grouped search, for Hopper (sm_90a).
//
// Replaces the TPU kernel B1 of the JAX package,
// probabilistic_point_clouds_registration_tpu/ops/fused_grid.py::_select_kernel
// (launched by _run_select). The contract, per source row of `padded`:
//   d2 = (cx-sx)^2 + (cy-sy)^2 + (cz-sz)^2 against every lane of the row's
//   group window; a lane is live when its target id is >= 0, the row is
//   valid, d2 <= r2 and lo <= lane < hi (the row-meta segment); the k
//   smallest live lanes come out in ascending (d2, lane) order as distance,
//   target id and x/y/z. Empty slots hold 3e38 / -1 / 0.
//
// Design. One warp per source row, 8 warps (one group of 8 rows sharing a
// window) per block. The kernel reads the window straight from the prepacked
// table, cand_xyz[step_rows[g]], instead of a per-group gathered copy, and
// scans only [0, width_lut[window]) lanes: lanes past a window's union are
// dead by construction. Round r takes the smallest 64-bit key
// (float_bits(d2) << 32 | lane) not below the previous round's key + 1 (bits
// of a non-negative float order like the float), so the rounds emit exactly
// the (d2, lane) order and the loop stops when no live lane is left. No
// storage grows with the window width (dense windows may exceed 4096 lanes).
//
// What bounds it on the card: it recomputes every lane's d2 in each of the
// k rounds, so its cost is k * width lane evaluations per row, each a
// 16-byte read of the window (x, y, z, id) that the block's 8 warps share
// through L1. That is a simple design that is right; keeping the window in
// shared memory or selecting in one pass is work for later.
//
// d2 uses the round-to-nearest intrinsics so that nvcc cannot contract it
// into FMAs: the result is then bit-equal to the plain PyTorch twin (one
// rounded op at a time). Dead lanes carry 1e30 coordinates, whose d2
// overflows to inf and fails the radius test.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;           // source rows per group (= warps per block)
constexpr float kEmptyD = 3e38f;    // outd of an empty slot
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void __launch_bounds__(kGroup * 32)
select_windows_kernel(const float* __restrict__ padded,
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
        const float dx = __fsub_rn(cx[j], sx);
        const float dy = __fsub_rn(cy[j], sy);
        const float dz = __fsub_rn(cz[j], sz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (id >= 0 && d2 <= r2 && d2 < kEmptyD) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)j;
          if (key >= floor_key && key < best) best = key;
        }
      }
      best = warp_min(best);
      if (best == kNone) break;
      floor_key = best + 1;
      if (lane == 0) {
        const int j = (int)(best & 0xffffffffull);
        od[found] = __uint_as_float((unsigned)(best >> 32));
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
// cudaError_t (0 = launched). Outputs are (n_groups * 8, kp) row-major.
extern "C" int select_windows_launch(const float* padded, const float* cand_xyz,
                                     const int* cand_idx, const int* step_rows,
                                     const int* width_lut, float* outd, int* outi,
                                     float* outx, float* outy, float* outz,
                                     int n_groups, int n_lanes, int k, int kp,
                                     float r2, void* stream) {
  if (n_groups == 0) return 0;
  select_windows_kernel<<<n_groups, kGroup * 32, 0, (cudaStream_t)stream>>>(
      padded, cand_xyz, cand_idx, step_rows, width_lut, outd, outi, outx, outy,
      outz, n_lanes, k, kp, r2);
  return (int)cudaGetLastError();
}
