// Bitonic k-select for the pooled search, for Hopper (sm_90a).
//
// Replaces the TPU kernel B4 of the JAX package,
// probabilistic_point_clouds_registration_tpu/ops/select_bitonic.py::_bitonic_select_kernel
// (launched by run_select_bitonic). Its contract is B1's
// (csrc/select_windows.cu), per source row of `padded`:
//   d2 = (cx-sx)^2 + (cy-sy)^2 + (cz-sz)^2 against every lane of the row's
//   group window; a lane is live when its target id is >= 0, the row is
//   valid, d2 <= r2 and lo <= lane < hi (the row-meta segment); the k
//   smallest live lanes come out in ascending (d2, lane) order as distance,
//   target id and x/y/z. Empty slots hold 3e38 / -1 / 0. k <= 32 and the
//   output has 32 slots.
//
// Design. One warp per source row, 8 warps (one group of 8 rows sharing a
// window) per block; the window is read straight from the pool through
// step_rows, and only lanes [0, width_lut[window]) are walked, in 32-lane
// chunks, from the chunk holding the segment's first lane to its end. Keys
// are 64 bits, float_bits(d2) << 32 | lane (bits of a non-negative float
// order like the float); a dead lane's key is float_bits(3e38) << 32 | lane,
// so it loses to every live key. Each lane of the warp holds one slot of a
// running ascending top 32. Per chunk:
//   1. the chunk's 32 keys are sorted DESCENDING across the warp by the
//      bitonic network (15 compare-exchange stages through __shfl_xor_sync);
//   2. the lane-wise minimum with the running list (ascending) is the
//      bitonic sequence of the 32 smallest keys of both;
//   3. a 5-stage bitonic clean-up sorts it ascending again.
// A chunk with no live key below the running 32nd key is skipped: it cannot
// change a found slot. Slot j < k is then lane j's key; its payload (id,
// x/y/z) is read from the window at that key's lane.
//
// What bounds it on the card: 21 shuffle stages of a 64-bit key (two
// 32-bit shuffles, a compare and two selects each) per 32-lane chunk per
// row, against B1's k passes over the window; the window's 16 bytes per lane
// are read once per row, shared by the block's 8 warps through L1. The
// chunk skip removes the network for chunks that cannot contribute, which
// is most chunks once the running list holds k near candidates.
//
// d2 uses the round-to-nearest intrinsics so that nvcc cannot contract it
// into FMAs: the result is then bit-equal to the plain PyTorch twin (one
// rounded op at a time). Dead lanes carry 1e30 coordinates, whose d2
// overflows to inf and fails the radius test.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 8;         // source rows per group (= warps per block)
constexpr int kSlots = 32;        // output slots per row
constexpr float kEmptyD = 3e38f;  // outd of an empty slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long shfl_xor64(unsigned long long v, int m) {
  return __shfl_xor_sync(kFull, v, m);
}

// Compare-exchange with the partner at XOR distance `stride`: the lane keeps
// the smaller key when `keep_min`, else the larger.
__device__ __forceinline__ unsigned long long cmp_swap(unsigned long long v, int stride,
                                                       bool keep_min) {
  const unsigned long long o = shfl_xor64(v, stride);
  return keep_min ? (o < v ? o : v) : (o > v ? o : v);
}

__global__ void __launch_bounds__(kGroup * 32)
select_bitonic_kernel(const float* __restrict__ padded,
                      const float* __restrict__ cand_xyz,
                      const int* __restrict__ cand_idx,
                      const int* __restrict__ step_rows,
                      const int* __restrict__ width_lut,
                      float* __restrict__ outd, int* __restrict__ outi,
                      float* __restrict__ outx, float* __restrict__ outy,
                      float* __restrict__ outz, int n_lanes, int k, float r2) {
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
  const unsigned long long dead_hi = (unsigned long long)__float_as_uint(kEmptyD) << 32;

  // Running top 32, ascending across the lanes; ~0 marks a slot not filled.
  unsigned long long run = ~0ull;
  if (valid) {
    for (int base = lo & ~31; base < end; base += 32) {
      const int j = base + lane;
      unsigned long long key = dead_hi | (unsigned)j;
      bool live = false;
      if (j >= lo && j < end) {
        const int id = ci[j];
        const float dx = __fsub_rn(cx[j], sx);
        const float dy = __fsub_rn(cy[j], sy);
        const float dz = __fsub_rn(cz[j], sz);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (id >= 0 && d2 <= r2 && d2 < kEmptyD) {
          key = ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)j;
          live = true;
        }
      }
      const unsigned long long worst = __shfl_sync(kFull, run, 31);
      if (!__any_sync(kFull, live && key < worst)) continue;
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
    }
  }

  const long long o = row * kSlots + lane;
  if (lane < k && run < dead_hi) {
    const int j = (int)(run & 0xffffffffull);
    outd[o] = __uint_as_float((unsigned)(run >> 32));
    outi[o] = ci[j];
    outx[o] = cx[j];
    outy[o] = cy[j];
    outz[o] = cz[j];
  } else {
    outd[o] = kEmptyD;
    outi[o] = -1;
    outx[o] = 0.0f;
    outy[o] = 0.0f;
    outz[o] = 0.0f;
  }
}

}  // namespace

// Launch over n_groups groups of 8 rows on `stream`; returns the launch's
// cudaError_t (0 = launched). Outputs are (n_groups * 8, 32) row-major.
extern "C" int select_bitonic_launch(const float* padded, const float* cand_xyz,
                                     const int* cand_idx, const int* step_rows,
                                     const int* width_lut, float* outd, int* outi,
                                     float* outx, float* outy, float* outz,
                                     int n_groups, int n_lanes, int k, float r2,
                                     void* stream) {
  if (n_groups == 0) return 0;
  select_bitonic_kernel<<<n_groups, kGroup * 32, 0, (cudaStream_t)stream>>>(
      padded, cand_xyz, cand_idx, step_rows, width_lut, outd, outi, outx, outy,
      outz, n_lanes, k, r2);
  return (int)cudaGetLastError();
}
