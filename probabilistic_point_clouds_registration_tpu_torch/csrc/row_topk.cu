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
// Design. Keys are 64 bits, float_bits(d2) << 32 | column: the bits of a
// non-negative float (and of +inf) order like the float, so key order is
// exactly (value, column) order and all keys of a row differ. One warp per
// row, 8 rows per block.
//   k <= 32: each lane holds one slot of a running ascending top 32. The row
//   is walked in 32-column chunks (coalesced 128-byte reads). A chunk with no
//   key below the running k-th key cannot change slots [0, k) and is skipped
//   by a warp vote; otherwise its keys are sorted descending across the warp
//   (bitonic network through __shfl_xor_sync), the lane-wise minimum with the
//   running list is the bitonic sequence of the 32 smallest of both, and a
//   5-stage clean-up sorts it ascending again. Columns past w carry the key
//   ~0, which never enters.
//   k > 32: round r takes the smallest key above round r-1's (one pass over
//   the row per round, a warp minimum), as the window-select kernel does.
//
// What bounds it on the card: bytes. Each entry is read once (4 bytes) and
// k * 8 bytes per row are written; the network runs only for chunks that can
// still contribute, which after the first chunks of a row are few (most
// entries of the grid search's matrix are +inf).

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float v, int col) {
  return ((unsigned long long)__float_as_uint(v) << 32) | (unsigned)col;
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

__global__ void __launch_bounds__(kRowsPerBlock * 32)
row_topk_kernel(const float* __restrict__ d2, float* __restrict__ out_v,
                int* __restrict__ out_i, int n, int w, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const float* x = d2 + row * w;
  float* ov = out_v + row * k;
  int* oi = out_i + row * k;

  if (k <= 32) {
    // Running top 32, ascending across the lanes; ~0 marks a slot not filled.
    unsigned long long run = kNone;
    for (int base = 0; base < w; base += 32) {
      const int j = base + lane;
      unsigned long long key = j < w ? make_key(x[j], j) : kNone;
      const unsigned long long kth = __shfl_sync(kFull, run, k - 1);
      if (!__any_sync(kFull, key < kth)) continue;
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
    if (lane < k) {  // k <= w: slot `lane` holds a real key
      ov[lane] = __uint_as_float((unsigned)(run >> 32));
      oi[lane] = (int)(run & 0xffffffffull);
    }
    return;
  }

  unsigned long long floor_key = 0;  // smallest key the round may take
  for (int r = 0; r < k; ++r) {
    unsigned long long best = kNone;
    for (int j = lane; j < w; j += 32) {
      const unsigned long long key = make_key(x[j], j);
      if (key >= floor_key && key < best) best = key;
    }
    best = warp_min(best);
    floor_key = best + 1;
    if (lane == 0) {
      ov[r] = __uint_as_float((unsigned)(best >> 32));
      oi[r] = (int)(best & 0xffffffffull);
    }
  }
}

}  // namespace

// Launch over the n rows of the row-major (n, w) matrix `d2` on `stream`;
// returns the launch's cudaError_t (0 = launched). Outputs are (n, k)
// row-major. The caller guarantees 1 <= k <= w.
extern "C" int row_topk_launch(const float* d2, float* out_v, int* out_i, int n,
                               int w, int k, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  row_topk_kernel<<<blocks, kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      d2, out_v, out_i, n, w, k);
  return (int)cudaGetLastError();
}
