// Native host-runtime functions of the PyTorch port: a copy of the JAX
// package's native/pcr_native.cpp, unchanged below this comment.
//
// The reference gets its host runtime from PCL/Boost C++ (PCD codec:
// pcl::io::loadPCDFile at src/prob_point_cloud_registration_ex.cc:111-136;
// voxel filter: pcl::VoxelGrid at src/prob_point_cloud_registration.cc:24-41).
// These are fresh implementations of the same roles: an LZF codec for PCD
// binary_compressed bodies, a hash-grid centroid voxel downsample and the
// occupied-cell dilation of the grid engines' host plan. Exposed extern "C"
// for ctypes; native/__init__.py builds it with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// LZF codec (PCD binary_compressed body format).
// Stream grammar: ctrl < 32 => literal run of ctrl+1 bytes;
// else back-reference of length (ctrl>>5)+2 (+ext byte when ctrl>>5 == 7),
// offset ((ctrl & 0x1f) << 8 | next_byte) + 1.
// ---------------------------------------------------------------------------

// Returns 0 on success, negative on corrupt stream / size mismatch.
int pcr_lzf_decompress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                       uint64_t out_len) {
  uint64_t i = 0, o = 0;
  while (i < in_len && o < out_len) {
    uint32_t ctrl = in[i++];
    if (ctrl < 32) {  // literal run
      uint32_t run = ctrl + 1;
      if (i + run > in_len || o + run > out_len) return -1;
      std::memcpy(out + o, in + i, run);
      i += run;
      o += run;
    } else {  // back-reference
      uint32_t len = ctrl >> 5;
      if (len == 7) {
        if (i >= in_len) return -2;
        len += in[i++];
      }
      len += 2;
      if (i >= in_len) return -3;
      uint64_t ref_off = ((ctrl & 0x1f) << 8) + in[i++] + 1;
      if (ref_off > o) return -4;
      if (o + len > out_len) return -5;
      uint64_t ref = o - ref_off;
      for (uint32_t k = 0; k < len; ++k) out[o + k] = out[ref + k];
      o += len;
    }
  }
  // Tolerate trailing input once the expected output is complete — the
  // Python fallback stops at out_len too, so behavior is toolchain-independent.
  return (o == out_len) ? 0 : -6;
}

// Greedy hash-chain LZF encoder (liblzf-style parameters, written fresh).
// Returns compressed size, or 0 if out_cap is too small (caller should fall
// back to storing literals; PCL accepts any valid LZF stream).
uint64_t pcr_lzf_compress(const uint8_t* in, uint64_t in_len, uint8_t* out,
                          uint64_t out_cap) {
  if (in_len == 0) return 0;
  constexpr uint32_t kHashLog = 16;
  constexpr uint32_t kHashSize = 1u << kHashLog;
  constexpr uint32_t kMaxOff = 1 << 13;      // 8192: 5 offset bits + 8
  constexpr uint32_t kMaxRef = 264;          // 7 + 255 + 2
  constexpr uint32_t kMaxLit = 32;
  std::vector<int64_t> htab(kHashSize, -1);

  auto hash3 = [&](uint64_t p) -> uint32_t {
    uint32_t v = (uint32_t(in[p]) << 16) | (uint32_t(in[p + 1]) << 8) |
                 uint32_t(in[p + 2]);
    return ((v * 2654435761u) >> (32 - kHashLog)) & (kHashSize - 1);
  };

  uint64_t i = 0, o = 0;
  uint64_t lit_start = 0;
  uint32_t lit = 0;

  auto flush_literals = [&](uint64_t end) -> bool {
    while (lit > 0) {
      uint32_t run = lit < kMaxLit ? lit : kMaxLit;
      if (o + 1 + run > out_cap) return false;
      out[o++] = run - 1;
      std::memcpy(out + o, in + end - lit, run);
      o += run;
      lit -= run;
    }
    return true;
  };

  while (i + 2 < in_len) {
    uint32_t h = hash3(i);
    int64_t ref = htab[h];
    htab[h] = int64_t(i);
    uint64_t off = (ref >= 0) ? i - uint64_t(ref) : kMaxOff + 1;
    if (ref >= 0 && off <= kMaxOff && off > 0 && in[ref] == in[i] &&
        in[ref + 1] == in[i + 1] && in[ref + 2] == in[i + 2]) {
      // Extend the match.
      uint32_t len = 3;
      uint64_t max_len = in_len - i;
      if (max_len > kMaxRef) max_len = kMaxRef;
      while (len < max_len && in[ref + len] == in[i + len]) ++len;
      if (!flush_literals(i)) return 0;
      uint32_t enc_len = len - 2;
      uint64_t enc_off = off - 1;
      if (enc_len < 7) {
        if (o + 2 > out_cap) return 0;
        out[o++] = uint8_t((enc_off >> 8) | (enc_len << 5));
      } else {
        if (o + 3 > out_cap) return 0;
        out[o++] = uint8_t((enc_off >> 8) | (7u << 5));
        out[o++] = uint8_t(enc_len - 7);
      }
      out[o++] = uint8_t(enc_off & 0xff);
      // Seed the hash table through the match region (cheap, improves ratio).
      uint64_t stop = i + len;
      ++i;
      while (i < stop && i + 2 < in_len) {
        htab[hash3(i)] = int64_t(i);
        ++i;
      }
      i = stop;
      lit_start = i;
    } else {
      ++lit;
      ++i;
    }
  }
  lit += uint32_t(in_len - i);
  if (!flush_literals(in_len)) return 0;
  (void)lit_start;
  return o;
}

// ---------------------------------------------------------------------------
// Voxel-grid centroid downsample (pcl::VoxelGrid semantics: one point per
// occupied cubic leaf = centroid; output ordered by ascending linear voxel
// index, x fastest). Open-addressing hash on the linear voxel id.
// ---------------------------------------------------------------------------

namespace {
struct Cell {
  int64_t key;
  double sx, sy, sz;
  uint32_t count;
};
}  // namespace

// Computes centroids; writes at most n rows into out (xyz float64,
// row-major) and the corresponding linear voxel ids into keys_out.
// Returns the number of occupied voxels, or -1 on error. Caller sorts by
// key to get PCL's output order (done on the Python side with argsort).
int64_t pcr_voxel_downsample(const double* pts, int64_t n, double leaf,
                             double* out, int64_t* keys_out) {
  if (n <= 0 || leaf <= 0) return -1;
  // Bounding box for non-negative grid coordinates.
  double mn[3] = {pts[0], pts[1], pts[2]};
  for (int64_t p = 1; p < n; ++p)
    for (int d = 0; d < 3; ++d)
      if (pts[3 * p + d] < mn[d]) mn[d] = pts[3 * p + d];
  int64_t minijk[3];
  for (int d = 0; d < 3; ++d)
    minijk[d] = int64_t(std::floor(mn[d] / leaf));

  // Grid dims from max coordinate (for the linear index ordering).
  int64_t dims[2] = {1, 1};
  {
    int64_t mx[3] = {INT64_MIN, INT64_MIN, INT64_MIN};
    for (int64_t p = 0; p < n; ++p)
      for (int d = 0; d < 3; ++d) {
        int64_t c = int64_t(std::floor(pts[3 * p + d] / leaf)) - minijk[d];
        if (c > mx[d]) mx[d] = c;
      }
    dims[0] = mx[0] + 1;
    dims[1] = mx[1] + 1;
  }

  uint64_t cap = 1;
  while (cap < uint64_t(n) * 2) cap <<= 1;
  std::vector<Cell> table(cap);
  for (auto& c : table) c.key = -1;
  const uint64_t mask = cap - 1;

  int64_t n_cells = 0;
  for (int64_t p = 0; p < n; ++p) {
    double x = pts[3 * p], y = pts[3 * p + 1], z = pts[3 * p + 2];
    int64_t i = int64_t(std::floor(x / leaf)) - minijk[0];
    int64_t j = int64_t(std::floor(y / leaf)) - minijk[1];
    int64_t k = int64_t(std::floor(z / leaf)) - minijk[2];
    int64_t key = i + j * dims[0] + k * dims[0] * dims[1];
    uint64_t slot = (uint64_t(key) * 0x9e3779b97f4a7c15ull) & mask;
    while (true) {
      Cell& c = table[slot];
      if (c.key == key) {
        c.sx += x; c.sy += y; c.sz += z; ++c.count;
        break;
      }
      if (c.key < 0) {
        c.key = key; c.sx = x; c.sy = y; c.sz = z; c.count = 1;
        ++n_cells;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }

  int64_t w = 0;
  for (uint64_t s = 0; s < cap; ++s) {
    const Cell& c = table[s];
    if (c.key < 0) continue;
    out[3 * w] = c.sx / c.count;
    out[3 * w + 1] = c.sy / c.count;
    out[3 * w + 2] = c.sz / c.count;
    keys_out[w] = c.key;
    ++w;
  }
  return n_cells;
}

// ---------------------------------------------------------------------------
// Occupied-cell dilation for the fused search engines (the host half of the
// per-pair prepack; replaces ops/fused_grid.dilate_cells_host's numpy body —
// semantics identical, including the (x slowest, z fastest) 27-offset
// enumeration that IS the engines' shared tie-break contract and the STABLE
// descending-union window order).
//
// Inputs: the occupied cells' ORIGINAL linear ids (ascending), grid dims,
// and per-cell candidate counts. Work runs in the double-extended (+4) grid
// so no neighbor offset ever leaves bounds. Outputs (width-sorted, i.e.
// stable-descending by candidate union): the dilated cells' double-extended
// linear ids, the (UD, 27) occupied-row table (-1 = no occupied neighbor),
// and the per-window candidate union.
//
// Returns UD (>= 0), or -1 when the extended grid exceeds the int32 id
// space / -2 when the caller's capacity is too small.
int64_t pcr_dilate_cells(const int64_t* cell_ids, int64_t u,
                         const int64_t* dims, const int32_t* counts,
                         int64_t ud_cap, int32_t* d_cells_e_out,
                         int32_t* nrows_out, int32_t* union_out) {
  const int64_t e0 = dims[0] + 4, e1 = dims[1] + 4, e2 = dims[2] + 4;
  const int64_t prod_e = e0 * e1 * e2;
  if (prod_e >= (int64_t(1) << 31)) return -1;

  int64_t off[27];
  int idx = 0;
  for (int ox = -1; ox <= 1; ++ox)
    for (int oy = -1; oy <= 1; ++oy)
      for (int oz = -1; oz <= 1; ++oz)
        off[idx++] = ox + e0 * (oy + e1 * int64_t(oz));

  std::vector<uint8_t> flags(prod_e, 0);
  std::vector<int32_t> lut_e(prod_e, -1);
  for (int64_t i = 0; i < u; ++i) {
    const int64_t c = cell_ids[i];
    const int64_t x = c % dims[0];
    const int64_t r = c / dims[0];
    const int64_t y = r % dims[1];
    const int64_t z = r / dims[1];
    const int64_t b = (x + 2) + e0 * ((y + 2) + e1 * (z + 2));
    lut_e[b] = int32_t(i);
    for (int j = 0; j < 27; ++j) flags[b + off[j]] = 1;
  }

  std::vector<int32_t> dce;
  dce.reserve(std::min<int64_t>(27 * u, prod_e));
  for (int64_t p = 0; p < prod_e; ++p)
    if (flags[p]) dce.push_back(int32_t(p));
  const int64_t ud = int64_t(dce.size());
  if (ud > ud_cap) return -2;

  std::vector<int32_t> nr(size_t(ud) * 27);
  std::vector<int32_t> un(ud);
  for (int64_t d = 0; d < ud; ++d) {
    int32_t s = 0;
    for (int j = 0; j < 27; ++j) {
      const int32_t row = lut_e[int64_t(dce[size_t(d)]) + off[j]];
      nr[size_t(d) * 27 + j] = row;
      if (row >= 0) s += counts[row];
    }
    un[size_t(d)] = s;
  }

  // Stable descending-union order == np.argsort(-union, kind="stable"):
  // equal unions keep ascending dilated-cell-id order.
  std::vector<int64_t> perm(ud);
  std::iota(perm.begin(), perm.end(), int64_t(0));
  std::stable_sort(perm.begin(), perm.end(),
                   [&](int64_t a, int64_t b) { return un[a] > un[b]; });
  for (int64_t d = 0; d < ud; ++d) {
    const int64_t s = perm[size_t(d)];
    d_cells_e_out[d] = dce[size_t(s)];
    union_out[d] = un[size_t(s)];
    std::memcpy(nrows_out + size_t(d) * 27, nr.data() + size_t(s) * 27,
                27 * sizeof(int32_t));
  }
  return ud;
}

}  // extern "C"
