// The pooled engine's host plan in one pass: the C++ twin of the numpy body
// of ops/fused_pool.py::plan_pool_host, which it equals bit for bit.
//
// The dilation runs on the dense double-extended grid (occupied cells at
// coords + 2): a window's candidate union is the separable 3x3x3 box sum of
// the cell counts (x, then y, then z), and a cell is a window iff its box
// sum of occupancy is non-zero. Both sums travel in one int32 per cell as
// count << 5 | 1 (at most 27 occupied neighbours fit the low 5 bits; counts
// are clipped to one past the widest class, so a clipped union still
// declines). Windows come out in ascending extended id; a stable counting
// sort by descending union puts them in the plan's order, and the (UD, 27)
// neighbour-row table is written once, in that order. The class split, the
// segment bands, the band layout, the pool-row bounds, the group estimates
// and budgets and every padded upload array follow in the same pass.
// Single-threaded. Exposed extern "C" for ctypes; native/__init__.py builds
// it with pcr_native.cpp into one library.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxClasses = 32;
constexpr int kMaxBands = 4;  // one per segment factor F in {1, 2, 4, 8}

int64_t bit_length(int64_t v) { return v > 0 ? 64 - __builtin_clzll(uint64_t(v)) : 0; }

int64_t round_up(int64_t n, int64_t m) { return (n + m - 1) / m * m; }

// core/types.py::pow2: the smallest power of two >= n, and >= 2.
int64_t pow2(int64_t n) { return int64_t(1) << bit_length(std::max<int64_t>(n, 2) - 1); }

// 1 << ceil(log2(max(n, 1))).
int64_t pow2ceil(int64_t n) { return n <= 1 ? 1 : int64_t(1) << bit_length(n - 1); }

int64_t log2i(int64_t p) { return bit_length(p) - 1; }

// core/types.py::bucket_rows.
int64_t bucket_rows(int64_t n, int64_t floor, int64_t step_bits) {
  n = std::max(n, floor);
  const int64_t q =
      std::max(floor, int64_t(1) << std::max<int64_t>(bit_length(n) - step_bits, 0));
  return round_up(n, q);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ceil(a / 2^s) for a >= 0.
int64_t ceil_shift(int64_t a, int64_t s) { return (a + (int64_t(1) << s) - 1) >> s; }

// Ranks of key[0..m) in stable descending order (keys in [0, kmax]).
void rank_desc(const int32_t* key, int64_t m, int64_t kmax, std::vector<int64_t>& hist,
               int64_t* rank) {
  hist.assign(size_t(kmax) + 2, 0);
  for (int64_t i = 0; i < m; ++i) ++hist[size_t(key[i])];
  int64_t start = 0;
  for (int64_t k = kmax; k >= 0; --k) {
    const int64_t c = hist[size_t(k)];
    hist[size_t(k)] = start;
    start += c;
  }
  for (int64_t i = 0; i < m; ++i) rank[i] = hist[size_t(key[i])]++;
}

}  // namespace

extern "C" {

// Allocates the pass's outputs once their sizes are known: counts[i]
// entries of buffer i (in the order of the enum below), its address into
// ptrs[i]. Returns 0, or non-zero when it could not.
typedef int64_t (*PcrPlanAlloc)(const int64_t* counts, void** ptrs);

enum PcrPlanBuffer {
  kOffE,         // (27,) int32
  kNrows,        // (ud, 27) int32
  kUnionLut,     // (ud + 1,) int32: per window, then 0
  kDilWidthLut,  // (ud + 1,) int32
  kDCells,       // (ud_b,) int32
  kDCellsE,      // (ud_b,) int32
  kRowVals,      // (ud_b,) int32
  kQmetaVals,    // (ud_b,) int32
  kBaseE,        // (u_pad,) int32
  kCellStart,    // (u_pad,) int32
  kCellCount,    // (u_pad,) int32
  kPacked,       // (n_pad + 1, 4) float32
  kWidthLut,     // (n_rows_pad + 1,) int32: per pool row, then 0
  kRowUnionLut,  // (n_rows_pad + 1,) int32
  kBuffers
};

struct PcrPlanIn {
  const int64_t* cell_ids;    // (u,) occupied cells' linear grid ids
  const int32_t* cell_count;  // (u,)
  const int32_t* cell_start;  // (u,)
  const int32_t* sort_order;  // (n,) the cell-sorted target's original indices
  const double* target;       // (n, 3)
  int64_t u, n;
  int64_t dims[3];
  int64_t select_max_w;  // the narrow-class cutoff the class split follows
  int64_t group, block_groups, max_class_lanes, max_pool_bytes;
  double big;  // the dead lanes' coordinate
  // Padded sizes known before the pass (forced, or the scan's own).
  int64_t prod_e_pad, prod_d_pad, u_pad, n_pad;
  // Forced statics; n_forced = 0: the plan keys itself.
  int64_t n_forced;
  const int64_t* forced_widths;
  const int64_t* forced_pad_sizes;
  int64_t forced_ud_b;
  PcrPlanAlloc alloc;
};

struct PcrPlanOut {
  int64_t ud, max_union, ud_pad, n_rows_pad, budget_rows, n_classes;
  int64_t widths[kMaxClasses], ends_pad[kMaxClasses], row_ends[kMaxClasses];
  int64_t sizes_real[kMaxClasses], budgets[kMaxClasses], n_bands[kMaxClasses];
  int64_t bands[kMaxClasses][kMaxBands][3];  // (w_assemble, F, n_pad)
};

// The layout native/__init__.py mirrors, which load() checks: the number
// of buffers, kMaxClasses, kMaxBands and the sizes of the two structs.
void pcr_plan_layout(int64_t* out) {
  out[0] = kBuffers;
  out[1] = kMaxClasses;
  out[2] = kMaxBands;
  out[3] = int64_t(sizeof(PcrPlanIn));
  out[4] = int64_t(sizeof(PcrPlanOut));
}

// Returns 0 with a plan, 1 when the scan does not fit the engine (the
// numpy body's None), -2 when the class table is too small for this scan,
// -3 when the outputs could not be allocated.
int64_t pcr_plan_pool(const PcrPlanIn* in, PcrPlanOut* out) {
  const int64_t u = in->u, n = in->n, group = in->group, lanes = in->max_class_lanes;
  if (group < 1 || (group & (group - 1))) return -2;  // segment meta holds log2(GROUP / F)
  const int64_t d0 = in->dims[0] + 2, d1 = in->dims[1] + 2, d2 = in->dims[2] + 2;
  const int64_t prod_d = d0 * d1 * d2;
  if (prod_d > (int64_t(1) << 25)) return 1;
  const int64_t e0 = d0 + 2, e1 = d1 + 2, e2 = d2 + 2;
  const int64_t prod_e = e0 * e1 * e2;
  if (in->prod_e_pad < prod_e || in->prod_d_pad < prod_d || in->u_pad < u ||
      in->n_pad < n + 1)
    return 1;

  int64_t off[27];
  int idx = 0;
  for (int ox = -1; ox <= 1; ++ox)
    for (int oy = -1; oy <= 1; ++oy)
      for (int oz = -1; oz <= 1; ++oz) off[idx++] = ox + e0 * (oy + e1 * int64_t(oz));
  auto base_of = [&](int64_t i) {
    const int64_t c = in->cell_ids[i];
    const int64_t x = c % in->dims[0], r = c / in->dims[0];
    const int64_t y = r % in->dims[1], z = r / in->dims[1];
    return (x + 2) + e0 * ((y + 2) + e1 * (z + 2));
  };

  // Occupied cells onto the dense grid: their rows, and count << 5 | 1.
  std::vector<int32_t> lut_e(size_t(prod_e), -1), box(size_t(prod_e), 0);
  for (int64_t i = 0; i < u; ++i) {
    const int64_t be = base_of(i);
    lut_e[size_t(be)] = int32_t(i);
    const int64_t cnt = std::min<int64_t>(in->cell_count[i], lanes + 1);
    box[size_t(be)] = int32_t(cnt << 5 | 1);
  }

  // The box sum in place, one axis at a time. Every cell within one of an
  // occupied cell lies inside the border ring, so the flat strides never
  // wrap onto a non-zero cell and the border itself stays 0.
  int32_t* v = box.data();
  for (int64_t p = 0, last = 0; p + 1 < prod_e; ++p) {  // last: v[p - 1] before this pass
    const int32_t cur = v[p];
    v[p] = int32_t(last) + cur + v[p + 1];
    last = cur;
  }
  std::vector<int32_t> line;  // the previous line's (plane's) values before this pass
  for (const int64_t st : {e0, e0 * e1}) {
    line.assign(size_t(st), 0);
    int32_t* __restrict__ old = line.data();
    for (int64_t p0 = 0; p0 + st < prod_e; p0 += st) {
      int32_t* __restrict__ row = v + p0;
      const int32_t* __restrict__ next = v + p0 + st;
      for (int64_t i = 0; i < st; ++i) {
        const int32_t cur = row[i];
        row[i] = old[i] + cur + next[i];
        old[i] = cur;
      }
    }
  }

  // Windows by union; a union past the widest class declines.
  std::vector<int64_t> hist(size_t(lanes) + 1, 0);
  int64_t ud = 0, max_union = 0;
  for (int64_t p = 0; p < prod_e; ++p) {
    if (!(v[p] & 31)) continue;
    const int64_t un = v[p] >> 5;
    if (un > lanes) return 1;
    ++hist[size_t(un)];
    max_union = std::max(max_union, un);
    ++ud;
  }
  // Stable descending-union slots (equal unions keep ascending ids).
  for (int64_t k = max_union, start = 0; k >= 0; --k) {
    const int64_t c = hist[size_t(k)];
    hist[size_t(k)] = start;
    start += c;
  }
  // Windows in ascending extended id (the border holds none), each put in
  // its slot: extended and search-grid ids, union, centre-cell count.
  const size_t nud = size_t(ud);
  std::vector<int32_t> dce(nud), dcl(nud), uni(nud), center(nud);
  for (int64_t z = 1; z + 1 < e2; ++z)
    for (int64_t y = 1; y + 1 < e1; ++y)
      for (int64_t x = 1, p = x + e0 * (y + e1 * z); x + 1 < e0; ++x, ++p) {
        if (!(v[p] & 31)) continue;
        const int32_t un = v[p] >> 5;
        const size_t k = size_t(hist[size_t(un)]++);
        dce[k] = int32_t(p);
        dcl[k] = int32_t((x - 1) + d0 * ((y - 1) + d1 * (z - 1)));
        uni[k] = un;
        const int32_t row = lut_e[size_t(p)];
        center[k] = row >= 0 ? in->cell_count[row] : 0;
      }
  std::vector<int32_t>().swap(box);

  // Width classes: three coarse classes split into pow2 sub-widths, or the
  // forced ladder with pow2 binning.
  std::vector<int64_t> widths, ends;
  if (in->n_forced == 0) {
    auto w128 = [&](int64_t i) { return ceil_div(std::max(uni[size_t(i)], 1), 128) * 128; };
    const int64_t l_max = ud ? pow2(w128(0)) : 128;
    std::vector<int64_t> coarse = {l_max};
    if (l_max > 512) coarse.push_back(512);
    if (l_max > 128) coarse.push_back(128);
    std::vector<int64_t> cw, ce;
    int64_t prev = 0, e = 0;
    for (size_t c = 0; c < coarse.size(); ++c) {
      const int64_t nxt = c + 1 < coarse.size() ? coarse[c + 1] : 0;
      while (e < ud && w128(e) > nxt) ++e;
      const int64_t end = c + 1 == coarse.size() ? ud : e;
      if (end > prev) {
        cw.push_back(coarse[c]);
        ce.push_back(end);
        prev = end;
      }
    }
    // Pow2 sub-width classes down to the cutoff's floor.
    const int64_t w_floor = in->select_max_w == 0 ? 128 : 8;
    prev = 0;
    for (size_t c = 0; c < cw.size(); ++c) {
      for (int64_t i = prev; i < ce[c];) {
        const int64_t sw = std::min(std::max(w_floor, pow2ceil(uni[size_t(i)])), cw[c]);
        int64_t j = i + 1;
        while (j < ce[c] && std::min(std::max(w_floor, pow2ceil(uni[size_t(j)])), cw[c]) == sw)
          ++j;
        widths.push_back(sw);
        ends.push_back(j);
        i = j;
      }
      prev = ce[c];
    }
  } else {
    widths.assign(in->forced_widths, in->forced_widths + in->n_forced);
    const int64_t narrow = widths.back();
    auto wl = [&](int64_t i) { return std::max(narrow, pow2ceil(uni[size_t(i)])); };
    if (ud && wl(0) > widths[0]) return 1;
    int64_t e = 0;
    for (size_t c = 0; c < widths.size(); ++c) {
      const int64_t nxt = c + 1 < widths.size() ? widths[c + 1] : 0;
      while (e < ud && wl(e) > nxt) ++e;
      ends.push_back(c + 1 == widths.size() ? ud : e);
    }
  }
  const int64_t nc = int64_t(widths.size());
  if (nc > kMaxClasses) return -2;

  // Segment bands per class: (w_assemble, F, n_real, n_pad).
  struct Band {
    int64_t wa, f, nb, npad;
  };
  std::vector<std::vector<Band>> layout(static_cast<size_t>(nc));
  std::vector<int32_t> run_sorted;
  int64_t prev = 0;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t w_cls = widths[size_t(c)], e = ends[size_t(c)];
    std::vector<Band>& bands = layout[size_t(c)];
    if (in->n_forced) {
      const int64_t sz = e - prev, p = in->forced_pad_sizes[c];
      if (p < sz) return 1;
      bands.push_back({w_cls, 1, sz, p});
      prev = e;
      continue;
    }
    const int64_t f_cap = std::min(group, std::max<int64_t>(w_cls / 16, 1));
    auto f_max = [&](int64_t i) {
      return std::min(f_cap, w_cls >> log2i(std::min(pow2ceil(uni[size_t(i)]), w_cls)));
    };
    for (int64_t s0 = prev; s0 < e;) {
      const int64_t fm = f_max(s0);
      int64_t s1 = s0 + 1;
      while (s1 < e && f_max(s1) == fm) ++s1;
      // The run's centre counts, descending, as the band packs them.
      hist.assign(size_t(max_union) + 1, 0);
      for (int64_t i = s0; i < s1; ++i) ++hist[size_t(center[size_t(i)])];
      run_sorted.clear();
      for (int64_t k = max_union; k >= 0; --k)
        run_sorted.insert(run_sorted.end(), size_t(hist[size_t(k)]), int32_t(k));
      const int64_t len = s1 - s0;
      int64_t best_f = 1, best_rows = -1;
      for (int64_t f = 1; f <= fm; f *= 2) {
        // A pool row's cost is set by its first (largest) count.
        const int64_t gshift = log2i(group / f);
        int64_t rows = 0;
        for (int64_t r = 0; r < len; r += f) rows += ceil_shift(run_sorted[size_t(r)], gshift);
        rows *= group;
        if (best_rows < 0 || rows <= best_rows) {
          best_f = f;
          best_rows = rows;
        }
      }
      const int64_t wa = std::min(w_cls / best_f, pow2(std::max(uni[size_t(s0)], 1)));
      if (!bands.empty() && bands.back().f == best_f) {
        bands.back().wa = std::max(bands.back().wa, wa);
        bands.back().nb += len;
      } else {
        if (int64_t(bands.size()) == kMaxBands) return -2;
        bands.push_back({wa, best_f, len, 0});
      }
      s0 = s1;
    }
    if (bands.empty()) bands.push_back({w_cls, 1, 0, 0});
    for (Band& bd : bands) {
      const int64_t floor_rows = std::max<int64_t>(64, (int64_t(1) << 20) / (16 * bd.wa));
      bd.npad = bucket_rows(bd.nb, floor_rows, 3);
    }
    prev = e;
  }

  int64_t ud_pad = 0, n_rows_pad = 0, pool_bytes = 0;
  for (int64_t c = 0; c < nc; ++c) {
    int64_t rows = 0;
    for (const Band& bd : layout[size_t(c)]) {
      ud_pad += bd.npad;
      rows += bd.npad / bd.f;
    }
    n_rows_pad += rows;
    pool_bytes += (rows + 1) * widths[size_t(c)] * 16;
  }
  if (pool_bytes > in->max_pool_bytes) return 1;
  if (n_rows_pad >= (int64_t(1) << 22)) return 1;  // packed keys need row ids < 2^22
  const int64_t ud_b = in->n_forced ? in->forced_ud_b : bucket_rows(ud, 64, 3);
  if (ud_b < ud) return 1;

  // The plan is made: its outputs, each at its size.
  const int64_t counts[kBuffers] = {
      27,     ud * 27,  ud + 1,   ud + 1,   ud_b,     ud_b,     ud_b,
      ud_b,   in->u_pad, in->u_pad, in->u_pad, (in->n_pad + 1) * 4, n_rows_pad + 1,
      n_rows_pad + 1};
  void* ptr[kBuffers] = {};
  if (in->alloc(counts, ptr) != 0) return -3;
  for (void* q : ptr)
    if (q == nullptr) return -3;
  auto buf = [&](int k) { return static_cast<int32_t*>(ptr[k]); };
  int32_t *nrows = buf(kNrows), *union_lut = buf(kUnionLut), *dil_width = buf(kDilWidthLut);
  int32_t *d_cells = buf(kDCells), *d_cells_e = buf(kDCellsE), *row_vals = buf(kRowVals);
  int32_t *qmeta_vals = buf(kQmetaVals), *base_e = buf(kBaseE), *cell_start = buf(kCellStart);
  int32_t *cell_count = buf(kCellCount), *width_lut = buf(kWidthLut);
  int32_t* row_union_lut = buf(kRowUnionLut);
  float* packed = static_cast<float*>(ptr[kPacked]);

  // The dilation's tables, and its neighbour rows front to back.
  for (int j = 0; j < 27; ++j) buf(kOffE)[j] = int32_t(off[j]);
  for (int64_t i = 0; i < u; ++i) base_e[i] = int32_t(base_of(i));
  for (int64_t k = 0; k < ud; ++k) {
    d_cells_e[k] = dce[size_t(k)];
    d_cells[k] = dcl[size_t(k)];
    union_lut[k] = uni[size_t(k)];
    dil_width[k] = int32_t(ceil_div(std::max(uni[size_t(k)], 1), 128) * 128);
    const int32_t* at = lut_e.data() + dce[size_t(k)];
    int32_t* nr = nrows + k * 27;
    for (int j = 0; j < 27; ++j) nr[j] = at[off[j]];
  }
  union_lut[ud] = 0;
  dil_width[ud] = 0;
  std::vector<int32_t>().swap(lut_e);

  // Window -> pool row and segment, the pool-row bounds, the group counts.
  int64_t est_groups = 0, prev_real = 0, pad_cursor = 0, row_cursor = 0;
  std::vector<int64_t> cls_groups(static_cast<size_t>(nc)), rank;
  std::vector<int32_t> u_pos, c_pos;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t w_cls = widths[size_t(c)];
    int64_t cls_g = 0;
    for (const Band& bd : layout[size_t(c)]) {
      const int64_t f = bd.f, nb = bd.nb, npad = bd.npad, nr = npad / f;
      const int64_t lf = log2i(f), gshift = log2i(group / f), ws = w_cls / f;
      const int64_t meta = (gshift << 3) | (log2i(ws) << 5);
      // Inside an F > 1 band windows go by descending centre count (stable).
      rank.resize(size_t(nb));
      if (f > 1) {
        rank_desc(center.data() + prev_real, nb, max_union, hist, rank.data());
      } else {
        for (int64_t i = 0; i < nb; ++i) rank[size_t(i)] = i;
      }
      u_pos.assign(size_t(npad), 0);
      c_pos.assign(size_t(npad), 0);
      for (int64_t i = 0; i < nb; ++i) {
        const int64_t j = rank[size_t(i)], w = prev_real + i;
        row_vals[w] = int32_t(pad_cursor + j);
        qmeta_vals[w] = int32_t(((row_cursor + (j >> lf)) << 9) | (j & (f - 1)) | meta);
        u_pos[size_t(j)] = uni[size_t(w)];
        c_pos[size_t(j)] = center[size_t(w)];
      }
      for (int64_t r = 0; r < nr; ++r) {
        int64_t u_max = 0, top = 0, g_raw = 0, g_fl = 0;
        for (int64_t i = 0; i < f; ++i) {
          const int64_t p = r * f + i, uv = u_pos[size_t(p)], cv = c_pos[size_t(p)];
          u_max = std::max(u_max, uv);
          if (uv > 0) top = std::max(top, i * ws + std::min(uv, ws));
          g_raw = std::max(g_raw, ceil_shift(cv, gshift));
          // Budgets floor real windows at 1 (stray sources); the row budget does not.
          g_fl = std::max(g_fl, p < nb ? ceil_shift(std::max<int64_t>(cv, 1), gshift) : 0);
        }
        row_union_lut[row_cursor + r] = int32_t(u_max);
        width_lut[row_cursor + r] = int32_t(std::min(ceil_div(top, 128) * 128, w_cls));
        est_groups += g_raw;
        cls_g += g_fl;
      }
      prev_real += nb;
      pad_cursor += npad;
      row_cursor += nr;
    }
    cls_groups[size_t(c)] = cls_g;
    out->row_ends[c] = row_cursor;
  }
  width_lut[n_rows_pad] = 0;
  row_union_lut[n_rows_pad] = 0;

  // Row budget: 1.3x over the occupancy-predicted rows; class budgets 2x
  // over the cumulative group estimate, the last class every group.
  const int64_t est_rows = group * est_groups;
  const int64_t budget_rows = round_up(
      bucket_rows(std::max(int64_t(1.3 * double(est_rows)), n), 64, 3),
      2 * in->block_groups * group);
  const int64_t ng = budget_rows / group;
  int64_t cum = 0, end_pad = 0;
  for (int64_t c = 0; c < nc; ++c) {
    cum += cls_groups[size_t(c)];
    out->budgets[c] =
        c == nc - 1 ? ng
                    : std::min(ng, round_up(bucket_rows(2 * cum + 4 * in->block_groups, 1024, 3),
                                            in->block_groups));
    out->widths[c] = widths[size_t(c)];
    out->sizes_real[c] = ends[size_t(c)] - (c ? ends[size_t(c - 1)] : 0);
    out->n_bands[c] = int64_t(layout[size_t(c)].size());
    int64_t pad_c = 0;
    for (size_t k = 0; k < layout[size_t(c)].size(); ++k) {
      const Band& bd = layout[size_t(c)][k];
      out->bands[c][k][0] = bd.wa;
      out->bands[c][k][1] = bd.f;
      out->bands[c][k][2] = bd.npad;
      pad_c += bd.npad;
    }
    end_pad += pad_c;
    out->ends_pad[c] = end_pad;
  }

  // Padded upload arrays.
  for (int64_t w = ud; w < ud_b; ++w) {
    row_vals[w] = int32_t(ud_pad);
    d_cells[w] = int32_t(in->prod_d_pad);
    d_cells_e[w] = 0;
    qmeta_vals[w] = -1;
  }
  for (int64_t i = u; i < in->u_pad; ++i) base_e[i] = int32_t(in->prod_e_pad);
  for (int64_t i = 0; i < in->u_pad; ++i) {
    cell_start[i] = i < u ? in->cell_start[i] : int32_t(n);
    cell_count[i] = i < u ? in->cell_count[i] : 0;
  }
  // The cell-sorted target, its original index bitcast into column 3.
  const float big = float(in->big);
  const int32_t dead = -1;
  float dead_bits;
  std::memcpy(&dead_bits, &dead, 4);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t o = in->sort_order[i];
    const double* t = in->target + int64_t(o) * 3;
    float* row = packed + i * 4;
    row[0] = float(t[0]);
    row[1] = float(t[1]);
    row[2] = float(t[2]);
    std::memcpy(row + 3, &o, 4);
  }
  for (int64_t i = n; i <= in->n_pad; ++i) {
    float* row = packed + i * 4;
    row[0] = row[1] = row[2] = big;
    row[3] = dead_bits;
  }

  out->ud = ud;
  out->max_union = max_union;
  out->ud_pad = ud_pad;
  out->n_rows_pad = n_rows_pad;
  out->budget_rows = budget_rows;
  out->n_classes = nc;
  return 0;
}

}  // extern "C"
