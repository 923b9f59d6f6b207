// The ORB detection of csrc/orb_detect.cu, written once for the kernels and
// for the host build (csrc/orb_detect_host.cpp): each stage is a function
// of the block's thread index and thread count, with the block's shared
// state passed in. Between stages the kernels synchronise the block; the
// host runs one thread a block (tid 0 of 1) and the stages in order.
//
// The arithmetic is orb.py::detect_levels_plain's, rounding for rounding:
// the row resize as one fused multiply-add (the plain version's float64 sum
// of an exact product), the column resize, the FAST sums and the sub-pixel
// fit with no contraction (mul_rn, add_rn, div_rn: __fmul_rn, __fadd_rn,
// __fdiv_rn on the card; the host compiler contracts nothing under
// -std=c++17), rintf for torch.round.
#pragma once

#include <math.h>
#include <string.h>

#if defined(__CUDACC__)
#define OD_FN __device__ __forceinline__
#define OD_CONST __constant__
#define OD_SYNC() __syncthreads()
#define OD_UNROLL _Pragma("unroll")
#else
#define OD_FN inline
#define OD_CONST static const
#define OD_SYNC()
#define OD_UNROLL
#endif

namespace orb_detect {

constexpr int kMaxLevels = 16;
constexpr int kMaxCell = 32;
constexpr int kMaxPerCell = 8;
constexpr int kTileHalo = 5;   // level pixels a tile holds past its cell
constexpr int kRespHalo = 2;   // response pixels past the cell
constexpr int kMaxTile = kMaxCell + 2 * kTileHalo;
constexpr int kMaxResp = kMaxCell + 2 * kRespHalo;

// FAST-16's Bresenham circle (x = column, y = row), OpenCV's tap order.
OD_CONST int kFastDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                            0, -1, -2, -3, -3, -3, -2, -1};
OD_CONST int kFastDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                            3, 3, 2, 1, 0, -1, -2, -3};

}  // namespace orb_detect

// Mirrored field by field by the ctypes structures of
// frontend/detect_kernel.py.
struct OrbLevel {
  int H, W;            // the level's size
  int ncx, ncy;        // cells across and down
  int k;               // output slots: max(budget, 1)
  int out_begin;       // the level's first output slot
  int cand_begin;      // its first candidate in the scratch
  int padded_begin;    // offset (floats) of its edge-padded image
  int row_taps;        // offsets in `taps` of the (4, H) and (4, W) resize
  int col_taps;        //   taps from the previous level (level 0: unused)
  int mask_row_taps;   // the same from the mask's rows and columns
  int mask_col_taps;   //   (unused without a mask)
  float scale;         // the level's scale in float32
};

struct OrbDetectArgs {
  OrbLevel level[orb_detect::kMaxLevels];
  const float* img;     // (H0, W0) input image
  const float* mask;    // (Hm, Wm) footprint mask, or null
  const int* taps;      // every tap table: i0, i1, w0 bits, w1 bits
  float* padded;        // every level, edge-padded by `pad`
  int* cand;            // (5, n_cand): value, row, column, x, y bits
  int* yx;              // (2, k_total): rows, then columns
  float* xy;            // (capacity, 2)
  float* response;      // (capacity,)
  int* octave;          // (capacity,)
  unsigned char* valid; // (capacity,)
  int W0, Wm;           // the image's and the mask's widths (row pitches)
  int n_levels, cell, per_cell, pad, edge, n_cand, k_total, capacity;
  int pick_keys;        // a power of two >= every level's candidate count
  float threshold;
};

namespace orb_detect {

// A cell's block state: its tile of level pixels, the raw response around
// it, the suppressed response by lane, the positive lanes and the picks.
struct CellState {
  float lv[kMaxTile * kMaxTile];
  float rr[kMaxResp * kMaxResp];
  float nv[kMaxCell * kMaxCell];
  float pos_v[kMaxCell * kMaxCell];
  int pos_i[kMaxCell * kMaxCell];
  float sel_v[kMaxPerCell];
  int sel_i[kMaxPerCell];
  int n_pos;
};

#if defined(__CUDACC__)
OD_FN float mul_rn(float a, float b) { return __fmul_rn(a, b); }
OD_FN float add_rn(float a, float b) { return __fadd_rn(a, b); }
OD_FN float sub_rn(float a, float b) { return __fsub_rn(a, b); }
OD_FN float div_rn(float a, float b) { return __fdiv_rn(a, b); }
OD_FN float as_float(int v) { return __int_as_float(v); }
OD_FN int as_int(float f) { return __float_as_int(f); }
OD_FN unsigned as_uint(float f) { return __float_as_uint(f); }
template <class T>
OD_FN T ld(const T* p) { return __ldg(p); }
OD_FN int fetch_add(int* p, int v) { return atomicAdd(p, v); }
#else
OD_FN float mul_rn(float a, float b) { return a * b; }
OD_FN float add_rn(float a, float b) { return a + b; }
OD_FN float sub_rn(float a, float b) { return a - b; }
OD_FN float div_rn(float a, float b) { return a / b; }
OD_FN float as_float(int v) {
  float f;
  memcpy(&f, &v, sizeof f);
  return f;
}
OD_FN int as_int(float f) {
  int v;
  memcpy(&v, &f, sizeof v);
  return v;
}
OD_FN unsigned as_uint(float f) {
  unsigned v;
  memcpy(&v, &f, sizeof v);
  return v;
}
template <class T>
OD_FN T ld(const T* p) { return *p; }
OD_FN int fetch_add(int* p, int v) {
  const int old = *p;
  *p += v;
  return old;
}
#endif

OD_FN int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// One bilinear tap pair of a resize.
struct Taps {
  int i0, i1;
  float w0, w1;
};

OD_FN Taps taps_at(const int* t, int n, int j) {
  return Taps{ld(t + j), ld(t + n + j), as_float(ld(t + 2 * n + j)),
              as_float(ld(t + 3 * n + j))};
}

// Rows as fma(w1, x1, round(w0 x0)), columns as
// round(round(b0 y0) + round(b1 y1)).
OD_FN float resize_at(const float* src, int pitch, const Taps& r,
                      const Taps& c) {
  const float* p0 = src + static_cast<long long>(r.i0) * pitch;
  const float* p1 = src + static_cast<long long>(r.i1) * pitch;
  const float y0 = fmaf(r.w1, ld(p1 + c.i0), mul_rn(r.w0, ld(p0 + c.i0)));
  const float y1 = fmaf(r.w1, ld(p1 + c.i1), mul_rn(r.w0, ld(p0 + c.i1)));
  return add_rn(mul_rn(c.w0, y0), mul_rn(c.w1, y1));
}

// The pixel (y, x) of level l, both inside the level.
OD_FN float level_pixel(const OrbDetectArgs& a, int l, int y, int x) {
  if (l == 0) return rintf(ld(a.img + static_cast<long long>(y) * a.W0 + x));
  const OrbLevel& L = a.level[l];
  const OrbLevel& P = a.level[l - 1];
  const int pitch = P.W + 2 * a.pad;
  const float* src = a.padded + P.padded_begin +
                     static_cast<long long>(a.pad) * pitch + a.pad;
  return rintf(resize_at(src, pitch, taps_at(a.taps + L.row_taps, L.H, y),
                         taps_at(a.taps + L.col_taps, L.W, x)));
}

// The footprint mask resized to level l at (y, x), over one half.
OD_FN bool mask_at(const OrbDetectArgs& a, int l, int y, int x) {
  const OrbLevel& L = a.level[l];
  return resize_at(a.mask, a.Wm, taps_at(a.taps + L.mask_row_taps, L.H, y),
                   taps_at(a.taps + L.mask_col_taps, L.W, x)) > 0.5f;
}

// FAST-9/16 response at tile position (ty, tx): the bright or dark excess
// sum, taps in circle order, where a 9-arc of the circle passes the
// threshold, else 0.
OD_FN float fast_at(const float* lv, int T, int ty, int tx, float thr) {
  const float c = lv[ty * T + tx];
  const float hi = add_rn(c, thr);
  const float lo = sub_rn(c, thr);
  unsigned bb = 0, db = 0;
  float sb = 0.0f, sd = 0.0f;
  OD_UNROLL
  for (int k = 0; k < 16; ++k) {
    const float p = lv[(ty + kFastDy[k]) * T + tx + kFastDx[k]];
    const bool b = p > hi;
    const bool d = p < lo;
    bb |= static_cast<unsigned>(b) << k;
    db |= static_cast<unsigned>(d) << k;
    sb = add_rn(sb, b ? sub_rn(sub_rn(p, c), thr) : 0.0f);
    sd = add_rn(sd, d ? sub_rn(sub_rn(c, p), thr) : 0.0f);
  }
  bool is_b = false, is_d = false;
  OD_UNROLL
  for (int k = 0; k < 16; ++k) {
    const unsigned pk = ((0x1FFu << k) | (0x1FFu >> (16 - k))) & 0xFFFFu;
    is_b |= (bb & pk) == pk;
    is_d |= (db & pk) == pk;
  }
  return add_rn(is_b ? sb : 0.0f, is_d ? sd : 0.0f);
}

// The 1-D parabola fit of the plain version's _subpixel_offsets.
OD_FN float fit(float m, float c, float p) {
  const float denom = mul_rn(2.0f, sub_rn(sub_rn(mul_rn(2.0f, c), m), p));
  const float d = fabsf(denom) > 1e-6f ? denom : 1e-6f;
  const float off = div_rn(sub_rn(p, m), d);
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

// The stages of one cell of level l, in order, a synchronisation between
// each two; the first thread sets s.n_pos = 0 before the first.

// 1. The tile: level pixels at clamped coordinates (edge replicated).
OD_FN void cell_tile(const OrbDetectArgs& a, int l, int cell, CellState& s,
                     int tid, int nt) {
  const OrbLevel& L = a.level[l];
  const int C = a.cell, T = C + 2 * kTileHalo;
  const int cy = cell / L.ncx, cx = cell - cy * L.ncx;
  const int oy = cy * C - kTileHalo, ox = cx * C - kTileHalo;
  for (int i = tid; i < T * T; i += nt) {
    const int ty = i / T, tx = i - ty * T;
    s.lv[i] = level_pixel(a, l, clampi(oy + ty, 0, L.H - 1),
                          clampi(ox + tx, 0, L.W - 1));
  }
}

// 2. The cell's share of the edge-padded level (its own pixels, and the
// padding beside them where the cell is on the level's edge), and the raw
// response around the cell: FAST inside the border margin and the
// footprint, 0 elsewhere (outside the level too).
OD_FN void cell_response(const OrbDetectArgs& a, int l, int cell,
                         CellState& s, int tid, int nt) {
  const OrbLevel& L = a.level[l];
  const int C = a.cell, H = L.H, W = L.W;
  const int T = C + 2 * kTileHalo, R = C + 2 * kRespHalo;
  const int cy = cell / L.ncx, cx = cell - cy * L.ncx;
  const int by = cy * C, bx = cx * C;
  const int oy = by - kTileHalo, ox = bx - kTileHalo;
  const int pad = a.pad, pitch = W + 2 * pad;
  const int y0 = cy == 0 ? -pad : by;
  const int y1 = cy == L.ncy - 1 ? H + pad : by + C;
  const int x0 = cx == 0 ? -pad : bx;
  const int x1 = cx == L.ncx - 1 ? W + pad : bx + C;
  const int nx = x1 - x0, n = (y1 - y0) * nx;
  float* out = a.padded + L.padded_begin;
  for (int i = tid; i < n; i += nt) {
    const int y = y0 + i / nx, x = x0 + i % nx;
    const int ty = clampi(y, 0, H - 1) - oy, tx = clampi(x, 0, W - 1) - ox;
    out[static_cast<long long>(y + pad) * pitch + x + pad] = s.lv[ty * T + tx];
  }
  for (int i = tid; i < R * R; i += nt) {
    const int ry = i / R, rx = i - ry * R;
    const int y = by - kRespHalo + ry, x = bx - kRespHalo + rx;
    float r = 0.0f;
    if (y >= a.edge && y < H - a.edge && x >= a.edge && x < W - a.edge) {
      r = fast_at(s.lv, T, y - oy, x - ox, a.threshold);
      if (r != 0.0f && a.mask != nullptr && !mask_at(a, l, y, x)) r = 0.0f;
    }
    s.rr[i] = r;
  }
}

// 3. 3x3 suppression (ties kept) by lane, lanes past the level 0; the
// positive lanes listed in s.pos_*.
OD_FN void cell_suppress(const OrbDetectArgs& a, int l, int cell,
                         CellState& s, int tid, int nt) {
  const OrbLevel& L = a.level[l];
  const int C = a.cell, R = C + 2 * kRespHalo;
  const int cy = cell / L.ncx, cx = cell - cy * L.ncx;
  for (int i = tid; i < C * C; i += nt) {
    const int dy = i / C, dx = i - dy * C;
    float v = 0.0f;
    if (cy * C + dy < L.H && cx * C + dx < L.W) {
      const int ry = dy + kRespHalo, rx = dx + kRespHalo;
      v = s.rr[ry * R + rx];
      float m = v;
      for (int j = -1; j <= 1; ++j)
        for (int k = -1; k <= 1; ++k) m = fmaxf(m, s.rr[(ry + j) * R + rx + k]);
      v = v >= m ? v : 0.0f;
    }
    s.nv[i] = v;
    if (v > 0.0f) {
      const int slot = fetch_add(&s.n_pos, 1);
      s.pos_v[slot] = v;
      s.pos_i[slot] = i;
    }
  }
}

// 4. The cell's top per_cell: greater value first, lower lane on ties (the
// plain version's rounds of first-of-equal argmax), then the first zero
// lanes in lane order, as its rounds reach them.
OD_FN void cell_rank(const OrbDetectArgs& a, CellState& s, int tid, int nt) {
  const int np = s.n_pos, pc = a.per_cell;
  for (int j = tid; j < np; j += nt) {
    const float v = s.pos_v[j];
    const int lane = s.pos_i[j];
    int rank = 0;
    for (int k = 0; k < np; ++k) {
      const float u = s.pos_v[k];
      rank += (u > v) || (u == v && s.pos_i[k] < lane);
    }
    if (rank < pc) {
      s.sel_v[rank] = v;
      s.sel_i[rank] = lane;
    }
  }
  if (tid == 0) {
    int lane = 0;
    for (int k = np < pc ? np : pc; k < pc; ++k, ++lane) {
      while (s.nv[lane] > 0.0f) ++lane;
      s.sel_v[k] = 0.0f;
      s.sel_i[k] = lane;
    }
  }
}

// 5. Each candidate's sub-pixel fit on the raw response, its coordinates
// on the level and in the image, into the scratch.
OD_FN void cell_fit(const OrbDetectArgs& a, int l, int cell,
                    const CellState& s, int tid, int nt) {
  const OrbLevel& L = a.level[l];
  const int C = a.cell, R = C + 2 * kRespHalo, pc = a.per_cell;
  const int cy = cell / L.ncx, cx = cell - cy * L.ncx;
  const int by = cy * C, bx = cx * C;
  for (int k = tid; k < pc; k += nt) {
    const int lane = s.sel_i[k];
    const int ys = by + lane / C, xs = bx + lane % C;
    const int yc = clampi(ys, 1, L.H - 2), xc = clampi(xs, 1, L.W - 2);
    const float* p = s.rr + (yc - by + kRespHalo) * R + (xc - bx + kRespHalo);
    const float c = p[0], left = p[-1], right = p[1], up = p[-R], down = p[R];
    const float dx = (left > 0.0f && right > 0.0f) ? fit(left, c, right) : 0.0f;
    const float dy = (up > 0.0f && down > 0.0f) ? fit(up, c, down) : 0.0f;
    const int j = L.cand_begin + cell * pc + k;
    const int n = a.n_cand;
    a.cand[j] = as_int(s.sel_v[k]);
    a.cand[n + j] = ys;
    a.cand[2 * n + j] = xs;
    a.cand[3 * n + j] = as_int(mul_rn(add_rn(static_cast<float>(xs), dx), L.scale));
    a.cand[4 * n + j] = as_int(mul_rn(add_rn(static_cast<float>(ys), dy), L.scale));
  }
}

// Descending order of a float as an ascending unsigned key.
OD_FN unsigned desc_key(float f) {
  const unsigned u = as_uint(f);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

// Level l's pick: its k best candidates by value - rank * 1e7 (-inf where
// the value is not positive), ties to the lower index (the plain version's
// stable descending sort), by a bitonic sort of `keys` (a.pick_keys of
// them), into the level's output slots; the last level also writes the
// padding slots.
OD_FN void pick_level(const OrbDetectArgs& a, int l, unsigned long long* keys,
                      int tid, int nt) {
  const OrbLevel& L = a.level[l];
  const int n = L.ncx * L.ncy * a.per_cell, pc = a.per_cell;
  int N = 1;
  while (N < n) N <<= 1;
  const int* val = a.cand + L.cand_begin;
  for (int i = tid; i < N; i += nt) {
    unsigned long long key = ~0ull;
    if (i < n) {
      const float v = as_float(val[i]);
      const float comp =
          v > 0.0f ? sub_rn(v, mul_rn(static_cast<float>(i % pc), 1e7f))
                   : -INFINITY;
      key = (static_cast<unsigned long long>(desc_key(comp)) << 32) |
            static_cast<unsigned>(i);
    }
    keys[i] = key;
  }
  OD_SYNC();
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < N / 2; t += nt) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long u = keys[i], w = keys[j];
        if ((u > w) == ((i & size) == 0)) {
          keys[i] = w;
          keys[j] = u;
        }
      }
      OD_SYNC();
    }
  }
  const int nc = a.n_cand;
  for (int m = tid; m < L.k; m += nt) {
    const int j = L.cand_begin + static_cast<int>(keys[m] & 0xffffffffu);
    const float v = as_float(a.cand[j]);
    const bool ok = v > 0.0f;
    const int o = L.out_begin + m;
    a.yx[o] = a.cand[nc + j];
    a.yx[a.k_total + o] = a.cand[2 * nc + j];
    a.xy[2 * o] = as_float(a.cand[3 * nc + j]);
    a.xy[2 * o + 1] = as_float(a.cand[4 * nc + j]);
    a.response[o] = ok ? v : -INFINITY;
    a.octave[o] = l;
    a.valid[o] = ok;
  }
  if (l == a.n_levels - 1) {
    for (int o = a.k_total + tid; o < a.capacity; o += nt) {
      a.xy[2 * o] = 0.0f;
      a.xy[2 * o + 1] = 0.0f;
      a.response[o] = -INFINITY;
      a.octave[o] = 0;
      a.valid[o] = 0;
    }
  }
}

}  // namespace orb_detect
