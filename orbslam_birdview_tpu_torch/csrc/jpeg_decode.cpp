// JPEG decoder for the port's image reader (utils/imageio.py): the pixels
// cv2.imread returns for a file, i.e. libjpeg(-turbo)'s default decode:
//
// - baseline and extended sequential Huffman (SOF0, SOF1) and progressive
//   Huffman (SOF2); 8-bit samples; 1 or 3 components; sampling factors up
//   to 2x2 (other integral ratios are replicated, as libjpeg's
//   int_upsample does); restart intervals;
// - the integer "islow" IDCT with its range-limit table (jidctint.c);
// - a gray read of a 3-component file is its Y plane (JCS_GRAYSCALE
//   output); of an RGB-coded file, libjpeg's fixed-point Y table;
// - a colour read upsamples chroma with the "fancy" triangle filters
//   (jdsample.c: h2v1, h1v2, h2v2; context rows replicated at the image's
//   top and bottom edges, columns at its left and right), converts with the
//   fixed-point YCbCr->RGB tables of jdcolor.c and writes BGR.
//
// Refused with status 2 (unsupported): arithmetic coding, lossless and
// hierarchical frames, 12-bit samples, 2- and 4-component (CMYK / YCCK)
// files. Status 1 (corrupt): a stream that is not a JPEG or lacks what a
// decode needs. Data that runs out inside a scan is read as zero bits and
// the rest of its segment left zero, as libjpeg does.
//
// A plain C interface; no PyTorch header. Built with the host C++ compiler
// at first use (utils/build.py).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Failure {
  int status;
  std::string msg;
};

[[noreturn]] void fail(int status, const std::string& msg) {
  throw Failure{status, msg};
}

// zigzag -> natural order; the 16 extra entries guard a run past 63 in
// corrupt data, as jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol, 0: longer

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, n);
    int p = 0;
    int32_t code = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      int c = counts[l - 1];
      if (c) {
        valoffset[l] = p - code;
        for (int i = 0; i < c; ++i, ++p, ++code) {
          if (code >= (1 << l)) fail(kCorrupt, "bad Huffman table");
          if (l <= kLookBits) {
            int shift = kLookBits - l;
            for (int f = 0; f < (1 << shift); ++f)
              look[(code << shift) | f] =
                  static_cast<uint16_t>((l << 8) | symbols[p]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;            // downsampled (component) size in samples
  int bw = 0, bh = 0;            // allocated blocks: whole MCUs
  bool latched = false;
  uint16_t quant[64] = {};       // latched at the component's first scan
  std::vector<int16_t> coef;     // bw * bh blocks of 64, natural order
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  void header();
  void decode();
  void output(int want_color, uint8_t* out);

  int width = 0, height = 0, ncomp = 0;

 private:
  // ---- markers ----------------------------------------------------------
  int next_marker();
  uint16_t u16(size_t at) {
    if (at + 2 > n_) fail(kCorrupt, "truncated marker segment");
    return static_cast<uint16_t>((d_[at] << 8) | d_[at + 1]);
  }
  void read_dqt(size_t p, size_t end);
  void read_dht(size_t p, size_t end);
  void read_sof(size_t p, size_t end, int marker);
  void read_sos(size_t p, size_t end);

  // ---- entropy-coded data -------------------------------------------------
  void reset_bits() {
    bitbuf_ = 0;
    bitcnt_ = 0;
    realcnt_ = 0;
  }
  void fill() {
    while (bitcnt_ <= 56) {
      uint32_t byte = 0;
      bool real = false;
      if (!hit_marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;
          if (q < n_ && d_[q] == 0) {
            pos_ = q + 1;
            real = true;
          } else {
            hit_marker_ = true;   // pos_ stays at the marker's 0xFF
            byte = 0;
          }
        } else {
          ++pos_;
          real = true;
        }
      }
      bitbuf_ |= static_cast<uint64_t>(byte) << (56 - bitcnt_);
      bitcnt_ += 8;
      if (real) realcnt_ += 8;
    }
  }
  uint32_t peek(int n) {
    if (bitcnt_ < n) fill();
    return static_cast<uint32_t>(bitbuf_ >> (64 - n));
  }
  void skip(int n) {
    if (n > realcnt_) insufficient_ = true;
    realcnt_ = realcnt_ > n ? realcnt_ - n : 0;
    bitbuf_ <<= n;
    bitcnt_ -= n;
  }
  int bits(int n) {
    if (n == 0) return 0;
    int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  int huff(const Huffman& t) {
    uint32_t look = t.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    uint32_t word = peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(word >> (16 - l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(t.valoffset[l] + code) & 0xFF];
      }
    }
    skip(16);            // a bad code: libjpeg warns and takes symbol 0
    return 0;
  }

  void decode_scan();
  void decode_block_sequential(Component& c, int16_t* blk);
  void decode_dc_first(Component& c, int16_t* blk);
  void decode_dc_refine(int16_t* blk);
  void decode_ac_first(Component& c, int16_t* blk);
  void decode_ac_refine(Component& c, int16_t* blk);
  void restart();

  // ---- pixels -------------------------------------------------------------
  std::vector<uint8_t> samples(const Component& c);
  std::vector<uint8_t> upsampled(const Component& c);

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  uint64_t bitbuf_ = 0;
  int bitcnt_ = 0, realcnt_ = 0;
  bool hit_marker_ = false, insufficient_ = false;

  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  Component comp_[3];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool progressive_ = false, have_frame_ = false, saw_jfif_ = false;
  bool saw_adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  // the current scan
  int scomp_[4] = {}, ns_ = 0, ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
};

int Decoder::next_marker() {
  // skip to the next 0xFF, then past fill bytes
  while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
  while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
  if (pos_ >= n_) return -1;
  return d_[pos_++];
}

void Decoder::read_dqt(size_t p, size_t end) {
  while (p < end) {
    int pq = d_[p] >> 4, tq = d_[p] & 15;
    ++p;
    if (tq > 3) fail(kCorrupt, "bad quantization table id");
    size_t need = pq ? 128 : 64;
    if (p + need > end) fail(kCorrupt, "truncated quantization table");
    for (int k = 0; k < 64; ++k)
      qt_[tq][kNatural[k]] =
          pq ? static_cast<uint16_t>((d_[p + 2 * k] << 8) | d_[p + 2 * k + 1])
             : d_[p + k];
    qt_defined_[tq] = true;
    p += need;
  }
}

void Decoder::read_dht(size_t p, size_t end) {
  while (p < end) {
    if (p + 17 > end) fail(kCorrupt, "truncated Huffman table");
    int tc = d_[p] >> 4, th = d_[p] & 15;
    if (tc > 1 || th > 3) fail(kCorrupt, "bad Huffman table id");
    int total = 0;
    for (int i = 0; i < 16; ++i) total += d_[p + 1 + i];
    if (total > 256 || p + 17 + total > end)
      fail(kCorrupt, "bad Huffman table");
    (tc ? ac_[th] : dc_[th]).build(d_ + p + 1, d_ + p + 17, total);
    p += 17 + total;
  }
}

void Decoder::read_sof(size_t p, size_t end, int marker) {
  if (have_frame_) fail(kCorrupt, "two frame headers");
  if (p + 6 > end) fail(kCorrupt, "truncated frame header");
  int precision = d_[p];
  height = u16(p + 1);
  width = u16(p + 3);
  ncomp = d_[p + 5];
  if (precision != 8)
    fail(kUnsupported, std::to_string(precision) + "-bit samples");
  if (ncomp != 1 && ncomp != 3)
    fail(kUnsupported, std::to_string(ncomp) + "-component (" +
                           (ncomp == 4 ? "CMYK/YCCK" : "non-gray, non-YCbCr") +
                           ") JPEG");
  if (width == 0 || height == 0)
    fail(kCorrupt, "empty image or a DNL-defined height");
  if (p + 6 + 3 * ncomp > end) fail(kCorrupt, "truncated frame header");
  progressive_ = marker == 0xC2;
  hmax_ = vmax_ = 1;
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    c.id = d_[p + 6 + 3 * i];
    c.h = d_[p + 7 + 3 * i] >> 4;
    c.v = d_[p + 7 + 3 * i] & 15;
    c.tq = d_[p + 8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail(kCorrupt, "bad sampling factors or table id");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  for (int i = 0; i < ncomp; ++i) {
    Component& c = comp_[i];
    if (hmax_ % c.h || vmax_ % c.v)
      fail(kUnsupported, "fractional sampling ratios");
    c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax_ - 1) /
                            hmax_);
    c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax_ - 1) /
                            vmax_);
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
  }
  have_frame_ = true;
}

void Decoder::header() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail(kCorrupt, "no SOI");
  pos_ = 2;
  for (;;) {
    int m = next_marker();
    if (m < 0) fail(kCorrupt, "no frame header");
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    size_t len = u16(pos_);
    size_t p = pos_ + 2, end = pos_ + len;
    if (len < 2 || end > n_) fail(kCorrupt, "truncated marker segment");
    pos_ = end;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(p, end, m);
      return;
    }
    if ((m >= 0xC3 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      const char* what = m == 0xC3 ? "lossless" : m >= 0xC9 ?
          "arithmetic-coded" : "hierarchical";
      fail(kUnsupported, std::string(what) + " JPEG");
    }
    if (m == 0xD9) fail(kCorrupt, "no frame header");
    if (m == 0xDB) read_dqt(p, end);
    else if (m == 0xC4) read_dht(p, end);
    else if (m == 0xDD) restart_interval_ = u16(p);
    else if (m == 0xE0 && len >= 7 && std::memcmp(d_ + p, "JFIF", 5) == 0)
      saw_jfif_ = true;
    else if (m == 0xEE && len >= 14 && std::memcmp(d_ + p, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = d_[p + 11];
    }
  }
}

void Decoder::read_sos(size_t p, size_t end) {
  if (p >= end) fail(kCorrupt, "truncated scan header");
  ns_ = d_[p];
  if (ns_ < 1 || ns_ > 4 || p + 1 + 2 * ns_ + 3 > end)
    fail(kCorrupt, "bad scan header");
  for (int i = 0; i < ns_; ++i) {
    int id = d_[p + 1 + 2 * i], tables = d_[p + 2 + 2 * i];
    int ci = -1;
    for (int k = 0; k < ncomp; ++k)
      if (comp_[k].id == id) ci = k;
    if (ci < 0) fail(kCorrupt, "scan names an unknown component");
    scomp_[i] = ci;
    comp_[ci].dc_tbl = tables >> 4;
    comp_[ci].ac_tbl = tables & 15;
    if (comp_[ci].dc_tbl > 3 || comp_[ci].ac_tbl > 3)
      fail(kCorrupt, "bad Huffman table id");
  }
  size_t q = p + 1 + 2 * ns_;
  ss_ = d_[q];
  se_ = d_[q + 1];
  ah_ = d_[q + 2] >> 4;
  al_ = d_[q + 2] & 15;
  if (progressive_) {
    if (ss_ > se_ || se_ > 63 || (ss_ == 0 && se_ != 0) ||
        (ss_ > 0 && ns_ != 1) || al_ > 13)
      fail(kCorrupt, "bad progressive scan parameters");
  } else {
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  }
  for (int i = 0; i < ns_; ++i) {
    Component& c = comp_[scomp_[i]];
    if (!c.latched) {
      if (!qt_defined_[c.tq]) fail(kCorrupt, "undefined quantization table");
      std::memcpy(c.quant, qt_[c.tq], sizeof(c.quant));
      c.latched = true;
    }
    bool need_dc = ss_ == 0 && ah_ == 0;
    bool need_ac = !progressive_ || ss_ > 0;
    if (need_dc && !dc_[c.dc_tbl].defined)
      fail(kCorrupt, "undefined Huffman table");
    if (need_ac && !ac_[c.ac_tbl].defined)
      fail(kCorrupt, "undefined Huffman table");
  }
}

void Decoder::decode() {
  for (int i = 0; i < ncomp; ++i)
    comp_[i].coef.assign(static_cast<size_t>(comp_[i].bw) * comp_[i].bh * 64,
                         0);
  bool any_scan = false;
  for (;;) {
    int m = next_marker();
    if (m < 0 || m == 0xD9) break;      // EOI, or data that ends without one
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    size_t len = u16(pos_);
    size_t p = pos_ + 2, end = pos_ + len;
    if (len < 2 || end > n_) fail(kCorrupt, "truncated marker segment");
    pos_ = end;
    if (m == 0xDB) read_dqt(p, end);
    else if (m == 0xC4) read_dht(p, end);
    else if (m == 0xDD) restart_interval_ = u16(p);
    else if (m == 0xDC) fail(kUnsupported, "DNL marker");
    else if (m == 0xDA) {
      read_sos(p, end);
      decode_scan();
      any_scan = true;
    }
  }
  if (!any_scan) fail(kCorrupt, "no scan");
}

void Decoder::restart() {
  // consume the RSTn marker the interval ends at (after any fill bytes)
  reset_bits();
  size_t q = pos_;
  while (q < n_ && d_[q] == 0xFF) ++q;
  if (q > pos_ && q < n_ && d_[q] >= 0xD0 && d_[q] <= 0xD7) {
    pos_ = q + 1;
    hit_marker_ = false;
  }
  // stopped at another marker: the next segment reads as empty
  insufficient_ = hit_marker_;
  for (int i = 0; i < ncomp; ++i) comp_[i].pred = 0;
  eobrun_ = 0;
}

void Decoder::decode_block_sequential(Component& c, int16_t* blk) {
  const Huffman& dct = dc_[c.dc_tbl];
  const Huffman& act = ac_[c.ac_tbl];
  int s = huff(dct);
  int diff = s ? extend(bits(s), s) : 0;
  c.pred += diff;
  blk[0] = static_cast<int16_t>(c.pred);
  for (int k = 1; k < 64; ++k) {
    int rs = huff(act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::decode_dc_first(Component& c, int16_t* blk) {
  int s = huff(dc_[c.dc_tbl]);
  int diff = s ? extend(bits(s), s) : 0;
  c.pred += diff;
  blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al_);
}

void Decoder::decode_dc_refine(int16_t* blk) {
  if (bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
}

void Decoder::decode_ac_first(Component& c, int16_t* blk) {
  if (eobrun_ > 0) {
    --eobrun_;
    return;
  }
  const Huffman& act = ac_[c.ac_tbl];
  for (int k = ss_; k <= se_; ++k) {
    int rs = huff(act);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = static_cast<int16_t>(
          static_cast<unsigned>(extend(bits(s), s)) << al_);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1 << r;
      if (r) eobrun_ += bits(r);
      --eobrun_;
      break;
    }
  }
}

void Decoder::decode_ac_refine(Component& c, int16_t* blk) {
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  const Huffman& act = ac_[c.ac_tbl];
  int k = ss_;
  auto correct = [&](int16_t& coef) {
    if (bits(1) && (coef & p1) == 0)
      coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
  };
  if (eobrun_ == 0) {
    for (; k <= se_; ++k) {
      int rs = huff(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = bits(1) ? p1 : m1;   // s != 1 is corrupt; libjpeg goes on
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += bits(r);
        break;
      }
      // advance over nonzero coefficients (correcting each) and r zeros
      do {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) {
          correct(coef);
        } else {
          if (--r < 0) break;
        }
        ++k;
      } while (k <= se_);
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; ++k) {
      int16_t& coef = blk[kNatural[k]];
      if (coef != 0) correct(coef);
    }
    --eobrun_;
  }
}

void Decoder::decode_scan() {
  reset_bits();
  hit_marker_ = false;
  insufficient_ = false;
  eobrun_ = 0;
  for (int i = 0; i < ncomp; ++i) comp_[i].pred = 0;
  // a single-component scan covers the component's own blocks, not whole
  // MCUs; an interleaved one goes MCU by MCU
  int units_x, units_y;
  if (ns_ == 1) {
    const Component& c = comp_[scomp_[0]];
    units_x = (c.dw + 7) / 8;
    units_y = (c.dh + 7) / 8;
  } else {
    units_x = mcux_;
    units_y = mcuy_;
  }
  long total = static_cast<long>(units_x) * units_y;
  int left = restart_interval_;
  for (long u = 0; u < total; ++u) {
    if (restart_interval_) {
      if (left == 0) {
        restart();
        left = restart_interval_;
      }
      --left;
    }
    int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
    bool skip_unit = insufficient_;   // out of data: the rest stays zero
    for (int i = 0; i < ns_; ++i) {
      Component& c = comp_[scomp_[i]];
      int nh = ns_ == 1 ? 1 : c.h, nv = ns_ == 1 ? 1 : c.v;
      for (int by = 0; by < nv; ++by) {
        for (int bx = 0; bx < nh; ++bx) {
          int row = ns_ == 1 ? uy : uy * c.v + by;
          int col = ns_ == 1 ? ux : ux * c.h + bx;
          int16_t* blk =
              &c.coef[(static_cast<size_t>(row) * c.bw + col) * 64];
          if (skip_unit) continue;
          if (!progressive_) decode_block_sequential(c, blk);
          else if (ss_ == 0 && ah_ == 0) decode_dc_first(c, blk);
          else if (ss_ == 0) decode_dc_refine(blk);
          else if (ah_ == 0) decode_ac_first(c, blk);
          else decode_ac_refine(c, blk);
        }
      }
    }
  }
  // leave pos_ at the marker that ends the scan
  if (!hit_marker_) {
    while (pos_ < n_ && !(d_[pos_] == 0xFF && pos_ + 1 < n_ &&
                          d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF))
      ++pos_;
  }
}

// ---- the islow IDCT (jidctint.c) --------------------------------------------

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
}

// libjpeg's post-IDCT range limit: the output is centred on 0, masked to
// 10 bits and looked up (values past the 8-bit range wrap the way the
// table does)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      if (x < 128) t[x] = static_cast<uint8_t>(x + 128);
      else if (x < 512) t[x] = 255;
      else if (x < 896) t[x] = 0;
      else t[x] = static_cast<uint8_t>(x - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int32_t dc = (static_cast<int32_t>(ip[0]) * qp[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = descale(tmp10 + tmp3, sh);
    ws[7 * 8 + c] = descale(tmp10 - tmp3, sh);
    ws[1 * 8 + c] = descale(tmp11 + tmp2, sh);
    ws[6 * 8 + c] = descale(tmp11 - tmp2, sh);
    ws[2 * 8 + c] = descale(tmp12 + tmp1, sh);
    ws[5 * 8 + c] = descale(tmp12 - tmp1, sh);
    ws[3 * 8 + c] = descale(tmp13 + tmp0, sh);
    ws[4 * 8 + c] = descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[descale(w[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// The component's samples, (bh*8, bw*8) row-major.
std::vector<uint8_t> Decoder::samples(const Component& c) {
  int stride = c.bw * 8;
  std::vector<uint8_t> out(static_cast<size_t>(stride) * c.bh * 8);
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], c.quant,
                 &out[static_cast<size_t>(by) * 8 * stride + bx * 8], stride);
  return out;
}

// The component at full size, (height, width): libjpeg's upsampler choice
// (jdsample.c jinit_upsampler with do_fancy_upsampling) on the component's
// real dw x dh samples, edges replicated.
std::vector<uint8_t> Decoder::upsampled(const Component& c) {
  std::vector<uint8_t> s = samples(c);
  const int stride = c.bw * 8, W = width, H = height;
  const int fh = hmax_ / c.h, fv = vmax_ / c.v;
  std::vector<uint8_t> out(static_cast<size_t>(W) * H);
  auto in = [&](int y, int x) -> int {
    return s[static_cast<size_t>(y) * stride + x];
  };
  auto row_of = [&](int y) { return y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y); };
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(&out[static_cast<size_t>(y) * W], &s[static_cast<size_t>(y) * stride], W);
    return out;
  }
  const bool wide = c.dw > 2;
  std::vector<uint8_t> row(static_cast<size_t>(c.dw) * 2 + 2);
  if (fh == 2 && fv == 1 && wide) {
    for (int y = 0; y < H; ++y) {
      const int dw = c.dw;
      uint8_t* o = row.data();
      o[0] = static_cast<uint8_t>(in(y, 0));
      o[1] = static_cast<uint8_t>((in(y, 0) * 3 + in(y, 1) + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = in(y, x) * 3;
        o[2 * x] = static_cast<uint8_t>((v + in(y, x - 1) + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((v + in(y, x + 1) + 2) >> 2);
      }
      o[2 * dw - 2] =
          static_cast<uint8_t>((in(y, dw - 1) * 3 + in(y, dw - 2) + 1) >> 2);
      o[2 * dw - 1] = static_cast<uint8_t>(in(y, dw - 1));
      std::memcpy(&out[static_cast<size_t>(y) * W], o, W);
    }
    return out;
  }
  if (fh == 1 && fv == 2) {
    for (int y = 0; y < H; ++y) {
      int yi = y >> 1, near = row_of(yi + ((y & 1) ? 1 : -1));
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[static_cast<size_t>(y) * W + x] =
            static_cast<uint8_t>((in(yi, x) * 3 + in(near, x) + bias) >> 2);
    }
    return out;
  }
  if (fh == 2 && fv == 2 && wide) {
    const int dw = c.dw;
    std::vector<int> sum(dw);
    for (int y = 0; y < H; ++y) {
      int yi = y >> 1, near = row_of(yi + ((y & 1) ? 1 : -1));
      for (int x = 0; x < dw; ++x) sum[x] = in(yi, x) * 3 + in(near, x);
      uint8_t* o = row.data();
      o[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        o[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        o[2 * x + 1] =
            static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      o[2 * dw - 2] =
          static_cast<uint8_t>((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
      o[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
      std::memcpy(&out[static_cast<size_t>(y) * W], o, W);
    }
    return out;
  }
  // box replication (h2v1 / h2v2 without fancy, and int_upsample)
  for (int y = 0; y < H; ++y)
    for (int x = 0; x < W; ++x)
      out[static_cast<size_t>(y) * W + x] =
          static_cast<uint8_t>(in(y / fv, x / fh));
  return out;
}

// ---- colour conversion (jdcolor.c) ------------------------------------------

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = 1 << (kScaleBits - 1);
constexpr int32_t fix(double x) {
  return static_cast<int32_t>(x * (1 << kScaleBits) + 0.5);
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  int32_t r_y[256], g_y[256], b_y[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + kOneHalf) >> kScaleBits;
      cb_b[i] = (fix(1.77200) * x + kOneHalf) >> kScaleBits;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + kOneHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

bool is_rgb_coded(int ncomp, bool jfif, bool adobe, int transform,
                  const Component* comp) {
  if (ncomp != 3 || jfif) return false;
  if (adobe) return transform == 0;
  return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
}

void Decoder::output(int want_color, uint8_t* out) {
  const size_t npix = static_cast<size_t>(width) * height;
  const bool rgb = is_rgb_coded(ncomp, saw_jfif_, saw_adobe_,
                                adobe_transform_, comp_);
  if (ncomp == 1) {
    std::vector<uint8_t> g = upsampled(comp_[0]);
    if (!want_color) {
      std::memcpy(out, g.data(), npix);
    } else {
      for (size_t i = 0; i < npix; ++i)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
    }
    return;
  }
  if (!want_color && !rgb) {
    std::vector<uint8_t> y = upsampled(comp_[0]);
    std::memcpy(out, y.data(), npix);
    return;
  }
  std::vector<uint8_t> a = upsampled(comp_[0]), b = upsampled(comp_[1]),
                       c = upsampled(comp_[2]);
  for (size_t i = 0; i < npix; ++i) {
    int R, G, B;
    if (rgb) {
      R = a[i];
      G = b[i];
      B = c[i];
    } else {
      int y = a[i], cb = b[i], cr = c[i];
      R = clamp255(y + kYcc.cr_r[cr]);
      G = clamp255(y + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits));
      B = clamp255(y + kYcc.cb_b[cb]);
    }
    if (want_color) {
      out[3 * i] = static_cast<uint8_t>(B);
      out[3 * i + 1] = static_cast<uint8_t>(G);
      out[3 * i + 2] = static_cast<uint8_t>(R);
    } else {
      out[i] = static_cast<uint8_t>(
          (kYcc.r_y[R] + kYcc.g_y[G] + kYcc.b_y[B]) >> kScaleBits);
    }
  }
}

void copy_message(const std::string& msg, char* err, int err_cap) {
  if (err == nullptr || err_cap <= 0) return;
  size_t n = std::min(msg.size(), static_cast<size_t>(err_cap - 1));
  std::memcpy(err, msg.data(), n);
  err[n] = 0;
}

}  // namespace

extern "C" {

// Reads the frame header: image size and component count. Returns a
// status (0 ok, 1 corrupt, 2 unsupported) and a message in `err`.
int jpeg_info(const uint8_t* data, long size, int* width, int* height,
              int* components, char* err, int err_cap) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.header();
    *width = dec.width;
    *height = dec.height;
    *components = dec.ncomp;
    return kOk;
  } catch (const Failure& f) {
    copy_message(f.msg, err, err_cap);
    return f.status;
  } catch (const std::exception& e) {
    copy_message(e.what(), err, err_cap);
    return kCorrupt;
  }
}

// Decodes the whole image into `out`: (height, width) gray when `color` is
// 0, (height, width, 3) BGR otherwise. `out_cap` is the buffer's size.
int jpeg_decode(const uint8_t* data, long size, int color, uint8_t* out,
                long out_cap, char* err, int err_cap) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.header();
    long need = static_cast<long>(dec.width) * dec.height * (color ? 3 : 1);
    if (out_cap < need) fail(kCorrupt, "output buffer too small");
    dec.decode();
    dec.output(color, out);
    return kOk;
  } catch (const Failure& f) {
    copy_message(f.msg, err, err_cap);
    return f.status;
  } catch (const std::exception& e) {
    copy_message(e.what(), err, err_cap);
    return kCorrupt;
  }
}

}  // extern "C"
