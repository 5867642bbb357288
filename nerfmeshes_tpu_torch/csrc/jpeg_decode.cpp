// Baseline JPEG decoder of the PyTorch port (host C++, built with g++ by
// nerfmeshes_tpu_torch/data/jpeg.py and bound with ctypes).
//
// Decodes sequential (SOF0, SOF1) and progressive (SOF2) DCT JPEG, 8-bit,
// Huffman-coded, with 1 or 3 components, integer sampling ratios (1, 2 or
// 4 on an axis), restart intervals and any number of scans (interleaved or
// not). The output is what libjpeg gives with its default decompression
// parameters, bit for bit:
//   - progressive scans as jdphuff.c decodes them (spectral selection,
//     successive approximation: DC and AC first and refinement scans, EOB
//     runs, restarts) into the coefficient buffers a sequential scan fills;
//     the whole file is read before any output, as jpeg_start_decompress
//     absorbs a multi-scan file, so every coefficient is final and
//     jdcoefct.c's block smoothing (only for coefficients still partly
//     known) has nothing to do;
//   - the integer IDCT of jidctint.c (JDCT_ISLOW) with its descale and
//     range limit (a 1024-entry wrap, as prepare_range_limit_table builds);
//   - "fancy" triangular chroma upsampling of jdsample.c: h2v1 and h2v2 when
//     the downsampled width exceeds 2 (else box replication), h1v2 always;
//     the rows above the first and below the last real row, and the columns
//     beyond either edge, replicate the edge sample (jdmainct.c's context
//     pointers, the special first and last columns); any other integer
//     ratio (4:1:1's 4 x 1 among them) replicates each sample, jdsample.c's
//     int_upsample;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c (16 scale bits);
//   - jdapimin.c's colour-space guess: JFIF means YCbCr, an Adobe marker's
//     transform 0 means RGB, component ids 'R','G','B' mean RGB.
// APPn and COM segments are skipped (the EXIF orientation is not applied).
// Lossless, arithmetic-coded, hierarchical, 12-bit and 4-component files
// return NM_JPEG_UNSUPPORTED with a message.
//
// C entry points:
//   int nm_jpeg_info(data, size, hwc[3], err, errlen)   header only
//   int nm_jpeg_decode(data, size, out, out_size, err, errlen)
// both return NM_JPEG_OK, NM_JPEG_UNSUPPORTED or NM_JPEG_CORRUPT.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { NM_JPEG_OK = 0, NM_JPEG_UNSUPPORTED = 1, NM_JPEG_CORRUPT = 2 };

struct JpegError {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw JpegError{code, msg}; }

// Zig-zag position -> natural (row-major) index, padded as libjpeg pads
// jpeg_natural_order so a corrupt run past 63 lands in entry 63.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // vals index of a code of that length, minus the code
  uint16_t fast[1 << 9]; // 9-bit lookahead: (length << 8) | symbol, 0 if longer

  void build(const uint8_t counts[16], const uint8_t* symbols, int nsym) {
    memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    memset(fast, 0, sizeof(fast));
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) fail(NM_JPEG_CORRUPT, "bad Huffman table");
        if (len <= 9) {
          int shift = 9 - len;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = static_cast<uint16_t>((len << 8) | vals[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;          // blocks in the MCU-padded plane
  int dw = 0, dh = 0;          // downsampled_width / _height
  bool latched = false;
  int32_t quant[64];           // natural order
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> plane;  // (bh * 8) x (bw * 8) samples
  int pred = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos) : d_(data), n_(size), p_(pos) {}

  void ensure(int need) {
    while (cnt_ < need) {
      uint32_t byte = 0;
      if (!marker_ && p_ < n_) {
        byte = d_[p_];
        if (byte == 0xFF) {
          uint8_t next = p_ + 1 < n_ ? d_[p_ + 1] : 0xD9;
          if (next == 0x00) {
            p_ += 2;
          } else {
            marker_ = true;  // a marker ends the data: feed zeros, as libjpeg does
            byte = 0;
          }
        } else {
          ++p_;
        }
      }
      acc_ |= byte << (24 - cnt_);
      cnt_ += 8;
    }
  }

  int bits(int n) {  // n in 1..16
    ensure(n);
    int v = static_cast<int>(acc_ >> (32 - n));
    acc_ <<= n;
    cnt_ -= n;
    return v;
  }

  int decode(const Huffman& t) {
    ensure(16);
    uint16_t f = t.fast[acc_ >> 23];
    if (f) {
      int len = f >> 8;
      acc_ <<= len;
      cnt_ -= len;
      return f & 0xFF;
    }
    for (int len = 10; len <= 16; ++len) {
      int code = static_cast<int>(acc_ >> (32 - len));
      if (code <= t.maxcode[len]) {
        acc_ <<= len;
        cnt_ -= len;
        return t.vals[(t.valoffset[len] + code) & 0xFF];
      }
    }
    fail(NM_JPEG_CORRUPT, "corrupt Huffman code");
  }

  int receive_extend(int s) {
    if (s == 0) return 0;
    int v = bits(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }

  // At a restart interval's end: drop the buffered bits and read RSTn.
  void restart(int expected) {
    acc_ = 0;
    cnt_ = 0;
    marker_ = false;
    while (p_ + 1 < n_ && !(d_[p_] == 0xFF && d_[p_ + 1] >= 0xD0 && d_[p_ + 1] <= 0xD7)) ++p_;
    if (p_ + 1 >= n_) fail(NM_JPEG_CORRUPT, "missing restart marker");
    if (d_[p_ + 1] != 0xD0 + expected) fail(NM_JPEG_CORRUPT, "restart markers out of order");
    p_ += 2;
  }

  // After a scan: the position of the next marker (not a stuffed 0xFF00).
  size_t next_marker() const {
    size_t p = p_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 && d_[p + 1] != 0xFF &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7)))
      ++p;
    return p;
  }

 private:
  const uint8_t* d_;
  size_t n_, p_;
  uint32_t acc_ = 0;
  int cnt_ = 0;
  bool marker_ = false;
};

// jidctint.c's jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2.
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The post-IDCT range limit: idct_range_limit(x & 1023), libjpeg's table.
inline uint8_t range_limit(int64_t x) {
  int t = static_cast<int>(x & 1023);
  if (t < 128) return static_cast<uint8_t>(t + 128);
  if (t < 512) return 255;
  if (t < 896) return 0;
  return static_cast<uint8_t>(t - 896);
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = static_cast<int>(int64_t(ip[0]) * qp[0] * 4);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
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
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, 11));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, 11));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, 11));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, 11));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, 11));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, 11));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, 11));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, 11));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * 8192, tmp1 = (int64_t(wp[0]) - wp[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
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
    op[0] = range_limit(descale(tmp10 + tmp3, 18));
    op[7] = range_limit(descale(tmp10 - tmp3, 18));
    op[1] = range_limit(descale(tmp11 + tmp2, 18));
    op[6] = range_limit(descale(tmp11 - tmp2, 18));
    op[2] = range_limit(descale(tmp12 + tmp1, 18));
    op[5] = range_limit(descale(tmp12 - tmp1, 18));
    op[3] = range_limit(descale(tmp13 + tmp0, 18));
    op[4] = range_limit(descale(tmp13 - tmp0, 18));
  }
}

enum class ScanKind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  // Parses up to the first scan (header_only) or the whole file.
  void run(bool header_only) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail(NM_JPEG_CORRUPT, "not a JPEG file (no SOI)");
    size_t p = 2;
    for (;;) {
      while (p < n_ && d_[p] != 0xFF) ++p;  // libjpeg skips garbage before a marker
      while (p < n_ && d_[p] == 0xFF) ++p;
      if (p >= n_) fail(NM_JPEG_CORRUPT, "file ends before EOI");
      int m = d_[p++];
      if (m == 0xD9) break;                          // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, stray RSTn
      if (p + 2 > n_) fail(NM_JPEG_CORRUPT, "truncated marker segment");
      size_t len = (size_t(d_[p]) << 8) | d_[p + 1];
      if (len < 2 || p + len > n_) fail(NM_JPEG_CORRUPT, "truncated marker segment");
      const uint8_t* s = d_ + p + 2;
      size_t sl = len - 2;
      size_t end = p + len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          progressive_ = m == 0xC2;
          frame(s, sl);
          if (header_only) return;
          break;
        case 0xC6: case 0xCA: case 0xCE:
          fail(NM_JPEG_UNSUPPORTED, "hierarchical or arithmetic-coded progressive JPEG (SOF" +
                                        std::to_string(m - 0xC0) + ")");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          fail(NM_JPEG_UNSUPPORTED, "lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
        case 0xC5:
          fail(NM_JPEG_UNSUPPORTED, "hierarchical JPEG (SOF5)");
        case 0xC9:
          fail(NM_JPEG_UNSUPPORTED, "arithmetic-coded JPEG (SOF9)");
        case 0xCC:
          fail(NM_JPEG_UNSUPPORTED, "arithmetic-coded JPEG (DAC)");
        case 0xC4: huffman(s, sl); break;
        case 0xDB: quant(s, sl); break;
        case 0xDD:
          if (sl < 2) fail(NM_JPEG_CORRUPT, "bad DRI segment");
          restart_interval_ = (s[0] << 8) | s[1];
          break;
        case 0xDA:
          if (!have_frame_) fail(NM_JPEG_CORRUPT, "SOS before SOF");
          end = scan(s, sl, end);
          break;
        case 0xDC: fail(NM_JPEG_UNSUPPORTED, "DNL marker");
        case 0xE0:
          if (sl >= 14 && !memcmp(s, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xEE:
          if (sl >= 12 && !memcmp(s, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = s[11];
          }
          break;
        default: break;  // other APPn, COM, JPG extensions: skipped
      }
      p = end;
    }
    if (!have_frame_) fail(NM_JPEG_CORRUPT, "no SOF marker");
    if (!scanned_) fail(NM_JPEG_CORRUPT, "no scan");
  }

  int height() const { return H_; }
  int width() const { return W_; }
  int channels() const { return ncomp_ == 1 ? 1 : 3; }

  void write(uint8_t* out) {
    for (auto& c : comp_) {
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
      int stride = c.bw * 8;
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                     &c.plane[size_t(by) * 8 * stride + bx * 8], stride);
    }
    if (ncomp_ == 1) {
      upsample(comp_[0], out);
      return;
    }
    // jdapimin.c's default_decompress_parms, from the markers of the header.
    bool rgb = jfif_ ? false
               : adobe_ ? adobe_transform_ == 0
                        : comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
    std::vector<uint8_t> full[3];
    for (int i = 0; i < 3; ++i) {
      full[i].resize(size_t(W_) * H_);
      upsample(comp_[i], full[i].data());
    }
    size_t n = size_t(W_) * H_;
    if (rgb) {
      for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = full[k][i];
      return;
    }
    // jdcolor.c's build_ycc_rgb_table, SCALEBITS 16.
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < n; ++i) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }

 private:
  void frame(const uint8_t* s, size_t sl) {
    if (have_frame_) fail(NM_JPEG_CORRUPT, "more than one SOF marker");
    if (sl < 6) fail(NM_JPEG_CORRUPT, "bad SOF segment");
    if (s[0] != 8) fail(NM_JPEG_UNSUPPORTED, std::to_string(s[0]) + "-bit samples");
    H_ = (s[1] << 8) | s[2];
    W_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (H_ == 0 || W_ == 0) fail(NM_JPEG_CORRUPT, "empty image (or a DNL height)");
    if (ncomp_ == 4) fail(NM_JPEG_UNSUPPORTED, "4-component (CMYK / YCCK) JPEG");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail(NM_JPEG_UNSUPPORTED, std::to_string(ncomp_) + "-component JPEG");
    if (sl < size_t(6 + 3 * ncomp_)) fail(NM_JPEG_CORRUPT, "bad SOF segment");
    comp_.resize(ncomp_);
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
      Component& c = comp_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(NM_JPEG_CORRUPT, "bad sampling factors or quantization table");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (W_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (H_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comp_) {
      if (hmax_ % c.h || vmax_ % c.v)
        fail(NM_JPEG_UNSUPPORTED, "a fractional sampling ratio (" + std::to_string(c.h) + "x" +
                                      std::to_string(c.v) + " of " + std::to_string(hmax_) +
                                      "x" + std::to_string(vmax_) + ")");
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.dw = (W_ * c.h + hmax_ - 1) / hmax_;
      c.dh = (H_ * c.v + vmax_ - 1) / vmax_;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    have_frame_ = true;
  }

  void huffman(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      if (p + 17 > sl) fail(NM_JPEG_CORRUPT, "bad DHT segment");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) fail(NM_JPEG_CORRUPT, "bad DHT table id");
      const uint8_t* counts = s + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || p + 17 + total > sl) fail(NM_JPEG_CORRUPT, "bad DHT segment");
      (tc ? ac_ : dc_)[th].build(counts, s + p + 17, total);
      p += 17 + total;
    }
  }

  void quant(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (tq > 3 || pq > 1) fail(NM_JPEG_CORRUPT, "bad DQT segment");
      size_t need = 1 + 64 * (pq + 1);
      if (p + need > sl) fail(NM_JPEG_CORRUPT, "bad DQT segment");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kNatural[k]] = pq ? (s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k] : s[p + 1 + k];
      qdef_[tq] = true;
      p += need;
    }
  }

  // One sequential scan; returns the position of the marker after it.
  size_t scan(const uint8_t* s, size_t sl, size_t data_pos) {
    if (sl < 1) fail(NM_JPEG_CORRUPT, "bad SOS segment");
    int ns = s[0];
    if (ns < 1 || ns > 4 || sl < size_t(4 + 2 * ns)) fail(NM_JPEG_CORRUPT, "bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* c = nullptr;
      for (auto& cc : comp_)
        if (cc.id == id) c = &cc;
      if (!c) fail(NM_JPEG_CORRUPT, "SOS names an unknown component");
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3) fail(NM_JPEG_CORRUPT, "bad Huffman table id");
      if (!c->latched) {  // libjpeg latches a component's table at its first scan
        if (!qdef_[c->tq]) fail(NM_JPEG_CORRUPT, "undefined quantization table");
        memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      c->pred = 0;
      sc.push_back(c);
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail(NM_JPEG_CORRUPT, "a sequential scan with spectral selection or approximation");
    } else if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1)) {
      fail(NM_JPEG_CORRUPT, "bad progressive scan parameters");
    } else if (al > 13 || (ah && ah != al + 1)) {
      fail(NM_JPEG_CORRUPT, "bad successive approximation");
    }
    // Only the tables this kind of scan reads must be defined.
    for (auto* c : sc) {
      bool need_dc = ss == 0 && ah == 0, need_ac = se > 0;
      if ((need_dc && !dc_[c->td].defined) || (need_ac && !ac_[c->ta].defined))
        fail(NM_JPEG_CORRUPT, "scan uses an undefined Huffman table");
    }
    ScanKind kind = !progressive_ ? ScanKind::kSequential
                    : ss == 0     ? (ah ? ScanKind::kDcRefine : ScanKind::kDcFirst)
                                  : (ah ? ScanKind::kAcRefine : ScanKind::kAcFirst);
    eobrun_ = 0;
    BitReader br(d_, n_, data_pos);
    int blocks_x, blocks_y;
    if (ns == 1) {  // non-interleaved: one block per MCU over the component's own size
      blocks_x = (sc[0]->dw + 7) / 8;
      blocks_y = (sc[0]->dh + 7) / 8;
    } else {
      blocks_x = mcux_;
      blocks_y = mcuy_;
    }
    long done = 0;
    int next_rst = 0;
    for (int my = 0; my < blocks_y; ++my) {
      for (int mx = 0; mx < blocks_x; ++mx) {
        if (restart_interval_ && done && done % restart_interval_ == 0) {
          br.restart(next_rst);
          next_rst = (next_rst + 1) & 7;
          for (auto* c : sc) c->pred = 0;
          eobrun_ = 0;
        }
        if (ns == 1) {
          any_block(br, kind, *sc[0], my, mx, ss, se, al);
        } else {
          for (auto* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h)
                any_block(br, kind, *c, my * c->v + v, mx * c->h + h, ss, se, al);
        }
        ++done;
      }
    }
    scanned_ = true;
    return br.next_marker();
  }

  void any_block(BitReader& br, ScanKind kind, Component& c, int by, int bx, int ss, int se,
                 int al) {
    int16_t* b = &c.coef[(size_t(by) * c.bw + bx) * 64];
    switch (kind) {
      case ScanKind::kSequential: block(br, c, by, bx); break;
      case ScanKind::kDcFirst: dc_first(br, c, b, al); break;
      case ScanKind::kDcRefine:
        if (br.bits(1)) b[0] = static_cast<int16_t>(b[0] | (1 << al));
        break;
      case ScanKind::kAcFirst: ac_first(br, c, b, ss, se, al); break;
      case ScanKind::kAcRefine: ac_refine(br, c, b, ss, se, al); break;
    }
  }

  // jdphuff.c's decode_mcu_DC_first: the DC difference, shifted by Al.
  void dc_first(BitReader& br, Component& c, int16_t* b, int al) {
    int t = br.decode(dc_[c.td]);
    if (t > 16) fail(NM_JPEG_CORRUPT, "bad DC coefficient size");
    c.pred += br.receive_extend(t);
    b[0] = static_cast<int16_t>(int32_t(uint32_t(c.pred) << al));
  }

  // decode_mcu_AC_first: one band of a block, or one block of an EOB run.
  void ac_first(BitReader& br, Component& c, int16_t* b, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& ac = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        b[kNatural[k]] = static_cast<int16_t>(int32_t(uint32_t(br.receive_extend(sz)) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br.bits(r);
        --eobrun_;
        break;
      }
    }
  }

  // decode_mcu_AC_refine: a correction bit for every coefficient already
  // nonzero, and the band's newly nonzero ones (+-1 << Al).
  void ac_refine(BitReader& br, Component& c, int16_t* b, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    auto refine = [&](int16_t& coef) {
      if (br.bits(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun_ == 0) {
      const Huffman& ac = ac_[c.ta];
      for (; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, sz = rs & 15, v = 0;
        if (sz) {
          v = br.bits(1) ? p1 : m1;  // a size other than 1 is corrupt; libjpeg warns and goes on
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.bits(r);
          break;
        }
        do {
          int16_t& coef = b[kNatural[k]];
          if (coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (v) b[kNatural[k]] = static_cast<int16_t>(v);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = b[kNatural[k]];
        if (coef != 0) refine(coef);
      }
      --eobrun_;
    }
  }

  void block(BitReader& br, Component& c, int by, int bx) {
    int16_t* b = &c.coef[(size_t(by) * c.bw + bx) * 64];
    int t = br.decode(dc_[c.td]);
    if (t > 16) fail(NM_JPEG_CORRUPT, "bad DC coefficient size");
    c.pred += br.receive_extend(t);
    b[0] = static_cast<int16_t>(c.pred);
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        b[kNatural[k]] = static_cast<int16_t>(br.receive_extend(sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // One component's samples upsampled to W x H as jdsample.c does it.
  void upsample(const Component& c, uint8_t* out) const {
    const int stride = c.bw * 8;
    const uint8_t* P = c.plane.data();
    const int rx = hmax_ / c.h, ry = vmax_ / c.v;
    auto row = [&](int j) { return P + size_t(std::clamp(j, 0, c.dh - 1)) * stride; };
    std::vector<int> colsum(c.dw + 2);
    std::vector<uint8_t> line(size_t(c.dw) * 2 + 2);
    for (int y = 0; y < H_; ++y) {
      uint8_t* o = out + size_t(y) * W_;
      int j = y / ry;
      if (rx == 1 && ry == 1) {
        memcpy(o, row(j), W_);
      } else if (rx == 2 && ry == 1) {
        const uint8_t* s = row(j);
        if (c.dw > 2) {  // h2v1_fancy_upsample
          for (int i = 0; i < c.dw; ++i) {
            int a = s[i] * 3, l = s[std::max(i - 1, 0)], r = s[std::min(i + 1, c.dw - 1)];
            line[2 * i] = static_cast<uint8_t>((a + l + 1) >> 2);
            line[2 * i + 1] = static_cast<uint8_t>((a + r + 2) >> 2);
          }
        } else {
          for (int i = 0; i < c.dw; ++i) line[2 * i] = line[2 * i + 1] = s[i];
        }
        memcpy(o, line.data(), W_);
      } else if (rx == 1 && ry == 2) {  // h1v2_fancy_upsample
        const uint8_t* s0 = row(j);
        bool below = y & 1;
        const uint8_t* s1 = row(below ? j + 1 : j - 1);
        int bias = below ? 2 : 1;
        for (int i = 0; i < W_; ++i) o[i] = static_cast<uint8_t>((s0[i] * 3 + s1[i] + bias) >> 2);
      } else if (rx != 2 || ry != 2) {  // int_upsample: replicate rx x ry
        const uint8_t* s = row(j);
        for (int i = 0; i < W_; ++i) o[i] = s[i / rx];
      } else {  // rx == 2 && ry == 2
        const uint8_t* s0 = row(j);
        if (c.dw > 2) {  // h2v2_fancy_upsample
          const uint8_t* s1 = row((y & 1) ? j + 1 : j - 1);
          for (int i = 0; i < c.dw; ++i) colsum[i + 1] = s0[i] * 3 + s1[i];
          colsum[0] = colsum[1];
          colsum[c.dw + 1] = colsum[c.dw];
          for (int i = 0; i < c.dw; ++i) {
            int t = colsum[i + 1] * 3;
            line[2 * i] = static_cast<uint8_t>((t + colsum[i] + 8) >> 4);
            line[2 * i + 1] = static_cast<uint8_t>((t + colsum[i + 2] + 7) >> 4);
          }
        } else {
          for (int i = 0; i < c.dw; ++i) line[2 * i] = line[2 * i + 1] = s0[i];
        }
        memcpy(o, line.data(), W_);
      }
    }
  }

  const uint8_t* d_;
  size_t n_;
  int H_ = 0, W_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  int eobrun_ = 0;  // blocks left in a progressive AC scan's end-of-band run
  bool progressive_ = false;
  bool have_frame_ = false, scanned_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  std::vector<Component> comp_;
  Huffman dc_[4], ac_[4];
  int32_t qt_[4][64];
  bool qdef_[4] = {false, false, false, false};
};

int report(const JpegError& e, char* err, int64_t errlen) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

int nm_jpeg_info(const uint8_t* data, int64_t size, int32_t* hwc, char* err, int64_t errlen) {
  try {
    Decoder dec(data, size_t(size));
    dec.run(true);
    hwc[0] = dec.height();
    hwc[1] = dec.width();
    hwc[2] = dec.channels();
    return NM_JPEG_OK;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(JpegError{NM_JPEG_CORRUPT, "out of memory"}, err, errlen);
  }
}

int nm_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* err,
                   int64_t errlen) {
  try {
    Decoder dec(data, size_t(size));
    dec.run(false);
    if (int64_t(dec.height()) * dec.width() * dec.channels() != out_size)
      throw JpegError{NM_JPEG_CORRUPT, "output buffer of the wrong size"};
    dec.write(out);
    return NM_JPEG_OK;
  } catch (const JpegError& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(JpegError{NM_JPEG_CORRUPT, "out of memory"}, err, errlen);
  }
}

}  // extern "C"
