// Baseline JPEG encoder of the PyTorch port (host C++, built with g++ by
// nerfmeshes_tpu_torch/data/jpeg.py and bound with ctypes).
//
// Writes what libjpeg-turbo writes with its default compression parameters
// (PIL's `Image.save(format="JPEG")`, and so imageio's JPEG writer), byte
// for byte:
//   - SOI, a JFIF 1.01 APP0 (density unit 0, density 1:1), one DQT segment
//     per table, SOF0, one DHT segment per table (DC then AC of each
//     component's tables, each once), SOS, the entropy-coded data, EOI;
//   - RGB -> YCbCr in jccolor.c's fixed point (16 scale bits, Cb and Cr
//     rounded with ONE_HALF - 1);
//   - 4:2:0 sampling (Y 2x2, Cb and Cr 1x1): jcsample.c's h2v2_downsample
//     with its alternating bias 1, 2, 1, 2 along each row; the right edge
//     replicated to whole blocks (expand_right_edge), the bottom to an even
//     row count before downsampling and to the MCU height after it
//     (jcprepct.c's expand_bottom_edge);
//   - the islow forward DCT of jfdctint.c (CONST_BITS 13, PASS1_BITS 2) on
//     samples less 128, quantized as libjpeg-turbo's jcdctmgr.c quantizes:
//     a multiply by compute_reciprocal's reciprocal, correction and shift;
//   - the Annex K tables scaled to quality 75 as jcparam.c scales them;
//   - the Annex K Huffman tables, one interleaved scan (one
//     non-interleaved scan for grey), dummy blocks at the right and bottom
//     of the last MCUs with zero AC and the previous block's DC
//     (jccoefct.c), and the last byte padded with one bits.
// A grey image is one component (JCS_GRAYSCALE): table 0 only.
//
// C entry point:
//   int64_t nm_jpeg_encode(img, H, W, C, out, capacity)
// img is H x W x C uint8 (C 1 or 3). Returns the file's size, written to
// `out` when it fits in `capacity` (else nothing is written: call again
// with that much room), or -1 for bad arguments.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {  // zig-zag position -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1 / K.2 quantization tables, natural order.
const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman tables: code counts by length 1..16, then symbols.
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  void build() {  // jchuff.c's jpeg_make_c_derived_tbl
    memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

struct Quant {
  uint8_t table[64];  // natural order, as written
  uint32_t recip[64], corr[64];
  int shift[64];

  // jcparam.c's jpeg_add_quant_table at quality 75 (scale 50%), then
  // jcdctmgr.c's compute_reciprocal of each divisor (quantval << 3).
  void build(const int* basic) {
    for (int i = 0; i < 64; ++i) {
      long t = (long(basic[i]) * 50 + 50L) / 100L;
      t = std::clamp(t, 1L, 255L);
      table[i] = static_cast<uint8_t>(t);
      uint32_t divisor = uint32_t(t) << 3;
      int b = 31 - __builtin_clz(divisor);
      int r = 16 + b;
      uint32_t fq = (uint32_t(1) << r) / divisor;
      uint32_t fr = (uint32_t(1) << r) % divisor;
      uint32_t c = divisor / 2;
      if (fr == 0) {
        fq >>= 1;
        --r;
      } else if (fr <= divisor / 2) {
        ++c;
      } else {
        ++fq;
      }
      recip[i] = fq & 0xFFFF;
      corr[i] = c & 0xFFFF;
      shift[i] = r;
    }
  }
};

constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int descale(int64_t x, int n) {
  return static_cast<int>((x + (int64_t(1) << (n - 1))) >> n);
}

// jfdctint.c's jpeg_fdct_islow, in place on 64 level-shifted samples.
void fdct_islow(int* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    for (int k = 0; k < 8; ++k) {
      int* p = d + k * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
      const int nb = pass ? 15 : 11;  // CONST_BITS -/+ PASS1_BITS
      if (pass) {
        p[0] = descale(tmp10 + tmp11, 2);
        p[4 * step] = descale(tmp10 - tmp11, 2);
      } else {
        p[0] = static_cast<int>((tmp10 + tmp11) * 4);
        p[4 * step] = static_cast<int>((tmp10 - tmp11) * 4);
      }
      p[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, nb);
      p[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, nb);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, nb);
      p[5 * step] = descale(tmp5 + z2 + z4, nb);
      p[3 * step] = descale(tmp6 + z2 + z3, nb);
      p[step] = descale(tmp7 + z1 + z4, nb);
    }
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}

  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((uint32_t(1) << size) - 1));
    cnt_ += size;
    while (cnt_ >= 8) {
      uint8_t byte = static_cast<uint8_t>(acc_ >> (cnt_ - 8));
      out_.push_back(byte);
      if (byte == 0xFF) out_.push_back(0);
      cnt_ -= 8;
    }
    acc_ &= (uint32_t(1) << cnt_) - 1;
  }

  void flush() { put(0x7F, 7); cnt_ = 0; acc_ = 0; }  // pad the last byte with ones

 private:
  std::vector<uint8_t>& out_;
  uint32_t acc_ = 0;
  int cnt_ = 0;
};

struct Plane {
  int bw = 0, bh = 0;            // blocks wide and high in the stored samples
  int width_in_blocks = 0, height_in_blocks = 0;
  std::vector<uint8_t> s;        // (bh * 8) x (bw * 8)
  int at(int y, int x) const { return s[size_t(y) * bw * 8 + x]; }
};

// A component's samples, its right edge replicated to `cols` and its
// bottom to `rows`.
Plane pad_plane(const std::vector<uint8_t>& src, int w, int h, int cols, int rows) {
  Plane p;
  p.bw = cols / 8;
  p.bh = rows / 8;
  p.s.resize(size_t(rows) * cols);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* r = &src[size_t(std::min(y, h - 1)) * w];
    uint8_t* o = &p.s[size_t(y) * cols];
    memcpy(o, r, w);
    memset(o + w, r[w - 1], cols - w);
  }
  return p;
}

class Encoder {
 public:
  Encoder(const uint8_t* img, int H, int W, int C) : img_(img), H_(H), W_(W), C_(C) {
    q_[0].build(kStdLuma);
    q_[1].build(kStdChroma);
    dc_[0] = {kDcLumaBits, kDcVals, 12, {}, {}};
    ac_[0] = {kAcLumaBits, kAcLumaVals, 162, {}, {}};
    dc_[1] = {kDcChromaBits, kDcVals, 12, {}, {}};
    ac_[1] = {kAcChromaBits, kAcChromaVals, 162, {}, {}};
    for (auto* t : {&dc_[0], &ac_[0], &dc_[1], &ac_[1]}) t->build();
  }

  void run(std::vector<uint8_t>& out) {
    headers(out);
    BitWriter bw(out);
    if (C_ == 1) {
      grey(bw);
    } else {
      colour(bw);
    }
    bw.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
  }

 private:
  static void u16(std::vector<uint8_t>& o, int v) {
    o.push_back(static_cast<uint8_t>(v >> 8));
    o.push_back(static_cast<uint8_t>(v & 0xFF));
  }

  void headers(std::vector<uint8_t>& o) {
    const int ntab = C_ == 1 ? 1 : 2;
    o.insert(o.end(), {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                       0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
    for (int t = 0; t < ntab; ++t) {
      o.insert(o.end(), {0xFF, 0xDB, 0x00, 0x43, static_cast<uint8_t>(t)});
      for (int k = 0; k < 64; ++k) o.push_back(q_[t].table[kZigzag[k]]);
    }
    o.insert(o.end(), {0xFF, 0xC0});
    u16(o, 8 + 3 * C_);
    o.push_back(8);
    u16(o, H_);
    u16(o, W_);
    o.push_back(static_cast<uint8_t>(C_));
    if (C_ == 1) {
      o.insert(o.end(), {1, 0x11, 0});
    } else {
      o.insert(o.end(), {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
    }
    for (int t = 0; t < ntab; ++t) {
      for (int ac = 0; ac < 2; ++ac) {
        const HuffTable& h = ac ? ac_[t] : dc_[t];
        o.insert(o.end(), {0xFF, 0xC4});
        u16(o, 2 + 1 + 16 + h.nvals);
        o.push_back(static_cast<uint8_t>((ac << 4) | t));
        o.insert(o.end(), h.bits, h.bits + 16);
        o.insert(o.end(), h.vals, h.vals + h.nvals);
      }
    }
    o.insert(o.end(), {0xFF, 0xDA});
    u16(o, 6 + 2 * C_);
    o.push_back(static_cast<uint8_t>(C_));
    if (C_ == 1) {
      o.insert(o.end(), {1, 0x00});
    } else {
      o.insert(o.end(), {1, 0x00, 2, 0x11, 3, 0x11});
    }
    o.insert(o.end(), {0x00, 0x3F, 0x00});
  }

  // forward_DCT + quantize of the block at (by, bx) of `p`, zig-zag order.
  void block_coefs(const Plane& p, int by, int bx, const Quant& q, int16_t* out) const {
    int d[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) d[8 * y + x] = p.at(by * 8 + y, bx * 8 + x) - 128;
    fdct_islow(d);
    for (int k = 0; k < 64; ++k) {
      int i = kZigzag[k];
      int t = d[i];
      uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
      uint32_t v = ((a + q.corr[i]) * q.recip[i]) >> q.shift[i];
      out[k] = static_cast<int16_t>(t < 0 ? -int(v) : int(v));
    }
  }

  void encode_block(BitWriter& bw, const int16_t* z, int& last_dc, int t) const {
    const HuffTable& dc = dc_[t];
    const HuffTable& ac = ac_[t];
    int diff = z[0] - last_dc;
    last_dc = z[0];
    int v = diff < 0 ? -diff : diff, bits = diff < 0 ? diff - 1 : diff;
    int n = v ? 32 - __builtin_clz(static_cast<uint32_t>(v)) : 0;
    bw.put(dc.code[n], dc.size[n]);
    if (n) bw.put(static_cast<uint32_t>(bits), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int c = z[k];
      if (c == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        run -= 16;
      }
      v = c < 0 ? -c : c;
      bits = c < 0 ? c - 1 : c;
      n = 32 - __builtin_clz(static_cast<uint32_t>(v));
      int sym = (run << 4) | n;
      bw.put(ac.code[sym], ac.size[sym]);
      bw.put(static_cast<uint32_t>(bits), n);
      run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
  }

  void grey(BitWriter& bw) {
    std::vector<uint8_t> src(img_, img_ + size_t(H_) * W_);
    int wb = (W_ + 7) / 8, hb = (H_ + 7) / 8;
    Plane p = pad_plane(src, W_, H_, wb * 8, hb * 8);
    int last = 0;
    int16_t z[64];
    for (int by = 0; by < hb; ++by)
      for (int bx = 0; bx < wb; ++bx) {
        block_coefs(p, by, bx, q_[0], z);
        encode_block(bw, z, last, 0);
      }
  }

  void colour(BitWriter& bw) {
    const size_t n = size_t(H_) * W_;
    std::vector<uint8_t> ycc[3];
    for (auto& c : ycc) c.resize(n);
    for (size_t i = 0; i < n; ++i) {  // jccolor.c's rgb_ycc_convert
      int32_t r = img_[3 * i], g = img_[3 * i + 1], b = img_[3 * i + 2];
      ycc[0][i] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      ycc[1][i] = static_cast<uint8_t>((-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767)
                                       >> 16);
      ycc[2][i] = static_cast<uint8_t>((32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767)
                                       >> 16);
    }
    const int mcux = (W_ + 15) / 16, mcuy = (H_ + 15) / 16;
    // Y: full size, blocks up to width_in_blocks; MCU rows of 16 samples.
    const int ywb = (W_ + 7) / 8, yhb = (H_ + 7) / 8;
    Plane Y = pad_plane(ycc[0], W_, H_, ywb * 8, mcuy * 16);
    // Cb, Cr: h2v2-downsampled from the edge-padded full-size planes.
    const int cw = (W_ + 1) / 2, ch = (H_ + 1) / 2;
    const int cwb = (cw + 7) / 8;
    Plane CbCr[2];
    for (int k = 0; k < 2; ++k) {
      Plane full = pad_plane(ycc[k + 1], W_, H_, cwb * 16, ch * 2);
      std::vector<uint8_t> down(size_t(ch) * cwb * 8);
      for (int y = 0; y < ch; ++y) {
        int bias = 1;
        for (int x = 0; x < cwb * 8; ++x) {
          int s = full.at(2 * y, 2 * x) + full.at(2 * y, 2 * x + 1) + full.at(2 * y + 1, 2 * x) +
                  full.at(2 * y + 1, 2 * x + 1);
          down[size_t(y) * cwb * 8 + x] = static_cast<uint8_t>((s + bias) >> 2);
          bias ^= 3;
        }
      }
      CbCr[k] = pad_plane(down, cwb * 8, ch, cwb * 8, mcuy * 8);
    }
    // jccoefct.c's compress_data: right and bottom dummy Y blocks.
    const int last_col_width = ywb % 2 ? 1 : 2, last_row_height = yhb % 2 ? 1 : 2;
    int last[3] = {0, 0, 0};
    int16_t mcu[6][64];
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        int blockcnt = mx < mcux - 1 ? 2 : last_col_width;
        for (int yi = 0; yi < 2; ++yi) {
          int16_t* row = mcu[2 * yi];
          if (my < mcuy - 1 || yi < last_row_height) {
            for (int bi = 0; bi < blockcnt; ++bi)
              block_coefs(Y, 2 * my + yi, 2 * mx + bi, q_[0], row + 64 * bi);
            if (blockcnt < 2) {
              memset(row + 64, 0, 64 * sizeof(int16_t));
              row[64] = row[0];
            }
          } else {
            memset(row, 0, 128 * sizeof(int16_t));
            row[0] = row[64] = mcu[2 * yi - 1][0];
          }
        }
        block_coefs(CbCr[0], my, mx, q_[1], mcu[4]);
        block_coefs(CbCr[1], my, mx, q_[1], mcu[5]);
        for (int b = 0; b < 4; ++b) encode_block(bw, mcu[b], last[0], 0);
        encode_block(bw, mcu[4], last[1], 1);
        encode_block(bw, mcu[5], last[2], 1);
      }
    }
  }

  const uint8_t* img_;
  int H_, W_, C_;
  Quant q_[2];
  HuffTable dc_[2], ac_[2];
};

}  // namespace

extern "C" {

int64_t nm_jpeg_encode(const uint8_t* img, int32_t H, int32_t W, int32_t C, uint8_t* out,
                       int64_t capacity) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535 || (C != 1 && C != 3)) return -1;
  std::vector<uint8_t> buf;
  buf.reserve(size_t(H) * W * C / 4 + 1024);
  Encoder(img, H, W, C).run(buf);
  int64_t size = static_cast<int64_t>(buf.size());
  if (size <= capacity) memcpy(out, buf.data(), buf.size());
  return size;
}

}  // extern "C"
