// Animated GIF encoder of the PyTorch port (host C++, built with g++ by
// nerfmeshes_tpu_torch/data/gif.py and bound with ctypes).
//
// Writes GIF89a: a logical screen of the frames' size whose global colour
// table is the first frame's palette, a NETSCAPE2.0 application block with
// the loop count (0: forever), and per frame a Graphic Control Extension
// with the delay in hundredths of a second, an image descriptor over the
// whole screen (later frames with a local colour table) and the frame's
// LZW data in sub-blocks of at most 255 bytes; then the trailer.
//
// Each frame gets its own palette of at most 256 colours by a median cut
// over the frame's distinct colours, without dithering (what Pillow does
// for RGB frames): the box whose colours have the largest squared error
// about their mean is split at the count-weighted median of its widest
// channel, until 256 boxes; an entry is its box's weighted mean. A frame of
// at most 256 colours keeps them exactly. Every colour is then drawn as its
// nearest palette entry. The LZW coder is giflib's: 8-bit roots, codes of
// 9 to 12 bits, a clear code when the table is full.
//
// Frames are independent, so they are coded on as many threads as the host
// has cores.
//
// C entry point:
//   int64_t nm_gif_encode(frames, n, H, W, delay_cs, loop, out, capacity)
// frames is n x H x W x 3 uint8. Returns the file's size, written to
// `out` when it fits in `capacity` (else nothing is written: call again
// with that much room), or -1 for bad arguments.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct Colour {
  uint8_t c[3];
  uint32_t count;
};

struct Box {
  int lo, hi;        // range of the colour array
  double err;        // squared error about the mean, count-weighted
  int axis;          // channel of the largest spread
  uint8_t mean[3];
};

Box make_box(const std::vector<Colour>& cols, int lo, int hi) {
  Box b{lo, hi, 0.0, 0, {0, 0, 0}};
  double n = 0, s[3] = {0, 0, 0}, s2[3] = {0, 0, 0};
  for (int i = lo; i < hi; ++i) {
    double w = cols[i].count;
    n += w;
    for (int k = 0; k < 3; ++k) {
      s[k] += w * cols[i].c[k];
      s2[k] += w * cols[i].c[k] * cols[i].c[k];
    }
  }
  double best = -1;
  for (int k = 0; k < 3; ++k) {
    double var = s2[k] - s[k] * s[k] / n;  // n * variance
    b.err += var;
    if (var > best) {
      best = var;
      b.axis = k;
    }
    b.mean[k] = static_cast<uint8_t>(std::min(255.0, s[k] / n + 0.5));
  }
  if (hi - lo < 2) b.err = 0;
  return b;
}

// The frame's palette (<= 256 entries) and each pixel's index.
void quantize(const uint8_t* rgb, size_t npx, std::vector<uint8_t>& palette,
              std::vector<uint8_t>& index) {
  std::vector<uint32_t> keys(npx);
  for (size_t i = 0; i < npx; ++i)
    keys[i] = (uint32_t(rgb[3 * i]) << 16) | (uint32_t(rgb[3 * i + 1]) << 8) | rgb[3 * i + 2];
  std::vector<uint32_t> sorted(keys);
  std::sort(sorted.begin(), sorted.end());
  std::vector<Colour> cols;
  std::vector<uint32_t> uniq;
  for (size_t i = 0; i < npx;) {
    size_t j = i;
    while (j < npx && sorted[j] == sorted[i]) ++j;
    uint32_t k = sorted[i];
    cols.push_back({{uint8_t(k >> 16), uint8_t(k >> 8), uint8_t(k)}, uint32_t(j - i)});
    uniq.push_back(k);
    i = j;
  }
  std::vector<uint8_t> entry_of(cols.size());  // palette entry of each distinct colour
  palette.clear();
  if (cols.size() <= 256) {
    for (size_t i = 0; i < cols.size(); ++i) {
      palette.insert(palette.end(), cols[i].c, cols[i].c + 3);
      entry_of[i] = static_cast<uint8_t>(i);
    }
  } else {
    std::vector<Box> boxes{make_box(cols, 0, int(cols.size()))};
    while (boxes.size() < 256) {
      auto it = std::max_element(boxes.begin(), boxes.end(),
                                 [](const Box& a, const Box& b) { return a.err < b.err; });
      if (it->err <= 0) break;
      Box b = *it;
      const int ax = b.axis;
      std::sort(cols.begin() + b.lo, cols.begin() + b.hi,
                [ax](const Colour& x, const Colour& y) { return x.c[ax] < y.c[ax]; });
      double total = 0;
      for (int i = b.lo; i < b.hi; ++i) total += cols[i].count;
      double acc = 0;
      int cut = b.lo + 1;
      for (int i = b.lo; i < b.hi - 1; ++i) {
        acc += cols[i].count;
        cut = i + 1;
        if (acc >= total / 2) break;
      }
      *it = make_box(cols, b.lo, cut);
      boxes.push_back(make_box(cols, cut, b.hi));
    }
    for (const Box& b : boxes) palette.insert(palette.end(), b.mean, b.mean + 3);
    // Nearest entry of every distinct colour, the palette sorted by red so
    // the search can stop once red alone is farther than the best.
    const int np = int(boxes.size());
    std::vector<int> order(np);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(),
              [&](int a, int b) { return palette[3 * a] < palette[3 * b]; });
    std::vector<int> pr(np), pg(np), pb(np);
    for (int i = 0; i < np; ++i) {
      pr[i] = palette[3 * order[i]];
      pg[i] = palette[3 * order[i] + 1];
      pb[i] = palette[3 * order[i] + 2];
    }
    std::vector<uint32_t> key_of(cols.size());
    for (size_t i = 0; i < cols.size(); ++i) {
      int r = cols[i].c[0], g = cols[i].c[1], bl = cols[i].c[2];
      int start = int(std::lower_bound(pr.begin(), pr.end(), r) - pr.begin());
      int best = 1 << 30, arg = 0;
      for (int j = start; j < np; ++j) {
        int dr = pr[j] - r;
        if (dr * dr >= best) break;
        int d = dr * dr + (pg[j] - g) * (pg[j] - g) + (pb[j] - bl) * (pb[j] - bl);
        if (d < best) best = d, arg = j;
      }
      for (int j = start - 1; j >= 0; --j) {
        int dr = r - pr[j];
        if (dr * dr >= best) break;
        int d = dr * dr + (pg[j] - g) * (pg[j] - g) + (pb[j] - bl) * (pb[j] - bl);
        if (d < best) best = d, arg = j;
      }
      key_of[i] = (uint32_t(r) << 16) | (uint32_t(g) << 8) | bl;
      entry_of[i] = static_cast<uint8_t>(order[arg]);
    }
    // cols was reordered by the splits: key the entries by colour again.
    std::vector<uint32_t> perm(cols.size());
    std::iota(perm.begin(), perm.end(), 0);
    std::sort(perm.begin(), perm.end(),
              [&](uint32_t a, uint32_t b) { return key_of[a] < key_of[b]; });
    std::vector<uint8_t> by_key(cols.size());
    for (size_t i = 0; i < cols.size(); ++i) by_key[i] = entry_of[perm[i]];
    entry_of.swap(by_key);
  }
  palette.resize(256 * 3, 0);
  index.resize(npx);
  for (size_t i = 0; i < npx; ++i)
    index[i] = entry_of[std::lower_bound(uniq.begin(), uniq.end(), keys[i]) - uniq.begin()];
}

// giflib's EGifCompressLine over one frame's indices (8-bit roots).
class Lzw {
 public:
  explicit Lzw(std::vector<uint8_t>& out) : out_(out), table_(4096 * 256) {}

  void encode(const std::vector<uint8_t>& px) {
    out_.push_back(8);  // LZW minimum code size
    reset();
    put(kClear);
    int cur = px[0];
    for (size_t i = 1; i < px.size(); ++i) {
      int p = px[i];
      int16_t& slot = table_[size_t(cur) * 256 + p];
      if (slot) {
        cur = slot;
        continue;
      }
      put(cur);
      cur = p;
      if (next_ >= 4095) {
        put(kClear);
        reset();
      } else {
        slot = static_cast<int16_t>(next_++);
      }
    }
    put(cur);
    put(kEoi);
    if (nbits_ > 0) byte(static_cast<uint8_t>(acc_));
    if (block_.size()) flush_block();
    out_.push_back(0);  // block terminator
  }

 private:
  static constexpr int kClear = 256, kEoi = 257;

  void reset() {
    std::fill(table_.begin(), table_.end(), 0);
    next_ = kEoi + 1;
    size_ = 9;
    max_ = 1 << size_;
  }

  void put(int code) {  // CompressOutput: LSB first, then widen the codes
    acc_ |= uint32_t(code) << nbits_;
    nbits_ += size_;
    while (nbits_ >= 8) {
      byte(static_cast<uint8_t>(acc_ & 0xFF));
      acc_ >>= 8;
      nbits_ -= 8;
    }
    if (next_ >= max_ && code <= 4095 && size_ < 12) max_ = 1 << ++size_;
  }

  void byte(uint8_t b) {
    block_.push_back(b);
    if (block_.size() == 255) flush_block();
  }

  void flush_block() {
    out_.push_back(static_cast<uint8_t>(block_.size()));
    out_.insert(out_.end(), block_.begin(), block_.end());
    block_.clear();
  }

  std::vector<uint8_t>& out_;
  std::vector<int16_t> table_;  // (prefix code, byte) -> code, 0 if absent
  std::vector<uint8_t> block_;
  uint32_t acc_ = 0;
  int nbits_ = 0, next_ = 0, size_ = 9, max_ = 512;
};

void u16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v & 0xFF));
  o.push_back(static_cast<uint8_t>(v >> 8));
}

// One frame's blocks (GCE, descriptor, local table unless `global`, LZW
// data); its palette goes to `palette`.
void frame(const uint8_t* rgb, int H, int W, int delay_cs, bool global,
           std::vector<uint8_t>& palette, std::vector<uint8_t>& o) {
  std::vector<uint8_t> index;
  quantize(rgb, size_t(H) * W, palette, index);
  o.insert(o.end(), {0x21, 0xF9, 0x04, 0x04});  // disposal 1: leave the frame in place
  u16(o, delay_cs);
  o.insert(o.end(), {0x00, 0x00});
  o.push_back(0x2C);
  u16(o, 0);
  u16(o, 0);
  u16(o, W);
  u16(o, H);
  if (global) {
    o.push_back(0x00);
  } else {
    o.push_back(0x87);  // a local table of 256 entries
    o.insert(o.end(), palette.begin(), palette.end());
  }
  Lzw(o).encode(index);
}

}  // namespace

extern "C" {

int64_t nm_gif_encode(const uint8_t* frames, int32_t n, int32_t H, int32_t W, int32_t delay_cs,
                      int32_t loop, uint8_t* out, int64_t capacity) {
  if (n < 1 || H < 1 || W < 1 || H > 65535 || W > 65535 || delay_cs < 0 || delay_cs > 65535 ||
      loop < 0 || loop > 65535)
    return -1;
  std::vector<std::vector<uint8_t>> parts(n), palettes(n);
  const size_t fsz = size_t(H) * W * 3;
  int threads = std::max(1, std::min<int>(n, int(std::thread::hardware_concurrency())));
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      for (int i = t; i < n; i += threads)
        frame(frames + fsz * i, H, W, delay_cs, i == 0, palettes[i], parts[i]);
    });
  for (auto& th : pool) th.join();

  std::vector<uint8_t> o{'G', 'I', 'F', '8', '9', 'a'};
  u16(o, W);
  u16(o, H);
  o.insert(o.end(), {0xF7, 0x00, 0x00});  // a global table of 256 entries
  o.insert(o.end(), palettes[0].begin(), palettes[0].end());
  o.insert(o.end(), {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A', 'P', 'E', '2', '.', '0', 0x03,
                     0x01});
  u16(o, loop);
  o.push_back(0x00);
  for (auto& p : parts) o.insert(o.end(), p.begin(), p.end());
  o.push_back(0x3B);
  int64_t size = static_cast<int64_t>(o.size());
  if (size <= capacity) memcpy(out, o.data(), o.size());
  return size;
}

}  // extern "C"
