// Lossless WebP (VP8L) decoding on the host, behind a plain C interface (loaded through
// ctypes by foley_tpu_torch/io/webp.py; built by ops/kernels/build.py's host route). The
// RIFF container is parsed in Python; this file takes a VP8L chunk's payload and writes the
// image as ARGB words, whose RGB bytes the caller takes out. It also decodes a lossy
// picture's VP8L-compressed ALPH plane (the same image stream without the VP8L header), so
// that a corrupt one fails where libwebp fails.
//
// The bitstream follows the WebP lossless format (RFC 9649) as libwebp's vp8l_dec.c reads
// it: bits least significant first; the transforms (predictor with its 14 modes,
// cross-colour, subtract-green, colour indexing with pixel bundling), each read once and
// inverted in reverse order; the colour cache; the meta prefix codes of the entropy image;
// normal and simple prefix codes (the 19 code-length codes in their fixed order, repeat
// codes 16-18); LZ77 backward references with the 120-entry distance map. Every stage is
// sequential: a pixel's prefix group, its cache state and (for the predictor) its left
// neighbour depend on the pixels before it.
//
// Data that ends early, an invalid prefix code, a copy before the image's start or past its
// end, or a transform read twice is an error (non-zero return and a message), which the
// Python side raises as ValueError.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                                  15};
// the distance map: (yoffset << 4) | (8 - xoffset) of the 120 short distance codes
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};
const int kRootBits = 8;  // a table of 256 a code: a frame may hold thousands of codes
enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };
enum { kGreen = 0, kRed = 1, kBlue = 2, kAlpha = 3, kDist = 4 };

struct Error {};

struct BitReader {
  const uint8_t* data;
  int64_t size, pos = 0;
  uint64_t buf = 0;
  int nbits = 0;

  void fill() {
    while (nbits <= 56 && pos < size) {
      buf |= (uint64_t)data[pos++] << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(buf & ((1ull << n) - 1));
  }
  void skip(int n) {
    if (n > nbits) throw Error();  // past the end of the data
    buf >>= n;
    nbits -= n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

// A canonical prefix code: a root table of kRootBits indexed by the next bits (codes are
// sent most significant bit first, so a table index holds the code's bits reversed), and a
// bit-by-bit walk for longer codes.
struct PrefixCode {
  std::vector<uint32_t> root;  // symbol << 8 | length; length 0: longer than kRootBits
  int first[16], count[16], offset[16];
  std::vector<int> sorted;  // symbols by (length, symbol)
  int single = -1;          // the only symbol of a one-symbol code (zero bits)

  // false if the lengths do not make a complete code
  bool build(const int* lengths, int n) {
    int nonzero = 0, last = 0;
    std::memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++nonzero;
        last = s;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    int64_t kraft = 0;
    for (int l = 1; l <= 15; ++l) kraft += (int64_t)count[l] << (15 - l);
    if (kraft != (1 << 15)) return false;
    int code = 0, off = 0;
    for (int l = 1; l <= 15; ++l) {
      first[l] = code;
      offset[l] = off;
      code = (code + count[l]) << 1;
      off += count[l];
    }
    sorted.assign(nonzero, 0);
    int next[16];
    std::memcpy(next, offset, sizeof(next));
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[next[lengths[s]]++] = s;
    root.assign(1 << kRootBits, 0);
    for (int l = 1; l <= kRootBits; ++l) {
      for (int i = 0; i < count[l]; ++i) {
        int c = first[l] + i, rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1) << (l - 1 - b);
        uint32_t entry = ((uint32_t)sorted[offset[l] + i] << 8) | (uint32_t)l;
        for (int k = rev; k < (1 << kRootBits); k += 1 << l) root[k] = entry;
      }
    }
    return true;
  }

  int decode(BitReader* br) const {
    if (single >= 0) return single;
    uint32_t bits = br->peek(15);
    uint32_t e = root[bits & ((1 << kRootBits) - 1)];
    if (e & 0xff) {
      br->skip((int)(e & 0xff));
      return (int)(e >> 8);
    }
    int code = 0;
    for (int l = 1; l <= 15; ++l) {
      code = (code << 1) | (int)((bits >> (l - 1)) & 1);
      if (code - first[l] < count[l] && code >= first[l]) {
        br->skip(l);
        return sorted[offset[l] + code - first[l]];
      }
    }
    throw Error();
  }
};

int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Decoder {
  BitReader br;
  char* err;
  int32_t err_len;

  [[noreturn]] void fail(const char* msg, long long a = 0) {
    if (err && err_len > 0) std::snprintf(err, (size_t)err_len, msg, a);
    throw Error();
  }

  void read_code(int alphabet, PrefixCode* code) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code: one or two symbols
      int n = (int)br.read(1) + 1;
      int first_bits = br.read(1) ? 8 : 1;
      int s0 = (int)br.read(first_bits);
      if (s0 >= alphabet) fail("a simple prefix code's symbol %lld is past its alphabet", s0);
      lengths[s0] = 1;
      if (n == 2) {
        int s1 = (int)br.read(8);
        if (s1 >= alphabet) fail("a simple prefix code's symbol %lld is past its alphabet", s1);
        lengths[s1] = 1;
      }
    } else {  // normal code: code lengths coded by a code of their own
      int cl_lengths[19] = {0};
      int n = (int)br.read(4) + 4;
      if (n > 19) fail("%lld code-length codes (19 at most)", n);
      for (int i = 0; i < n; ++i) cl_lengths[kCodeLengthOrder[i]] = (int)br.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths, 19)) fail("an invalid code-length code");
      int max_symbol = alphabet;
      if (br.read(1)) {
        int nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(nbits);
        if (max_symbol > alphabet) fail("a prefix code of %lld symbols past its alphabet", max_symbol);
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        int len = cl.decode(&br);
        if (len < 16) {
          lengths[s++] = len;
          if (len) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = (int)br.read(kExtra[len - 16]) + kOffset[len - 16];
          if (s + repeat > alphabet) fail("code lengths past the alphabet at symbol %lld", s);
          int v = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[s++] = v;
        }
      }
    }
    if (!code->build(lengths.data(), alphabet)) fail("an invalid prefix code (%lld symbols)", alphabet);
  }

  int copy_value(int symbol) {  // a length or distance from its prefix symbol
    if (symbol < 4) return symbol + 1;
    int extra = (symbol - 2) >> 1;
    int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  // One entropy-coded image of xsize x ysize ARGB words; the top level also reads the meta
  // prefix codes.
  std::vector<uint32_t> decode_image(int xsize, int ysize, bool top) {
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("a colour cache of %lld bits", cache_bits);
    }
    int meta_bits = 0, meta_w = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (top && br.read(1)) {
      meta_bits = (int)br.read(3) + 2;
      meta_w = sub_sample(xsize, meta_bits);
      meta = decode_image(meta_w, sub_sample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if ((int)m + 1 > groups) groups = (int)m + 1;
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
    std::vector<PrefixCode> codes(5 * (size_t)groups);
    for (int g = 0; g < groups; ++g)
      for (int k = 0; k < 5; ++k) read_code(alphabets[k], &codes[5 * (size_t)g + k]);
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const int cache_shift = 32 - cache_bits;
    std::vector<uint32_t> px((size_t)xsize * ysize);
    const int64_t total = (int64_t)xsize * ysize;
    int64_t i = 0, cached = 0;
    auto flush_cache = [&]() {
      if (!cache_size) return;
      for (; cached < i; ++cached) cache[(0x1e35a7bdu * px[cached]) >> cache_shift] = px[cached];
    };
    while (i < total) {
      int x = (int)(i % xsize), y = (int)(i / xsize);
      const PrefixCode* g = codes.data();
      if (meta_bits) g += 5 * (size_t)meta[(size_t)(y >> meta_bits) * meta_w + (x >> meta_bits)];
      int green = g[kGreen].decode(&br);
      if (green < 256) {
        uint32_t red = g[kRed].decode(&br), blue = g[kBlue].decode(&br);
        uint32_t alpha = g[kAlpha].decode(&br);
        px[i++] = (alpha << 24) | (red << 16) | ((uint32_t)green << 8) | blue;
      } else if (green < 256 + 24) {
        int length = copy_value(green - 256);
        int dist_code = copy_value(g[kDist].decode(&br));
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          int c = kCodeToPlane[dist_code - 1];
          dist = (int64_t)(c >> 4) * xsize + (8 - (c & 0xf));
          if (dist < 1) dist = 1;
        }
        if (dist > i || length > total - i) fail("a backward reference out of the image at pixel %lld", i);
        for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
      } else {
        int key = green - 256 - 24;
        flush_cache();
        px[i++] = cache[key];
      }
    }
    flush_cache();
    return px;
  }
};

// VP8LAddPixels: per-channel sums modulo 256
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline int channel(uint32_t v, int shift) { return (int)((v >> shift) & 0xff); }

uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: {  // Select: the neighbour nearer the gradient L + T - TL
      int pl = 0, pt = 0;
      for (int s = 0; s < 32; s += 8) {
        pl += std::abs(channel(top[0], s) - channel(top[-1], s));
        pt += std::abs(channel(left, s) - channel(top[-1], s));
      }
      return pt - pl <= 0 ? top[0] : left;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= (uint32_t)clip255(channel(left, s) + channel(top[0], s) - channel(top[-1], s)) << s;
      return out;
    }
    case 13: {
      uint32_t ave = average2(left, top[0]), out = 0;
      for (int s = 0; s < 32; s += 8) {
        int a = channel(ave, s);
        out |= (uint32_t)clip255(a + (a - channel(top[-1], s)) / 2) << s;
      }
      return out;
    }
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

void inverse_predictor(std::vector<uint32_t>& px, int w, int h, int bits,
                       const std::vector<uint32_t>& modes) {
  const int tiles = sub_sample(w, bits);
  px[0] = add_pixels(px[0], 0xff000000u);
  for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
  for (int y = 1; y < h; ++y) {
    uint32_t* row = px.data() + (size_t)y * w;
    const uint32_t* top = row - w;
    row[0] = add_pixels(row[0], top[0]);
    const uint32_t* mode_row = modes.data() + (size_t)(y >> bits) * tiles;
    for (int x = 1; x < w; ++x) {
      int mode = (int)((mode_row[x >> bits] >> 8) & 0xf);
      // top[x + 1] of the last column is the current row's first pixel, as libwebp reads it
      row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
    }
  }
}

inline int delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

void inverse_cross_color(std::vector<uint32_t>& px, int w, int h, int bits,
                         const std::vector<uint32_t>& codes) {
  const int tiles = sub_sample(w, bits);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint32_t c = codes[(size_t)(y >> bits) * tiles + (x >> bits)];
      int8_t g2r = (int8_t)(c & 0xff), g2b = (int8_t)((c >> 8) & 0xff);
      int8_t r2b = (int8_t)((c >> 16) & 0xff);
      uint32_t& p = px[(size_t)y * w + x];
      int8_t green = (int8_t)(p >> 8);
      int red = (int)((p >> 16) & 0xff) + delta(g2r, green);
      red &= 0xff;
      int blue = (int)(p & 0xff) + delta(g2b, green) + delta(r2b, (int8_t)red);
      blue &= 0xff;
      p = (p & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
    }
  }
}

void inverse_subtract_green(std::vector<uint32_t>& px) {
  for (uint32_t& p : px) {
    uint32_t g = (p >> 8) & 0xff;
    uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
    p = (p & 0xff00ff00u) | rb;
  }
}

// packed indices (bundled when the palette is small) -> the palette's colours, xsize w
std::vector<uint32_t> inverse_color_indexing(const std::vector<uint32_t>& packed, int w, int h,
                                             int bits, const std::vector<uint32_t>& palette) {
  std::vector<uint32_t> out((size_t)w * h);
  const int packed_w = sub_sample(w, bits), bpp = 8 >> bits, mask = (1 << bpp) - 1;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint32_t idx = (packed[(size_t)y * packed_w + (x >> bits)] >> 8) & 0xff;
      idx = (idx >> ((x & ((1 << bits) - 1)) * bpp)) & mask;
      out[(size_t)y * w + x] = palette[idx];
    }
  }
  return out;
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

// The image stream after the VP8L header: the transforms, then the entropy-coded image,
// then the transforms inverted in reverse order, into out (w * h ARGB words); seen receives a
// bit for each transform the stream holds (1 << type).
void decode_stream(Decoder& d, int w, int h, uint32_t* out, int32_t* seen_out) {
  std::vector<Transform> transforms;
  int seen = 0, xsize = w;
  while (d.br.read(1)) {
    Transform t;
    t.type = (int)d.br.read(2);
    if (seen & (1 << t.type)) d.fail("transform %lld read twice", t.type);
    seen |= 1 << t.type;
    t.xsize = xsize;
    t.bits = 0;
    if (t.type == kPredictor || t.type == kCrossColor) {
      t.bits = (int)d.br.read(3) + 2;
      t.data = d.decode_image(sub_sample(xsize, t.bits), sub_sample(h, t.bits), false);
    } else if (t.type == kColorIndexing) {
      int n = (int)d.br.read(8) + 1;
      t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
      std::vector<uint32_t> colors = d.decode_image(n, 1, false);
      t.data.assign((size_t)1 << (8 >> t.bits), 0);  // transparent black past the colours
      t.data[0] = colors[0];
      for (int i = 1; i < n; ++i) t.data[i] = add_pixels(colors[i], t.data[i - 1]);
      xsize = sub_sample(xsize, t.bits);
    }
    transforms.push_back(std::move(t));
  }
  *seen_out = seen;
  std::vector<uint32_t> px = d.decode_image(xsize, h, true);
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) {
    switch (it->type) {
      case kPredictor: inverse_predictor(px, it->xsize, h, it->bits, it->data); break;
      case kCrossColor: inverse_cross_color(px, it->xsize, h, it->bits, it->data); break;
      case kSubtractGreen: inverse_subtract_green(px); break;
      default: px = inverse_color_indexing(px, it->xsize, h, it->bits, it->data); break;
    }
  }
  std::memcpy(out, px.data(), (size_t)w * h * sizeof(uint32_t));
}

int finish(char* err, int32_t err_len) {
  if (err && err_len > 0 && err[0] == 0) std::snprintf(err, (size_t)err_len, "truncated or corrupt VP8L data");
  return 1;
}

}  // namespace

extern "C" {

// Decode one VP8L chunk's payload data[0:size] into out (width * height ARGB words; width
// and height from the payload's header, which the caller read); transforms receives a bit
// for each transform the stream holds (1 << type). Returns 0, or non-zero with a message in
// err.
int webp_lossless_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                         uint32_t* out, int32_t* transforms_read, char* err, int32_t err_len) {
  Decoder d{BitReader{data, size}, err, err_len};
  try {
    if (d.br.read(8) != 0x2f) d.fail("not a VP8L bitstream (signature)");
    int w = (int)d.br.read(14) + 1, h = (int)d.br.read(14) + 1;
    d.br.read(1);  // alpha_is_used: a hint only
    if (d.br.read(3) != 0) d.fail("VP8L version is not 0");
    if (w != width || h != height) d.fail("a VP8L header of another size (width %lld)", w);
    decode_stream(d, w, h, out, transforms_read);
  } catch (const Error&) {
    return finish(err, err_len);
  }
  return 0;
}

// Decode a WebP ALPH chunk's VP8L-compressed plane: data[0:size] is the image stream after
// the chunk's header byte, a VP8L stream without its 5-byte header (libwebp's
// VP8LDecodeAlphaHeader), width x height from the VP8 frame. The plane lands in the green
// bytes of out (width * height ARGB words); bytes after a sound stream are not read. Returns
// 0, or non-zero with a message in err.
int webp_alpha_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                      uint32_t* out, int32_t* transforms_read, char* err, int32_t err_len) {
  Decoder d{BitReader{data, size}, err, err_len};
  try {
    decode_stream(d, width, height, out, transforms_read);
  } catch (const Error&) {
    return finish(err, err_len);
  }
  return 0;
}

}  // extern "C"
