// TIFF's sequential decompressors on the host, behind a plain C interface (loaded through
// ctypes by foley_tpu_torch/io/tiff.py; built by ops/kernels/build.py's host route): LZW
// (compression 5) and PackBits (32773). Both are byte- or code-serial. Everything per pixel
// (the predictor, bit unpacking, the planes, the palette) runs in torch on the caller's
// device; Deflate goes through Python's zlib.
//
// LZW follows libtiff's tif_lzw.c decoder for the format TIFF 6.0 specifies: codes of 9 to
// 12 bits, most significant bit first, 256 clears the table, 257 ends the strip, and the
// width grows one code early (at 511, 1023 and 2047 entries). A decode stops when the strip
// or tile is full, as libtiff stops at the size it asks for. The pre-6.0 ("old-style",
// LSB-first) variant is refused by the Python side before it gets here.

#include <cstdint>
#include <cstring>

namespace {

struct Entry {
  int32_t prefix;  // the code this one extends, -1 for a root
  uint16_t length; // bytes of the string
  uint8_t last;    // its last byte
  uint8_t first;   // its first byte
};

}  // namespace

extern "C" {

// Decode one LZW strip or tile of in[0:n_in] into out[0:n_out]. Returns the bytes written
// (n_out unless the data ended first), -1 on a code past the table (corrupt data).
int64_t tiff_lzw_decode(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out) {
  static thread_local Entry table[4096];
  for (int i = 0; i < 256; ++i) table[i] = {-1, 1, (uint8_t)i, (uint8_t)i};
  int nbits = 9;
  int next = 258;
  int32_t prev = -1;
  int64_t ip = 0, o = 0;
  uint64_t buf = 0;
  int have = 0;  // bits in buf not yet read
  auto read_code = [&](int32_t* code) -> bool {
    while (have < nbits) {
      if (ip >= n_in) return false;
      buf = (buf << 8) | in[ip++];
      have += 8;
    }
    have -= nbits;
    *code = (int32_t)((buf >> have) & ((1u << nbits) - 1));
    return true;
  };
  // write the string of code c (its bytes stored back to front along the prefixes)
  auto emit = [&](int32_t c) {
    int len = table[c].length;
    int64_t end = o + len;
    int64_t p = end - 1;
    while (c >= 0) {
      if (p < n_out) out[p] = table[c].last;
      --p;
      c = table[c].prefix;
    }
    o = end < n_out ? end : n_out;
  };
  int32_t code;
  while (o < n_out && read_code(&code)) {
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      do {  // consecutive clears are allowed
        if (!read_code(&code)) return o;
      } while (code == 256);
      if (code == 257) break;
      if (code > 256) return -1;
      emit(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && prev < 0)) return -1;
    if (code < next) {
      emit(code);
      if (prev >= 0 && next < 4096) {
        table[next] = {prev, (uint16_t)(table[prev].length + 1), table[code].first,
                       table[prev].first};
        ++next;
      }
    } else {  // code == next: the previous string and its own first byte
      if (next >= 4096) return -1;
      table[next] = {prev, (uint16_t)(table[prev].length + 1), table[prev].first,
                     table[prev].first};
      ++next;
      emit(code);
    }
    if (next > (1 << nbits) - 2 && nbits < 12) ++nbits;
    prev = code;
  }
  return o;
}

// Decode one PackBits strip or tile: a header byte n, then n + 1 literal bytes (n 0-127) or
// one byte repeated 1 - n times (n -127 to -1; -128 is skipped). Returns the bytes written.
int64_t tiff_packbits_decode(const uint8_t* in, int64_t n_in, uint8_t* out, int64_t n_out) {
  int64_t i = 0, o = 0;
  while (i < n_in && o < n_out) {
    int n = (int8_t)in[i++];
    if (n >= 0) {
      int64_t k = n + 1;
      if (k > n_in - i) k = n_in - i;
      if (k > n_out - o) k = n_out - o;
      std::memcpy(out + o, in + i, (size_t)k);
      i += n + 1;
      o += k;
    } else if (n != -128) {
      if (i >= n_in) break;
      int64_t k = 1 - n;
      if (k > n_out - o) k = n_out - o;
      std::memset(out + o, in[i++], (size_t)k);
      o += k;
    }
  }
  return o;
}

}  // extern "C"
