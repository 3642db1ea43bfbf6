// JPEG entropy decoding (Huffman and arithmetic, sequential and progressive) and baseline
// Huffman encoding on the host, behind a plain C interface (loaded through ctypes by
// foley_tpu_torch/io/jpeg.py; built by ops/kernels/build.py's host route). Everything else
// of the codec runs in torch on the caller's device: the marker parse, the (de)quantisation,
// the block smoothing, the islow DCTs, the sampling and the colour conversion. Entropy
// coding is bit-serial: a 720p frame holds 1e5 to 1e6 symbols.
//
// Tables come in one layout for both directions: bits[8][17] (bits[t][l] codes of length
// l, index 0 unused) and vals[8][256], tables 0-3 DC and 4-7 AC. Blocks are int16[64] in
// natural (row-major) order; the zig-zag order is applied here.
//
// Huffman decoding follows jdhuff.c and jdphuff.c: DC differences accumulate per component
// and reset at every RSTn, whose number must follow the sequence, as does a progressive
// scan's EOB run. Data that ends early, a bad code, a coefficient index past 63 or a missing
// restart marker is an error (non-zero return and a message), which the Python side raises
// as ValueError. Arithmetic decoding follows jdarith.c (ITU T.81 Annex D and F.2.4, G.1.3):
// the Qe state machine of Table D.2, 64 DC and 256 AC statistics bins a table, the DAC
// conditioning (L, U and Kx), zeros supplied once a marker is reached (legal in arithmetic
// coding), and at each RSTn the statistics, the DC predictors and the decoder reset; a
// magnitude or spectral overflow (libjpeg warns and leaves the rest of the scan undecoded),
// data past the end or a missing restart marker is an error. Encoding follows jchuff.c with
// optimize_coding off: the DC difference's category and bits, AC run/size symbols with ZRL
// and EOB, 0xFF byte stuffing, and the last byte padded with 1-bits.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// zig-zag index -> natural index (jpeg_natural_order), with libjpeg's 16 extra entries of 63:
// a corrupt run that steps past the band writes there, not past the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct DecTable {
  int32_t maxcode[18];   // largest code of each length, -1 if none; [17] sentinel
  int32_t valoffset[17]; // value index of a code of length l: code + valoffset[l]
  uint8_t vals[256];
  bool present;
};

bool build_dec_table(const uint8_t* bits, const uint8_t* vals, DecTable* t) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l];
  t->present = count > 0;
  if (count > 256) return false;
  std::memcpy(t->vals, vals, 256);
  int32_t code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - code;
      code += bits[l];
      p += bits[l];
      t->maxcode[l] = code - 1;
      if (code - 1 >= (1 << l)) return false;  // more codes than the length holds
    } else {
      t->maxcode[l] = -1;
      t->valoffset[l] = 0;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  return true;
}

struct BitReader {
  const uint8_t* data;
  int64_t size, pos;
  uint64_t buf = 0;
  int nbits = 0;        // valid bits in buf (real data and zero fill)
  int fill_bits = 0;    // of those, zero bits past the data
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (!at_marker && pos < size) {
        uint8_t b = data[pos];
        if (b == 0xFF) {
          if (pos + 1 < size && data[pos + 1] == 0x00) {
            pos += 2;
            byte = 0xFF;
          } else {
            at_marker = true;  // a marker (or the end): zeros from here
            fill_bits += 8;
          }
        } else {
          pos += 1;
          byte = b;
        }
      } else {
        fill_bits += 8;
      }
      buf |= byte << (56 - nbits);
      nbits += 8;
    }
  }
  // the next n (<= 16) bits, not consumed
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  // false when the bits consumed reach past the data
  bool skip(int n) {
    buf <<= n;
    nbits -= n;
    if (fill_bits > nbits) return false;
    return true;
  }
  // at a restart or the scan's end: the bits left are the padding of the last byte (the
  // reader never reads past a marker); drop them and move to the next marker
  void to_marker() {
    buf = 0;
    nbits = 0;
    fill_bits = 0;
    at_marker = false;
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF))
      ++pos;
  }
};

// returns the symbol, or -1 on a bad code or data past the end
inline int decode_symbol(BitReader* br, const DecTable* t) {
  uint32_t look = br->peek(16);
  int l = 1;
  int32_t code = (int32_t)(look >> 15);
  while (l <= 16 && code > t->maxcode[l]) {
    ++l;
    code = (int32_t)(look >> (16 - l));
  }
  if (l > 16) return -1;
  if (!br->skip(l)) return -1;
  int idx = code + t->valoffset[l];
  if (idx < 0 || idx > 255) return -1;
  return t->vals[idx];
}

inline bool receive_extend(BitReader* br, int s, int32_t* out) {
  if (s == 0) {
    *out = 0;
    return true;
  }
  if (s > 16) return false;
  int32_t r = (int32_t)br->peek(s);
  if (!br->skip(s)) return false;
  *out = r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  return true;
}

void set_err(char* err, int32_t err_len, const char* msg, long long a = 0, long long b = 0) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, msg, a, b);
}

// The blocks of a scan in order: MCU after MCU (one block an MCU in a non-interleaved
// scan), each component's comp_h x comp_v blocks in turn, block (row, col) of component c at
// out[c] + (row * blocks_w[c] + col) * 64. restart(n) runs before every restart_interval-th
// MCU and returns false when RSTn is not there; block(c, blk) returns 0, or 1 / 2 on bad DC
// / AC data.
template <typename Restart, typename Block>
int walk_mcus(int32_t n_comp, const int32_t* comp_h, const int32_t* comp_v, int32_t mcus_x,
              int32_t mcus_y, const int32_t* blocks_w, int16_t* const* out,
              int32_t restart_interval, Restart restart, Block block, char* err,
              int32_t err_len) {
  int64_t n_mcus = (int64_t)mcus_x * mcus_y;
  int64_t until_restart = restart_interval;
  int next_rst = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval > 0 && until_restart == 0) {
      if (!restart(next_rst)) {
        set_err(err, err_len, "restart marker %lld missing before MCU %lld", next_rst, m);
        return 2;
      }
      next_rst = (next_rst + 1) & 7;
      until_restart = restart_interval;
    }
    int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < n_comp; ++c) {
      for (int by = 0; by < comp_v[c]; ++by) {
        for (int bx = 0; bx < comp_h[c]; ++bx) {
          int64_t row = my * comp_v[c] + by, col = mx * comp_h[c] + bx;
          int rc = block(c, out[c] + (row * blocks_w[c] + col) * 64);
          if (rc) {
            set_err(err, err_len,
                    rc == 1 ? "corrupt or truncated data at MCU %lld (DC, component %lld)"
                            : "corrupt or truncated data at MCU %lld (AC, component %lld)",
                    m, c);
            return 3;
          }
        }
      }
    }
    --until_restart;
  }
  return 0;
}

// ITU T.81 Table D.2, the probability estimation state machine: Qe, the next index after
// an LPS and after an MPS, and whether an LPS swaps the MPS sense. Entry 113 is libjpeg's
// fixed bin (probability 0.5, never adapted), for the sign of an AC value and the bits of a
// refinement.
struct QeEntry {
  uint16_t qe;
  uint8_t nlps, nmps, swap;
};
const QeEntry kQe[114] = {
    {0x5a1d, 1, 1, 1},     {0x2586, 14, 2, 0},    {0x1114, 16, 3, 0},    {0x080b, 18, 4, 0},
    {0x03d8, 20, 5, 0},    {0x01da, 23, 6, 0},    {0x00e5, 25, 7, 0},    {0x006f, 28, 8, 0},
    {0x0036, 30, 9, 0},    {0x001a, 33, 10, 0},   {0x000d, 35, 11, 0},   {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0},   {0x0001, 12, 13, 0},   {0x5a7f, 15, 15, 1},   {0x3f25, 36, 16, 0},
    {0x2cf2, 38, 17, 0},   {0x207c, 39, 18, 0},   {0x17b9, 40, 19, 0},   {0x1182, 42, 20, 0},
    {0x0cef, 43, 21, 0},   {0x09a1, 45, 22, 0},   {0x072f, 46, 23, 0},   {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0},   {0x0303, 51, 26, 0},   {0x0240, 52, 27, 0},   {0x01b1, 54, 28, 0},
    {0x0144, 56, 29, 0},   {0x00f5, 57, 30, 0},   {0x00b7, 59, 31, 0},   {0x008a, 60, 32, 0},
    {0x0068, 62, 33, 0},   {0x004e, 63, 34, 0},   {0x003b, 32, 35, 0},   {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1},   {0x484c, 64, 38, 0},   {0x3a0d, 65, 39, 0},   {0x2ef1, 67, 40, 0},
    {0x261f, 68, 41, 0},   {0x1f33, 69, 42, 0},   {0x19a8, 70, 43, 0},   {0x1518, 72, 44, 0},
    {0x1177, 73, 45, 0},   {0x0e74, 74, 46, 0},   {0x0bfb, 75, 47, 0},   {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0},   {0x0706, 79, 50, 0},   {0x05cd, 48, 51, 0},   {0x04de, 50, 52, 0},
    {0x040f, 50, 53, 0},   {0x0363, 51, 54, 0},   {0x02d4, 52, 55, 0},   {0x025c, 53, 56, 0},
    {0x01f8, 54, 57, 0},   {0x01a4, 55, 58, 0},   {0x0160, 56, 59, 0},   {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0},   {0x00cb, 59, 62, 0},   {0x00ab, 61, 63, 0},   {0x008f, 61, 32, 0},
    {0x5b12, 65, 65, 1},   {0x4d04, 80, 66, 0},   {0x412c, 81, 67, 0},   {0x37d8, 82, 68, 0},
    {0x2fe8, 83, 69, 0},   {0x293c, 84, 70, 0},   {0x2379, 86, 71, 0},   {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0},   {0x174e, 72, 74, 0},   {0x1424, 72, 75, 0},   {0x119c, 74, 76, 0},
    {0x0f6b, 74, 77, 0},   {0x0d51, 75, 78, 0},   {0x0bb6, 77, 79, 0},   {0x0a40, 77, 48, 0},
    {0x5832, 80, 81, 1},   {0x4d1c, 88, 82, 0},   {0x438e, 89, 83, 0},   {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0},   {0x2eae, 92, 86, 0},   {0x299a, 93, 87, 0},   {0x2516, 86, 71, 0},
    {0x5570, 88, 89, 1},   {0x4ca9, 95, 90, 0},   {0x44d9, 96, 91, 0},   {0x3e22, 97, 92, 0},
    {0x3824, 99, 93, 0},   {0x32b4, 99, 94, 0},   {0x2e17, 93, 86, 0},   {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0},  {0x47e5, 102, 98, 0},  {0x41cf, 103, 99, 0},  {0x3c3d, 104, 100, 0},
    {0x375e, 99, 93, 0},   {0x5231, 105, 102, 0}, {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0},
    {0x415e, 103, 99, 0},  {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1}, {0x5522, 112, 109, 0},
    {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};
const int kFixedBin = 113;

// The arithmetic decoder of jdarith.c (its C register holds the interval's base and the
// next bits, cut at CT). Bytes are read as libjpeg's get_byte reads them: 0xFF 0x00 is a
// 0xFF, fill bytes are swallowed, and a marker stops the reading (zeros from there, the
// marker left for the caller). reach counts the bytes read; past_end is set when the data
// ends without a marker.
struct ArithDecoder {
  const uint8_t* data;
  int64_t size, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false, past_end = false;
  int64_t marker_pos = 0, reach = 0;

  int get_byte() {
    if (pos >= size) {
      past_end = true;
      return 0;
    }
    reach = pos + 1 > reach ? pos + 1 : reach;
    return data[pos++];
  }
  void reset() {  // at a restart: two bytes are read to fill C again
    c = 0;
    a = 0;
    ct = -16;
    at_marker = false;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalisation and data input (D.2.6)
      if (--ct < 0) {
        int byte = 0;
        if (!at_marker) {
          byte = get_byte();
          if (byte == 0xFF) {
            do byte = get_byte();
            while (byte == 0xFF && !past_end);
            if (byte == 0) {
              byte = 0xFF;  // a stuffed zero
            } else {
              at_marker = true;
              marker_pos = pos - 2;
              byte = 0;
            }
          }
        }
        c = (c << 8) | byte;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the first two bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    const QeEntry& e = kQe[sv & 0x7F];
    int64_t qe = e.qe;
    int nl = e.nlps | (e.swap << 7), nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {  // the LPS sub-interval, unless the conditional exchange (D.2.4-5)
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct EncTable {
  uint32_t code[256];
  uint8_t size[256];
};

bool build_enc_table(const uint8_t* bits, const uint8_t* vals, EncTable* t) {
  std::memset(t->size, 0, sizeof(t->size));
  uint32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) {
      if (p >= 256) return false;
      t->code[vals[p]] = code++;
      t->size[vals[p]] = (uint8_t)l;
      ++p;
    }
    if (code > (1u << l)) return false;
    code <<= 1;
  }
  return true;
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint64_t buf = 0;
  int nbits = 0;
  bool overflow = false;

  inline void put_byte(uint8_t b) {
    if (pos + 2 > cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
    if (b == 0xFF) out[pos++] = 0x00;
  }
  inline void emit(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      put_byte((uint8_t)(buf >> (nbits - 8)));
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (nbits > 0) emit(0x7F, 8 - nbits);
  }
};

}  // namespace

extern "C" {

// Decode one scan. data[0:size] starts right after the SOS header and may run to the end of
// the file; consumed receives the offset of the first marker after the scan's data. The
// scan's n_comp components (1-4) each take comp_h x comp_v blocks of an MCU (1 x 1 in a
// non-interleaved scan); mcus_x x mcus_y MCUs. Block (row, col) of component c lands in
// out[c] + (row * blocks_w[c] + col) * 64, natural order.
//
// A sequential scan (progressive 0) writes whole blocks. A progressive one (jdphuff.c) adds
// to the blocks earlier scans left, each coefficient kept shifted by its scan's Al: spectral
// selection ss..se and successive approximation ah / al give its kind, DC first (ss 0, ah
// 0), DC refinement (ss 0, ah > 0: one bit a block), AC first (ss > 0, ah 0: EOBn runs
// across blocks) and AC refinement (correction bits for the coefficients already nonzero,
// new ones of magnitude 1 << al placed among the zeros). Restart markers reset the DC
// predictors and the EOB run.
int fj_decode_scan(const uint8_t* data, int64_t size, int32_t n_comp, const int32_t* comp_h,
                   const int32_t* comp_v, const int32_t* dc_tbl, const int32_t* ac_tbl,
                   const uint8_t* bits, const uint8_t* vals, int32_t mcus_x, int32_t mcus_y,
                   const int32_t* blocks_w, int16_t* const* out, int32_t restart_interval,
                   int32_t progressive, int32_t ss, int32_t se, int32_t ah, int32_t al,
                   int64_t* consumed, char* err, int32_t err_len) {
  if (n_comp < 1 || n_comp > 4) {
    set_err(err, err_len, "a scan of %lld components", n_comp);
    return 1;
  }
  if (ss < 0 || se > 63 || ss > se || ah < 0 || ah > 13 || al < 0 || al > 13) {
    set_err(err, err_len, "a scan of spectral selection %lld-%lld", ss, se);
    return 1;
  }
  DecTable tables[8];
  for (int t = 0; t < 8; ++t) {
    if (!build_dec_table(bits + 17 * t, vals + 256 * t, &tables[t])) {
      set_err(err, err_len, "an invalid Huffman table (%lld)", t);
      return 1;
    }
  }
  // the tables a scan reads: both when sequential; DC first the DC table, AC scans the AC
  // table, DC refinement none
  const bool need_dc = !progressive || (ss == 0 && ah == 0);
  const bool need_ac = !progressive || ss > 0;
  for (int c = 0; c < n_comp; ++c) {
    if (dc_tbl[c] < 0 || dc_tbl[c] > 3 || ac_tbl[c] < 0 || ac_tbl[c] > 3) {
      set_err(err, err_len, "component %lld names Huffman table %lld (0-3 exist)", c,
              dc_tbl[c] < 0 || dc_tbl[c] > 3 ? dc_tbl[c] : ac_tbl[c]);
      return 1;
    }
    if ((need_dc && !tables[dc_tbl[c]].present) || (need_ac && !tables[4 + ac_tbl[c]].present)) {
      set_err(err, err_len, "component %lld names an undefined Huffman table", c);
      return 1;
    }
  }
  BitReader br{data, size, 0};
  int32_t pred[4] = {0, 0, 0, 0};
  int32_t eobrun = 0;
  const int32_t p1 = 1 << al, m1 = -(1 << al);
  // one block; 0, or 1 on bad DC data, 2 on bad AC data
  auto sequential = [&](int c, int16_t* blk) -> int {
    const DecTable* act = &tables[4 + ac_tbl[c]];
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = decode_symbol(&br, &tables[dc_tbl[c]]);
    int32_t diff;
    if (s < 0 || s > 15 || !receive_extend(&br, s, &diff)) return 1;
    pred[c] += diff;
    blk[0] = (int16_t)pred[c];
    for (int k = 1; k < 64;) {
      int rs = decode_symbol(&br, act);
      if (rs < 0) return 2;
      int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        int32_t v;
        if (k > 63 || !receive_extend(&br, sz, &v)) return 2;
        blk[kNatural[k]] = (int16_t)v;
        ++k;
      } else if (r == 15) {
        k += 16;
      } else {
        break;
      }
    }
    return 0;
  };
  auto dc_first = [&](int c, int16_t* blk) -> int {
    int s = decode_symbol(&br, &tables[dc_tbl[c]]);
    int32_t diff;
    if (s < 0 || s > 15 || !receive_extend(&br, s, &diff)) return 1;
    pred[c] += diff;
    blk[0] = (int16_t)(int32_t)((uint32_t)pred[c] << al);
    return 0;
  };
  auto dc_refine = [&](int, int16_t* blk) -> int {
    uint32_t bit = br.peek(1);
    if (!br.skip(1)) return 1;
    if (bit) blk[0] = (int16_t)(blk[0] | p1);
    return 0;
  };
  auto ac_first = [&](int c, int16_t* blk) -> int {
    if (eobrun > 0) {
      --eobrun;
      return 0;
    }
    const DecTable* act = &tables[4 + ac_tbl[c]];
    for (int k = ss; k <= se; ++k) {
      int rs = decode_symbol(&br, act);
      if (rs < 0) return 2;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int32_t v;
        if (!receive_extend(&br, s, &v)) return 2;
        blk[kNatural[k]] = (int16_t)(int32_t)((uint32_t)v << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) {
          eobrun += (int32_t)br.peek(r);
          if (!br.skip(r)) return 2;
        }
        --eobrun;
        break;
      }
    }
    return 0;
  };
  // a correction bit for a coefficient already nonzero: 1 raises its magnitude by 1 << al
  auto correct = [&](int16_t* coef) -> bool {
    uint32_t bit = br.peek(1);
    if (!br.skip(1)) return false;
    if (bit && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
    return true;
  };
  auto ac_refine = [&](int c, int16_t* blk) -> int {
    const DecTable* act = &tables[4 + ac_tbl[c]];
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_symbol(&br, act);
        if (rs < 0) return 2;
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a new coefficient: its magnitude is 1 << al, a bit gives its sign
          uint32_t bit = br.peek(1);
          if (!br.skip(1)) return 2;
          s = bit ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) {
            eobrun += (int32_t)br.peek(r);
            if (!br.skip(r)) return 2;
          }
          break;
        }
        // pass the nonzero coefficients (a correction bit each) and r zeros
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (!correct(coef)) return 2;
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {  // the rest of the band: correction bits only
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && !correct(coef)) return 2;
      }
      --eobrun;
    }
    return 0;
  };
  auto restart = [&](int n) -> bool {
    br.to_marker();
    if (br.pos + 1 >= size || data[br.pos] != 0xFF || data[br.pos + 1] != 0xD0 + n) return false;
    br.pos += 2;
    for (int c = 0; c < 4; ++c) pred[c] = 0;
    eobrun = 0;
    return true;
  };
  auto run = [&](auto block) -> int {
    return walk_mcus(n_comp, comp_h, comp_v, mcus_x, mcus_y, blocks_w, out, restart_interval,
                     restart, block, err, err_len);
  };
  int rc;
  if (!progressive)
    rc = run(sequential);
  else if (ss == 0)
    rc = ah == 0 ? run(dc_first) : run(dc_refine);
  else
    rc = ah == 0 ? run(ac_first) : run(ac_refine);
  if (rc) return rc;
  br.to_marker();
  *consumed = br.pos;
  return 0;
}

// Decode one arithmetic-coded scan (SOF9 / SOF10): the arguments and the output as
// fj_decode_scan's, the tables' DAC conditioning in dc_l / dc_u / ac_k (16 each; 0, 1 and 5
// where no DAC segment set them) in place of the Huffman tables, whose selectors may be
// 0-15. reach receives the bytes of data read (restart markers included), which tells
// whether a reader fed the file in blocks had the bytes when it needed them.
int fj_decode_scan_arith(const uint8_t* data, int64_t size, int32_t n_comp,
                         const int32_t* comp_h, const int32_t* comp_v, const int32_t* dc_tbl,
                         const int32_t* ac_tbl, const int32_t* dc_l, const int32_t* dc_u,
                         const int32_t* ac_k, int32_t mcus_x, int32_t mcus_y,
                         const int32_t* blocks_w, int16_t* const* out,
                         int32_t restart_interval, int32_t progressive, int32_t ss, int32_t se,
                         int32_t ah, int32_t al, int64_t* consumed, int64_t* reach, char* err,
                         int32_t err_len) {
  if (n_comp < 1 || n_comp > 4) {
    set_err(err, err_len, "a scan of %lld components", n_comp);
    return 1;
  }
  if (ss < 0 || se > 63 || ss > se || ah < 0 || ah > 13 || al < 0 || al > 13) {
    set_err(err, err_len, "a scan of spectral selection %lld-%lld", ss, se);
    return 1;
  }
  for (int c = 0; c < n_comp; ++c) {
    if (dc_tbl[c] < 0 || dc_tbl[c] > 15 || ac_tbl[c] < 0 || ac_tbl[c] > 15) {
      set_err(err, err_len, "component %lld names arithmetic table %lld (0-15 exist)", c,
              dc_tbl[c] < 0 || dc_tbl[c] > 15 ? dc_tbl[c] : ac_tbl[c]);
      return 1;
    }
  }
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = kFixedBin;
  const bool dc_scan = !progressive || (ss == 0 && ah == 0), ac_scan = !progressive || ss > 0;
  int32_t last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  auto clear_stats = [&]() {
    for (int c = 0; c < n_comp; ++c) {
      if (dc_scan) std::memset(dc_stats[dc_tbl[c]], 0, 64);
      if (ac_scan) std::memset(ac_stats[ac_tbl[c]], 0, 256);
      last_dc[c] = 0;
      dc_context[c] = 0;
    }
  };
  clear_stats();
  ArithDecoder ad{data, size, 0};
  auto restart = [&](int n) -> bool {
    int64_t at = ad.pos;
    if (ad.at_marker) {
      at = ad.marker_pos;
    } else {
      while (at + 1 < size && !(data[at] == 0xFF && data[at + 1] != 0x00 && data[at + 1] != 0xFF))
        ++at;
    }
    if (at + 1 >= size || data[at] != 0xFF || data[at + 1] != 0xD0 + n) return false;
    ad.pos = at + 2;
    ad.reach = ad.pos > ad.reach ? ad.pos : ad.reach;
    ad.reset();
    clear_stats();
    return true;
  };
  // F.2.4.1 (Figures F.19, F.21-F.24): a DC difference into last_dc[c]; false on overflow
  auto dc_diff = [&](int c) -> bool {
    const int t = dc_tbl[c];
    uint8_t* st = dc_stats[t] + dc_context[c];
    if (ad.decode(st) == 0) {
      dc_context[c] = 0;
      return true;
    }
    int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m != 0) {
      st = dc_stats[t] + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << dc_l[t]) >> 1))
      dc_context[c] = 0;  // a zero difference category
    else if (m > (int)((1L << dc_u[t]) >> 1))
      dc_context[c] = 12 + sign * 4;  // large
    else
      dc_context[c] = 4 + sign * 4;  // small
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[c] = (last_dc[c] + v) & 0xFFFF;
    return true;
  };
  // F.2.4.2 (Figure F.20): the AC values k0..k1 of a block, each shifted by shift; false on
  // a spectral or magnitude overflow
  auto ac_values = [&](int c, int16_t* blk, int k0, int k1, int shift) -> bool {
    const int t = ac_tbl[c];
    for (int k = k0; k <= k1; ++k) {
      uint8_t* st = ac_stats[t] + 3 * (k - 1);
      if (ad.decode(st)) break;  // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > k1) return false;
      }
      int sign = ad.decode(&fixed_bin);
      st += 2;
      int m = ad.decode(st);
      if (m != 0 && ad.decode(st)) {
        m <<= 1;
        st = ac_stats[t] + (k <= ac_k[t] ? 189 : 217);
        while (ad.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ad.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = (int16_t)(int32_t)((uint32_t)v << shift);
    }
    return true;
  };
  auto sequential = [&](int c, int16_t* blk) -> int {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    if (!dc_diff(c)) return 1;
    blk[0] = (int16_t)last_dc[c];
    return ac_values(c, blk, 1, 63, 0) ? 0 : 2;
  };
  auto dc_first = [&](int c, int16_t* blk) -> int {
    if (!dc_diff(c)) return 1;
    blk[0] = (int16_t)(int32_t)((uint32_t)last_dc[c] << al);
    return 0;
  };
  auto dc_refine = [&](int, int16_t* blk) -> int {
    if (ad.decode(&fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << al));
    return 0;
  };
  auto ac_first = [&](int c, int16_t* blk) -> int { return ac_values(c, blk, ss, se, al) ? 0 : 2; };
  // G.1.3.3: correction bits for the coefficients already nonzero, new ones of magnitude
  // 1 << al, the EOB decided only past the last coefficient an earlier scan made nonzero
  auto ac_refine = [&](int c, int16_t* blk) -> int {
    const int t = ac_tbl[c];
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[t] + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (ad.decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {
          *coef = (int16_t)(ad.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return 2;
      }
    }
    return 0;
  };
  auto run = [&](auto block) -> int {
    return walk_mcus(n_comp, comp_h, comp_v, mcus_x, mcus_y, blocks_w, out, restart_interval,
                     restart, [&](int c, int16_t* blk) -> int {
                       int rc = block(c, blk);
                       return rc ? rc : ad.past_end ? 2 : 0;
                     }, err, err_len);
  };
  int rc;
  if (!progressive)
    rc = run(sequential);
  else if (ss == 0)
    rc = ah == 0 ? run(dc_first) : run(dc_refine);
  else
    rc = ah == 0 ? run(ac_first) : run(ac_refine);
  if (rc) return rc;
  int64_t at = ad.at_marker ? ad.marker_pos : ad.pos;
  while (at + 1 < size && !(data[at] == 0xFF && data[at + 1] != 0x00 && data[at + 1] != 0xFF))
    ++at;
  *consumed = at;
  *reach = ad.reach;
  return 0;
}

// Table D.2 as the decoder holds it (114 rows of Qe, next index after an LPS, after an MPS,
// and the MPS swap), for the tests.
void fj_arith_qe_table(int32_t* out) {
  for (int i = 0; i < 114; ++i) {
    out[4 * i] = kQe[i].qe;
    out[4 * i + 1] = kQe[i].nlps;
    out[4 * i + 2] = kQe[i].nmps;
    out[4 * i + 3] = kQe[i].swap;
  }
}

// Encode one scan of n_blocks blocks (int16[64], natural order) in scan order: MCU after
// MCU, blocks_per_mcu blocks each, block b of an MCU belonging to component block_comp[b]
// (0-3) with DC table dc_tbl[component] and AC table ac_tbl[component]. Returns the bytes
// written to out (stuffed, the last byte padded with 1-bits), -1 if out_cap is too small, -2
// on a bad table, -3 on a coefficient out of the baseline range.
int64_t fj_encode_scan(const int16_t* blocks, int64_t n_blocks, int32_t blocks_per_mcu,
                       const int32_t* block_comp, const int32_t* dc_tbl, const int32_t* ac_tbl,
                       const uint8_t* bits, const uint8_t* vals, uint8_t* out, int64_t out_cap) {
  if (blocks_per_mcu < 1) return -2;
  for (int b = 0; b < blocks_per_mcu; ++b) {
    int c = block_comp[b];
    if (c < 0 || c > 3 || dc_tbl[c] < 0 || dc_tbl[c] > 3 || ac_tbl[c] < 0 || ac_tbl[c] > 3)
      return -2;
  }
  EncTable tables[8];
  for (int t = 0; t < 8; ++t) {
    if (!build_enc_table(bits + 17 * t, vals + 256 * t, &tables[t])) return -2;
  }
  BitWriter bw{out, out_cap};
  int32_t last_dc[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < n_blocks; ++i) {
    int c = block_comp[i % blocks_per_mcu];
    const EncTable* dct = &tables[dc_tbl[c]];
    const EncTable* act = &tables[4 + ac_tbl[c]];
    const int16_t* blk = blocks + i * 64;
    int32_t temp = blk[0] - last_dc[c], temp2 = temp;
    last_dc[c] = blk[0];
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    if (nbits > 11 || dct->size[nbits] == 0) return -3;
    bw.emit(dct->code[nbits], dct->size[nbits]);
    if (nbits) bw.emit((uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int32_t v = blk[kNatural[k]];
      if (v == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.emit(act->code[0xF0], act->size[0xF0]);
        r -= 16;
      }
      int32_t t2 = v;
      if (v < 0) {
        v = -v;
        t2--;
      }
      int nb = 1;
      while ((v >>= 1)) nb++;
      if (nb > 10) return -3;
      int sym = (r << 4) + nb;
      if (act->size[sym] == 0) return -3;
      bw.emit(act->code[sym], act->size[sym]);
      bw.emit((uint32_t)t2, nb);
      r = 0;
    }
    if (r > 0) bw.emit(act->code[0], act->size[0]);
    if (bw.overflow) return -1;
  }
  bw.flush();
  if (bw.overflow) return -1;
  return bw.pos;
}

}  // extern "C"
