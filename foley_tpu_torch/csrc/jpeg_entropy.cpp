// JPEG Huffman decoding (sequential and progressive) and baseline encoding on the host, behind a plain C interface
// (loaded through ctypes by foley_tpu_torch/io/jpeg.py; built by ops/kernels/build.py's
// host route). Everything else of the codec runs in torch on the caller's device: the
// marker parse, the (de)quantisation, the islow DCTs, the sampling and the colour
// conversion. Huffman coding is bit-serial: a 720p frame holds 1e5 to 1e6 symbols.
//
// Tables come in one layout for both directions: bits[8][17] (bits[t][l] codes of length
// l, index 0 unused) and vals[8][256], tables 0-3 DC and 4-7 AC. Blocks are int16[64] in
// natural (row-major) order; the zig-zag order is applied here.
//
// Decoding follows jdhuff.c and jdphuff.c: DC differences accumulate per component and reset
// at every RSTn, whose number must follow the sequence, as does a progressive scan's EOB run. Data that ends early, a bad code, a
// coefficient index past 63 or a missing restart marker is an error (non-zero return and a
// message), which the Python side raises as ValueError. Encoding follows jchuff.c with
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
  auto run = [&](auto block) -> int {
    int64_t n_mcus = (int64_t)mcus_x * mcus_y;
    int64_t until_restart = restart_interval;
    int next_rst = 0;
    for (int64_t m = 0; m < n_mcus; ++m) {
      if (restart_interval > 0 && until_restart == 0) {
        br.to_marker();
        if (br.pos + 1 >= size || data[br.pos] != 0xFF || data[br.pos + 1] != 0xD0 + next_rst) {
          set_err(err, err_len, "restart marker %lld missing before MCU %lld", next_rst, m);
          return 2;
        }
        br.pos += 2;
        next_rst = (next_rst + 1) & 7;
        for (int c = 0; c < 4; ++c) pred[c] = 0;
        eobrun = 0;
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
