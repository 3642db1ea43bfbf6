// Lossy WebP (VP8 key frame) decoding on the host, behind a plain C interface (loaded
// through ctypes by foley_tpu_torch/io/webp.py; built by ops/kernels/build.py's host route).
// The RIFF container is parsed in Python; this file takes a "VP8 " chunk's payload (with the
// chunk's padding byte, as libwebp's demuxer hands it to the decoder) and writes the Y, U
// and V planes at the macroblock-padded size, loop filter applied. Fancy upsampling and the
// YUV -> RGB conversion run in torch on the caller's device.
//
// The decoder follows RFC 6386 as libwebp 1.6 decodes it, bit for bit (src/dec/vp8_dec.c,
// tree_dec.c, quant_dec.c, frame_dec.c, src/dsp/dec.c, src/utils/bit_reader*):
// - the boolean decoder keeps libwebp's state (range - 1, a bit count that loads a byte when
//   it falls below 0, and an end-of-data flag set on the first load past the data), with its
//   shortcut for the coefficients' sign bits;
// - the first partition: colour space and clamping type (read, not used), segmentation,
//   filter type, level, sharpness and the mode / reference loop-filter deltas, the token
//   partitions (1, 2, 4 or 8; the last one's size implied; macroblock row y reads partition
//   y & (n - 1)), the quantiser indices with their five deltas, the coefficient probability
//   updates, the skip probability; then per macroblock row the segment, skip flag and modes;
// - dequantisation as VP8ParseQuant: y2 dc x2, y2 ac x155/100 floored at 8, uv dc at index
//   117 at most (132), every index clipped to 0..127 after its delta;
// - reconstruction in libwebp's 32-byte-stride work buffer: prediction from unfiltered top
//   and left samples (127 above the frame, 129 left of it), the 4x4 modes' top-right samples
//   from the macroblock above-right (repeated from the last pixel above on the right edge),
//   the inverse WHT and DCT (20091 / 35468 >> 16, +4 >> 3) with the DC-only and three-
//   coefficient shortcuts libwebp dispatches on; the full DCT in the 16-bit lanes of
//   libwebp's x86 build (the build Pillow ships), which wrap where corrupt data overflows;
// - the loop filter after the frame, macroblock by macroblock in raster order (left edge,
//   inner vertical edges, top edge, inner horizontal edges), simple (luma only) or normal
//   (FilterLoop26 on macroblock edges, FilterLoop24 inside, the high-edge-variance
//   threshold 2 from level 40, 1 from 15), levels per segment and mode, interior limit from
//   the sharpness, no inner edges on a 16x16 macroblock without coefficients.
//
// A premature end of either partition, a partition size past the data, or a frame that is
// not a displayable key frame is an error (non-zero return and a message), which the Python
// side raises as ValueError.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int NUM_TYPES = 4, NUM_BANDS = 8, NUM_CTX = 3, NUM_PROBAS = 11, NUM_BMODES = 10;
const int BPS = 32;  // the work buffer's stride

// 4x4 modes in libwebp's order; the 16x16 and chroma modes share the first four
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, TM_PRED = B_TM_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

// the features a frame held (python: io/webp.py::VP8_FEATURES, in this order)
enum {
  F_FILTER_SIMPLE = 0, F_FILTER_NORMAL = 1, F_FILTER_NONE = 2, F_SEGMENTS = 3,
  F_UPDATE_MAP = 4, F_PARTS2 = 5, F_PARTS4 = 6, F_PARTS8 = 7, F_SKIP = 8,
  F_I16 = 9,    // + the 16x16 mode (DC, TM, V, H): bits 9-12
  F_I4 = 13,    // + the 4x4 mode (libwebp's order): bits 13-22
  F_PROBA_UPDATE = 23, F_SHARPNESS = 24, F_SEGMENT_DELTA = 25,
};

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
    18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
    29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
    44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
    59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
    75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
    91,  93,  95,  96,  98,  100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
    20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
    36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
    52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
    78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,  100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// the coefficient bands of positions 0..15 (and 16: a sentinel for the last read)
const uint8_t kBands[16 + 1] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// RFC 6386 13.5: the default coefficient probabilities [type][band][ctx][proba]
const uint8_t CoeffsProba0[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS] = {
  { { { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128 },
      { 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128 },
      { 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128 } },
    { { 1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128 },
      { 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128 },
      { 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128 } },
    { { 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128 },
      { 184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128 },
      { 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128 } },
    { { 1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128 },
      { 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128 },
      { 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128 } },
    { { 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128 },
      { 207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128 },
      { 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128 } },
    { { 1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128 },
      { 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128 },
      { 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128 } },
    { { 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 } } },
  { { { 198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62 },
      { 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1 },
      { 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128 } },
    { { 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128 },
      { 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128 },
      { 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128 } },
    { { 1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128 },
      { 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128 },
      { 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128 } },
    { { 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128 },
      { 109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128 },
      { 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128 } },
    { { 1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128 },
      { 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128 },
      { 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128 } },
    { { 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128 },
      { 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128 },
      { 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128 } },
    { { 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128 },
      { 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128 },
      { 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128 } },
    { { 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128 },
      { 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128 } } },
  { { { 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128 },
      { 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128 },
      { 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128 } },
    { { 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128 },
      { 239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128 },
      { 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128 } },
    { { 1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128 },
      { 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128 },
      { 69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128 } },
    { { 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128 },
      { 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128 } },
    { { 1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128 },
      { 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128 },
      { 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128 } },
    { { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128 } } },
  { { { 202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255 },
      { 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128 },
      { 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128 } },
    { { 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128 },
      { 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128 },
      { 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128 } },
    { { 1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128 },
      { 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128 },
      { 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128 } },
    { { 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128 },
      { 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128 },
      { 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128 } },
    { { 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128 },
      { 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128 },
      { 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128 } },
    { { 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128 },
      { 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128 },
      { 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128 } },
    { { 1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128 },
      { 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128 },
      { 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128 } },
    { { 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 },
      { 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128 } } }};

// RFC 6386 13.4: the probabilities that a coefficient probability is updated
const uint8_t CoeffsUpdateProba[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS] = {
  { { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255 },
      { 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } },
  { { { 217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255 },
      { 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255 } },
    { { 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } },
  { { { 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255 } },
    { { 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } },
  { { { 248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255 },
      { 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255 } },
    { { 255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } },
    { { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 },
      { 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255 } } }};

// RFC 6386 12.3: the key frame's 4x4 mode probabilities [above][left][node], the modes in
// libwebp's order (the RFC's with RD, VR before LD)
const uint8_t kBModesProba[NUM_BMODES][NUM_BMODES][NUM_BMODES - 1] = {
  { { 231, 120, 48, 89, 115, 113, 120, 152, 112 },
    { 152, 179, 64, 126, 170, 118, 46, 70, 95 },
    { 175, 69, 143, 80, 85, 82, 72, 155, 103 },
    { 56, 58, 10, 171, 218, 189, 17, 13, 152 },
    { 114, 26, 17, 163, 44, 195, 21, 10, 173 },
    { 121, 24, 80, 195, 26, 62, 44, 64, 85 },
    { 144, 71, 10, 38, 171, 213, 144, 34, 26 },
    { 170, 46, 55, 19, 136, 160, 33, 206, 71 },
    { 63, 20, 8, 114, 114, 208, 12, 9, 226 },
    { 81, 40, 11, 96, 182, 84, 29, 16, 36 } },
  { { 134, 183, 89, 137, 98, 101, 106, 165, 148 },
    { 72, 187, 100, 130, 157, 111, 32, 75, 80 },
    { 66, 102, 167, 99, 74, 62, 40, 234, 128 },
    { 41, 53, 9, 178, 241, 141, 26, 8, 107 },
    { 74, 43, 26, 146, 73, 166, 49, 23, 157 },
    { 65, 38, 105, 160, 51, 52, 31, 115, 128 },
    { 104, 79, 12, 27, 217, 255, 87, 17, 7 },
    { 87, 68, 71, 44, 114, 51, 15, 186, 23 },
    { 47, 41, 14, 110, 182, 183, 21, 17, 194 },
    { 66, 45, 25, 102, 197, 189, 23, 18, 22 } },
  { { 88, 88, 147, 150, 42, 46, 45, 196, 205 },
    { 43, 97, 183, 117, 85, 38, 35, 179, 61 },
    { 39, 53, 200, 87, 26, 21, 43, 232, 171 },
    { 56, 34, 51, 104, 114, 102, 29, 93, 77 },
    { 39, 28, 85, 171, 58, 165, 90, 98, 64 },
    { 34, 22, 116, 206, 23, 34, 43, 166, 73 },
    { 107, 54, 32, 26, 51, 1, 81, 43, 31 },
    { 68, 25, 106, 22, 64, 171, 36, 225, 114 },
    { 34, 19, 21, 102, 132, 188, 16, 76, 124 },
    { 62, 18, 78, 95, 85, 57, 50, 48, 51 } },
  { { 193, 101, 35, 159, 215, 111, 89, 46, 111 },
    { 60, 148, 31, 172, 219, 228, 21, 18, 111 },
    { 112, 113, 77, 85, 179, 255, 38, 120, 114 },
    { 40, 42, 1, 196, 245, 209, 10, 25, 109 },
    { 88, 43, 29, 140, 166, 213, 37, 43, 154 },
    { 61, 63, 30, 155, 67, 45, 68, 1, 209 },
    { 100, 80, 8, 43, 154, 1, 51, 26, 71 },
    { 142, 78, 78, 16, 255, 128, 34, 197, 171 },
    { 41, 40, 5, 102, 211, 183, 4, 1, 221 },
    { 51, 50, 17, 168, 209, 192, 23, 25, 82 } },
  { { 138, 31, 36, 171, 27, 166, 38, 44, 229 },
    { 67, 87, 58, 169, 82, 115, 26, 59, 179 },
    { 63, 59, 90, 180, 59, 166, 93, 73, 154 },
    { 40, 40, 21, 116, 143, 209, 34, 39, 175 },
    { 47, 15, 16, 183, 34, 223, 49, 45, 183 },
    { 46, 17, 33, 183, 6, 98, 15, 32, 183 },
    { 57, 46, 22, 24, 128, 1, 54, 17, 37 },
    { 65, 32, 73, 115, 28, 128, 23, 128, 205 },
    { 40, 3, 9, 115, 51, 192, 18, 6, 223 },
    { 87, 37, 9, 115, 59, 77, 64, 21, 47 } },
  { { 104, 55, 44, 218, 9, 54, 53, 130, 226 },
    { 64, 90, 70, 205, 40, 41, 23, 26, 57 },
    { 54, 57, 112, 184, 5, 41, 38, 166, 213 },
    { 30, 34, 26, 133, 152, 116, 10, 32, 134 },
    { 39, 19, 53, 221, 26, 114, 32, 73, 255 },
    { 31, 9, 65, 234, 2, 15, 1, 118, 73 },
    { 75, 32, 12, 51, 192, 255, 160, 43, 51 },
    { 88, 31, 35, 67, 102, 85, 55, 186, 85 },
    { 56, 21, 23, 111, 59, 205, 45, 37, 192 },
    { 55, 38, 70, 124, 73, 102, 1, 34, 98 } },
  { { 125, 98, 42, 88, 104, 85, 117, 175, 82 },
    { 95, 84, 53, 89, 128, 100, 113, 101, 45 },
    { 75, 79, 123, 47, 51, 128, 81, 171, 1 },
    { 57, 17, 5, 71, 102, 57, 53, 41, 49 },
    { 38, 33, 13, 121, 57, 73, 26, 1, 85 },
    { 41, 10, 67, 138, 77, 110, 90, 47, 114 },
    { 115, 21, 2, 10, 102, 255, 166, 23, 6 },
    { 101, 29, 16, 10, 85, 128, 101, 196, 26 },
    { 57, 18, 10, 102, 102, 213, 34, 20, 43 },
    { 117, 20, 15, 36, 163, 128, 68, 1, 26 } },
  { { 102, 61, 71, 37, 34, 53, 31, 243, 192 },
    { 69, 60, 71, 38, 73, 119, 28, 222, 37 },
    { 68, 45, 128, 34, 1, 47, 11, 245, 171 },
    { 62, 17, 19, 70, 146, 85, 55, 62, 70 },
    { 37, 43, 37, 154, 100, 163, 85, 160, 1 },
    { 63, 9, 92, 136, 28, 64, 32, 201, 85 },
    { 75, 15, 9, 9, 64, 255, 184, 119, 16 },
    { 86, 6, 28, 5, 64, 255, 25, 248, 1 },
    { 56, 8, 17, 132, 137, 255, 55, 116, 128 },
    { 58, 15, 20, 82, 135, 57, 26, 121, 40 } },
  { { 164, 50, 31, 137, 154, 133, 25, 35, 218 },
    { 51, 103, 44, 131, 131, 123, 31, 6, 158 },
    { 86, 40, 64, 135, 148, 224, 45, 183, 128 },
    { 22, 26, 17, 131, 240, 154, 14, 1, 209 },
    { 45, 16, 21, 91, 64, 222, 7, 1, 197 },
    { 56, 21, 39, 155, 60, 138, 23, 102, 213 },
    { 83, 12, 13, 54, 192, 255, 68, 47, 28 },
    { 85, 26, 85, 85, 128, 128, 32, 146, 171 },
    { 18, 11, 7, 63, 144, 171, 4, 4, 246 },
    { 35, 27, 10, 146, 174, 171, 12, 26, 128 } },
  { { 190, 80, 35, 99, 180, 80, 126, 54, 45 },
    { 85, 126, 47, 87, 176, 51, 41, 20, 32 },
    { 101, 75, 128, 139, 118, 146, 116, 128, 85 },
    { 56, 41, 15, 176, 236, 85, 37, 9, 62 },
    { 71, 30, 17, 119, 118, 255, 17, 18, 138 },
    { 101, 38, 60, 138, 55, 70, 43, 26, 142 },
    { 146, 36, 19, 30, 171, 255, 97, 27, 20 },
    { 138, 45, 61, 62, 219, 1, 81, 188, 64 },
    { 32, 41, 20, 117, 151, 142, 20, 21, 163 },
    { 112, 19, 12, 61, 195, 128, 48, 4, 24 } } };

struct Error {
  const char* msg;
};

// libwebp's boolean decoder (bit_reader_utils.h / bit_reader_inl_utils.h): one byte is
// loaded at a time where libwebp loads seven, which leaves value >> bits unchanged.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;        // bits in value past the 8 of the window; < 0: load a byte
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* start, size_t size) {
    buf = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (uint64_t)(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;  // as libwebp: no undefined shifts past the end
    }
  }
  static int log2_floor(uint32_t v) { return 31 ^ __builtin_clz(v); }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ log2_floor(r);
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // VP8GetSigned: a bit at probability 1/2 that always shifts by one
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t value_ = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - value_) >> 31;  // -1 or 0
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  int get_value(int n) {
    int v = 0;
    while (n-- > 0) v |= get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = get_value(n);
    return get_bit(0x80) ? -v : v;
  }
  int get() { return get_value(1); }
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};
struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};
struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};
struct NzCtx {
  uint8_t nz = 0, nz_dc = 0;
};

typedef const uint8_t (*BandProbas)[NUM_PROBAS];  // [ctx][proba] of one band

struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  QuantMatrix dqm[4];
  uint8_t proba[NUM_TYPES][NUM_BANDS][NUM_CTX][NUM_PROBAS];
  int use_skip_proba = 0, skip_p = 0;
  BandProbas bands[NUM_TYPES][16 + 1];  // per coefficient position
  FInfo fstrengths[4][2];
  uint32_t features = 0;
};

// ---- the first partition --------------------------------------------------------------

void parse_segment_header(Decoder& d) {
  BoolReader& br = d.br;
  d.use_segment = br.get();
  if (d.use_segment) {
    d.update_map = br.get();
    if (br.get()) {  // update data
      d.absolute_delta = br.get();
      for (int s = 0; s < 4; ++s) d.quantizer[s] = br.get() ? br.get_signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        d.filter_strength[s] = br.get() ? br.get_signed_value(6) : 0;
      d.features |= 1u << F_SEGMENT_DELTA;
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s) d.seg_proba[s] = br.get() ? br.get_value(8) : 255;
      d.features |= 1u << F_UPDATE_MAP;
    }
  } else {
    d.update_map = 0;
  }
  if (br.eof) throw Error{"cannot parse segment header"};
}

void parse_filter_header(Decoder& d) {
  BoolReader& br = d.br;
  d.simple = br.get();
  d.level = br.get_value(6);
  d.sharpness = br.get_value(3);
  d.use_lf_delta = br.get();
  if (d.use_lf_delta) {
    if (br.get()) {  // update lf-delta?
      for (int i = 0; i < 4; ++i)
        if (br.get()) d.ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get()) d.mode_lf_delta[i] = br.get_signed_value(6);
    }
  }
  d.filter_type = (d.level == 0) ? 0 : d.simple ? 1 : 2;
  if (br.eof) throw Error{"cannot parse filter header"};
}

void parse_partitions(Decoder& d, const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  d.num_parts_minus_one = (1 << d.br.get_value(2)) - 1;
  const size_t last_part = d.num_parts_minus_one;
  if (size < 3 * last_part) throw Error{"cannot parse partitions"};
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    d.parts[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  d.parts[last_part].init(part_start, size_left);
  if (part_start >= buf_end) throw Error{"cannot parse partitions"};
  if (last_part == 1) d.features |= 1u << F_PARTS2;
  if (last_part == 3) d.features |= 1u << F_PARTS4;
  if (last_part == 7) d.features |= 1u << F_PARTS8;
}

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

void parse_quant(Decoder& d) {
  BoolReader& br = d.br;
  const int base_q0 = br.get_value(7);
  const int dqy1_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dqy2_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dqy2_ac = br.get() ? br.get_signed_value(4) : 0;
  const int dquv_dc = br.get() ? br.get_signed_value(4) : 0;
  const int dquv_ac = br.get() ? br.get_signed_value(4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else {
      if (i > 0) {
        d.dqm[i] = d.dqm[0];
        continue;
      }
      q = base_q0;
    }
    QuantMatrix& m = d.dqm[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q + 0, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 == (x * 101581) >> 16 for every x of the table
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void parse_proba(Decoder& d) {
  BoolReader& br = d.br;
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < NUM_BANDS; ++b)
      for (int c = 0; c < NUM_CTX; ++c)
        for (int p = 0; p < NUM_PROBAS; ++p) {
          if (br.get_bit(CoeffsUpdateProba[t][b][c][p])) {
            d.proba[t][b][c][p] = br.get_value(8);
            d.features |= 1u << F_PROBA_UPDATE;
          } else {
            d.proba[t][b][c][p] = CoeffsProba0[t][b][c][p];
          }
        }
  d.use_skip_proba = br.get();
  if (d.use_skip_proba) d.skip_p = br.get_value(8);
  for (int t = 0; t < NUM_TYPES; ++t)
    for (int b = 0; b < 16 + 1; ++b) d.bands[t][b] = d.proba[t][kBands[b]];
}

void parse_intra_mode(Decoder& d, MBData& block, uint8_t* top, uint8_t* left) {
  BoolReader& br = d.br;
  if (d.update_map) {
    block.segment = !br.get_bit(d.seg_proba[0]) ? br.get_bit(d.seg_proba[1])
                                                : br.get_bit(d.seg_proba[2]) + 2;
  } else {
    block.segment = 0;
  }
  if (block.segment != 0) d.features |= 1u << F_SEGMENTS;
  block.skip = d.use_skip_proba ? br.get_bit(d.skip_p) : 0;
  block.is_i4x4 = !br.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br.get_bit(156) ? (br.get_bit(128) ? TM_PRED : H_PRED)
                                      : (br.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
    d.features |= 1u << (F_I16 + ymode);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba[top[x]][ymode];
        ymode = !br.get_bit(prob[0])   ? B_DC_PRED
                : !br.get_bit(prob[1]) ? B_TM_PRED
                : !br.get_bit(prob[2]) ? B_VE_PRED
                : !br.get_bit(prob[3])
                    ? (!br.get_bit(prob[4]) ? B_HE_PRED
                                            : (!br.get_bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                    : (!br.get_bit(prob[6])
                           ? B_LD_PRED
                           : (!br.get_bit(prob[7])
                                  ? B_VL_PRED
                                  : (!br.get_bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
        top[x] = ymode;
        d.features |= 1u << (F_I4 + ymode);
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = ymode;
    }
  }
  block.uvmode = !br.get_bit(142)   ? DC_PRED
                 : !br.get_bit(114) ? V_PRED
                 : br.get_bit(183)  ? TM_PRED
                                    : H_PRED;
}

// ---- the token partitions -------------------------------------------------------------

int get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get_bit(*tab);
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// the position of the last non-zero coefficient plus one (16 after a run of zeros to the
// end), as libwebp's GetCoeffsFast
int get_coeffs(BoolReader& br, BandProbas const prob[], int ctx, const int dq[2], int n,
               int16_t* out) {
  const uint8_t* p = prob[n][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;  // the previous coefficient was the last non-zero one
    while (!br.get_bit(p[1])) {       // a run of zeros
      p = prob[++n][0];
      if (n == 16) return 16;
    }
    BandProbas const* p_ctx = &prob[n + 1];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = (*p_ctx)[1];
    } else {
      v = get_large_value(br, p);
      p = (*p_ctx)[2];
    }
    out[kZigzag[n]] = (int16_t)(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;  // with the rounder
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// returns 1 when the macroblock holds no non-zero coefficient
int parse_residuals(Decoder& d, MBData& block, NzCtx& mb, NzCtx& left_mb, BoolReader& br) {
  const auto& bands = d.bands;
  const QuantMatrix& q = d.dqm[block.segment];
  int16_t* dst = block.coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  BandProbas const* ac_proba;
  int first;

  memset(dst, 0, 384 * sizeof(*dst));
  if (!block.is_i4x4) {  // the DC of the 16 luma blocks: the y2 block
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left_mb.nz_dc;
    const int nz = get_coeffs(br, bands[1], ctx, q.y2, 0, dc);
    mb.nz_dc = left_mb.nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {  // only the DC: the WHT's shortcut
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
    }
    first = 1;
    ac_proba = bands[0];
  } else {
    first = 0;
    ac_proba = bands[3];
  }

  uint8_t tnz = mb.nz & 0x0f;
  uint8_t lnz = left_mb.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;

  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(mb.nz >> (4 + ch));
    lnz = (uint8_t)(left_mb.nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, bands[2], ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  mb.nz = (uint8_t)out_t_nz;
  left_mb.nz = (uint8_t)out_l_nz;
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// ---- reconstruction (dsp/dec.c) -------------------------------------------------------

inline uint8_t clip_8b(int v) { return (!(v & ~0xff)) ? (uint8_t)v : (v < 0) ? 0 : 255; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
#define STORE(x, y, v) dst[(x) + (y) * BPS] = clip_8b(dst[(x) + (y) * BPS] + ((v) >> 3))

// The full inverse DCT as libwebp's x86 build runs it (Transform_SSE2): every sum wraps at
// 16 bits, MUL1 / MUL2 are mulhi with 20091 and 35468 - 65536, and the sum with the
// prediction saturates to 0..255. For the coefficients an encoder writes this equals the C
// version (TransformOne_C: 32-bit sums, no wrap); on corrupt data only this one is libwebp's.
inline int16_t w16(int v) { return (int16_t)v; }
inline int16_t mulhi(int16_t x, int k) { return (int16_t)(((int32_t)x * k) >> 16); }

void idct_pass(const int16_t i0[4], const int16_t i1[4], const int16_t i2[4],
               const int16_t i3[4], int16_t bias, int16_t out[4][4]) {
  for (int j = 0; j < 4; ++j) {  // one 16-bit lane a column (vertical) or a row (horizontal)
    const int16_t dc = w16(i0[j] + bias);
    const int16_t a = w16(dc + i2[j]);
    const int16_t b = w16(dc - i2[j]);
    const int16_t c = w16(w16(i1[j] - i3[j]) + w16(mulhi(i1[j], -30068) - mulhi(i3[j], 20091)));
    const int16_t d = w16(w16(i1[j] + i3[j]) + w16(mulhi(i1[j], 20091) + mulhi(i3[j], -30068)));
    out[0][j] = w16(a + d);
    out[1][j] = w16(b + c);
    out[2][j] = w16(b - c);
    out[3][j] = w16(a - d);
  }
}

void transform_one(const int16_t* in, uint8_t* dst) {
  int16_t v[4][4], t[4][4], h[4][4];
  idct_pass(in, in + 4, in + 8, in + 12, 0, v);  // v[k][col]
  for (int r = 0; r < 4; ++r)
    for (int s = 0; s < 4; ++s) t[r][s] = v[s][r];  // transpose: t[col][row]
  idct_pass(t[0], t[1], t[2], t[3], 4, h);  // h[col][row]
  for (int row = 0; row < 4; ++row)
    for (int col = 0; col < 4; ++col) {
      const int16_t sum = w16(dst[col + row * BPS] + (int16_t)(h[col][row] >> 3));
      dst[col + row * BPS] = sum < 0 ? 0 : sum > 255 ? 255 : (uint8_t)sum;
    }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {  // in[0], in[1] and in[4] only
  const int a = in[0] + 4;
  const int c4 = mul2(in[4]), d4 = mul1(in[4]);
  const int c1 = mul2(in[1]), d1 = mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int dc = rows[y];
    STORE(0, y, dc + d1);
    STORE(1, y, dc + c1);
    STORE(2, y, dc - c1);
    STORE(3, y, dc - d1);
  }
}

void transform_dc(const int16_t* in, uint8_t* dst) {  // in[0] only
  const int dc = in[0] + 4;
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) STORE(i, j, dc);
}
#undef STORE

void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: transform_one(src, dst); break;
    case 2: transform_ac3(src, dst); break;
    case 1: transform_dc(src, dst); break;
    default: break;
  }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {    // any non-zero coefficient
    if (bits & 0xaa) {  // any non-zero AC coefficient: the full transform on all four
      transform_one(src, dst);
      transform_one(src + 16, dst + 4);
      transform_one(src + 32, dst + 4 * BPS);
      transform_one(src + 48, dst + 4 * BPS + 4);
    } else {
      if (src[0]) transform_dc(src, dst);
      if (src[16]) transform_dc(src + 16, dst + 4);
      if (src[32]) transform_dc(src + 32, dst + 4 * BPS);
      if (src[48]) transform_dc(src + 48, dst + 4 * BPS + 4);
    }
  }
}

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip_8b(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS],
                E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, avg3(A, B, C), 4);
      memset(dst + 1 * BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS],
                D = dst[3 - BPS];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_LD_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VL_PRED: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS],
                E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS],
                C = dst[2 - BPS];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS],
                L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
  }
}
#undef DST

// the 16x16 luma (size 16) and 8x8 chroma (size 8) predictions; mode after check_mode
void pred_block(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case DC_PRED: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> shift, size);
      break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> (shift - 1), size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      fill(dst, dc >> (shift - 1), size);
      break;
    }
    case DC_NOTOPLEFT: fill(dst, 0x80, size); break;
  }
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return (mb_y == 0) ? DC_NOTOPLEFT : DC_NOLEFT;
    return (mb_y == 0) ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// One macroblock row reconstructed (frame_dec.c's ReconstructRow) into the planes.
void reconstruct_row(const Decoder& d, int mb_y, const std::vector<MBData>& row,
                     std::vector<TopSamples>& top, uint8_t* work, uint8_t* Y, uint8_t* U,
                     uint8_t* V) {
  uint8_t* const y_dst = work + BPS * 1 + 8;
  uint8_t* const u_dst = y_dst + BPS * 16 + BPS;
  uint8_t* const v_dst = u_dst + 16;
  const int y_stride = d.mb_w * 16, uv_stride = d.mb_w * 8;
  static const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                                0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                                0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                                0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

  // the left-most block's left samples, and the top-left one
  for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
  for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
  if (mb_y > 0) {
    y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
  } else {  // above the frame: 127, the top-right samples included
    memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
    memset(u_dst - BPS - 1, 127, 8 + 1);
    memset(v_dst - BPS - 1, 127, 8 + 1);
  }

  for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
    const MBData& block = row[mb_x];
    if (mb_x > 0) {  // the previous block's right columns become the left samples
      for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
        memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
      }
    }
    TopSamples* const top_yuv = &top[mb_x];
    const int16_t* const coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      memcpy(y_dst - BPS, top_yuv[0].y, 16);
      memcpy(u_dst - BPS, top_yuv[0].u, 8);
      memcpy(v_dst - BPS, top_yuv[0].v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= d.mb_w - 1) {  // on the right edge: the last pixel above, repeated
          memset(top_right, top_yuv[0].y[15], 4);
        } else {
          memcpy(top_right, top_yuv[1].y, 4);
        }
      }
      // the sub-blocks of the right column below the first take the same samples
      memcpy(top_right + 4 * BPS, top_right, 4);
      memcpy(top_right + 8 * BPS, top_right, 4);
      memcpy(top_right + 12 * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        pred_luma4(block.imodes[n], dst);
        do_transform(bits, coeffs + n * 16, dst);
      }
    } else {
      pred_block(check_mode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
      if (bits != 0) {
        for (int n = 0; n < 16; ++n, bits <<= 2)
          do_transform(bits, coeffs + n * 16, y_dst + kScan[n]);
      }
    }
    {
      const uint32_t bits_uv = block.non_zero_uv;
      const int mode = check_mode(mb_x, mb_y, block.uvmode);
      pred_block(mode, u_dst, 8);
      pred_block(mode, v_dst, 8);
      do_uv_transform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
      do_uv_transform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
    }
    if (mb_y < d.mb_h - 1) {  // the unfiltered bottom row, for the row below
      memcpy(top_yuv[0].y, y_dst + 15 * BPS, 16);
      memcpy(top_yuv[0].u, u_dst + 7 * BPS, 8);
      memcpy(top_yuv[0].v, v_dst + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j)
      memcpy(Y + (size_t)(mb_y * 16 + j) * y_stride + mb_x * 16, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(U + (size_t)(mb_y * 8 + j) * uv_stride + mb_x * 8, u_dst + j * BPS, 8);
      memcpy(V + (size_t)(mb_y * 8 + j) * uv_stride + mb_x * 8, v_dst + j * BPS, 8);
    }
  }
}

// ---- the loop filter (dsp/dec.c) ------------------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]
inline uint8_t clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int step) {  // 4 pixels in, 2 out
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {  // 4 pixels in, 4 out
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip1(p1 + a3);
  p[-step] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {  // 6 pixels in, 6 out
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip1(p2 + a3);
  p[-2 * step] = clip1(p1 + a2);
  p[-step] = clip1(p0 + a1);
  p[0] = clip1(q0 - a1);
  p[step] = clip1(q1 - a2);
  p[2 * step] = clip1(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs0(p1 - p0) > thresh) || (abs0(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs0(p0 - q0) + abs0(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs0(p0 - q0) + abs0(p1 - q1)) > t) return 0;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it &&
         abs0(q3 - q2) <= it && abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

// the simple filter: one edge of 16 pixels, across ``step``, along ``stride``
void simple_filter16(uint8_t* p, int step, int along, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, thresh2)) do_filter2(p + i * along, step);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter6(p, hstride);
      }
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) {
        do_filter2(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

void precompute_filter_strengths(Decoder& d) {
  if (d.filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = (level < 0) ? 0 : (level > 63) ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= (d.sharpness > 4) ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = (uint8_t)ilevel;
        info.limit = (uint8_t)(2 * level + ilevel);
        info.hev_thresh = (level >= 40) ? 2 : (level >= 15) ? 1 : 0;
      } else {
        info.limit = 0;  // no filtering
      }
      info.inner = (uint8_t)i4x4;
    }
  }
}

// one macroblock's edges, in libwebp's order (DoFilter)
void filter_mb(const Decoder& d, const FInfo& f, int mb_x, int mb_y, uint8_t* Y, uint8_t* U,
               uint8_t* V) {
  const int limit = f.limit;
  if (limit == 0) return;
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  uint8_t* const y_dst = Y + (size_t)mb_y * 16 * ys + mb_x * 16;
  if (d.filter_type == 1) {  // simple
    if (mb_x > 0) simple_filter16(y_dst, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter16(y_dst + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_filter16(y_dst, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_filter16(y_dst + 4 * k * ys, ys, 1, limit);
  } else {  // normal
    uint8_t* const u_dst = U + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t* const v_dst = V + (size_t)mb_y * 8 * uvs + mb_x * 8;
    const int il = f.ilevel, hv = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop26(y_dst, 1, ys, 16, limit + 4, il, hv);
      filter_loop26(u_dst, 1, uvs, 8, limit + 4, il, hv);
      filter_loop26(v_dst, 1, uvs, 8, limit + 4, il, hv);
    }
    if (f.inner) {
      for (int k = 1; k < 4; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, il, hv);
      filter_loop24(u_dst + 4, 1, uvs, 8, limit, il, hv);
      filter_loop24(v_dst + 4, 1, uvs, 8, limit, il, hv);
    }
    if (mb_y > 0) {
      filter_loop26(y_dst, ys, 1, 16, limit + 4, il, hv);
      filter_loop26(u_dst, uvs, 1, 8, limit + 4, il, hv);
      filter_loop26(v_dst, uvs, 1, 8, limit + 4, il, hv);
    }
    if (f.inner) {
      for (int k = 1; k < 4; ++k)
        filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, il, hv);
      filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, il, hv);
      filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, il, hv);
    }
  }
}

// ---- the frame ------------------------------------------------------------------------

void decode(const uint8_t* data, size_t size, int width, int height, uint8_t* Y, uint8_t* U,
            uint8_t* V, uint32_t* features) {
  Decoder d;
  if (size < 10) throw Error{"cannot parse picture header"};
  const uint32_t tag = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(tag & 1), profile = (tag >> 1) & 7, show = (tag >> 4) & 1;
  const uint32_t partition_length = tag >> 5;
  if (profile > 3) throw Error{"Incorrect keyframe parameters."};
  if (!show) throw Error{"Frame not displayable."};
  if (!key_frame) throw Error{"Not a key frame."};
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) throw Error{"Bad code word"};
  d.width = ((data[7] << 8) | data[6]) & 0x3fff;
  d.height = ((data[9] << 8) | data[8]) & 0x3fff;
  if (d.width != width || d.height != height) throw Error{"the frame's size differs"};
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_size = size - 10;
  if (partition_length > buf_size) throw Error{"bad partition length"};
  d.br.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;

  d.br.get();  // colour space
  d.br.get();  // clamping type (the decoder always clamps)
  parse_segment_header(d);
  parse_filter_header(d);
  parse_partitions(d, buf, buf_size);
  parse_quant(d);
  d.br.get();  // update_proba: ignored on a key frame
  parse_proba(d);
  precompute_filter_strengths(d);
  d.features |= 1u << (d.filter_type == 0   ? F_FILTER_NONE
                       : d.filter_type == 1 ? F_FILTER_SIMPLE
                                            : F_FILTER_NORMAL);
  if (d.filter_type > 0 && d.sharpness > 0) d.features |= 1u << F_SHARPNESS;

  std::vector<MBData> row(d.mb_w);
  std::vector<NzCtx> nz_top(d.mb_w);
  std::vector<TopSamples> top(d.mb_w);
  std::vector<FInfo> finfo((size_t)d.mb_w * d.mb_h);
  std::vector<uint8_t> intra_t(4 * d.mb_w, B_DC_PRED);
  uint8_t intra_l[4];
  uint8_t work[BPS * 17 + BPS * 9] = {0};

  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    BoolReader& token_br = d.parts[mb_y & d.num_parts_minus_one];
    NzCtx left;  // the row's left context and modes start afresh (VP8InitScanline)
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
      parse_intra_mode(d, row[mb_x], &intra_t[4 * mb_x], intra_l);
    if (d.br.eof) throw Error{"Premature end-of-partition0 encountered."};
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& block = row[mb_x];
      NzCtx& mb = nz_top[mb_x];
      int skip = d.use_skip_proba ? block.skip : 0;
      if (!skip) {
        skip = parse_residuals(d, block, mb, left, token_br);
      } else {
        left.nz = mb.nz = 0;
        if (!block.is_i4x4) left.nz_dc = mb.nz_dc = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
        d.features |= 1u << F_SKIP;
      }
      if (d.filter_type > 0) {
        FInfo& f = finfo[(size_t)mb_y * d.mb_w + mb_x];
        f = d.fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
      }
      if (token_br.eof) throw Error{"Premature end-of-file encountered."};
    }
    reconstruct_row(d, mb_y, row, top, work, Y, U, V);
  }
  if (d.filter_type > 0) {
    for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
        filter_mb(d, finfo[(size_t)mb_y * d.mb_w + mb_x], mb_x, mb_y, Y, U, V);
  }
  *features = d.features;
}

}  // namespace

extern "C" {

// A "VP8 " chunk's payload (data, size) of a width x height key frame -> the Y plane
// [mb_h * 16, mb_w * 16] and the U and V planes [mb_h * 8, mb_w * 8], and the bitmask of
// the features met. 0 on success; otherwise 1 and a message in err.
int webp_vp8_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                    uint8_t* y, uint8_t* u, uint8_t* v, int32_t* features, char* err,
                    int32_t err_len) {
  try {
    uint32_t seen = 0;
    decode(data, (size_t)size, width, height, y, u, v, &seen);
    *features = (int32_t)seen;
    return 0;
  } catch (const Error& e) {
    snprintf(err, err_len, "%s", e.msg);
  } catch (const std::bad_alloc&) {
    snprintf(err, err_len, "out of memory");
  }
  return 1;
}

// The constant tables, concatenated (for the tests' digest): kDcTable, kAcTable (little-
// endian uint16), kBands, kZigzag, kCat3-6, CoeffsProba0, CoeffsUpdateProba, kBModesProba.
// Returns the number of bytes (out may be NULL to ask).
int64_t webp_vp8_tables(uint8_t* out) {
  std::vector<uint8_t> t;
  auto put = [&t](const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    t.insert(t.end(), b, b + n);
  };
  put(kDcTable, sizeof(kDcTable));
  for (uint16_t a : kAcTable) {
    t.push_back(a & 0xff);
    t.push_back(a >> 8);
  }
  put(kBands, sizeof(kBands));
  put(kZigzag, sizeof(kZigzag));
  put(kCat3, sizeof(kCat3));
  put(kCat4, sizeof(kCat4));
  put(kCat5, sizeof(kCat5));
  put(kCat6, sizeof(kCat6));
  put(CoeffsProba0, sizeof(CoeffsProba0));
  put(CoeffsUpdateProba, sizeof(CoeffsUpdateProba));
  put(kBModesProba, sizeof(kBModesProba));
  if (out) memcpy(out, t.data(), t.size());
  return (int64_t)t.size();
}
}
