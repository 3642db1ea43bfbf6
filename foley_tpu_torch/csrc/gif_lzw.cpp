// GIF's first frame on the host, behind a plain C interface (loaded through ctypes by
// foley_tpu_torch/io/gif.py; built by ops/kernels/build.py's host route): the block
// structure up to the first image descriptor (gif_parse) and that image's LZW data
// (gif_lzw_decode), read as Pillow 12's GifImagePlugin.py and libImaging/GifDecode.c read
// them. The palette lookup, the de-interlacing and the placement on the logical screen run
// on the caller's device.
//
// The walk (GifImageFile._open and _seek(0)): the 13-byte header and logical screen
// descriptor, the global colour table, then blocks: '!' extensions, each a label and
// sub-blocks (a Graphic Control Extension's flags, and its transparent index where its bit 0
// is set), ',' the image descriptor (its extent, local colour table and interlace flag,
// then the LZW minimum code size), ';' or the end of the file before an image descriptor
// (no image), any other byte skipped.
//
// The LZW data (ImagingGifDecode): variable-width codes read least significant bit first
// across the sub-blocks (a sub-block's length byte read where the bits run out, a zero
// length skipped), clear = 1 << bits, end = clear + 1, codes from bits + 1 up to 12 bits
// wide, the width growing when the next free code reaches the mask; a full table (4096
// codes) adds no code and is not reset until a clear code (a deferred clear). The first
// code after a clear must be a literal; a code past the next free one, or a string longer
// than the 4096-byte stack, is a broken stream. Pixels go out in decode order; the decoder
// stops when the frame's last row (in interlaced order) is full.
//
// Pillow feeds the decoder the file in 65536-byte reads from the image data's start and
// raises "image file is truncated" when it wants more and the file has ended. At an end
// code before the frame is full the decoder returns and Pillow reads on: past the end of
// the file that is the same error, and where the file goes on, the decoder goes on reading
// codes after the end code. Both are kept here.

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

const int kBits = 12, kTable = 4096, kStack = 4096, kRead = 65536;

}  // namespace

extern "C" {

// The first frame's layout of data[0:size] into info: [0] screen width, [1] screen height,
// [2] global table flag, [3] global table offset, [4] global table entries, [5] frame left,
// [6] top, [7] width, [8] height, [9] interlace, [10] local table flag, [11] local table
// offset, [12] local table entries, [13] transparent index (-1: none), [14] LZW minimum code
// size, [15] offset of the image data (after the code size byte). Returns 0, or non-zero
// with a message in err.
int gif_parse(const uint8_t* data, int64_t size, int64_t* info, char* err, int32_t err_len) {
  auto fail = [&](const char* msg) {
    std::snprintf(err, (size_t)err_len, "%s", msg);
    return 1;
  };
  if (size < 13 || (std::memcmp(data, "GIF87a", 6) != 0 && std::memcmp(data, "GIF89a", 6) != 0))
    return fail("not a GIF file");
  for (int i = 0; i < 16; ++i) info[i] = 0;
  info[0] = data[6] | data[7] << 8;
  info[1] = data[8] | data[9] << 8;
  int64_t pos = 13;
  if (data[10] & 128) {
    info[2] = 1;
    info[3] = pos;
    info[4] = 1 << ((data[10] & 7) + 1);
    pos += 3 * info[4];
    if (pos > size) return fail("truncated GIF (the global colour table)");
  }
  info[13] = -1;
  while (true) {
    if (pos >= size || data[pos] == ';') return fail("no image descriptor before the GIF's end");
    uint8_t s = data[pos++];
    if (s == '!') {  // an extension: its label, then sub-blocks
      if (pos >= size) return fail("truncated GIF (an extension without its label)");
      uint8_t label = data[pos++];
      // GifImageFile.data(): one sub-block's bytes, from at: -1 where its length byte is 0
      // or the file has ended (None), else the bytes that are there of its length
      int64_t at = 0;
      auto sub_block = [&]() -> int64_t {
        if (pos >= size || data[pos] == 0) {
          pos += pos < size;
          return -1;
        }
        int64_t n = data[pos++];
        at = pos;
        if (n > size - pos) n = size - pos;
        pos += n;
        return n;
      };
      if (label == 254) {  // a comment: sub-blocks up to a zero length
        while (sub_block() > 0) {
        }
        continue;
      }
      int64_t n = sub_block();
      if (n >= 0 && label == 249) {  // the Graphic Control Extension: flags, delay, index
        if (n < 3 || ((data[at] & 1) && n < 4))
          return fail("a Graphic Control Extension too short for its fields");
        if (data[at] & 1) info[13] = data[at + 3];
      }
      if (n >= 11 && label == 255 && std::memcmp(data + at, "NETSCAPE2.0", 11) == 0)
        sub_block();  // the loop count's sub-block
      // then sub-blocks up to a zero length; where the first was empty, this reads on past
      // its terminator (Pillow's walk)
      while (sub_block() > 0) {
      }
    } else if (s == ',') {  // the image descriptor
      if (pos + 9 > size) return fail("truncated GIF (the image descriptor)");
      const uint8_t* d = data + pos;
      info[5] = d[0] | d[1] << 8;
      info[6] = d[2] | d[3] << 8;
      info[7] = d[4] | d[5] << 8;
      info[8] = d[6] | d[7] << 8;
      info[9] = (d[8] & 64) != 0;
      pos += 9;
      if (d[8] & 128) {
        info[10] = 1;
        info[11] = pos;
        info[12] = 1 << ((d[8] & 7) + 1);
        pos += 3 * info[12];
        if (pos > size) return fail("truncated GIF (the local colour table)");
      }
      if (pos >= size) return fail("truncated GIF (no LZW minimum code size)");
      info[14] = data[pos++];
      info[15] = pos;
      return 0;
    }
  }
}

// Decode the LZW data of data[0:size] (from the image data's start to the file's end) at
// minimum code size bits into out (width * height indices, in decode order). Returns the
// count of indices written (the frame full: width * height), or -1 for a broken stream, -2
// for data that ends before the frame is full (Pillow's truncated file), -3 for a code size
// past 12.
int64_t gif_lzw_decode(const uint8_t* data, int64_t size, int32_t bits, int32_t width,
                       int32_t height, int32_t interlace, uint8_t* out) {
  if (bits < 0 || bits > kBits) return -3;
  static thread_local uint8_t table_data[kTable], stack[kStack], stack_out[kStack + 1];
  static thread_local uint16_t link[kTable];
  const int clear = 1 << bits, end = clear + 1;
  int next = 0, codesize = 0, codemask = 0, lastcode = 0, state = 1;
  uint8_t lastdata = 0;
  uint32_t bitbuffer = 0;
  int bitcount = 0;
  int64_t pos = 0, blockend = 0;  // blockend: the end of the last sub-block started
  int blocksize = 0;
  // the rows in the order they are written: the four interlace passes, or top to bottom
  int y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0, x = 0;
  int64_t written = 0;
  const int64_t total = (int64_t)width * height;
  while (true) {
    if (state == 1) {  // after a clear: a fresh table
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
    }
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuffer |= (uint32_t)data[pos++] << bitcount;
        bitcount += 8;
        --blocksize;
      } else {  // a sub-block's length byte; Pillow waits until the whole block is read
        if (pos >= size || pos + 1 + data[pos] > size) return -2;
        blocksize = data[pos++];
        blockend = pos + blocksize;
      }
    }
    int c = (int)(bitbuffer & (uint32_t)codemask);
    bitbuffer >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      if (state != 2) state = 1;
      continue;
    }
    if (c == end) {  // Pillow reads on: past the file's end that is a truncated file
      int64_t read = (blockend + kRead - 1) / kRead * kRead;
      if (read >= size) return -2;
      continue;
    }
    int sp = kStack;  // the string's bytes after its first (lastdata), from stack[sp]
    if (state == 2) {  // the first code after a clear: a literal
      if (c > clear) return -1;
      lastdata = (uint8_t)c;
      lastcode = c;
      state = 3;
    } else {
      int thiscode = c;
      if (c > next) return -1;
      if (c == next) {
        stack[--sp] = lastdata;
        c = lastcode;
      }
      while (c >= clear) {
        if (sp <= 0 || c >= kTable) return -1;
        stack[--sp] = table_data[c];
        c = link[c];
      }
      lastdata = (uint8_t)c;
      if (next < kTable) {
        table_data[next] = (uint8_t)c;
        link[next] = (uint16_t)lastcode;
        if (next == codemask && codesize < kBits) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    // the first byte, then the rest of the string (Pillow's buffer, returned next)
    stack_out[0] = lastdata;
    const int n = 1 + kStack - sp;
    std::memcpy(stack_out + 1, stack + sp, (size_t)(kStack - sp));
    const uint8_t* p = stack_out;
    for (int i = 0; i < n; ++i) {
      out[written++] = p[i];
      if (++x >= width) {  // the row is full: the next row of the pass, or the next pass
        x = 0;
        y += step;
        while (y >= height) {
          if (pass == 1) {
            y = 4;
            pass = 2;
          } else if (pass == 2) {
            step = 4;
            y = 2;
            pass = 3;
          } else if (pass == 3) {
            step = 2;
            y = 1;
            pass = 0;
          } else {
            return written;
          }
        }
      }
      if (written >= total) return written;
    }
  }
}

}  // extern "C"
