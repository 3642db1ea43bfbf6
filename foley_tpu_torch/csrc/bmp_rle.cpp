// RLE8 and RLE4 BMP pixel data on the host, behind a plain C interface (loaded through ctypes
// by foley_tpu_torch/io/bmp.py; built by ops/kernels/build.py's host route). It reads the
// runs as Pillow 12's BmpRleDecoder (PIL/BmpImagePlugin.py) reads them, quirks included, and
// writes palette indices in file row order; the palette lookup and the row order run on the
// caller's device.
//
// A pair (count, value) with count > 0 is an encoded run: count pixels of value (RLE4: its
// two nibbles in turn), cut at the row's end. Count 0 is an escape: 0 ends the line (the rest
// of the row reads index 0), 1 ends the bitmap, 2 is a delta (Pillow reads two bytes, then
// the two after them as right and up, and writes right + up * width zeros), and n >= 3 an
// absolute run of n indices (RLE4: n / 2 bytes, two nibbles each, so an odd n loses its last
// pixel), after which the read position is aligned to an even offset in the file. The runs
// end when width * height indices are written, at the end of the bitmap, or where the file
// ends.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// Decode the runs of file[0:size] from byte offset into out (width * height indices, in
// file row order). Returns the count of indices the runs wrote (more than width * height is
// cut to it; fewer is Pillow's "not enough image data"), or -1 where a delta's two values
// are missing (Pillow's own read fails there).
int64_t bmp_rle_decode(const uint8_t* file, int64_t size, int64_t offset, int32_t width,
                       int32_t height, int32_t rle4, uint8_t* out) {
  const int64_t dest = (int64_t)width * height;
  std::vector<uint8_t> data;
  data.reserve((size_t)dest);
  int64_t pos = offset < size ? offset : size, x = 0;
  auto read = [&](int64_t n, const uint8_t** p) {  // fd.read(n): what is left of n bytes
    int64_t got = pos + n <= size ? n : pos < size ? size - pos : 0;
    *p = file + pos;
    pos += got;
    return got;
  };
  const uint8_t* p;
  while ((int64_t)data.size() < dest) {
    if (read(1, &p) < 1) break;
    int count = p[0];
    if (read(1, &p) < 1) break;
    int value = p[0];
    if (count) {  // encoded run
      int64_t n = count;
      if (x + n > width) n = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < n; ++i)
        data.push_back((uint8_t)(rle4 ? (i % 2 == 0 ? value >> 4 : value & 15) : value));
      x += n;
    } else if (value == 0) {  // end of line
      while (data.size() % (size_t)width != 0) data.push_back(0);
      x = 0;
    } else if (value == 1) {  // end of bitmap
      break;
    } else if (value == 2) {  // delta
      if (read(2, &p) < 2) break;
      if (read(2, &p) < 2) return -1;
      data.insert(data.end(), (size_t)p[0] + (size_t)p[1] * width, 0);
      x = (int64_t)(data.size() % (size_t)width);
    } else {  // absolute run
      int64_t want = rle4 ? value / 2 : value;
      int64_t got = read(want, &p);
      for (int64_t i = 0; i < got; ++i) {
        if (rle4) {
          data.push_back(p[i] >> 4);
          data.push_back(p[i] & 15);
        } else {
          data.push_back(p[i]);
        }
      }
      if (got < want) break;
      x += value;
      if (pos % 2 != 0) pos += 1;  // a seek: past the end of the file reads nothing
    }
  }
  const int64_t n = (int64_t)data.size();
  for (int64_t i = 0; i < (n < dest ? n : dest); ++i) out[i] = data[(size_t)i];
  return n;
}

}  // extern "C"
