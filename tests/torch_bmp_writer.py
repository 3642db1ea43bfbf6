"""A BMP writer for the port's tests and fixtures (numpy and the standard library): files
assembled field by field, and RLE8 and RLE4 streams as an encoder writes them (Pillow writes
no RLE)."""

import struct

import numpy as np


def bmp_bytes(w, h, bits, rows, palette=b"", colors=0, compression=0, masks=b"", hsize=40,
              top_down=False, data=None):
    """A BMP file assembled field by field: ``rows`` top row first, each padded to 4
    bytes, stored bottom-up unless ``top_down`` (or ``data``, the pixel data as it is: an
    RLE stream); a 40-byte header's masks follow it, a larger one's sit inside it."""
    stride = ((w * bits + 31) >> 3) & ~3
    order = rows if top_down else rows[::-1]
    if data is None:
        data = b"".join(r.ljust(stride, b"\0") for r in order)
    if hsize == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, colors, 0).ljust(hsize, b"\0")
        if hsize >= 52 and masks:
            info = info[:40] + masks + info[40 + len(masks):]
    extra = masks if hsize == 40 else b""
    off = 14 + hsize + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info + extra + palette
            + data)


def rle_encode(idx: np.ndarray, rle4: bool) -> bytes:
    """Indices ``[H, W]`` (file row order: the bottom row first) -> an RLE8 or RLE4 stream as
    an encoder writes it: runs of one value encoded (RLE4: a byte of the value twice),
    stretches without runs in absolute runs of 3 or more (RLE4: an even count), each padded
    to a word, an end of line after each row and an end of bitmap."""
    out = bytearray()
    for row in idx.tolist():
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 2 or w - x < 4:
                out += bytes([n, row[x] * 17 if rle4 else row[x]])
                x += n
                continue
            k = 1  # an absolute stretch: up to the next run of two
            while x + k < w and k < 254 and not (x + k + 1 < w and row[x + k] == row[x + k + 1]):
                k += 1
            k -= k % 2 if rle4 else 0
            if k < 3:
                out += bytes([1, row[x] * 17 if rle4 else row[x]])
                x += 1
                continue
            vals = row[x:x + k]
            payload = bytes(a << 4 | b for a, b in zip(vals[::2], vals[1::2])) if rle4 \
                else bytes(vals)
            out += bytes([0, k]) + payload + b"\0" * (len(payload) & 1)
            x += k
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle_bmp(w, h, stream: bytes, rle4: bool, palette: np.ndarray, top_down=False,
            gap=b"") -> bytes:
    """An RLE BMP of ``stream`` (``gap`` bytes between the palette and the data, which the
    header's offset skips: an odd gap makes the absolute runs' padding fall elsewhere)."""
    data = bmp_bytes(w, h, 4 if rle4 else 8, [], palette.tobytes(), colors=len(palette),
                     compression=2 if rle4 else 1, top_down=top_down, data=gap + stream)
    if gap:
        off = struct.unpack("<I", data[10:14])[0] + len(gap)
        data = data[:10] + struct.pack("<I", off) + data[14:]
    return data
