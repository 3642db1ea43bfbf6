"""A TIFF writer for the port's tests and fixtures (numpy, zlib and Pillow's JPEG encoder):
files assembled tag by tag in either byte order, BigTIFF, strips or tiles, either planar
configuration, the predictor, LZW, Deflate and PackBits, and the layouts Pillow's writer does
not make: subsampled YCbCr in sampling blocks, JPEG-in-TIFF with shared tables."""

import io
import struct
import zlib

import numpy as np
from PIL import Image


def lzw_encode(data: bytes) -> bytes:
    """TIFF 6.0 LZW: 9- to 12-bit codes, MSB first, a clear first and when the table fills,
    the code width growing one code early, as libtiff's encoder writes it."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, n):
        nonlocal acc, nacc
        acc, nacc = (acc << n) | code, nacc + n
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def fresh():
        return {bytes([i]): i for i in range(256)}, 258, 9

    table, nxt, nbits = fresh()
    put(256, 9)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc], nxt = nxt, nxt + 1
        if nxt == 4094:
            put(256, nbits)
            table, nxt, nbits = fresh()
        elif nxt == 1 << nbits:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w], nbits)
        nxt += 1
        if nxt == 1 << nbits:
            nbits += 1
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and data[i + run] == data[i]:
            run += 1
        if run > 1:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_row(row: np.ndarray, bits: int, order: str) -> bytes:
    if bits == 16:
        return row.astype(order + "u2").tobytes()
    if bits == 8:
        return row.astype(np.uint8).tobytes()
    b = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - bits:].reshape(-1)
    return np.packbits(b).tobytes()


def tiff_bytes(px, photometric, bits, order="<", big=False, compression=1, predictor=1,
               planar=1, tile=None, rows=None, extra=None, colormap=None, tags=None,
               raw_chunks=None):
    """``px`` [H, W, spp] samples -> a TIFF: strips of ``rows`` rows (all in one when None)
    or ``tile`` = (height, width) tiles, planar configuration ``planar``, the samples
    differenced along each row for predictor 2, compressed, with the given tags and any
    ``tags`` = {tag: (type, values)} added or replacing them (type 5, rationals: values
    (numerator, denominator) pairs). ``raw_chunks``, where given, are the strips' or tiles'
    bytes before compression (subsampled YCbCr, JPEG streams), in place of ``px``'s."""
    h, w, spp = px.shape
    planes = spp if planar == 2 else 1
    ch, cw = tile if tile else ((rows or h), w)
    across, down = -(-w // cw), -(-h // ch)
    chunks = []
    compress = {1: lambda d: d, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
                32773: packbits_encode, 7: lambda d: d}[compression]
    for raw in raw_chunks or ():
        chunks.append(compress(raw))
    for p in range(planes if raw_chunks is None else 0):
        for cy in range(down):
            for cx in range(across):
                part = np.zeros((ch, cw, spp // planes), np.int64)
                src = px[cy * ch:(cy + 1) * ch, cx * cw:(cx + 1) * cw,
                         p if planar == 2 else slice(None)]
                src = src.reshape(src.shape[0], src.shape[1], -1)
                part[:src.shape[0], :src.shape[1]] = src
                if not tile:
                    part = part[:min(ch, h - cy * ch)]
                if predictor == 2:
                    part = np.concatenate([part[:, :1], np.diff(part, axis=1)], 1) % (1 << bits)
                raw = b"".join(_pack_row(r.reshape(-1), bits, order) for r in part)
                chunks.append(compress(raw))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra is not None:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    if tile:
        entries.update({322: (3, [cw]), 323: (3, [ch]), 324: (4, [0] * len(chunks)),
                        325: (4, [len(c) for c in chunks])})
    else:
        entries.update({278: (4, [ch]), 273: (4, [0] * len(chunks)),
                        279: (4, [len(c) for c in chunks])})
    entries.update(tags or {})
    head = 16 if big else 8
    data_at = head
    offsets = []
    for c in chunks:
        offsets.append(data_at)
        data_at += len(c) + (len(c) & 1)
    entries[324 if tile else 273] = (16 if big else 4, offsets)
    fmt = {1: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
    n_entry, field = (20, 8) if big else (12, 4)
    ifd_at = data_at
    blob_at = ifd_at + (8 if big else 2) + n_entry * len(entries) + (8 if big else 4)
    ifd, blobs = bytearray(), bytearray()
    ifd += struct.pack(order + ("Q" if big else "H"), len(entries))
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if typ == 16 and not big:
            typ = 4
        if typ == 5:
            raw = b"".join(struct.pack(order + "II", *v) for v in vals)
        else:
            raw = struct.pack(order + fmt[typ] * len(vals), *vals)
        count = struct.pack(order + ("Q" if big else "I"), len(vals))
        if len(raw) <= field:
            value = raw.ljust(field, b"\0")
        else:
            value = struct.pack(order + ("Q" if big else "I"), blob_at + len(blobs))
            blobs += raw + b"\0" * (len(raw) & 1)
        ifd += struct.pack(order + "HH", tag, typ) + count + value
    ifd += b"\0" * (8 if big else 4)
    magic = 43 if big else 42
    header = (order.replace("<", "II").replace(">", "MM").encode()
              + struct.pack(order + "H", magic)
              + (struct.pack(order + "HHQ", 8, 0, ifd_at) if big
                 else struct.pack(order + "I", ifd_at)))
    body = b"".join(c + b"\0" * (len(c) & 1) for c in chunks)
    return header + body + bytes(ifd) + bytes(blobs)


def ycbcr_chunks(ycc: np.ndarray, sub, rows=None, tile=None):
    """Y, Cb, Cr samples ``[H, W, 3]`` -> the raw strips (``rows`` rows each) or tiles
    (``tile`` = (height, width)) of a contiguous YCbCr TIFF at subsampling ``sub`` = (sh,
    sv): blocks of sh x sv luma samples, then the block's top-left Cb and Cr, the edges
    replicated out to whole blocks."""
    h, w, _ = ycc.shape
    sh, sv = sub
    ch, cw = tile if tile else ((rows or h), w)
    out = []
    for y0 in range(0, h, ch):
        for x0 in range(0, w, cw):
            part = ycc[y0:y0 + ch, x0:x0 + cw]
            ph, pw = (ch, cw) if tile else part.shape[:2]
            bh, bw = -(-ph // sv), -(-pw // sh)
            pad = np.pad(part, ((0, bh * sv - part.shape[0]), (0, bw * sh - part.shape[1]),
                                (0, 0)), mode="edge")
            blk = pad.reshape(bh, sv, bw, sh, 3).transpose(0, 2, 1, 3, 4)
            units = np.concatenate([blk[..., 0].reshape(bh, bw, sv * sh),
                                    blk[:, :, 0, 0, 1:]], -1)
            out.append(units.astype(np.uint8).tobytes())
    return out


def ycbcr_tiff(ycc, sub, compression=5, rows=None, tile=None, tags=None, subsampling_tag=True,
               **kw):
    t = dict(tags or {})
    if subsampling_tag:
        t[530] = (3, list(sub))
    return tiff_bytes(ycc, 6, 8, compression=compression, rows=rows, tile=tile, tags=t,
                      raw_chunks=ycbcr_chunks(ycc, sub, rows, tile), **kw)


def split_jpeg(data: bytes):
    """A whole JPEG -> (its tables as a tables-only stream, the stream without them)."""
    pos, tables, rest = 2, [], [b"\xff\xd8"]
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        (tables if data[pos + 1] in (0xDB, 0xC4) else rest).append(data[pos:pos + 2 + n])
        pos += 2 + n
    return b"\xff\xd8" + b"".join(tables) + b"\xff\xd9", b"".join(rest) + data[pos:]


def jpeg_tiff(rgb, photometric=6, subsampling=2, rows=None, tile=None, quality=80,
              shared_tables=True, subsampling_tag=True, tags=None, encode=None, **kw):
    """RGB ``[H, W, 3]`` -> a JPEG-in-TIFF whose strips or tiles are Pillow's JPEG streams
    (4:4:4, 4:2:2 or 4:2:0 by ``subsampling`` 0, 1, 2; photometric 2 at 4:4:4 in RGB
    components, Pillow's ``keep_rgb``), their tables in ``JPEGTables`` (``shared_tables``) or each
    stream's own. ``encode``, where given, writes each strip's or tile's JPEG in place of
    Pillow (then ``subsampling`` is the luma's (h, v), the ``YCbCrSubsampling`` tag)."""
    h, w, _ = rgb.shape
    ch, cw = tile if tile else ((rows or h), w)
    streams, tables = [], None
    for y0 in range(0, h, ch):
        for x0 in range(0, w, cw):
            part = rgb[y0:y0 + ch, x0:x0 + cw]
            if tile:
                part = np.pad(part, ((0, ch - part.shape[0]), (0, cw - part.shape[1]), (0, 0)),
                              mode="edge")
            if encode is None:
                buf = io.BytesIO()
                Image.fromarray(part.astype(np.uint8)).save(
                    buf, format="JPEG", quality=quality, subsampling=subsampling,
                    keep_rgb=photometric == 2 and subsampling == 0)
                whole = buf.getvalue()
            else:
                whole = encode(part.astype(np.uint8))
            tables, stream = split_jpeg(whole)
            streams.append(stream if shared_tables else whole)
    t = dict(tags or {})
    if shared_tables:
        t[347] = (7, list(tables))
    if photometric == 6 and subsampling_tag and 530 not in t:
        t[530] = (3, list(subsampling) if encode else
                  [{0: 1, 1: 2, 2: 2}[subsampling], {0: 1, 1: 1, 2: 2}[subsampling]])
    return tiff_bytes(rgb, photometric, 8, compression=7, rows=rows, tile=tile, tags=t,
                      raw_chunks=streams, **kw)
