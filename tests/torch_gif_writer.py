"""A GIF writer for the port's tests (numpy and the standard library): LSB-first LZW at any
minimum code size, with or without clear codes when the table fills, and files assembled
block by block, for the layouts Pillow's writer does not make."""

import struct

import numpy as np


def lzw_encode(indices, bits: int, clear_when_full: bool = True, clear_every: int = 0,
               extra_clears: int = 0) -> bytes:
    """Indices (each below ``2 ** bits``; only 0 at ``bits`` 0) -> GIF LZW data without its
    sub-blocks: a clear code first, codes a bit wider once the table passes the width's
    mask, at 4096 codes a clear (``clear_when_full``) or the table kept full (a deferred
    clear); ``clear_every`` > 0 adds a clear after that many codes."""
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc = bytearray(), 0, 0

    def put(code, n):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += n
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def grow(entry):
        # the decoder adds each entry one code later, and widens once it adds 2**size - 1
        return 1 if entry >= (1 << size) and size < 12 else 0

    table, nxt, size, since = {(i,): i for i in range(clear)}, clear + 2, bits + 1, 0
    for _ in range(1 + extra_clears):
        put(clear, size)
    w, codes = (), 0
    for c in (int(v) for v in indices):
        wc = w + (c,)
        if wc in table:
            w = wc
            continue
        put(table[w], size)
        codes, since = codes + 1, since + 1
        if nxt < 4096:
            table[wc] = nxt
            size += grow(nxt)
            nxt += 1
        if (nxt >= 4096 and clear_when_full) or (clear_every and codes % clear_every == 0):
            put(clear, size)
            table, nxt, size, since = {(i,): i for i in range(clear)}, clear + 2, bits + 1, 0
        w = (c,)
    if w:
        put(table[w], size)
        if since and nxt < 4096:  # the decoder adds an entry for this code too
            size += grow(nxt)
    put(end, size)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    out = bytearray()
    for i in range(0, len(data), size):
        part = data[i:i + size]
        out += bytes([len(part)]) + part
    return bytes(out + b"\0")


def interlace_order(height: int) -> np.ndarray:
    rows = np.arange(height)
    return np.concatenate([rows[0::8], rows[4::8], rows[2::4], rows[1::2]])


def gif_bytes(indices: np.ndarray, screen=None, at=(0, 0), global_table=None, local_table=None,
              transparency=None, interlace=False, bits=None, background=0, before=b"",
              lzw=None, **lzw_kw) -> bytes:
    """A GIF of one frame: ``indices`` ``[h, w]`` at ``at`` (left, top) on a ``screen``
    (width, height; the frame's own size by default), with a global and / or a local colour
    table (``[n, 3]``, n a power of two from 2 to 256), a Graphic Control Extension with
    ``transparency`` where given, ``before`` (blocks) ahead of the image descriptor, rows
    interlaced where ``interlace``, LZW at minimum code size ``bits`` (from the tables'
    size, at least 2, by default), or ``lzw`` as the data."""
    h, w = indices.shape
    sw, sh = screen or (w + at[0], h + at[1])
    flags = 0
    body = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if global_table is not None:
        flags |= 0x80 | (int(np.log2(len(global_table))) - 1)
    body += bytes([flags, background, 0])
    if global_table is not None:
        body += np.asarray(global_table, np.uint8).tobytes()
    if transparency is not None:
        body += b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\0"
    body += before
    lflags = 0x40 if interlace else 0
    if local_table is not None:
        lflags |= 0x80 | (int(np.log2(len(local_table))) - 1)
    body += b"," + struct.pack("<HHHH", at[0], at[1], w, h) + bytes([lflags])
    if local_table is not None:
        body += np.asarray(local_table, np.uint8).tobytes()
    table = local_table if local_table is not None else global_table
    if bits is None:
        bits = max(2, int(np.log2(len(table)))) if table is not None else 8
    rows = indices[interlace_order(h)] if interlace else indices
    data = lzw if lzw is not None else lzw_encode(rows.reshape(-1), bits, **lzw_kw)
    body += bytes([bits]) + sub_blocks(data) + b";"
    return bytes(body)
