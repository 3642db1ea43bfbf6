"""JPEG kinds Pillow's ``save`` does not write, for the tests of ``foley_tpu_torch/io/jpeg.py``:
any per-component sampling factors (4:1:1, 4:1:0, luma below its chroma, ...), custom scan
scripts (progressive files cut short, DC-only files, multi-scan sequential files),
arithmetic coding (SOF9, SOF10) with chosen DAC conditioning, and restart intervals. A
small C shim (``tests/torch_jpeg_writer.c``) is built at first use with ``cc`` against the
system's ``jpeglib.h`` and linked to the libjpeg-turbo Pillow 12.1 bundles, into a temporary
directory. Only the tests load it; the port never does.
"""

import ctypes
import glob
import os
import subprocess
import tempfile

import numpy as np
import PIL

_LIBS = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg_writer.c")
_LIB = None

# J_COLOR_SPACE
GREY, RGB, YCC, CMYK, YCCK = 1, 2, 3, 4, 5
SPACES = {"grey": GREY, "rgb": RGB, "ycc": YCC, "cmyk": CMYK, "ycck": YCCK}


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        jpeg = glob.glob(os.path.join(_LIBS, "libjpeg-*.so*"))[0]
        out = os.path.join(tempfile.mkdtemp(prefix="torch_jpeg_writer_"), "libfjw.so")
        subprocess.run(["cc", "-O1", "-shared", "-fPIC", _SRC, jpeg, "-o", out,
                        f"-Wl,-rpath,{os.path.dirname(jpeg)}"], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(out)
        p, i, ul = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulong
        lib.fjw_compress.argtypes = [p, i, i, i, i, i, p, p, i, p, i, i, i, i, i, i, p, p, p,
                                     p, i]
        lib.fjw_transcode.argtypes = [p, ul, p, i, i, i, i, i, i, p, p, p, p, p, p, i]
        lib.fjw_free.argtypes = [p]
        _LIB = lib
    return _LIB


def _arr(values) -> np.ndarray:
    return np.ascontiguousarray(values, np.int32)


def _scan_rows(scans):
    """[(components, ss, se, ah, al), ...] -> the shim's rows of nine ints."""
    rows = [[len(c), *(list(c) + [0] * 4)[:4], ss, se, ah, al] for c, ss, se, ah, al in scans]
    return _arr(rows if rows else np.zeros((0, 9)))


def _dac(dac):
    """{("dc", t): (L, U), ("ac", t): K} -> L[16], U[16], K[16] (the defaults elsewhere)."""
    if dac is None:
        return None
    out = np.array([0] * 16 + [1] * 16 + [5] * 16, np.int32)
    for (kind, t), value in dac.items():
        if kind == "dc":
            out[t], out[16 + t] = value
        else:
            out[32 + t] = value
    return out


def _call(fn, *args) -> bytes:
    out, size = ctypes.c_void_p(), ctypes.c_ulong()
    err = ctypes.create_string_buffer(200)
    rc = fn(*args, ctypes.byref(out), ctypes.byref(size), err, len(err))
    if rc:
        raise ValueError(f"libjpeg refused: {err.value.decode()}")
    data = ctypes.string_at(out, size.value)
    library().fjw_free(out)
    return data


def _options(scans, progressive, arith, restart, restart_rows, optimize, dac):
    rows, d = _scan_rows(scans or []), _dac(dac)
    keep = [rows, d]
    return keep, (rows.ctypes.data, len(rows), int(progressive), int(arith), restart,
                  restart_rows, int(optimize), None if d is None else d.ctypes.data)


def compress(pixels: np.ndarray, sampling, space: str = "ycc", quality: int = 85,
             scans=None, progressive=False, arith=False, restart=0, restart_rows=0,
             optimize=False, dac=None) -> bytes:
    """``pixels`` [H, W] (grey) or [H, W, 3 | 4] uint8 (RGB, or CMYK for ``cmyk`` / ``ycck``)
    -> a JPEG in colour space ``space`` whose component i is sampled ``sampling[i]`` = (h,
    v); ``scans`` a script of (component indices, Ss, Se, Ah, Al), else one interleaved
    scan (or ``jpeg_simple_progression`` when ``progressive``)."""
    px = np.ascontiguousarray(pixels, np.uint8)
    h, w = px.shape[:2]
    comps = 1 if px.ndim == 2 else px.shape[2]
    in_space = {1: GREY, 3: RGB, 4: CMYK}[comps]
    hs, vs = _arr([s[0] for s in sampling]), _arr([s[1] for s in sampling])
    keep, opts = _options(scans, progressive, arith, restart, restart_rows, optimize, dac)
    return _call(library().fjw_compress, px.ctypes.data, w, h, comps, in_space, SPACES[space],
                 hs.ctypes.data, vs.ctypes.data, quality, *opts)


def transcode(data: bytes, scans=None, progressive=False, arith=False, restart=0,
              restart_rows=0, optimize=False, dac=None, coefs=None, quant=None) -> bytes:
    """A JPEG's coefficients rewritten with these settings; ``coefs`` (each component's
    int16 blocks ``[rows, cols, 64]`` on the MCU grid, natural order, or None) and ``quant``
    (``{table: 64 values}``, natural order) replace the file's."""
    keep, opts = _options(scans, progressive, arith, restart, restart_rows, optimize, dac)
    ptrs = None
    if coefs is not None:
        blocks = [None if c is None else np.ascontiguousarray(c, np.int16) for c in coefs]
        keep.append(blocks)
        ptrs = (ctypes.c_void_p * len(blocks))(*[None if b is None else b.ctypes.data
                                                 for b in blocks])
    q = None
    if quant is not None:
        q = np.zeros((4, 64), np.int32)
        for t, table in quant.items():
            q[t] = table
        keep.append(q)
    return _call(library().fjw_transcode, data, len(data), *opts, ptrs,
                 None if q is None else q.ctypes.data)


def cut_after(data: bytes, n: int) -> bytes:
    """The file cut before its (n + 1)-th scan (and the tables or DAC segments that lead up
    to it), closed with EOI."""
    pos, scans, last_end = 2, 0, 2
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return data
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            if scans == n:
                return data[:last_end] + b"\xff\xd9"
            scans += 1
            pos += 2 + length
            while not (data[pos] == 0xFF and data[pos + 1] not in (0x00, 0xFF)
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            last_end = pos
            continue
        pos += 2 + length
        if marker not in (0xC4, 0xCC):  # tables for the next scan stay with it
            last_end = pos


def n_scans(data: bytes) -> int:
    return data.count(b"\xff\xda")
