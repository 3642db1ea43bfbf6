"""JPEG without PIL: decode as Pillow's ``Image.open(f).convert("RGB")`` and encode as
``Image.fromarray(rgb).save(f, format="JPEG", quality=q)``, byte for byte, over
libjpeg-turbo (what the JAX package's ``pipeline/video.py::read_frames_dir`` and
``io/avi.py`` call).

Decoding: the markers are parsed on the host (SOI, APPn, COM, DQT in 8 or 16 bits, SOF0,
SOF1, SOF2, SOF9 and SOF10 at 8 bits, DHT, DAC, DRI, SOS, RSTn, EOI), and the entropy-coded
data is decoded into coefficient blocks by ``csrc/jpeg_entropy.cpp`` (host C++, built at
first use by ``ops/kernels/build.py::host_library``): Huffman (``jdhuff.c``, ``jdphuff.c``)
or arithmetic (``jdarith.c``: T.81's Qe state machine, the DAC conditioning), sequential
scans and the four progressive scan kinds (DC first and refinement, AC first, AC
refinement), the coefficients kept across scans shifted by their Al, restart markers
resetting the predictors (and an arithmetic scan's statistics), an AC scan covering its
component's own block grid. The rest runs in integer torch ops on the device the caller
names (the card, unless the caller asks for the CPU), over every frame of one geometry at
once, ``CHUNK_BLOCKS`` blocks at a time: libjpeg-turbo's block smoothing of a progressive
file whose scans leave a first coefficient unfinished (``jdcoefct.c``:
``smooth_blocks``), dequantisation, libjpeg's islow inverse DCT (``jidctint.c``: 13-bit
constants, 2 bits kept between the passes, 64-bit products, the range limit a clamp as in
its SIMD build), the upsampling ``jdsample.c`` picks per component from the ratio of the
largest sampling factors to its own (fancy 2 x 1 and 2 x 2 while the component is wider
than 2 samples, else a box; fancy 1 x 2; any other whole ratio replicated; edges
replicated) and the colour conversion. Every sampling factor 1-4 is taken whose ratios are
whole and whose interleaved MCUs hold at most 10 blocks; libjpeg refuses the others, and so
does the port (``ValueError``). The markers decide the colour space as ``jdapimin.c`` does:
one component is grey, replicated to RGB as PIL's ``L -> RGB``; three are YCbCr
(``jdcolor.c``'s fixed-point tables) unless an Adobe marker's transform 0, or the ids R, G,
B without a JFIF marker, make them RGB (no transform); four are CMYK, or YCCK under an Adobe
transform other than 0 (``ycck_cmyk_convert``: the YCbCr tables, C, M, Y the complements, K
kept), then inverted as Pillow's ``CMYK;I`` raw mode reads every CMYK JPEG and converted as
its ``convert("RGB")`` (``cmyk_to_rgb``). Pillow hands libjpeg a file 64 KiB at a time and
its arithmetic decoder cannot wait for more inside a scan, so an arithmetic-coded scan that
needs bytes past the block it began in raises, as Pillow does (``PIL_READ_BLOCK``).

Encoding (RGB, 4:2:0, the standard tables scaled by ``jpeg_quality_scaling`` and clamped to
1-255, standard Huffman tables, no restart markers: Pillow's defaults) runs the other way on
the device: ``jccolor.c``'s RGB -> YCbCr, edge replication to the MCU grid, ``jcsample.c``'s
2 x 2 average with its alternating 1, 2 bias, the islow forward DCT (``jfdctint.c``),
``jcdctmgr.c``'s reciprocal quantiser, and ``jccoefct.c``'s dummy blocks at the right and
bottom MCU edges (AC zero, DC that of the block before); the Huffman pass runs on the host.

Refused, each with ``JPEGUnsupported`` naming what it is: lossless and hierarchical files
(their arithmetic-coded kinds, SOF11 and SOF13-15, too), 12-bit samples, two components,
and a height given in a DNL marker. Corrupt or truncated data raises ``ValueError``, also
where libjpeg warns and reads on (a bad Huffman code, an arithmetic coefficient overflow).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.png import check_image_size, file_bytes

# coefficient blocks reconstructed in one pass: the inverse DCT's int64 temporaries take
# about 0.5 KiB a block each, so 2**18 blocks (12 frames of 1280x720 in 4:2:0) hold a few GiB
CHUNK_BLOCKS = 1 << 18

# natural (row-major) index of each zig-zag position (jpeg_natural_order)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# the JPEG standard's quantisation tables, natural order (jcparam.c)
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)


# the JPEG standard's Huffman tables (jstdhuff.c): 16 counts of codes by length, then values
STD_DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
STD_DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
STD_AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
STD_AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

# islow DCT constants (jidctint.c, jfdctint.c): FIX(x) at CONST_BITS 13
CONST_BITS, PASS1_BITS = 13, 2
F0_298, F0_390, F0_541, F0_765 = 2446, 3196, 4433, 6270
F0_899, F1_175, F1_501, F1_847 = 7373, 9633, 12299, 15137
F1_961, F2_053, F2_562, F3_072 = 16069, 16819, 20995, 25172

_SOF_REFUSED = {
    0xC3: "a lossless JPEG",
    0xC5: "a hierarchical (differential) JPEG", 0xC6: "a hierarchical (differential) JPEG",
    0xC7: "a hierarchical (differential) JPEG", 0xCB: "a lossless arithmetic-coded JPEG",
    0xCD: "a hierarchical arithmetic-coded JPEG", 0xCE: "a hierarchical arithmetic-coded JPEG",
    0xCF: "a hierarchical arithmetic-coded JPEG", 0xDE: "a hierarchical JPEG (DHP)",
    0xDC: "a JPEG with a DNL marker"}
# the frames decoded: SOF0-2 (Huffman), SOF9 and SOF10 (arithmetic), as (progressive, arithmetic)
_SOF_DECODED = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
                0xC9: (False, True), 0xCA: (True, True)}
# the zig-zag positions libjpeg-turbo's block smoothing reads (jdcoefct.c, SAVED_COEFS)
SMOOTHING_COEFS = 10
# libjpeg's limits (jpeglib.h, jdinput.c): sampling factors 1-4, 10 blocks an interleaved MCU
MAX_SAMP_FACTOR, MAX_BLOCKS_IN_MCU = 4, 10
# Pillow's ``ImageFile.load`` feeds its JPEG decoder the file 64 KiB at a time (``MAXBLOCK``),
# and libjpeg's arithmetic decoder cannot wait for more inside a scan
PIL_READ_BLOCK = 1 << 16


class JPEGUnsupported(ValueError):
    """A JPEG this codec does not take."""


# ---------------------------------------------------------------------------------
# the host entropy coder
# ---------------------------------------------------------------------------------

_LIB = None


def entropy_library() -> ctypes.CDLL:
    """``csrc/jpeg_entropy.cpp``, built at first use (a missing compiler or a failed build
    raises)."""
    global _LIB
    if _LIB is None:
        from foley_tpu_torch.ops.kernels.build import host_library

        lib = host_library("jpeg_entropy")
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        lib.fj_decode_scan.argtypes = [p, i64, i32, p, p, p, p, p, p, i32, i32, p, p, i32, i32,
                                       i32, i32, i32, i32, p, p, i32]
        lib.fj_decode_scan.restype = ctypes.c_int
        lib.fj_decode_scan_arith.argtypes = [p, i64, i32, p, p, p, p, p, p, p, i32, i32, p, p,
                                             i32, i32, i32, i32, i32, i32, p, p, p, i32]
        lib.fj_decode_scan_arith.restype = ctypes.c_int
        lib.fj_arith_qe_table.argtypes = [p]
        lib.fj_encode_scan.argtypes = [p, i64, i32, p, p, p, p, p, p, i64]
        lib.fj_encode_scan.restype = i64
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _table_arrays(tables: Dict[Tuple[int, int], Tuple[bytes, bytes]]):
    """DHT tables keyed (class, id) -> the C layout: bits [8, 17], vals [8, 256]."""
    bits = np.zeros((8, 17), np.uint8)
    vals = np.zeros((8, 256), np.uint8)
    for (tc, th), (b, v) in tables.items():
        t = 4 * tc + th
        bits[t, 1:] = np.frombuffer(b, np.uint8)
        vals[t, :len(v)] = np.frombuffer(v, np.uint8)
    return bits, vals


# ---------------------------------------------------------------------------------
# decoding: the marker parse and the entropy decode (host)
# ---------------------------------------------------------------------------------

def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def parse_jpeg(data: bytes, name: str = "JPEG", tables: bytes = b"",
               color: Optional[str] = None, read_block: Optional[int] = PIL_READ_BLOCK) -> Dict:
    """One JPEG's bytes -> its geometry (``width``, ``height``, ``sampling``: the (h, v) of
    each component), its colour space (``color``: ``grey``, ``ycc``, ``rgb``, ``cmyk`` or
    ``ycck``), ``quant`` (int32 ``[C, 64]``, natural order, each component's table as its
    first scan latched it), ``coefs`` (each component's int16 blocks ``[rows, cols, 64]``,
    natural order, on the MCU grid) and ``smooth`` (int32 ``[C, SMOOTHING_COEFS]``: the
    ``coef_bits`` libjpeg's block smoothing reads, zeros where it does not smooth),
    Huffman- or arithmetic-coded, sequential or progressive. ``tables``, where given, is a
    tables-only stream (SOI, DQT and DHT segments, EOI: a JPEG-in-TIFF's ``JPEGTables``)
    read before ``data``, an abbreviated stream that may lack them; ``color``, where given,
    is the colour space the caller sets, as libtiff sets libjpeg's, whatever the markers say
    (``rgb``: each component as it is, no transform). ``read_block``: the bytes Pillow's
    reader hands libjpeg at a time (None: the whole stream at once, as libtiff does); an
    arithmetic-coded scan that needs bytes past the block it starts in raises, as Pillow
    does."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    if tables:
        if tables[:2] != b"\xff\xd8":
            raise ValueError(f"{name}: JPEG tables without an SOI marker")
        head = tables[:-2] if tables.endswith(b"\xff\xd9") else tables
        data = head + data[2:]  # the tables' segments, then the stream's
    buf = np.frombuffer(data, np.uint8)
    qt: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    # DAC conditioning per table (jdmarker.c::get_dac), the defaults libjpeg sets at SOI
    dac = np.array([[0] * 16, [1] * 16, [5] * 16], np.int32)  # DC L, DC U, AC Kx
    frame: Optional[Dict] = None
    restart = 0
    jfif, adobe = False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes before a marker
        if pos + 1 >= len(data):
            raise ValueError(f"{name}: truncated JPEG (the data ends before its EOI marker)")
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        if pos + 4 > len(data):
            raise ValueError(f"{name}: truncated JPEG (a marker without its length)")
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + length]
        if len(seg) != length - 2:
            raise ValueError(f"{name}: truncated JPEG (marker 0x{marker:02X})")
        if marker in _SOF_REFUSED:
            raise JPEGUnsupported(f"{name}: {_SOF_REFUSED[marker]} is not decoded (baseline, "
                                  "extended sequential and progressive JPEG, Huffman- or "
                                  "arithmetic-coded, are)")
        if marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(seg[p + 1:p + 1 + n], ">u2" if pq else np.uint8)
                if raw.size != 64 or tq > 3:
                    raise ValueError(f"{name}: corrupt DQT segment")
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = raw
                qt[tq] = table
                p += 1 + n
        elif marker in _SOF_DECODED:
            if frame is not None:
                raise ValueError(f"{name}: corrupt JPEG (a second frame header)")
            precision, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise JPEGUnsupported(f"{name}: {precision}-bit samples are not decoded "
                                      "(8-bit are)")
            if h == 0 or w == 0:
                raise JPEGUnsupported(f"{name}: a JPEG whose height comes in a DNL marker")
            check_image_size(w, h, name)
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            progressive, arith = _SOF_DECODED[marker]
            frame = {"width": w, "height": h, "comps": comps, "progressive": progressive,
                     "arith": arith, "quant": [None] * nc,
                     # per component and zig-zag position, the Al of the last scan that
                     # reached it (-1: none yet), as libjpeg's coef_bits
                     "coef_bits": np.full((nc, 64), -1, np.int32)}
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = seg[p + 1:p + 17]
                n = sum(bits)
                if tc > 1 or th > 3 or len(bits) != 16 or n > 256:
                    raise ValueError(f"{name}: corrupt DHT segment")
                huff[(tc, th)] = (bits, seg[p + 17:p + 17 + n])
                p += 17 + n
        elif marker == 0xCC:
            _read_dac(seg, dac, name)
        elif marker == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: a scan before the frame header")
            if not frame.get("checked"):
                _check_frame(frame, jfif, adobe, name)
                frame["color"] = color or frame["color"]
            start = pos + 2 + length
            pos = _decode_scan(buf, start, seg, frame, huff, dac, qt, restart, name)
            if frame["arith"] and read_block:
                _check_read_block(start, frame.pop("reach"), read_block, name)
            continue
        pos += 2 + length
    if frame is None or not frame.get("checked") or (frame["coef_bits"][:, 0] < 0).any():
        raise ValueError(f"{name}: truncated JPEG (a component without image data)")
    quant = np.stack(frame["quant"])
    return {"width": frame["width"], "height": frame["height"], "color": frame["color"],
            "sampling": tuple((c["h"], c["v"]) for c in frame["comps"]), "quant": quant,
            "coefs": frame["coefs"], "smooth": _smoothing_latch(frame, quant)}


def _read_dac(seg: bytes, dac: np.ndarray, name: str) -> None:
    """A DAC segment (``jdmarker.c::get_dac``): per table class and id, the DC conditioning
    bounds L and U (L <= U) or the AC Kx."""
    if len(seg) % 2:
        raise ValueError(f"{name}: corrupt DAC segment (odd length)")
    for index, value in zip(seg[0::2], seg[1::2]):
        if index >= 32:
            raise ValueError(f"{name}: corrupt DAC segment (table index {index})")
        if index >= 16:
            dac[2, index - 16] = value
        elif value & 15 > value >> 4:
            raise ValueError(f"{name}: corrupt DAC segment (L {value & 15} above U "
                             f"{value >> 4})")
        else:
            dac[0, index], dac[1, index] = value & 15, value >> 4


def _check_read_block(start: int, reach: int, block: int, name: str) -> None:
    """Pillow hands libjpeg the file ``block`` bytes at a time, and reads more only when the
    decoder suspends, which the arithmetic decoder cannot do inside a scan: a scan starting
    at byte ``start`` whose decode reads ``reach`` bytes fails unless they all lie in the
    blocks read when it started (``jdarith.c::get_byte``, JERR_CANT_SUSPEND)."""
    have = block * max(1, _ceil(start, block))
    if start + reach > have:
        raise ValueError(f"{name}: an arithmetic-coded scan at byte {start} reads past byte "
                         f"{have}, where Pillow's reader hands libjpeg the file {block} bytes "
                         "at a time and the arithmetic decoder cannot wait for more "
                         "(Pillow raises: broken data stream)")


def _smoothing_latch(frame: Dict, quant: np.ndarray) -> np.ndarray:
    """``jdcoefct.c::smoothing_ok`` after the last scan: a progressive file is smoothed when
    every component's table is nonzero at the DC and the first nine AC positions and one of
    those AC coefficients is still incomplete (never sent, or not refined to Al 0) in some
    component; then each component's ``coef_bits`` at zig-zag 0-9 is latched. Zeros (no
    smoothing) otherwise. libjpeg keeps the latch of the scan before too, and reads it only
    while its output runs ahead of its input (buffered-image mode); Pillow reads the whole
    file before its output pass, so the last latch is the one it smooths with (held against
    Pillow over every cut of every script in the tests)."""
    latch = frame["coef_bits"][:, :SMOOTHING_COEFS].astype(np.int32)
    if not frame["progressive"] or (quant[:, ZIGZAG[:SMOOTHING_COEFS]] == 0).any() \
            or not (latch[:, 1:] != 0).any():
        return np.zeros_like(latch)
    return latch


# libjpeg's colour spaces (jdapimin.c::default_decompress_parms) and Pillow's raw modes
_COLORS = {1: "grey", 3: "ycc", 4: "cmyk"}


def _check_frame(frame: Dict, jfif: bool, adobe: Optional[int], name: str) -> None:
    """The frame's colour space and sampling, as libjpeg reads its markers; allocates its
    blocks. Any sampling factors 1-4 whose maximum each way is a whole multiple of every
    component's (``jdsample.c::jinit_upsampler``) are decoded; libjpeg refuses the others,
    and so does the port (``ValueError``)."""
    comps = frame["comps"]
    if len(comps) not in _COLORS:
        raise JPEGUnsupported(f"{name}: a {len(comps)}-component JPEG is not decoded (grey, "
                              "YCbCr, RGB, CMYK and YCCK are)")
    color = _COLORS[len(comps)]
    if len(comps) == 3 and not jfif:
        ids = tuple(c["id"] for c in comps)
        if adobe == 0 or (adobe is None and ids == (82, 71, 66)):
            color = "rgb"  # an Adobe marker's transform 0, or the ids R, G, B
    elif len(comps) == 4 and adobe is not None and adobe != 0:
        color = "ycck"  # Adobe transform 2; libjpeg takes any other but 0 as YCCK too
    frame["color"] = color
    factors = [(c["h"], c["v"]) for c in comps]
    if any(not 1 <= f <= MAX_SAMP_FACTOR for hv in factors for f in hv):
        raise ValueError(f"{name}: bogus sampling factors {factors} (libjpeg takes 1-4: "
                         "JERR_BAD_SAMPLING)")
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if any(hmax % h or vmax % v for h, v in factors):
        raise ValueError(f"{name}: sampling factors {factors} need fractional upsampling, "
                         "which libjpeg does not implement (JERR_FRACT_SAMPLE_NOT_IMPL)")
    mx, my = _ceil(frame["width"], 8 * hmax), _ceil(frame["height"], 8 * vmax)
    frame.update(hmax=hmax, vmax=vmax, mcus_x=mx, mcus_y=my, checked=True,
                 coefs=[np.zeros((my * c["v"], mx * c["h"], 64), np.int16) for c in comps])


def _decode_scan(buf: np.ndarray, start: int, seg: bytes, frame: Dict, huff, dac: np.ndarray,
                 qt: Dict[int, np.ndarray], restart: int, name: str) -> int:
    """Entropy-decode one scan starting at ``start`` into ``frame["coefs"]`` (a progressive
    scan adds to what the earlier ones left), Huffman- or arithmetic-coded as the frame is;
    returns the position of the marker after it (an arithmetic scan leaves the bytes it read
    in ``frame["reach"]``)."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise ValueError(f"{name}: corrupt JPEG (an SOS segment of {len(seg)} bytes for "
                         f"{ns} components)")
    comps = frame["comps"]
    index = {c["id"]: i for i, c in enumerate(comps)}
    arith = frame["arith"]
    members, dc, ac = [], [], []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in index:
            raise ValueError(f"{name}: a scan names component {cid}, not in the frame")
        if not arith and (tables >> 4 > 3 or tables & 15 > 3):
            raise ValueError(f"{name}: corrupt JPEG (a scan names Huffman tables "
                             f"{tables >> 4} and {tables & 15}; baseline has 0-3)")
        members.append(index[cid])
        dc.append(tables >> 4)
        ac.append(tables & 15)
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    progressive = frame["progressive"]
    if not progressive:  # libjpeg warns (JWRN_NOT_SEQUENTIAL) and decodes whole blocks
        ss, se, ah, al = 0, 63, 0, 0
    # jdphuff.c / jdarith.c start_pass: the progression's checks (JERR_BAD_PROGRESSION)
    if progressive and ((ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1))
                        or (ah != 0 and al != ah - 1) or al > 13):
        raise ValueError(f"{name}: corrupt progressive JPEG (a scan of spectral selection "
                         f"{ss}-{se}, approximation {ah}/{al}, {ns} components)")
    if ns == 1:
        c = comps[members[0]]
        # a non-interleaved scan covers the component's own blocks, one an MCU
        mx = _ceil(_ceil(frame["width"] * c["h"], frame["hmax"]), 8)
        my = _ceil(_ceil(frame["height"] * c["v"], frame["vmax"]), 8)
        hs, vs = [1], [1]
    else:
        mx, my = frame["mcus_x"], frame["mcus_y"]
        hs, vs = [comps[m]["h"] for m in members], [comps[m]["v"] for m in members]
        if sum(h * v for h, v in zip(hs, vs)) > MAX_BLOCKS_IN_MCU:
            raise ValueError(f"{name}: sampling factors too large for an interleaved scan "
                             f"({sum(h * v for h, v in zip(hs, vs))} blocks an MCU, libjpeg "
                             f"takes {MAX_BLOCKS_IN_MCU}: JERR_BAD_MCU_SIZE)")
    for m in members:  # jdinput.c::latch_quant_tables, at a component's first scan
        if frame["quant"][m] is None:
            tq = comps[m]["tq"]
            if tq not in qt:
                raise ValueError(f"{name}: quantisation table {tq} is not defined")
            frame["quant"][m] = qt[tq].copy()
    outs = [frame["coefs"][m] for m in members]
    arr = lambda xs: np.asarray(xs, np.int32)  # noqa: E731
    hs, vs, dc, ac = arr(hs), arr(vs), arr(dc), arr(ac)
    bw = arr([o.shape[1] for o in outs])
    ptrs = (ctypes.c_void_p * len(outs))(*[o.ctypes.data for o in outs])
    consumed, reach = ctypes.c_int64(0), ctypes.c_int64(0)
    err = ctypes.create_string_buffer(256)
    rest = buf[start:]
    lib = entropy_library()
    if arith:
        rc = lib.fj_decode_scan_arith(
            _ptr(rest), rest.size, ns, _ptr(hs), _ptr(vs), _ptr(dc), _ptr(ac), _ptr(dac[0]),
            _ptr(dac[1]), _ptr(dac[2]), mx, my, _ptr(bw), ptrs, restart, int(progressive), ss,
            se, ah, al, ctypes.byref(consumed), ctypes.byref(reach), err, len(err))
    else:
        bits, vals = _table_arrays(huff)
        rc = lib.fj_decode_scan(
            _ptr(rest), rest.size, ns, _ptr(hs), _ptr(vs), _ptr(dc), _ptr(ac), _ptr(bits),
            _ptr(vals), mx, my, _ptr(bw), ptrs, restart, int(progressive), ss, se, ah, al,
            ctypes.byref(consumed), err, len(err))
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    for m in members:
        frame["coef_bits"][m, ss:se + 1] = al
    frame["reach"] = reach.value
    return start + consumed.value


# ---------------------------------------------------------------------------------
# decoding: reconstruction (device)
# ---------------------------------------------------------------------------------

def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x: List[torch.Tensor]) -> List[torch.Tensor]:
    """One pass of ``jpeg_idct_islow`` on eight int64 vectors, before its descale."""
    z1 = (x[2] + x[6]) * F0_541
    tmp2 = z1 - x[6] * F1_847
    tmp3 = z1 + x[2] * F0_765
    tmp0 = (x[0] + x[4]) * (1 << CONST_BITS)
    tmp1 = (x[0] - x[4]) * (1 << CONST_BITS)
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F1_175
    t0, t1, t2, t3 = t0 * F0_298, t1 * F2_053, t2 * F3_072, t3 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def idct_islow(coefs: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """Quantised blocks ``[..., 64]`` (natural order) and their tables (broadcast) -> the
    samples ``[..., 8, 8]`` (uint8) of ``jpeg_idct_islow``, range limit included."""
    x = (coefs.long() * quant.long()).unflatten(-1, (8, 8))  # [..., v, u]
    cols = _idct_1d([x[..., k, :] for k in range(8)])       # down the columns
    w = torch.stack([_descale(c, CONST_BITS - PASS1_BITS) for c in cols], dim=-2)
    rows = _idct_1d([w[..., k] for k in range(8)])          # along the rows
    out = torch.stack([_descale(r, CONST_BITS + PASS1_BITS + 3) for r in rows], dim=-1)
    # the range limit as libjpeg-turbo's SIMD IDCT (which Pillow runs) applies it, a clamp
    # around 128; the C table wraps past +-512 instead, which no encoder of 8-bit samples
    # reaches
    return (out + 128).clamp_(0, 255).to(torch.uint8)


def _blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """``[F, rows, cols, 8, 8]`` -> ``[F, rows * 8, cols * 8]``."""
    f, r, c = blocks.shape[:3]
    return blocks.permute(0, 1, 3, 2, 4).reshape(f, r * 8, c * 8)


def _edge(x: torch.Tensor, dim: int, step: int) -> torch.Tensor:
    """``x`` shifted one sample along ``dim`` (``step`` -1: each sample's predecessor, +1:
    its successor), the edge sample replicated."""
    n = x.shape[dim]
    if step < 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``a[0], b[0], a[1], b[1], ...`` along ``dim``."""
    dim %= a.ndim
    return torch.stack([a, b], dim=dim + 1).flatten(dim, dim + 1)


def upsample(x: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """A component's plane ``[F, h, w]`` (int32, its real size) upsampled by ``fh`` x ``fv``
    (whole ratios of the largest sampling factors to its own) as libjpeg-turbo's
    ``jdsample.c::jinit_upsampler`` chooses: 2 x 1 and 2 x 2 fancy while ``w > 2``, else a
    box; 1 x 2 fancy; any other ratio ``int_upsample``, each sample replicated."""
    if fh == 1 and fv == 1:
        return x
    w = x.shape[-1]
    if (fh, fv) not in ((2, 1), (1, 2), (2, 2)) or (fh == 2 and w <= 2):
        # int_upsample, and h2v1_upsample / h2v2_upsample: replication
        return x.repeat_interleave(fh, dim=-1).repeat_interleave(fv, dim=-2)
    if fv == 1:  # h2v1_fancy_upsample
        return _interleave((3 * x + _edge(x, -1, -1) + 1) >> 2,
                           (3 * x + _edge(x, -1, 1) + 2) >> 2, -1)
    up, down = _edge(x, -2, -1), _edge(x, -2, 1)
    if fh == 1:  # h1v2_fancy_upsample
        return _interleave((3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2, -2)
    rows = []
    for near in (up, down):  # h2v2_fancy_upsample: the row above, then the row below
        cs = 3 * x + near
        rows.append(_interleave((3 * cs + _edge(cs, -1, -1) + 8) >> 4,
                                (3 * cs + _edge(cs, -1, 1) + 7) >> 4, -1))
    return _interleave(rows[0], rows[1], -2)


# jdcoefct.c::decompress_smooth_data (libjpeg-turbo 2.1 and later): for each zig-zag
# position 0-9 it may estimate, the weights of the 5 x 5 DC values around a block (rows and
# columns -2..2). "ac": a component that has AC data, the K.8 rule of ITU T.81 widened to
# 5 x 5, zig-zag 1-5 only; "dc": no AC data yet (every one of zig-zag 1-9 never sent), a
# Gaussian-like kernel that also replaces the DC, keeping the DC values' average.
_SMOOTHING_WEIGHTS = {
    "ac": {
        1: [[0] * 5, [0] * 5, [-7, 50, 0, -50, 7], [0] * 5, [0] * 5],
        2: [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0] * 5, [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
        3: [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0],
            [0, 0, -1, 0, 0]],
        4: [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0] * 5, [1, -10, 0, 10, -1],
            [0, 1, 0, -1, 0]],
        5: [[0] * 5, [0] * 5, [-1, 13, -24, 13, -1], [0] * 5, [0] * 5]},
    "dc": {
        0: [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8],
            [-6, 6, 42, 6, -6], [-2, -6, -8, -6, -2]],
        1: [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
            [-1, -1, 0, 1, 1]],
        2: [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0] * 5, [1, -13, -38, -13, 1],
            [1, 3, 3, 3, 1]],
        3: [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0],
            [0, 0, 1, 0, 0]],
        4: [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0] * 5, [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
        5: [[0] * 5, [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0] * 5],
        6: [[0] * 5, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0] * 5],
        7: [[0] * 5, [0, 1, -3, 1, 0], [0] * 5, [0, -1, 3, -1, 0], [0] * 5],
        8: [[0] * 5, [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0] * 5],
        9: [[0] * 5, [0, 1, 2, 1, 0], [0] * 5, [0, -1, -2, -1, 0], [0] * 5]}}


def _smoothing_rows(rows: int, v: int, imcu_rows: int, device) -> torch.Tensor:
    """The block rows ``decompress_smooth_data`` reads two and one above, at, and one and
    two below each of a component's ``rows`` real block rows (``[5, rows]``), as libjpeg-turbo
    3.1 reads them (held against Pillow at every v 1-4 and every height class). Above, the
    edge row replicated; below, whatever lies in the iMCU rows (``v`` block rows each,
    ``imcu_rows`` in the image) the coefficient buffer holds with the row's own: the next
    two, or in the last but one the last, its dummy rows past the image included; in the
    last, its real rows only, the edge one replicated."""
    r = torch.arange(rows, device=device)
    i, b = r // v, r % v
    last = imcu_rows - 1
    in_row = torch.where(i == last, rows - last * v, v)  # real block rows of the iMCU row
    end = torch.where(i + 1 < last, (i + 3) * v, torch.where(i < last, (i + 2) * v, rows))
    up = (r - 1).clamp(min=0)
    # two rows up: the row's own, except in a second iMCU row that is the last and holds one
    # real block row (libjpeg-turbo reads the row above twice there)
    up2 = torch.where((b > 1) | (i > 1) | ((i == 1) & (in_row > 1)), r - 2, up)
    down = torch.where(r + 1 < end, r + 1, r)
    down2 = torch.where(r + 2 < end, r + 2, down)
    return torch.stack([up2, up, r, down, down2])


def _smoothing_kernels() -> np.ndarray:
    """``_SMOOTHING_WEIGHTS`` as one float64 array ``[2, SMOOTHING_COEFS, 5, 5]`` ("ac", then
    "dc"; zeros where a mode estimates nothing)."""
    out = np.zeros((2, SMOOTHING_COEFS, 5, 5))
    for m, mode in enumerate(("ac", "dc")):
        for zz, weights in _SMOOTHING_WEIGHTS[mode].items():
            out[m, zz] = weights
    return out


_SMOOTHING_KERNELS = _smoothing_kernels()


def smooth_blocks(blocks: torch.Tensor, quant: torch.Tensor, latch: torch.Tensor,
                  rows: int, cols: int, v: int, imcu_rows: int) -> torch.Tensor:
    """libjpeg-turbo's block smoothing of one component of F frames: ``blocks`` (int16
    ``[F, R, C, 64]``, natural order, the first ``rows`` x ``cols`` real), their tables
    (``[F, 64]``) and ``parse_jpeg``'s ``smooth`` latch (``[F, SMOOTHING_COEFS]``; zeros:
    that frame is not smoothed) -> the blocks the inverse DCT reads. A coefficient of
    zig-zag 1-9 that is still zero and not known to full precision (latched Al nonzero) is
    estimated from the 5 x 5 DC values around the block (edge blocks replicated), clamped
    below ``1 << Al`` when Al > 0; with no AC data at all the DC is re-estimated too. Every
    position and frame at once: one gather of the windows, one contraction with the weights."""
    if not bool((latch != 0).any()):
        return blocks
    dev = blocks.device
    dc = blocks[:, :, :cols, 0].double()  # the dummy rows of the last iMCU row too
    near_rows = _smoothing_rows(rows, v, imcu_rows, dev)
    near_cols = (torch.arange(cols, device=dev)[None] +
                 torch.arange(-2, 3, device=dev)[:, None]).clamp_(0, cols - 1)
    window = dc[:, near_rows[:, None, :, None], near_cols[None, :, None, :]]  # [F, 5, 5, r, c]
    # the weighted sums are integers under 2**24, exact in float64 (CUDA has no int64 matmul)
    sums = torch.einsum("mkyx,fyxrc->fmrck", torch.from_numpy(_SMOOTHING_KERNELS).to(dev),
                        window).long()
    latch = latch.long()
    change_dc = (latch[:, 1:] == -1).all(dim=1)  # no AC data: the "dc" weights
    total = torch.where(change_dc[:, None, None, None], sums[:, 1], sums[:, 0])
    nat = torch.from_numpy(ZIGZAG[:SMOOTHING_COEFS]).to(dev)
    q = quant.long()
    qk = q[:, nat].clamp(min=1)[:, None, None]  # a frame not smoothed may hold a zero
    num = q[:, 0, None, None, None] * total
    pred = (qk * 128 + num.abs()) // (qk * 256)
    al = latch[:, None, None].clone()
    al[..., 0] = 0  # the DC's estimate is not clamped
    pred = torch.where(al > 0, torch.minimum(pred, (1 << al.clamp(min=0)) - 1), pred)
    pred = torch.where(num < 0, -pred, pred).to(torch.int16)
    current = blocks[:, :rows, :cols][..., nat]
    zz = torch.arange(SMOOTHING_COEFS, device=dev)
    in_mode = change_dc[:, None] | ((zz >= 1) & (zz <= 5))  # "ac" estimates zig-zag 1-5
    use = in_mode[:, None, None] & ((zz == 0) | ((al != 0) & (current == 0)))
    out = blocks.clone()
    out[:, :rows, :cols, nat] = torch.where(use, pred, current)
    return out


def _fix16(v: float) -> int:
    return int(v * (1 << 16) + 0.5)


def _ycc_tables(device) -> Tuple[torch.Tensor, ...]:
    """``jdcolor.c::build_ycc_rgb_table``: Cr -> R, Cb -> B, Cr -> G and Cb -> G."""
    x = torch.arange(-128, 128, dtype=torch.int64, device=device)
    half = 1 << 15
    cr_r = (_fix16(1.40200) * x + half) >> 16
    cb_b = (_fix16(1.77200) * x + half) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


def _ycc_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> List[torch.Tensor]:
    """R, G and B (int64, before the range limit) by ``jdcolor.c``'s tables."""
    cr_r, cb_b, cr_g, cb_g = _ycc_tables(y.device)
    y, cb, cr = y.long(), cb.long(), cr.long()
    return [y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]]


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """``jdcolor.c::ycc_rgb_convert`` -> ``[..., 3]`` uint8."""
    return torch.stack(_ycc_rgb(y, cb, cr), dim=-1).clamp_(0, 255).to(torch.uint8)


def _muldiv255(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pillow's ``MULDIV255``: a * b / 255, rounded, in integers."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def cmyk_to_rgb(cmyk: torch.Tensor) -> torch.Tensor:
    """A CMYK JPEG's decoded samples ``[..., 4]`` (int64) -> ``[..., 3]`` uint8, as Pillow
    gives them: its ``CMYK;I`` raw mode inverts every sample (Adobe's polarity, whatever
    the markers say), then ``convert("RGB")`` (``Convert.c::cmyk2rgb``) takes
    ``255 - k - MULDIV255(x, 255 - k)`` of each of the three inverted inks ``x``. Held
    against Pillow over every pair of ink and black in the tests."""
    nk = cmyk[..., 3:]  # 255 - (255 - K)
    return (nk - _muldiv255(255 - cmyk[..., :3], nk)).clamp_(0, 255).to(torch.uint8)


def ycck_to_cmyk(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                 k: torch.Tensor) -> torch.Tensor:
    """``jdcolor.c::ycck_cmyk_convert`` -> ``[..., 4]`` int64: C, M and Y the range-limited
    complements of ``ycc_to_rgb``'s R, G and B, K passed through."""
    inks = [(255 - c).clamp_(0, 255) for c in _ycc_rgb(y, cb, cr)]
    return torch.stack([*inks, k.long()], dim=-1)


def reconstruct(coefs: Sequence[torch.Tensor], quant: torch.Tensor, width: int, height: int,
                sampling: Sequence[Tuple[int, int]], color: str,
                smooth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F frames of one geometry and colour space (``parse_jpeg``'s ``color``): each
    component's blocks ``[F, rows, cols, 64]`` (int16), the tables ``[F, C, 64]`` and, where
    given, the smoothing latches ``[F, C, SMOOTHING_COEFS]``, on one device -> RGB
    ``[F, height, width, 3]`` uint8 there."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    imcu_rows = _ceil(height, 8 * vmax)
    planes = []
    for c, (blocks, (h, v)) in enumerate(zip(coefs, sampling)):
        cw, ch = _ceil(width * h, hmax), _ceil(height * v, vmax)
        if smooth is not None:
            blocks = smooth_blocks(blocks, quant[:, c], smooth[:, c], _ceil(ch, 8),
                                   _ceil(cw, 8), v, imcu_rows)
        plane = _blocks_to_plane(idct_islow(blocks, quant[:, c, None, None, :]))
        plane = upsample(plane[:, :ch, :cw].int(), hmax // h, vmax // v)
        planes.append(plane[:, :height, :width])
    if color == "grey":
        return planes[0].to(torch.uint8)[..., None].expand(-1, -1, -1, 3)
    if color == "rgb":  # no colour transform
        return torch.stack(planes, dim=-1).to(torch.uint8)
    if color == "cmyk":
        return cmyk_to_rgb(torch.stack(planes, dim=-1).long())
    if color == "ycck":
        return cmyk_to_rgb(ycck_to_cmyk(*planes))
    return ycc_to_rgb(*planes)


def reconstruct_parsed(parts: Sequence[Dict], device) -> torch.Tensor:
    """``parse_jpeg`` results of one geometry, sampling and colour space -> their RGB
    ``[F, height, width, 3]`` uint8 on ``device`` (``reconstruct``, smoothing included)."""
    first = parts[0]
    coefs = [torch.from_numpy(np.stack([p["coefs"][c] for p in parts])).to(device)
             for c in range(len(first["sampling"]))]
    quant = torch.from_numpy(np.stack([p["quant"] for p in parts])).to(device)
    smooth = torch.from_numpy(np.stack([p["smooth"] for p in parts])).to(device)
    return reconstruct(coefs, quant, first["width"], first["height"], first["sampling"],
                       first["color"], smooth)


def decode_jpegs(datas: Sequence[bytes], device: DeviceLike = None,
                 names: Optional[Sequence[str]] = None) -> np.ndarray:
    """JPEG files' bytes, all of one size -> ``[T, H, W, 3]`` uint8 RGB on the host, equal
    to PIL's ``np.asarray(Image.open(f).convert("RGB"))`` for each. The entropy decode runs
    on the host, the rest on ``device`` (``cuda`` unless given) ``CHUNK_BLOCKS`` blocks at a
    time."""
    dev = resolve_device(device)
    names = list(names) if names is not None else [f"frame {i}" for i in range(len(datas))]
    out = None
    i = 0
    while i < len(datas):
        frames, n_blocks = [], 0
        while i < len(datas) and (not frames or n_blocks < CHUNK_BLOCKS):
            frames.append((i, parse_jpeg(datas[i], names[i])))
            n_blocks += sum(c.shape[0] * c.shape[1] for c in frames[-1][1]["coefs"])
            i += 1
        sizes = {(fr["height"], fr["width"]) for _, fr in frames}
        if out is not None:
            sizes.add(out.shape[1:3])
        if len(sizes) > 1:
            raise ValueError(f"frames differ in size: {sorted(sizes)}")
        if out is None:
            (h, w), = sizes
            out = np.empty((len(datas), h, w, 3), np.uint8)
        groups: Dict[Tuple, List[Tuple[int, Dict]]] = {}
        for j, fr in frames:
            groups.setdefault((fr["sampling"], fr["color"]), []).append((j, fr))
        for members in groups.values():
            rgb = reconstruct_parsed([fr for _, fr in members], dev).cpu().numpy()
            for n, (j, _) in enumerate(members):
                out[j] = rgb[n]
    if out is None:
        raise ValueError("no JPEG files given")
    return out


def read_jpegs(paths: Sequence[str], device: DeviceLike = None,
               datas: Optional[Sequence[bytes]] = None) -> np.ndarray:
    """JPEG files of one size -> ``[T, H, W, 3]`` uint8 RGB (``decode_jpegs``); ``datas``,
    where given, holds each file's bytes, already read."""
    datas = [file_bytes(paths, datas, i) for i in range(len(paths))]
    return decode_jpegs(datas, device, names=paths)


# ---------------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------------

def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``: the luma and chroma tables
    (natural order), scaled by ``jpeg_quality_scaling`` and clamped to 1-255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMA_QUANT,
                                                                    STD_CHROMA_QUANT))


def _reciprocals(table: np.ndarray) -> Tuple[np.ndarray, ...]:
    """``jcdctmgr.c::compute_reciprocal`` for the islow divisors (table * 8): reciprocal,
    correction and shift (the 16-bit DCTELEM build)."""
    recip, corr, shift = (np.zeros(64, np.int64) for _ in range(3))
    for i, q in enumerate(table):
        d = int(q) << 3
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def _fdct_1d(x: List[torch.Tensor]):
    """``jpeg_fdct_islow``'s butterfly on eight int64 vectors: the even outputs 0 and 4
    (unscaled), then 2, 6 and the odd outputs 1, 3, 5, 7 before their descale."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    z1 = (tmp12 + tmp13) * F0_541
    even = {0: tmp10 + tmp11, 4: tmp10 - tmp11}
    rest = {2: z1 + tmp13 * F0_765, 6: z1 - tmp12 * F1_847}
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1_175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0_298, tmp5 * F2_053, tmp6 * F3_072, tmp7 * F1_501
    z1, z2 = z1 * -F0_899, z2 * -F2_562
    z3, z4 = z3 * -F1_961 + z5, z4 * -F0_390 + z5
    rest.update({7: tmp4 + z1 + z3, 5: tmp5 + z2 + z4, 3: tmp6 + z2 + z3, 1: tmp7 + z1 + z4})
    return even, rest


def fdct_quantize(samples: torch.Tensor, recip: torch.Tensor, corr: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """Sample blocks ``[..., 8, 8]`` (uint8) -> quantised coefficients ``[..., 64]`` (int16,
    natural order): ``jpeg_fdct_islow``, then ``jcdctmgr.c::quantize``'s reciprocal
    multiply."""
    x = samples.long() - 128
    even, rest = _fdct_1d([x[..., k] for k in range(8)])  # along the rows
    out = {k: v << PASS1_BITS for k, v in even.items()}
    out.update({k: _descale(v, CONST_BITS - PASS1_BITS) for k, v in rest.items()})
    w = torch.stack([out[k] for k in range(8)], dim=-1)
    even, rest = _fdct_1d([w[..., k, :] for k in range(8)])  # down the columns
    out = {k: _descale(v, PASS1_BITS) for k, v in even.items()}
    out.update({k: _descale(v, CONST_BITS + PASS1_BITS) for k, v in rest.items()})
    coef = torch.stack([out[k] for k in range(8)], dim=-2).flatten(-2)
    mag = ((coef.abs() + corr) * recip) >> shift
    return torch.where(coef < 0, -mag, mag).to(torch.int16)


def rgb_to_ycc(rgb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``jccolor.c::rgb_ycc_convert``: ``[..., 3]`` uint8 -> Y, Cb, Cr (int32)."""
    r, g, b = (rgb[..., i].int() for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + offset + half - 1) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edge(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``[F, h, w]`` -> ``[F, rows, cols]``, the last row and column replicated."""
    if cols > x.shape[-1]:
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], cols - x.shape[-1])], dim=-1)
    if rows > x.shape[-2]:
        x = torch.cat([x, x[..., -1:, :].expand(x.shape[0], rows - x.shape[-2], x.shape[-1])],
                      dim=-2)
    return x


def _to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """``[F, rows * 8, cols * 8]`` -> ``[F, rows, cols, 8, 8]``."""
    f, h, w = plane.shape
    return plane.reshape(f, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def encode_blocks(rgb: torch.Tensor, quality: int) -> torch.Tensor:
    """RGB frames ``[F, H, W, 3]`` (uint8, on any device) -> their quantised blocks in scan
    order, ``[F, MCUs * 6, 64]`` (int16): per 16 x 16 MCU four luma blocks, then Cb and Cr,
    with ``jccoefct.c``'s dummy blocks where the luma's block grid ends inside an MCU."""
    f, h, w, _ = rgb.shape
    dev = rgb.device
    mx, my = _ceil(w, 16), _ceil(h, 16)
    bw, bh = _ceil(w, 8), _ceil(h, 8)
    y, cb, cr = rgb_to_ycc(rgb)
    tables = quality_tables(quality)
    recips = [[torch.from_numpy(a).to(dev) for a in _reciprocals(t)] for t in tables]
    luma = fdct_quantize(_to_blocks(_pad_edge(y, 16 * my, 8 * bw)).to(torch.uint8),
                         *recips[0])  # [F, 2 my, bw, 64]
    if bw < 2 * mx:  # a dummy column: DC of the block to its left
        dummy = torch.zeros_like(luma[:, :, -1:])
        dummy[..., 0] = luma[:, :, -1, 0:1]
        luma = torch.cat([luma, dummy], dim=2)
    if bh < 2 * my:  # a dummy row: DC of the MCU's top-right block
        last = luma[:, -1].clone()
        last.zero_()
        last[..., 0] = luma[:, -2, 1::2, 0].repeat_interleave(2, dim=-1)
        luma[:, -1] = last
    luma = luma.reshape(f, my, 2, mx, 2, 64).permute(0, 1, 3, 2, 4, 5).reshape(f, my * mx, 4, 64)
    chroma = []
    for plane in (cb, cr):
        full = _pad_edge(plane, 2 * _ceil(h, 2), 16 * mx)  # rows to even, columns to MCUs
        s = full[:, 0::2, 0::2] + full[:, 0::2, 1::2] + full[:, 1::2, 0::2] + full[:, 1::2, 1::2]
        bias = torch.tensor([1, 2], dtype=s.dtype, device=dev).repeat(4 * mx)
        down = _pad_edge((s + bias) >> 2, 8 * my, 8 * mx)
        chroma.append(fdct_quantize(_to_blocks(down).to(torch.uint8), *recips[1])
                      .reshape(f, my * mx, 1, 64))
    return torch.cat([luma, *chroma], dim=2).reshape(f, my * mx * 6, 64)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def jpeg_header(width: int, height: int, quality: int) -> bytes:
    """Pillow's marker sequence up to the scan: SOI, APP0 JFIF 1.01 (no density unit, 1:1),
    the two tables, SOF0 (4:2:0), the four standard Huffman tables, SOS."""
    luma, chroma = quality_tables(quality)
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, table in enumerate((luma, chroma)):
        out.append(_segment(0xDB, bytes([tq]) + bytes(table[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls_id, (bits, vals) in ((0x00, STD_DC_LUMA), (0x10, STD_AC_LUMA),
                                 (0x01, STD_DC_CHROMA), (0x11, STD_AC_CHROMA)):
        out.append(_segment(0xC4, bytes([cls_id]) + bits + vals))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    return b"".join(out)


_STD_TABLES = {(0, 0): STD_DC_LUMA, (1, 0): STD_AC_LUMA, (0, 1): STD_DC_CHROMA,
               (1, 1): STD_AC_CHROMA}


def entropy_encode(blocks: np.ndarray) -> bytes:
    """One frame's blocks in scan order (``encode_blocks``, int16 ``[n, 64]`` on the host) ->
    its Huffman-coded scan data (host C++)."""
    blocks = np.ascontiguousarray(blocks, np.int16)
    bits, vals = _table_arrays(_STD_TABLES)
    comp = np.array([0, 0, 0, 0, 1, 2], np.int32)
    dc = np.array([0, 1, 1], np.int32)
    cap = blocks.shape[0] * 420 + 64  # 27 bits a coefficient at most, doubled by stuffing
    out = np.empty(cap, np.uint8)
    n = entropy_library().fj_encode_scan(_ptr(blocks), blocks.shape[0], 6, _ptr(comp),
                                         _ptr(dc), _ptr(dc), _ptr(bits), _ptr(vals),
                                         _ptr(out), cap)
    if n < 0:
        raise ValueError(f"JPEG entropy encode failed ({n})")
    return out[:n].tobytes()


def encode_jpegs(frames, quality: int = 95, device: DeviceLike = None) -> List[bytes]:
    """RGB frames ``[T, H, W, 3]`` (uint8, numpy or torch) -> one JPEG file's bytes each,
    equal to Pillow's ``save(format="JPEG", quality=quality)``. The transform and the
    quantisation run on ``device`` (``cuda`` unless given) ``CHUNK_BLOCKS`` blocks at a
    time, the Huffman pass on the host."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames)
    if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected [T, H, W, 3] uint8 frames, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    t, h, w, _ = frames.shape
    header = jpeg_header(w, h, quality)
    per_frame = max(1, CHUNK_BLOCKS // (6 * _ceil(w, 16) * _ceil(h, 16)))
    out = []
    for start in range(0, t, per_frame):
        blocks = encode_blocks(frames[start:start + per_frame].to(dev), quality).cpu().numpy()
        out.extend(header + entropy_encode(b) + b"\xff\xd9" for b in blocks)
    return out
