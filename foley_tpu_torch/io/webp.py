"""WebP frames without PIL: read as Pillow 12.1's ``Image.open(p).convert("RGB")`` reads them
over libwebp 1.6 (what the JAX package's ``pipeline/video.py::read_frames_dir`` calls), byte
for byte. Three layouts are read:

- a lossless still: a ``VP8L`` chunk alone, or ``VP8X`` [+ ``ICCP``] + ``VP8L`` [+ ``EXIF`` /
  ``XMP ``];
- a lossy still: a ``VP8 `` chunk alone, or ``VP8X`` [+ ``ICCP``] + [``ALPH``] + ``VP8 `` [+
  ``EXIF`` / ``XMP ``];
- an animation (``VP8X`` with the animation flag + ``ANIM`` + ``ANMF``...): its first frame,
  as libwebp's ``WebPAnimDecoder`` composes it for Pillow: the canvas filled with zeros and
  the first ``ANMF``'s picture (lossy, with or without ``ALPH``, or lossless) written into
  it at the frame's offset, unblended (the first frame is a key frame). The other frames'
  headers are checked, as libwebp's demuxer checks them; their pixels are not decoded.

A still's canvas (the ``VP8X`` chunk's) must be its bitstream's size, and an animation's
frames must lie inside the canvas. The RIFF chunks are parsed here, and a picture's chunks
taken as libwebp's demuxer takes them (``_picture``): a file shorter than its RIFF size, or
whose chunks break the demuxer's rules, raises where Pillow raises. The VP8L bitstream is
decoded on the host by ``csrc/webp_lossless.cpp`` into ARGB words, whose R, G and B bytes
are taken out in numpy (every VP8L stage is sequential, and the words are final in host
memory). A VP8 key frame is decoded on the host by ``csrc/webp_vp8.cpp`` into its Y, U and V
planes at the macroblock-padded size, loop filter applied (the filter runs in raster order
over overlapping edges); libwebp's fancy upsampling of the chroma (``UpsampleRgbaLinePair``'s
(9, 3, 3, 1) / 16 weights in their integer form) and ``VP8YUVToR/G/B`` (14-bit ``MultHi``)
then run as integer torch ops on the reader's device, the card unless the caller asks for the
CPU, and the result is cropped to the frame's size. No dithering is applied: Pillow's decoder
runs with it off. Both host libraries are built at first use by
``ops/kernels/build.py::host_library``; a failed build raises.

Alpha is dropped, as ``convert("RGB")`` drops it: libwebp decodes RGB apart from alpha in the
non-premultiplied RGBA mode Pillow asks for, so the RGB does not depend on the ``ALPH``
chunk. Where libwebp would decode it (a still whose ``VP8X`` sets the alpha flag, an
animation's first frame), its header is checked (compression 0 or 1, pre-processing 0 or 1,
reserved bits 0, an uncompressed plane of the frame's size) and invalid fields raise; its
plane is not decoded. So one case differs from Pillow: a sound ``VP8 `` bitstream beside a
corrupt VP8L-compressed alpha stream, which Pillow refuses and this reader reads. The
loop-filter deltas of the VP8 frame header (``mode_lf_delta`` / ``ref_lf_delta``) are decoded
as libwebp decodes them, but no encoder here writes them, so they are not held against
Pillow.

Errors: truncated or corrupt data raises ``ValueError`` where Pillow raises;
``WebPUnsupported`` (a ``ValueError``) names a VP8 frame libwebp itself refuses as unsupported:
an inter frame, a frame not to be shown, a profile above 3.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from foley_tpu_torch.core.device import DeviceLike, resolve_device
from foley_tpu_torch.io.png import check_image_size, file_bytes


class WebPUnsupported(ValueError):
    """A WebP this reader does not take."""


#: frames of lossy pixels converted on the device at a time: ``CHUNK_PIXELS`` at most
CHUNK_PIXELS = 1 << 25


def lossless_library() -> ctypes.CDLL:
    """``csrc/webp_lossless.cpp``, built at first use (a missing compiler or a failed build
    raises; ``host_library`` keeps the loaded library)."""
    from foley_tpu_torch.ops.kernels.build import host_library

    lib = host_library("webp_lossless")
    p = ctypes.c_void_p
    lib.webp_lossless_decode.argtypes = [p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                         p, p, p, ctypes.c_int32]
    lib.webp_lossless_decode.restype = ctypes.c_int
    return lib


def vp8_library() -> ctypes.CDLL:
    """``csrc/webp_vp8.cpp``, built at first use (a missing compiler or a failed build
    raises; ``host_library`` keeps the loaded library)."""
    from foley_tpu_torch.ops.kernels.build import host_library

    lib = host_library("webp_vp8")
    p = ctypes.c_void_p
    lib.webp_vp8_decode.argtypes = [p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, p, p,
                                    p, p, p, ctypes.c_int32]
    lib.webp_vp8_decode.restype = ctypes.c_int
    lib.webp_vp8_tables.argtypes = [p]
    lib.webp_vp8_tables.restype = ctypes.c_int64
    return lib


# ---------------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------------

def _le24(b: bytes) -> int:
    return int.from_bytes(b[:3], "little")


def _chunks(data: bytes, name: str, pos: int = 0, end: Optional[int] = None):
    """The chunks of ``data[pos:end]``: (fourcc, payload, the payload with its padding byte:
    what libwebp's demuxer hands its decoders). A chunk whose padded size passes ``end``
    is truncated, as the demuxer judges it."""
    end = len(data) if end is None else end
    while pos + 8 <= end:
        fourcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        padded = size + (size & 1)
        if pos + 8 + padded > end:
            raise ValueError(f"{name}: truncated WebP (chunk {fourcc!r})")
        yield fourcc, data[pos + 8:pos + 8 + size], data[pos + 8:pos + 8 + padded]
        pos += 8 + padded


def _vp8_size(payload: bytes, name: str) -> Tuple[int, int]:
    """A VP8 key frame's checked header -> (width, height) (libwebp's ``VP8GetInfo``)."""
    if len(payload) < 10:
        raise ValueError(f"{name}: truncated VP8 frame header")
    tag = payload[0] | payload[1] << 8 | payload[2] << 16
    if payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: not a VP8 bitstream (bad start code)")
    if tag & 1:
        raise WebPUnsupported(f"{name}: a VP8 inter frame (a WebP holds key frames)")
    if (tag >> 1) & 7 > 3:
        raise WebPUnsupported(f"{name}: VP8 profile {(tag >> 1) & 7} (0-3 are defined)")
    if not (tag >> 4) & 1:
        raise WebPUnsupported(f"{name}: a VP8 frame not to be shown")
    if (tag >> 5) >= len(payload):
        raise ValueError(f"{name}: a VP8 first partition past the chunk")
    # 14 bits each; the two scale bits above them are ignored, as libwebp ignores them
    width = (payload[6] | payload[7] << 8) & 0x3FFF
    height = (payload[8] | payload[9] << 8) & 0x3FFF
    if width == 0 or height == 0:
        raise ValueError(f"{name}: a VP8 frame of size {width} x {height}")
    return width, height


def _vp8l_size(payload: bytes, name: str) -> Tuple[int, int]:
    if len(payload) < 5 or payload[0] != 0x2F:
        raise ValueError(f"{name}: not a VP8L bitstream")
    bits = int.from_bytes(payload[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def _check_alpha(alph: bytes, width: int, height: int, name: str) -> None:
    """An ``ALPH`` chunk's header, as libwebp's ``ALPHInit`` checks it (the plane is not
    decoded: ``convert("RGB")`` drops it)."""
    if len(alph) <= 1:
        raise ValueError(f"{name}: an empty ALPH chunk")
    method, pre, reserved = alph[0] & 3, (alph[0] >> 4) & 3, alph[0] >> 6
    if method > 1 or pre > 1 or reserved:
        raise ValueError(f"{name}: invalid ALPH header (compression {method}, "
                         f"pre-processing {pre}, reserved bits {reserved})")
    if method == 0 and len(alph) - 1 < width * height:
        raise ValueError(f"{name}: truncated uncompressed alpha plane")


_PICTURE_CHUNKS = (b"ALPH", b"VP8 ", b"VP8L")


def _picture(chunks: List[Tuple[bytes, bytes, bytes]], name: str, *, skip_leading: bool,
             alpha_flag: bool, decoded: bool, trailing: bool) -> Dict:
    """One picture's chunks -> its ``kind``, ``width``, ``height`` and bitstream (``vp8``
    with its padding byte, or ``vp8l``), as libwebp's demuxer takes them: from the first
    picture chunk (the first chunk, unless ``skip_leading``) a run of one ``ALPH`` and one
    ``VP8 `` or ``VP8L`` in a row, in either order, up to any other chunk; no ``ALPH`` before
    a ``VP8L``; with ``trailing``, no picture chunk after the run. The ``ALPH`` counts where
    ``alpha_flag`` holds (a still's ``VP8X`` flag; always in an animation): it must precede
    the bitstream, and its header is checked where the picture is ``decoded``."""
    i = 0
    while skip_leading and i < len(chunks) and chunks[i][0] not in _PICTURE_CHUNKS:
        i += 1
    alph, image = None, None
    for fourcc, payload, padded in chunks[i:]:
        if fourcc == b"VP8L" and alph is not None:
            raise ValueError(f"{name}: an ALPH chunk before a VP8L bitstream")
        if fourcc == b"ALPH" and alph is None:
            alph = (image is not None, payload)
        elif fourcc in (b"VP8 ", b"VP8L") and image is None:
            image = (fourcc, payload, padded)
        else:
            break
        i += 1
    if image is None:
        raise ValueError(f"{name}: a WebP without image data")
    if trailing and any(fourcc in _PICTURE_CHUNKS for fourcc, _, _ in chunks[i:]):
        raise ValueError(f"{name}: picture chunks after the picture")
    fourcc, payload, padded = image
    if fourcc == b"VP8L":
        width, height = _vp8l_size(payload, name)
        info = {"kind": "lossless", "width": width, "height": height, "vp8l": payload}
    else:
        width, height = _vp8_size(payload, name)
        info = {"kind": "lossy", "width": width, "height": height, "vp8": padded}
    info["alpha"] = alph is not None and alpha_flag
    if info["alpha"]:
        if alph[0]:
            raise ValueError(f"{name}: an ALPH chunk after the picture's bitstream")
        if decoded:
            _check_alpha(alph[1], width, height, name)
    return info


def parse_webp(data: bytes, name: str = "WebP") -> Dict:
    """One WebP file's bytes -> its first picture (``_picture``'s keys: ``kind`` "lossy" or
    "lossless", the bitstream's ``width`` and ``height`` and its payload), ``canvas`` (width,
    height of the image read), ``offset`` (x, y of the picture on it) and ``frames`` (1 for a
    still)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError(f"{name}: not a WebP file")
    riff_end = 8 + struct.unpack("<I", data[4:8])[0]
    if riff_end < 20 or len(data) < riff_end:
        raise ValueError(f"{name}: truncated WebP (RIFF size {riff_end - 8})")
    chunks = list(_chunks(data, name, 12, riff_end))
    if not chunks or chunks[0][0] not in (b"VP8 ", b"VP8L", b"VP8X"):
        raise ValueError(f"{name}: not a WebP file (first chunk "
                         f"{chunks[0][0] if chunks else None!r})")
    if chunks[0][0] != b"VP8X":  # the simple layout: the bitstream alone
        info = _picture(chunks, name, skip_leading=False, alpha_flag=False, decoded=True,
                        trailing=False)
        canvas, offset, frames = (info["width"], info["height"]), (0, 0), 1
    else:
        vp8x = chunks[0][1]
        if len(vp8x) < 10:
            raise ValueError(f"{name}: truncated VP8X chunk")
        canvas = (1 + _le24(vp8x[4:7]), 1 + _le24(vp8x[7:10]))
        if not vp8x[0] & 0x02:  # a still
            info = _picture(chunks[1:], name, skip_leading=True, alpha_flag=bool(vp8x[0] & 0x10),
                            decoded=True, trailing=True)
            if canvas != (info["width"], info["height"]):
                raise ValueError(f"{name}: a VP8X canvas of {canvas} for a "
                                 f"{info['width']} x {info['height']} image")
            offset, frames = (0, 0), 1
        else:
            info, offset, frames = _first_frame(chunks[1:], canvas, name)
    check_image_size(*canvas, name)
    info.update(canvas=canvas, offset=offset, frames=frames)
    return info


def _first_frame(chunks, canvas: Tuple[int, int], name: str):
    """An animation's chunks after ``VP8X`` -> (its first frame's picture, its offset, the
    number of frames); every frame's picture header and rectangle are checked."""
    seen_anim, first, offset, n = False, None, None, 0
    for fourcc, payload, _ in chunks:
        if fourcc == b"ANIM":
            if len(payload) < 6:
                raise ValueError(f"{name}: truncated ANIM chunk")
            seen_anim = True
        elif fourcc == b"ANMF":
            if not seen_anim:
                raise ValueError(f"{name}: an ANMF chunk before ANIM")
            if len(payload) < 16:
                raise ValueError(f"{name}: truncated ANMF chunk")
            x, y = 2 * _le24(payload[0:3]), 2 * _le24(payload[3:6])
            pic = _picture(list(_chunks(payload, name, 16)), name, skip_leading=False,
                           alpha_flag=True, decoded=first is None, trailing=True)
            if x + pic["width"] > canvas[0] or y + pic["height"] > canvas[1]:
                raise ValueError(f"{name}: frame {n + 1} ({pic['width']} x {pic['height']} "
                                 f"at {x}, {y}) outside the {canvas} canvas")
            if first is None:
                first, offset = pic, (x, y)
            n += 1
        elif fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            raise ValueError(f"{name}: a {fourcc!r} chunk outside ANMF in an animation")
    if first is None:
        raise ValueError(f"{name}: an animation without frames")
    return first, offset, n


# ---------------------------------------------------------------------------------
# lossless (VP8L): every stage on the host
# ---------------------------------------------------------------------------------

# the VP8L transforms by their type numbers
TRANSFORMS = ("predictor", "cross_color", "subtract_green", "color_indexing")


def decode_argb(info: Dict, name: str = "WebP") -> np.ndarray:
    """A parsed lossless picture's pixels, ``[H, W, 4]`` uint8 in memory order (B, G, R, A),
    decoded on the host; ``info["transforms"]`` receives the names of the transforms it
    held."""
    if info["kind"] != "lossless":
        raise ValueError(f"{name}: decode_argb takes a lossless (VP8L) picture")
    out = np.empty((info["height"], info["width"]), np.uint32)
    src = np.frombuffer(info["vp8l"], np.uint8)
    seen = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(256)
    rc = lossless_library().webp_lossless_decode(src.ctypes.data, src.size, info["width"],
                                                 info["height"], out.ctypes.data,
                                                 ctypes.byref(seen), err, len(err))
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    info["transforms"] = [t for i, t in enumerate(TRANSFORMS) if seen.value >> i & 1]
    return out.view(np.uint8).reshape(info["height"], info["width"], 4)


# ---------------------------------------------------------------------------------
# lossy (VP8): the key frame on the host, upsampling and colour on the device
# ---------------------------------------------------------------------------------

# what ``csrc/webp_vp8.cpp`` reports a frame held, by bit: the loop filter's type, segments
# other than 0, a segment map, 2 / 4 / 8 token partitions, a skipped macroblock, the 16x16
# and 4x4 luma modes (libwebp's order), a coefficient probability update, a sharpness,
# per-segment quantiser / filter data
VP8_FEATURES = ("filter_simple", "filter_normal", "filter_none", "segments", "update_map",
                "partitions_2", "partitions_4", "partitions_8", "skip",
                "i16_dc", "i16_tm", "i16_v", "i16_h",
                "i4_dc", "i4_tm", "i4_ve", "i4_he", "i4_rd", "i4_vr", "i4_ld", "i4_vl",
                "i4_hd", "i4_hu", "proba_update", "sharpness", "segment_delta")


def decode_yuv(info: Dict, name: str = "WebP") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A parsed lossy picture -> its Y ``[16 mb_h, 16 mb_w]``, U and V ``[8 mb_h, 8 mb_w]``
    planes (uint8, macroblock-padded, loop filter applied), decoded on the host;
    ``info["features"]`` receives the names of the ``VP8_FEATURES`` the frame held."""
    if info["kind"] != "lossy":
        raise ValueError(f"{name}: decode_yuv takes a lossy (VP8) picture")
    mb_w, mb_h = (info["width"] + 15) >> 4, (info["height"] + 15) >> 4
    y = np.empty((16 * mb_h, 16 * mb_w), np.uint8)
    u = np.empty((8 * mb_h, 8 * mb_w), np.uint8)
    v = np.empty_like(u)
    src = np.frombuffer(info["vp8"], np.uint8)
    seen = ctypes.c_int32(0)
    err = ctypes.create_string_buffer(256)
    rc = vp8_library().webp_vp8_decode(src.ctypes.data, src.size, info["width"],
                                       info["height"], y.ctypes.data, u.ctypes.data,
                                       v.ctypes.data, ctypes.byref(seen), err, len(err))
    if rc != 0:
        raise ValueError(f"{name}: {err.value.decode(errors='replace')}")
    info["features"] = [f for i, f in enumerate(VP8_FEATURES) if seen.value >> i & 1]
    return y, u, v


def _fancy_upsample(c: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """libwebp's ``UpsampleRgbaLinePair`` over a whole chroma plane ``[F, ch, cw]`` (int32,
    ch = (height + 1) // 2, cw = (width + 1) // 2) -> ``[F, height, width]``. Output row r
    weighs a near chroma row 3:1 against a far one (row 0, and the last row of an even
    height, against itself), then each pair of columns as (9, 3, 3, 1) / 16 in libwebp's
    rounding: (a + (a + 3b + 3c + d + 8) >> 3) >> 1; the first column and the last of an
    even width take (3 near + far + 2) >> 2."""
    ch, cw = c.shape[1], c.shape[2]
    r = torch.arange(height, device=c.device)
    odd = r % 2 == 1
    near = torch.where(odd, (r - 1) // 2, r // 2)
    far = torch.where(odd, torch.clamp((r + 1) // 2, max=ch - 1), torch.clamp(r // 2 - 1, min=0))
    a, b = c[:, near], c[:, far]  # [F, height, cw]
    out = torch.empty((c.shape[0], height, width), dtype=c.dtype, device=c.device)
    out[..., 0] = (3 * a[..., 0] + b[..., 0] + 2) >> 2
    if cw > 1:
        a0, a1, b0, b1 = a[..., :-1], a[..., 1:], b[..., :-1], b[..., 1:]
        diag_12 = (a0 + 3 * a1 + 3 * b0 + b1 + 8) >> 3
        diag_03 = (3 * a0 + a1 + b0 + 3 * b1 + 8) >> 3
        out[..., 1:2 * cw - 1:2] = (diag_12 + a0) >> 1
        out[..., 2:2 * cw - 1:2] = (diag_03 + a1) >> 1
    if width % 2 == 0:
        out[..., width - 1] = (3 * a[..., cw - 1] + b[..., cw - 1] + 2) >> 2
    return out


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, width: int,
               height: int) -> torch.Tensor:
    """Macroblock-padded planes of F frames (uint8 ``[F, 16 mb_h, 16 mb_w]`` and
    ``[F, 8 mb_h, 8 mb_w]``, on one device) -> RGB ``[F, height, width, 3]`` uint8 there:
    fancy upsampling, then ``VP8YUVToR/G/B`` (``MultHi(v, c) = v * c >> 8``; the sums
    ``>> 6`` and clipped to 0..255)."""
    ch, cw = (height + 1) // 2, (width + 1) // 2
    yy = y[:, :height, :width].int()
    uu = _fancy_upsample(u[:, :ch, :cw].int(), height, width)
    vv = _fancy_upsample(v[:, :ch, :cw].int(), height, width)
    luma = (yy * 19077) >> 8
    red = luma + ((vv * 26149) >> 8) - 14234
    green = luma - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708
    blue = luma + ((uu * 33050) >> 8) - 17685
    return (torch.stack([red, green, blue], dim=-1) >> 6).clamp_(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------------

def read_webps(paths: Sequence[str], device: DeviceLike = None,
               datas: Optional[Sequence[bytes]] = None) -> np.ndarray:
    """WebP files (lossy, lossless or animated, mixed) whose images share one size ->
    ``[T, H, W, 3]`` uint8 RGB on the host, equal to PIL's
    ``np.asarray(Image.open(p).convert("RGB"))`` for each: VP8L and VP8 bitstreams decoded on
    the host, the lossy pictures' upsampling and colour conversion on ``device`` (``cuda``
    unless given), ``CHUNK_PIXELS`` at a time. ``datas``, where given, holds each file's
    bytes, already read."""
    dev = resolve_device(device)
    infos = [parse_webp(file_bytes(paths, datas, i), p) for i, p in enumerate(paths)]
    sizes = {(info["canvas"][1], info["canvas"][0]) for info in infos}
    if len(sizes) > 1:
        raise ValueError(f"frames differ in size: {sorted(sizes)}")
    if not infos:
        raise ValueError("no WebP files given")
    (h, w), = sizes
    out = np.zeros((len(infos), h, w, 3), np.uint8)  # an animation's canvas starts at 0

    def place(i: int, rgb: np.ndarray) -> None:
        (x, y), info = infos[i]["offset"], infos[i]
        out[i, y:y + info["height"], x:x + info["width"]] = rgb

    lossy: Dict[Tuple[int, int], List[int]] = {}
    for i, (p, info) in enumerate(zip(paths, infos)):
        if info["kind"] == "lossless":
            place(i, decode_argb(info, p)[..., 2::-1])  # B, G, R, A in memory -> R, G, B
        else:
            lossy.setdefault((info["width"], info["height"]), []).append(i)
    for (fw, fh), idx in lossy.items():
        planes = [decode_yuv(infos[i], paths[i]) for i in idx]
        for i, rgb in zip(idx, decode_lossy(planes, fw, fh, dev)):
            place(i, rgb)
    return out


def decode_lossy(planes: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], width: int,
                 height: int, device: torch.device) -> np.ndarray:
    """``decode_yuv``'s planes of F pictures of one size -> RGB ``[F, height, width, 3]``
    uint8 on the host, upsampled and converted on ``device`` ``CHUNK_PIXELS`` at a time."""
    per_chunk = max(1, CHUNK_PIXELS // planes[0][0].size)
    out = np.empty((len(planes), height, width, 3), np.uint8)
    for start in range(0, len(planes), per_chunk):
        part = planes[start:start + per_chunk]
        y, u, v = (torch.from_numpy(np.stack([pl[k] for pl in part])).to(device)
                   for k in range(3))
        out[start:start + len(part)] = yuv_to_rgb(y, u, v, width, height).cpu().numpy()
    return out
