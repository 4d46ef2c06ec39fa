"""WebP reader: the first frame, as ``np.asarray(PIL.Image.open(path))``,
``im.mode`` and ``im.info`` give it (Pillow 12's WebPImagePlugin, which
hands the whole file to libwebp's WebPAnimDecoder).

The RIFF container is checked as libwebp's demuxer checks it: the simple
forms (one ``VP8 `` or ``VP8L`` chunk), and ``VP8X`` with its canvas, its
flags and the ``ICCP``, ``EXIF`` and ``XMP `` chunks (kept in ``info``
where their flag is set, as PIL keeps them), an ``ALPH`` chunk before a
``VP8 `` frame (dropped where the alpha flag is clear), and ``ANIM`` with
its ``ANMF`` frames. The first frame is decoded into a canvas of the
container's size zeroed to transparent black, at its offset, with no
blending (a key frame, as WebPAnimDecoder treats it). The mode is what
libwebp's WebPGetFeatures reports for the file: "RGBA" where it has alpha
(the VP8X alpha flag, the VP8L header's alpha bit, an ALPH chunk), else
"RGB" (the canvas's alpha channel dropped).

The bitstreams are decoded by csrc/webp_decode.cpp (built with g++ at
first use): VP8L, VP8 with libwebp's YUV->RGB and fancy upsampling, and
ALPH. Streams PIL refuses raise WebpError, never a partial image; so
does a canvas over PIL's decompression-bomb limit.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import native

SRC = Path(__file__).resolve().parents[1] / "csrc" / "webp_decode.cpp"

_LIB = None
_U8P = ctypes.POINTER(ctypes.c_uint8)

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
# PIL's Image.open refuses an image of more than twice
# Image.MAX_IMAGE_PIXELS (DecompressionBombError)
PIL_MAX_PIXELS = 2 * 89_478_485
ANIMATION_FLAG, XMP_FLAG, EXIF_FLAG, ALPHA_FLAG, ICCP_FLAG = (
    0x02, 0x04, 0x08, 0x10, 0x20)
VALID_FLAGS = ANIMATION_FLAG | XMP_FLAG | EXIF_FLAG | ALPHA_FLAG | ICCP_FLAG
_ERRORS = {-1: "malformed bitstream", -2: "the data ends early",
           -3: "not a displayable key frame",
           -4: "the bitstream's size differs from the container's"}


class WebpError(ValueError):
    pass


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native.build_library(SRC, "webp_decode")))
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        lib.webp_vp8l_decode.argtypes = [_U8P, i64, i32, i32, _U8P]
        lib.webp_vp8_decode.argtypes = [_U8P, i64, i32, i32, _U8P]
        lib.webp_alph_decode.argtypes = [_U8P, i64, i32, i32, _U8P]
        for f in (lib.webp_vp8l_decode, lib.webp_vp8_decode,
                  lib.webp_alph_decode):
            f.restype = i64
        _LIB = lib
    return _LIB


def _le(b: bytes, o: int, n: int) -> int:
    return int.from_bytes(b[o:o + n], "little")


class _Fail(Exception):
    """Internal: the demuxer or the decoder refuses the stream."""


def _vp8_info(data: bytes, chunk_size: int):
    """libwebp's VP8GetInfo on a VP8 frame's bytes -> (width, height)."""
    if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
        raise _Fail("not a VP8 key frame")
    bits = _le(data, 0, 3)
    w, h = _le(data, 6, 2) & 0x3FFF, _le(data, 8, 2) & 0x3FFF
    if bits & 1:
        raise _Fail("VP8 interframe (not a key frame)")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        raise _Fail("bad VP8 frame header")
    if not w or not h:
        raise _Fail("VP8 frame of size 0")
    return w, h


def _vp8l_info(data: bytes):
    """libwebp's VP8LGetInfo -> (width, height, alpha_is_used)."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        raise _Fail("bad VP8L signature")
    bits = _le(data, 1, 4)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


def _chunk_features(buf: bytes, start: int, size: int):
    """WebPGetFeatures on an image chunk (header included) -> (width,
    height, has_alpha)."""
    data = buf[start + 8:start + size]
    if buf[start:start + 4] == b"VP8L":
        return _vp8l_info(data)
    return (*_vp8_info(data, _le(buf, start + 4, 4)), 0)


class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = self.duration = 0
        self.alpha = None           # (offset, size) of the ALPH chunk
        self.image = None           # (offset, size) of the VP8/VP8L chunk
        self.has_alpha = 0
        self.numbered = False       # an ALPH or image chunk was stored
        self.complete = False


class _Demux:
    """libwebp's demuxer (demux.c) on a whole file: the canvas, flags,
    loop count, background, stored chunks and frames, or _Fail."""

    def __init__(self, buf: bytes):
        if len(buf) < 20 or buf[:4] != b"RIFF" or buf[8:12] != b"WEBP":
            raise _Fail("not a WebP file")
        riff_size = _le(buf, 4, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise _Fail("bad RIFF size")
        self.end = riff_size + 8
        if len(buf) < self.end:
            raise _Fail("truncated file")
        self.buf = buf
        self.pos = 12
        self.flags = 0
        self.ext = False
        self.canvas = None
        self.loop, self.bgcolor = 1, 0xFFFFFFFF
        self.frames: list[_Frame] = []
        self.chunks: dict[bytes, bytes] = {}
        tag = buf[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            self._single_image()
        elif tag == b"VP8X":
            self._vp8x()
        else:
            raise _Fail(f"unknown chunk {tag!r}")
        self._validate()

    def left(self) -> int:
        return self.end - self.pos

    def _store_frame(self, frame: _Frame, min_size: int = 0) -> None:
        buf = self.buf
        if self.left() < 8 or self.left() < min_size:
            raise _Fail("truncated frame")
        n_alpha = n_image = 0
        while True:
            start = self.pos
            fourcc, size = buf[start:start + 4], _le(buf, start + 4, 4)
            self.pos += 8
            if size > MAX_CHUNK_PAYLOAD:
                raise _Fail("bad chunk size")
            padded = size + (size & 1)
            if padded > self.left():
                raise _Fail("chunk runs past the file")
            chunk = (start, 8 + padded)
            if fourcc == b"VP8L" and n_alpha:
                raise _Fail("ALPH before a VP8L frame")
            if fourcc == b"ALPH" and not n_alpha:
                n_alpha = 1
                frame.alpha, frame.has_alpha, frame.numbered = chunk, 1, True
                self.pos += padded
            elif fourcc in (b"VP8 ", b"VP8L") and not n_image:
                frame.width, frame.height, a = _chunk_features(buf, *chunk)
                n_image = 1
                frame.image, frame.numbered, frame.complete = chunk, True, True
                frame.has_alpha |= a
                self.pos += padded
            else:
                self.pos -= 8
                return
            if self.pos == self.end:
                return
            if self.left() < 8:
                raise _Fail("truncated chunk header")

    def _single_image(self) -> None:
        if self.frames:
            raise _Fail("a second image")
        if self.left() < 8:
            raise _Fail("truncated image chunk")
        frame = _Frame()
        self._store_frame(frame)
        if not self.flags & ALPHA_FLAG and frame.alpha is not None:
            frame.alpha, frame.has_alpha = None, 0
        if not self.ext and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
            self.flags |= ALPHA_FLAG if frame.has_alpha else 0
        self._add(frame)

    def _add(self, frame: _Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _Fail("a frame after an incomplete one")
        self.frames.append(frame)

    def _vp8x(self) -> None:
        buf = self.buf
        self.ext = True
        size = _le(buf, self.pos + 4, 4)
        self.pos += 8
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise _Fail("bad VP8X chunk size")
        size += size & 1
        if size > self.left():
            raise _Fail("VP8X chunk runs past the file")
        self.flags = buf[self.pos]
        w, h = _le(buf, self.pos + 4, 3) + 1, _le(buf, self.pos + 7, 3) + 1
        if w * h >= MAX_IMAGE_AREA:
            raise _Fail("canvas too large")
        self.canvas = (w, h)
        self.pos += size
        if self.left() < 8:
            raise _Fail("nothing after the VP8X chunk")
        animation = bool(self.flags & ANIMATION_FLAG)
        n_anim = 0
        while True:
            start = self.pos
            fourcc, size = buf[start:start + 4], _le(buf, start + 4, 4)
            self.pos += 8
            if size > MAX_CHUNK_PAYLOAD:
                raise _Fail("bad chunk size")
            padded = size + (size & 1)
            if padded > self.left():
                raise _Fail("chunk runs past the file")
            if fourcc == b"VP8X":
                raise _Fail("a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if n_anim or animation:
                    raise _Fail("an image outside ANMF in an animation")
                self.pos -= 8
                self._single_image()
            elif fourcc == b"ANIM" and not n_anim:
                if padded < 6:
                    raise _Fail("short ANIM chunk")
                n_anim = 1
                self.bgcolor = _le(buf, self.pos, 4)
                self.loop = _le(buf, self.pos + 4, 2)
                self.pos += padded
            elif fourcc == b"ANMF":
                if not n_anim:
                    raise _Fail("ANMF before ANIM")
                self._anmf(padded)
            else:
                flag = {b"ICCP": ICCP_FLAG, b"EXIF": EXIF_FLAG,
                        b"XMP ": XMP_FLAG}.get(fourcc, 0)
                if flag & self.flags and fourcc not in self.chunks:
                    self.chunks[fourcc] = buf[self.pos:self.pos + size]
                self.pos += padded
            if self.pos == self.end:
                return
            if self.left() < 8:
                raise _Fail("truncated chunk header")

    def _anmf(self, size: int) -> None:
        buf = self.buf
        if 16 > self.left() or size < 16:
            raise _Fail("short ANMF chunk")
        frame = _Frame()
        p = self.pos
        frame.x, frame.y = 2 * _le(buf, p, 3), 2 * _le(buf, p + 3, 3)
        w, h = 1 + _le(buf, p + 6, 3), 1 + _le(buf, p + 9, 3)
        frame.duration = _le(buf, p + 12, 3)
        if w * h >= MAX_IMAGE_AREA:
            raise _Fail("frame too large")
        self.pos += 16
        start = self.pos
        self._store_frame(frame, size - 16)
        if self.pos - start > size - 16:
            raise _Fail("frame runs past its ANMF chunk")
        if self.flags & ANIMATION_FLAG and frame.numbered:
            self._add(frame)

    def _validate(self) -> None:
        if self.canvas is None or not self.frames:
            raise _Fail("no frame")
        if self.ext and self.flags & ~VALID_FLAGS:
            raise _Fail("invalid VP8X flags")
        animation = bool(self.flags & ANIMATION_FLAG)
        cw, ch = self.canvas
        for i, f in enumerate(self.frames):
            if self.ext and not animation and i > 0:
                raise _Fail("several frames in a still image")
            if not f.complete:
                raise _Fail("a frame without an image")
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                raise _Fail("ALPH after the image chunk")
            if f.width <= 0 or f.height <= 0:
                raise _Fail("frame of size 0")
            if not animation or not self.ext:
                ok = (f.x, f.y, f.width, f.height) == (0, 0, cw, ch)
            else:
                ok = f.x + f.width <= cw and f.y + f.height <= ch
            if not ok:
                raise _Fail("frame outside the canvas")


def _has_alpha(buf: bytes):
    """WebPGetFeatures(file).has_alpha, or None where it fails (PIL then
    keeps its default mode, RGBA)."""
    riff_size = _le(buf, 4, 4)
    if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
        return None
    pos, flags, vp8x = 12, 0, False
    if buf[pos:pos + 4] == b"VP8X":
        if _le(buf, pos + 4, 4) != 10 or len(buf) < pos + 18:
            return None
        flags, vp8x = _le(buf, pos + 8, 4), True
        pos += 18
        if flags & ANIMATION_FLAG:
            return bool(flags & ALPHA_FLAG)
    has_alpha, alpha_chunk = bool(flags & ALPHA_FLAG), False
    if vp8x:
        total = 22
        while True:
            if len(buf) - pos < 8:
                return None
            size = _le(buf, pos + 4, 4)
            if size > MAX_CHUNK_PAYLOAD:
                return None
            disk = (8 + size + 1) & ~1
            total += disk
            if total > riff_size:
                return None
            if buf[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if len(buf) - pos < disk:
                return None
            alpha_chunk |= buf[pos:pos + 4] == b"ALPH"
            pos += disk
    if len(buf) - pos < 8 or buf[pos:pos + 4] not in (b"VP8 ", b"VP8L"):
        return None
    size = _le(buf, pos + 4, 4)
    if size > riff_size - 12:
        return None
    try:
        w, h, a = _chunk_features(buf, pos, 8 + size)
    except _Fail:
        return None
    if buf[pos:pos + 4] == b"VP8L":
        has_alpha = bool(a)
    if vp8x and (w, h) != (_le(buf, 24, 3) + 1, _le(buf, 27, 3) + 1):
        return None
    return has_alpha or alpha_chunk


def _check(rc: int, what: str) -> None:
    if rc < 0:
        raise _Fail(f"{what}: {_ERRORS.get(rc, rc)}")


def _decode_frame(buf: bytes, frame: _Frame) -> np.ndarray:
    """WebPDecode of the frame's chunks -> RGBA [height, width, 4]."""
    start, size = frame.image
    data = np.frombuffer(buf, np.uint8, size - 8, start + 8)
    w, h = frame.width, frame.height
    out = np.empty((h, w, 4), np.uint8)
    ptr = out.ctypes.data_as(_U8P)
    src = data.ctypes.data_as(_U8P)
    if buf[start:start + 4] == b"VP8L":
        _check(_lib().webp_vp8l_decode(src, len(data), w, h, ptr), "VP8L")
        return out
    _check(_lib().webp_vp8_decode(src, len(data), w, h, ptr), "VP8")
    if frame.alpha is not None:
        a_start = frame.alpha[0]
        alpha = np.frombuffer(buf, np.uint8, _le(buf, a_start + 4, 4),
                              a_start + 8)
        plane = np.empty((h, w), np.uint8)
        _check(_lib().webp_alph_decode(alpha.ctypes.data_as(_U8P),
                                       len(alpha), w, h,
                                       plane.ctypes.data_as(_U8P)), "ALPH")
        out[..., 3] = plane
    return out


def decode_webp(buf: bytes, name: str = "WebP"):
    """(array, mode, info) of a WebP file's bytes: its first frame."""
    try:
        dmx = _Demux(buf)
        if dmx.canvas[0] * dmx.canvas[1] > PIL_MAX_PIXELS:
            raise _Fail(f"{dmx.canvas[0]} x {dmx.canvas[1]} pixels: PIL "
                        f"refuses it as a decompression bomb")
        has_alpha = _has_alpha(buf)
        frame = dmx.frames[0]
        rgba = _decode_frame(buf, frame)
    except _Fail as e:
        raise WebpError(f"{name}: {e}") from None
    cw, ch = dmx.canvas
    canvas = np.zeros((ch, cw, 4), np.uint8)
    canvas[frame.y:frame.y + frame.height,
           frame.x:frame.x + frame.width] = rgba
    mode = "RGB" if has_alpha is False else "RGBA"
    if mode == "RGB":
        canvas = np.ascontiguousarray(canvas[..., :3])
    bg = dmx.bgcolor
    info = {"loop": dmx.loop,
            "background": ((bg >> 16) & 255, (bg >> 8) & 255, bg & 255,
                           (bg >> 24) & 255)}
    for key, tag in (("icc_profile", b"ICCP"), ("exif", b"EXIF"),
                     ("xmp", b"XMP ")):
        if dmx.chunks.get(tag):
            info[key] = dmx.chunks[tag]
    info["timestamp"], info["duration"] = 0, frame.duration
    return canvas, mode, info


def read_webp_like_pil(path: str):
    """(array, mode, info) of ``im = PIL.Image.open(path)`` for a WebP
    file."""
    with open(path, "rb") as f:
        return decode_webp(f.read(), path)
