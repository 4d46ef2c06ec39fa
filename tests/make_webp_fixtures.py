"""Write the WebP fixtures of tests/data/webp/ (with PIL, here only).

One small file per case of the port's reader (irgs_tpu_torch/utils/webp.py):
  - PIL's lossless saves (VP8L) at methods 0-6, of photo-like, palette (2,
    4, 16 and 256 colours: pixel bundling and colour indexing), RGBA, LA
    and P images, with ``exact``; an opaque RGBA image (the VP8L alpha bit
    clear: PIL reads RGB);
  - PIL's lossy saves (VP8, and VP8X + ALPH + VP8 with alpha) at several
    qualities and methods, and frames of widths and heights 1 to 17 (the
    fancy upsampler's edges);
  - a C helper built against the system libwebp (its encoder) for what
    PIL's options cannot set: the simple loop filter, sharpness 1-7, 1 and
    4 segments, no loop filter, raw and lossless alpha with each of
    libwebp's alpha filterings, alpha level reduction (the ALPH
    pre-processing bit); its frames rewritten (tests/vp8_streams.py) into
    1, 2, 4 and 8 token partitions and with loop-filter deltas, which its
    encoder does not write; a libvpx key frame (cv2's writer) with skipped
    macroblocks;
  - containers assembled here: ALPH chunks with each spatial filter (0-3)
    raw and VP8L-compressed, a VP8X alpha flag without ALPH and an ALPH
    without the flag, ICCP/EXIF/XMP chunks with and without their flags,
    data past the RIFF chunk, animations (PIL's, and one whose first frame
    is smaller than the canvas, at an offset, followed by frames that
    differ in alpha).
Beside each ``<name>.webp`` the ``<name>.npy`` PIL decodes from it and, in
``modes.json``, its PIL mode and ``info``; ``refused/`` holds streams PIL
refuses (``refused/refused.json``). ``large/`` holds three 1297x840 frames
(lossless, lossy q90, lossy with alpha) with the shape, mode and SHA-256
of PIL's array in ``large/large.json``; ``colmap/`` a COLMAP capture of
WebP frames (`write_colmap_capture`: rendered on the CPU, a few minutes).

    python tests/make_webp_fixtures.py [--no-capture]

(``--no-capture`` keeps the committed COLMAP capture.)
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import tempfile

import numpy as np
from PIL import Image

import vp8_streams as vs

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "webp")
H, W = 21, 26

# the C helper: encodes raw RGBA with libwebp's WebPEncode and the config
# keys given as key=value
HELPER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>
int main(int argc, char** argv) {
  if (argc < 5) return 2;
  int w = atoi(argv[2]), h = atoi(argv[3]);
  FILE* f = fopen(argv[1], "rb");
  unsigned char* rgba = malloc((size_t)w * h * 4);
  if (fread(rgba, 4, (size_t)w * h, f) != (size_t)w * h) return 3;
  fclose(f);
  WebPConfig c;
  if (!WebPConfigInit(&c)) return 4;
  for (int i = 5; i < argc; ++i) {
    char* eq = strchr(argv[i], '=');
    if (!eq) return 5;
    *eq = 0;
    float v = atof(eq + 1);
#define SET(k) if (!strcmp(argv[i], #k)) { c.k = v; continue; }
    SET(quality) SET(segments) SET(sns_strength) SET(filter_strength)
    SET(filter_sharpness) SET(filter_type) SET(autofilter)
    SET(alpha_compression) SET(alpha_filtering) SET(alpha_quality)
    SET(preprocessing)
    return 6;
  }
  if (!WebPValidateConfig(&c)) return 7;
  WebPPicture p;
  if (!WebPPictureInit(&p)) return 8;
  p.width = w; p.height = h;
  if (!WebPPictureImportRGBA(&p, rgba, w * 4)) return 9;
  WebPMemoryWriter wr;
  WebPMemoryWriterInit(&wr);
  p.writer = WebPMemoryWrite; p.custom_ptr = &wr;
  if (!WebPEncode(&c, &p)) return 10;
  f = fopen(argv[4], "wb");
  fwrite(wr.mem, 1, wr.size, f);
  fclose(f);
  return 0;
}
"""


def photo(h, w, seed=0, alpha=False, noise=4.0, scale=1.0):
    """A photo-like image: gradients, rings (features `scale` times wider)
    and a little noise (RGB, or RGBA with a soft disc as alpha)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64) / scale
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0 + seed),
                    128 + 90 * np.cos(np.hypot(x - w / scale / 3,
                                               y - h / scale / 2) / 4.0),
                    128 + 110 * np.sin(x * y / 90.0 + seed)], -1)
    img += np.random.default_rng(seed).normal(0, noise, img.shape)
    if alpha:
        r = np.hypot(x - w / scale / 2, y - h / scale / 2) / (
            0.45 * max(h, w) / scale)
        a = np.clip(255 * (1.3 - r), 0, 255)
        a[: h // 5] = 0                           # a transparent band
        img = np.concatenate([img, a[..., None]], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def tiles(n=128, seed=6):
    """Tiles of 16x16 with ramps both ways, checkers, noise, products and
    flat colours: lossless methods 4-6 pick every predictor mode and
    entropy-image (meta) prefix codes for it."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n, 3), np.uint8)
    y, x = np.mgrid[0:16, 0:16]
    kinds = [(x + y) * 8, (x - y) * 8, ((x // 2 + y // 2) % 2) * 255, None,
             x * 16, y * 16, (x * y) % 256, 0]
    for i in range(0, n, 16):
        for j in range(0, n, 16):
            v = kinds[rng.integers(0, 8)]
            if v is None:
                v = rng.integers(0, 256, x.shape)
            elif np.isscalar(v):
                v = np.full(x.shape, rng.integers(0, 256))
            for c in range(3):
                img[i:i + 16, j:j + 16, c] = (v * (c + 1) +
                                              rng.integers(0, 256)) % 256
    return img


def pil_webp(arr, mode=None, **kw) -> bytes:
    im = arr if isinstance(arr, Image.Image) else Image.fromarray(arr, mode)
    bio = io.BytesIO()
    im.save(bio, "WEBP", **kw)
    return bio.getvalue()


class Helper:
    """The C helper, built once in a temporary directory."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="webp_helper_")
        src = os.path.join(self.dir, "helper.c")
        with open(src, "w") as f:
            f.write(HELPER_C)
        self.exe = os.path.join(self.dir, "helper")
        subprocess.run(["gcc", "-O2", "-o", self.exe, src, "-lwebp"],
                       check=True)

    def encode(self, rgba: np.ndarray, **cfg) -> bytes:
        h, w = rgba.shape[:2]
        raw, out = (os.path.join(self.dir, n) for n in ("in.rgba", "o.webp"))
        np.ascontiguousarray(rgba, np.uint8).tofile(raw)
        subprocess.run([self.exe, raw, str(w), str(h), out,
                        *(f"{k}={v}" for k, v in cfg.items())], check=True)
        with open(out, "rb") as f:
            return f.read()

    def close(self):
        shutil.rmtree(self.dir, ignore_errors=True)


# ---- RIFF assembly ----

def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + \
        b"\0" * (len(payload) & 1)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + le24(w - 1) +
                 le24(h - 1))


def chunks_of(data: bytes) -> list[tuple[bytes, bytes]]:
    """The (tag, payload) chunks of a RIFF WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def image_chunk(data: bytes) -> tuple[bytes, bytes]:
    return next(c for c in chunks_of(data) if c[0] in (b"VP8 ", b"VP8L"))


def filter_alpha(a: np.ndarray, flt: int) -> np.ndarray:
    """The container spec's forward alpha filter: residuals mod 256."""
    a = a.astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if flt == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif flt == 2:
        pred[1:] = a[:-1]
    elif flt == 3:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8) if flt else a.astype(np.uint8)


def alph(a: np.ndarray, method: int, flt: int, pre: int = 0) -> bytes:
    """An ALPH chunk: raw, or the header-less VP8L stream of an image whose
    green channel is the filtered plane (PIL's lossless save, its 5-byte
    VP8L header cut)."""
    f = filter_alpha(a, flt)
    head = bytes([method | (flt << 2) | (pre << 4)])
    if method == 0:
        return chunk(b"ALPH", head + f.tobytes())
    vp8l = image_chunk(pil_webp(np.repeat(f[..., None], 3, -1),
                                lossless=True))[1]
    return chunk(b"ALPH", head + vp8l[5:])


def anmf(x, y, w, h, dur, flags, frame_chunks: bytes) -> bytes:
    return chunk(b"ANMF", le24(x // 2) + le24(y // 2) + le24(w - 1) +
                 le24(h - 1) + le24(dur) + bytes([flags]) + frame_chunks)


def libvpx_keyframe(rgb: np.ndarray) -> bytes:
    """The first (key) frame of a VP8 AVI that cv2 writes with libvpx."""
    import cv2
    path = os.path.join(tempfile.mkdtemp(prefix="webp_vpx_"), "v.avi")
    try:
        h, w = rgb.shape[:2]
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"VP80"), 5, (w, h))
        for _ in range(3):
            wr.write(np.ascontiguousarray(rgb[..., ::-1]))
        wr.release()
        with open(path, "rb") as f:
            avi = f.read()
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    i = avi.find(b"00dc", avi.find(b"movi"))
    return avi[i + 8:i + 8 + struct.unpack_from("<I", avi, i + 4)[0]]


def small_rgb(k: int):
    """The lossy RGB frame of height k (widths 17, 17, 16, ... 2)."""
    b = photo(k, 19 - k if k > 1 else 17, k + 20)
    return f"size_{b.shape[1]}x{k}_rgb", pil_webp(b, quality=60)


# a token partition whose first byte puts the boolean decoder's value past
# its range, in the 16x3 frame
PAST_RANGE = {47: 255, 59: 203}


def _edit(data: bytes, edits: dict) -> bytes:
    out = bytearray(data)
    for i, v in edits.items():
        out[i] = v
    return bytes(out)


def variants():
    out = []

    def add(name, data):
        out.append((name, data))

    rgb, rgba = photo(H, W, 0), photo(H, W, 1, alpha=True)
    big = photo(48, 64, 2)
    # VP8L: methods (transforms, colour cache, meta codes), palettes
    for m in range(7):
        add(f"lossless_m{m}", pil_webp(big, lossless=True, method=m))
    add("lossless_q0", pil_webp(big, lossless=True, quality=0))
    for m in (4, 6):
        add(f"lossless_tiles_m{m}", pil_webp(tiles(), lossless=True, method=m,
                                             quality=100))
    add("lossless_tiles3_m6", pil_webp(tiles(seed=3), lossless=True, method=6,
                                       quality=100))   # predictor mode 8
    for n in (2, 4, 16, 256):
        idx = np.random.default_rng(n).integers(0, n, (H, W))
        idx[: H // 2] = (np.arange(W) * n // W)[None]   # runs for LZ77
        pal = np.random.default_rng(n + 1).integers(0, 256, (n, 4))
        pal[:, 3] = np.where(np.arange(n) % 3 == 0, 255, pal[:, 3])
        add(f"lossless_palette{n}", pil_webp(pal[idx].astype(np.uint8),
                                             "RGBA", lossless=True))
    add("lossless_rgba", pil_webp(rgba, "RGBA", lossless=True))
    add("lossless_rgba_exact", pil_webp(rgba, "RGBA", lossless=True,
                                        exact=True))
    opaque = rgba.copy()
    opaque[..., 3] = 255
    add("lossless_rgba_opaque", pil_webp(opaque, "RGBA", lossless=True))
    src = Image.fromarray(rgba, "RGBA")
    for mode in ("LA", "P", "L"):
        add(f"lossless_from_{mode}", pil_webp(src.convert(mode),
                                              lossless=True))
        add(f"lossy_from_{mode}", pil_webp(src.convert(mode), quality=70))
    # VP8 and VP8X + ALPH + VP8
    for q, m in ((10, 0), (50, 4), (90, 6), (100, 4), (75, 2)):
        add(f"lossy_q{q}_m{m}", pil_webp(big, quality=q, method=m))
    add("lossy_rgba_q80", pil_webp(rgba, "RGBA", quality=80))
    flat = photo(48, 64, 11)
    flat[:, :40] = (90, 140, 200)                   # flat macroblocks
    flat[30:, 40:] = 30
    add("lossy_flat_regions", pil_webp(flat, quality=75))
    add("lossy_rgba_alpha_q40", pil_webp(rgba, "RGBA", quality=80,
                                         alpha_quality=40))
    for k in range(1, 18):
        a = photo(k, 18 - k, k, alpha=True)
        add(f"size_{18 - k}x{k}_rgba", pil_webp(a, "RGBA", quality=85))
        add(*small_rgb(k))
    # the system libwebp's encoder, options PIL does not expose
    helper = Helper()
    try:
        big_a = photo(48, 64, 3, alpha=True)
        enc = lambda img, **c: helper.encode(
            img if img.shape[-1] == 4 else np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1),
            **c)
        for s in range(1, 8):
            add(f"simple_filter_sharp{s}", enc(big, filter_type=0,
                                               filter_strength=60,
                                               filter_sharpness=s,
                                               quality=40))
            add(f"normal_filter_sharp{s}", enc(big, filter_type=1,
                                               filter_strength=80,
                                               filter_sharpness=s,
                                               quality=30))
        add("no_loop_filter", enc(big, filter_strength=0, quality=50))
        add("simple_filter_strong", enc(big, filter_type=0,
                                        filter_strength=100, quality=5))
        # token partitions and loop-filter deltas: libwebp's encoder
        # writes one partition and no deltas, so its frames are rewritten
        # (tests/vp8_streams.py); a partition-only rewrite must decode to
        # the same pixels
        tall = photo(136, 40, 9)
        for kind, cfg in (("normal", dict(filter_type=1, filter_strength=40,
                                          segments=4, sns_strength=80)),
                          ("simple", dict(filter_type=0, filter_strength=60,
                                          filter_sharpness=3))):
            data = enc(tall, quality=45, **cfg)
            frame = image_chunk(data)[1]
            want = np.asarray(Image.open(io.BytesIO(data)))
            for n in (1, 2, 4, 8):
                out_data = riff(chunk(b"VP8 ", vs.rewrite(frame, n)))
                got = np.asarray(Image.open(io.BytesIO(out_data)))
                assert np.array_equal(got, want), (kind, n)
                add(f"{kind}_partitions{n}", out_data)
            add(f"{kind}_lf_deltas", riff(chunk(b"VP8 ", vs.rewrite(
                frame, 2, ((6, -3, 2, 1), (-9, 4, 0, -1))))))
        for s in (1, 4):
            add(f"segments{s}", enc(big, segments=s, sns_strength=100,
                                    quality=45, filter_type=1,
                                    filter_strength=50))
        add("segments4_autofilter", enc(big, segments=4, autofilter=1,
                                        quality=25))
        add("preprocessing", enc(big, preprocessing=1, quality=70))
        for c in (0, 1):
            for flt in (0, 1, 2):
                add(f"alpha_c{c}_filtering{flt}",
                    enc(big_a, alpha_compression=c, alpha_filtering=flt,
                        quality=70))
        add("alpha_level_reduction", enc(big_a, alpha_quality=30,
                                         quality=70))
        add("alpha_level_reduction_raw", enc(big_a, alpha_quality=50,
                                             alpha_compression=0,
                                             quality=70))
    finally:
        helper.close()
    # a libvpx key frame (cv2's FFmpeg writer): loop-filter deltas, and
    # the flat macroblocks skipped (mb_no_coeff_skip), which libwebp's
    # encoder does not flag
    add("libvpx_keyframe", riff(chunk(b"VP8 ", libvpx_keyframe(flat))))
    # containers assembled here
    vp8 = image_chunk(pil_webp(rgb, quality=80))
    vp8c = chunk(*vp8)
    a = rgba[..., 3]
    for method in (0, 1):
        for flt in range(4):
            add(f"alph_m{method}_f{flt}", riff(vp8x(0x10, W, H),
                                               alph(a, method, flt), vp8c))
    add("alph_preprocessed", riff(vp8x(0x10, W, H), alph(a, 1, 3, 1), vp8c))
    add("vp8x_alpha_flag_no_alph", riff(vp8x(0x10, W, H), vp8c))
    add("vp8x_alph_without_flag", riff(vp8x(0, W, H), alph(a, 0, 1), vp8c))
    add("vp8x_metadata", riff(vp8x(0x2C, W, H), chunk(b"ICCP", b"icc!"),
                              vp8c, chunk(b"EXIF", b"Exif\0\0MM\0*"),
                              chunk(b"XMP ", b"<x:xmpmeta/>")))
    add("vp8x_metadata_no_flags", riff(vp8x(0, W, H), chunk(b"ICCP", b"icc!"),
                                       vp8c, chunk(b"XMP ", b"<x/>")))
    add("vp8l_in_vp8x", riff(vp8x(0x10, W, H),
                             chunk(*image_chunk(pil_webp(rgba, "RGBA",
                                                         lossless=True)))))
    add("trailing_data", pil_webp(rgb, quality=60) + b"\0junk after RIFF")
    # corrupt streams PIL still decodes (found by mutating the fixtures):
    # the boolean decoder's value past its range (libwebp's 7-byte loads
    # into a 64-bit word; with partition 0 damaged too, its branch-free
    # sign read), chroma coefficients far past any encoder's range
    # (libwebp's 16-bit SSE2 transform), and a lossless ALPH stream one
    # byte short whose last symbol reads past its end (libwebp's
    # DecodeAlphaData accepts it)
    sizes = dict(out)
    add("corrupt_vp8_value_past_range", _edit(sizes["size_16x3_rgb"],
                                              PAST_RANGE))
    add("corrupt_vp8_sign_past_range", _edit(sizes["size_16x3_rgb"], {
        **PAST_RANGE, 31: 40, 37: 29}))
    add("corrupt_vp8_chroma_coefficients", _edit(
        sizes["simple_partitions2"], {756: 195, 1079: 224, 1133: 163}))
    ch = chunks_of(sizes["size_6x12_rgba"])
    add("corrupt_alph_lossless_cut", riff(*[
        chunk(t, p[:-1] if t == b"ALPH" else p) for t, p in ch]))
    add("unknown_chunk_after_image", riff(vp8c, chunk(b"ABCD", b"xyz")))
    # animations
    frames = [Image.fromarray(photo(H, W, s, alpha=True), "RGBA")
              for s in range(3)]
    for kind, kw in (("lossless", dict(lossless=True)),
                     ("lossy", dict(quality=70))):
        bio = io.BytesIO()
        frames[0].save(bio, "WEBP", save_all=True, append_images=frames[1:],
                       duration=[40, 50, 60], loop=2,
                       background=(10, 20, 30, 40), **kw)
        add(f"animated_{kind}", bio.getvalue())
    small = photo(9, 12, 7)
    f1 = chunk(*image_chunk(pil_webp(small, quality=90)))
    f2 = alph(photo(H, W, 8, alpha=True)[..., 3], 1, 2) + chunk(
        *image_chunk(pil_webp(photo(H, W, 8), quality=90)))
    for flags, name in ((0x12, "animated_offset_first_frame"),
                        (0x02, "animated_offset_no_alpha_flag")):
        add(name, riff(vp8x(flags, W + 6, H + 4),
                       chunk(b"ANIM", struct.pack("<IH", 0x80402010, 0)),
                       anmf(4, 2, 12, 9, 70, 0, f1),
                       anmf(0, 0, W, H, 80, 2, f2)))
    return out


def refused():
    rgb, rgba = photo(H, W, 0), photo(H, W, 1, alpha=True)
    lossy, lossless = pil_webp(rgb, quality=80), pil_webp(rgba, "RGBA",
                                                          lossless=True)
    tag, payload = image_chunk(lossy)

    def vp8_with(tag_bits=None, sig=None):
        p = bytearray(payload)
        if tag_bits is not None:
            p[0] |= tag_bits
        if sig is not None:
            p[3:6] = sig
        return riff(chunk(b"VP8 ", bytes(p)))

    p = bytearray(payload)
    p[0] &= ~0x10                                   # show_frame 0
    not_shown = riff(chunk(b"VP8 ", bytes(p)))
    lossy_cut = riff(chunk(b"VP8 ", payload[:len(payload) * 2 // 3]))
    ltag, lpay = image_chunk(lossless)
    lossless_cut = riff(chunk(b"VP8L", lpay[:len(lpay) // 2]))
    bad_ver = bytearray(lpay)
    bad_ver[4] |= 0x20
    alpha = rgba[..., 3]
    vp8c = chunk(tag, payload)
    bad_alph = chunk(b"ALPH", bytes([0x40]) + alpha.tobytes())
    short_alph = chunk(b"ALPH", bytes([0]) + alpha.tobytes()[:100])
    alph_m2 = chunk(b"ALPH", bytes([2]) + alpha.tobytes())
    cut_alph = alph(alpha, 1, 0)
    cut_alph = chunk(b"ALPH", cut_alph[8:8 + len(cut_alph) // 3])
    big_size = bytearray(lossy)
    struct.pack_into("<I", big_size, 16, len(payload) + 1000)
    # a VP8L header (26 x 21, no alpha) and subtract-green twice
    twice = struct.pack("<BI", 0x2F, (W - 1) | ((H - 1) << 14)) + bytes(
        [0b1011101, 0, 0, 0])
    return [
        ("truncated", lossy[: len(lossy) // 2], None),
        ("vp8_value_past_range_tokens_past_end", _edit(
            small_rgb(3)[1], {**PAST_RANGE, 56: 117}), None),
        ("vp8l_transform_twice", riff(chunk(b"VP8L", twice)), None),
        ("truncated_header", lossy[:18], None),
        ("chunk_size_past_riff", bytes(big_size), None),
        ("riff_size_short", lossy[:4] + struct.pack("<I", 12) + lossy[8:],
         None),
        ("vp8_interframe", vp8_with(tag_bits=1), None),
        ("vp8_not_shown", not_shown, None),
        ("vp8_bad_start_code", vp8_with(sig=b"\x9d\x01\x2b"), None),
        ("vp8_data_cut", lossy_cut, None),
        ("vp8l_data_cut", lossless_cut, None),
        ("vp8l_bad_signature", riff(chunk(b"VP8L", b"\x2e" + lpay[1:])),
         None),
        ("vp8l_bad_version", riff(chunk(b"VP8L", bytes(bad_ver))), None),
        ("vp8x_bad_flags", riff(vp8x(0x01, W, H), vp8c), None),
        ("vp8x_canvas_mismatch", riff(vp8x(0, W + 1, H), vp8c), None),
        ("vp8x_no_image", riff(vp8x(0, W, H), chunk(b"EXIF", b"x")), None),
        ("alph_reserved_bits", riff(vp8x(0x10, W, H), bad_alph, vp8c), None),
        ("alph_raw_short", riff(vp8x(0x10, W, H), short_alph, vp8c), None),
        ("alph_method2", riff(vp8x(0x10, W, H), alph_m2, vp8c), None),
        ("alph_lossless_cut", riff(vp8x(0x10, W, H), cut_alph, vp8c), None),
        ("alph_after_image", riff(vp8x(0x10, W, H), vp8c, bad_alph), None),
        ("animation_flag_plain_image", riff(vp8x(0x02, W, H), vp8c), None),
        ("anmf_before_anim", riff(vp8x(0x02, W, H),
                                  anmf(0, 0, W, H, 10, 0, vp8c)), None),
        ("canvas_over_pil_limit", riff(vp8x(0x02, 16384, 16384),
                                       chunk(b"ANIM", bytes(6)),
                                       anmf(0, 0, W, H, 10, 0, vp8c)), None),
        ("anmf_outside_canvas", riff(vp8x(0x02, W, H),
                                     chunk(b"ANIM", bytes(6)),
                                     anmf(2, 0, W, H, 10, 0, vp8c)), None),
    ]


def save(out, files, refused_files):
    import glob
    for path in glob.glob(os.path.join(out, "*.*")):
        os.remove(path)
    shutil.rmtree(os.path.join(out, "refused"), ignore_errors=True)
    os.makedirs(os.path.join(out, "refused"))
    modes = {}
    for name, data in files:
        path = os.path.join(out, name + ".webp")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.asarray(im)
            modes[name] = {"mode": im.mode, "palette": None,
                           "transparency": None, "info": json_info(im.info)}
        np.save(os.path.join(out, name + ".npy"), arr)
    with open(os.path.join(out, "modes.json"), "w") as f:
        json.dump(modes, f, indent=0, sort_keys=True)
    notes = {}
    for name, data, why in refused_files:
        with open(os.path.join(out, "refused", name + ".webp"), "wb") as f:
            f.write(data)
        try:
            with Image.open(io.BytesIO(data)) as im:
                np.asarray(im)
            raise AssertionError(f"{name}: PIL reads it")
        except AssertionError:
            raise
        except Exception:
            notes[name] = why
    with open(os.path.join(out, "refused", "refused.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


def json_info(info: dict) -> dict:
    """PIL's info with bytes as hex and tuples as lists."""
    return {k: v.hex() if isinstance(v, bytes) else
            list(v) if isinstance(v, tuple) else v
            for k, v in sorted(info.items())}


# the three 1297x840 frames the chip smoke times
def large_frames():
    frame = photo(840, 1297, 5, noise=0.0, scale=8.0)
    lossy = photo(840, 1297, 5, noise=1.5, scale=8.0)
    frame_a = photo(840, 1297, 6, alpha=True, noise=1.5, scale=8.0)
    return [("large_lossless", pil_webp(frame, lossless=True, method=4)),
            ("large_lossy_q90", pil_webp(lossy, quality=90)),
            ("large_lossy_alpha_q90", pil_webp(frame_a, "RGBA", quality=90))]


def save_large(out):
    os.makedirs(out, exist_ok=True)
    notes = {}
    for name, data in large_frames():
        path = os.path.join(out, name + ".webp")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.ascontiguousarray(np.asarray(im))
            notes[name] = {"mode": im.mode, "shape": list(arr.shape),
                           "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    with open(os.path.join(out, "large.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


# the COLMAP capture: four ring views of the seeded toy sphere (4,096
# surfels) at 400x400, rendered on the CPU by the port's eval renderer,
# saved as WebP: two lossy at quality 90, one lossless, one lossy with the
# render's alpha; points3D.bin holds the surfel centres
CAPTURE_RES, CAPTURE_SPP, CAPTURE_OFFSET = 400, 4, 3.0
CAPTURE_SAVES = (("view_000.webp", dict(quality=90)),
                 ("view_001.webp", dict(quality=90)),
                 ("view_002.webp", dict(lossless=True)),
                 ("view_003.webp", dict(quality=90)))


def write_colmap_capture(root: str) -> None:
    import math
    import sys
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    from irgs_tpu_torch.config import Config
    from irgs_tpu_torch.ops import grid_tracer as gt
    from irgs_tpu_torch.render.eval import EvalConfig, render_ir_eval
    from irgs_tpu_torch.scene import colmap, toy

    res = CAPTURE_RES
    params, aux = toy.make_sphere_scene(n_surface=4096, n_capacity=4096,
                                        env_resolution=64, device="cpu")
    ring = toy.make_ring_cameras(len(CAPTURE_SAVES), width=res,
                                 height_px=res)
    f = res / (2 * math.tan(ring[0].fovx / 2))
    c = res / 2 + CAPTURE_OFFSET
    ecfg = EvalConfig(img_w=res, img_h=res, diffuse_sample_num=CAPTURE_SPP,
                      light_sample_num=0, white_background=False,
                      tracer=gt.TracerConfig.from_pipe(Config().pipe,
                                                       eval=True))
    grid = gt.build_grid_from_gaussians(params, aux, ecfg.tracer)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    images = []
    to8 = lambda x: (x.clamp(0, 1).numpy() * 255 + 0.5).astype(np.uint8)
    for i, (cam, (name, kw)) in enumerate(zip(ring, CAPTURE_SAVES)):
        with torch.no_grad():
            o = render_ir_eval(params, aux, grid, cam.params("cpu"), ecfg)
        rgb = to8(o["render"])
        if i == len(CAPTURE_SAVES) - 1:
            data = pil_webp(np.concatenate([rgb, to8(o["rend_alpha"])], -1),
                            "RGBA", **kw)
        else:
            data = pil_webp(rgb, **kw)
        with open(os.path.join(root, "images", name), "wb") as fh:
            fh.write(data)
        images.append(dict(id=i + 1, qvec=colmap.rotmat2qvec(cam.R.T),
                           tvec=cam.T, camera_id=1, name=name))
    xyz = params.xyz.detach().numpy()[aux.alive.numpy()]
    colmap.write_model(os.path.join(root, "sparse", "0"),
                       [dict(id=1, model="PINHOLE", width=res, height=res,
                             params=[f, f, c, c])],
                       images, xyz, np.full((len(xyz), 3), 128, np.uint8))


if __name__ == "__main__":
    import sys
    save(OUT, variants(), refused())
    save_large(os.path.join(OUT, "large"))
    if "--no-capture" not in sys.argv[1:]:
        write_colmap_capture(os.path.join(OUT, "colmap"))
    print(f"wrote {len(variants())} fixtures to {OUT}")
