"""Write the fixtures of PIL's small readers (with PIL, here only):
tests/data/ppm (Netpbm: P1-P6 plain and raw at several maxvals, PFM,
P0CMYK and PIL's Py variants), tga (Targa: every image type and depth,
colour maps from a first index, RLE across rows, mirrored and top-down),
ico (ICO with DIB and PNG frames, CUR, bare DIB), qoi, pcx (1 bit in 1,
2 and 4 planes, 8-bit grey and palette, planar RGB, padded strides) and
sgi (verbatim and RLE, 8 and 16 bits, shared rows, a row that stops the
decoder). Beside each file the ``.npy`` PIL decodes from it and, in
``modes.json``, its mode and palette; ``refused/`` holds streams PIL
refuses. Then ``tga/colmap/``: the four 400x400 views of
tests/data/webp/colmap as Targa RLE RGB, Iris RLE RGB, binary PPM and
Targa raw RGBA with a bottom-left origin, with that capture's cameras and
points.

    python tests/make_small_fixtures.py
"""

from __future__ import annotations

import io
import os
import struct
import sys

import numpy as np
from PIL import Image

import image_streams as ims

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
# format folder -> file extension
FORMATS = {"ppm": ".ppm", "tga": ".tga", "ico": ".ico", "qoi": ".qoi",
           "pcx": ".pcx", "sgi": ".sgi"}
H, W = 9, 13


def pil_save(arr, fmt, mode=None, **kw) -> bytes:
    im = Image.fromarray(np.asarray(arr))
    if mode is not None:
        im = im.convert(mode)
    bio = io.BytesIO()
    im.save(bio, fmt, **kw)
    return bio.getvalue()


def photo(h, w, seed, c=3):
    """Smooth colours with flat patches (runs, repeats) and some noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 17 + y * 3) % 256, (y * 23) % 256,
                     ((x + y) * 11) % 256, 255 - (x * y) % 256][:c], -1)
    noise = rng.integers(-3, 4, base.shape)
    img = np.clip(base + noise, 0, 255).astype(np.uint8)
    img[h // 3:h // 2] = img[h // 3, 0]
    return img


def ppm_variants():
    rng = np.random.default_rng(17)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    out = [(f"pil_{m}", pil_save(rgb, "PPM", m)) for m in ("1", "L", "RGB")]
    out.append(("pil_I16", pil_save(rng.integers(0, 65536, (H, W)).astype(
        np.int32), "PPM", "I")))
    out.append(("pil_F", pil_save(rng.normal(0, 100, (H, W)).astype(
        np.float32), "PPM")))
    grey = rgb[..., 0]
    bits = grey > 127
    out.append(("p1_plain", ims.write_pnm_plain(bits, b"P1",
                                                comment=b"made by hand")))
    out.append(("p1_plain_packed", b"P1\n13 9\n" + b"".join(
        b"".join(b"1" if v else b"0" for v in r) + b"\n" for r in ~bits)))
    for maxval in (255, 100, 1000, 65535):
        vals = (grey.astype(np.int64) * maxval // 255)
        out.append((f"p2_plain_max{maxval}",
                    ims.write_pnm_plain(vals, b"P2", maxval, b"grey")))
        out.append((f"p5_max{maxval}", ims.write_pnm_raw(vals, b"P5",
                                                         maxval)))
    for maxval in (255, 7, 4095, 65535):
        vals = (rgb.astype(np.int64) * maxval // 255)
        out.append((f"p3_plain_max{maxval}",
                    ims.write_pnm_plain(vals, b"P3", maxval, b"rgb")))
        out.append((f"p6_max{maxval}", ims.write_pnm_raw(vals, b"P6",
                                                         maxval)))
    # the maxval rules at the values PIL's scaling rounds
    out.append(("p5_max100_ramp", ims.write_pnm_raw(
        np.arange(0, 101).reshape(1, 101), b"P5", 100)))
    out.append(("p5_max1000_ramp", ims.write_pnm_raw(
        np.arange(0, 1001, 5).reshape(1, 201), b"P5", 1000)))
    out.append(("p6_header_comments", b"P6 # a comment\n13#no space\n 9\t"
                b"#x\r255\n" + rgb.tobytes()))
    out.append(("p6_over_maxval", ims.write_pnm_raw(
        np.full((2, 3, 3), 200), b"P6", 100)))
    img = rng.normal(0, 3, (H, W)).astype(np.float32)
    img[0, :3] = [np.inf, -np.inf, np.nan]
    out.append(("pfm_big_endian", ims.write_pfm(img, 2.5)))
    out.append(("pfm_little_endian", ims.write_pfm(img, -1.0)))
    cmyk = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    for magic in (b"P0CMYK", b"PyCMYK", b"PyRGBA"):
        out.append((magic.decode().lower(), b"%s\n%d %d\n255\n" % (
            magic, W, H) + cmyk.tobytes()))
    out.append(("pyp", b"PyP\n%d %d\n255\n" % (W, H) + grey.tobytes()))
    # a comment ends a line but not a token: "5#..." and "6" read as 56
    out.append(("p2_plain_comment_joins", b"P2\n3 2\n255\n1 2 # c\n3\n4 5#"
                + b"x" * 40 + b"\n6 7\n"))
    return out


def ppm_refused():
    rng = np.random.default_rng(18)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    p6 = ims.write_pnm_raw(rgb, b"P6", 255)
    return [
        ("truncated", p6[:-5], None),
        ("token_too_long", b"P6\n123456789012 3\n255\n", None),
        ("maxval_zero", b"P5\n2 2\n0\n\0\0\0\0", None),
        ("maxval_65536", b"P5\n2 2\n65536\n" + bytes(8), None),
        ("eof_in_header", b"P6\n13 ", None),
        ("plain_value_too_large", b"P2\n2 1\n10\n5 11\n", None),
        ("plain_negative", b"P2\n2 1\n10\n5 -1\n", None),
        ("plain_too_few", b"P3\n2 1\n255\n1 2 3 4\n", None),
        ("plain_bad_bit", b"P1\n2 2\n0 1 2 0\n", None),
        ("plain_token_too_long", b"P2\n2 1\n255\n12345678901 2\n", None),
        ("pfm_scale_zero", b"Pf\n1 1\n0.0\n" + bytes(4), None),
        ("pfm_scale_nan", b"Pf\n1 1\nnan\n" + bytes(4), None),
        ("unknown_magic", b"P7\n1 1\n255\n\0", None),
        ("zero_width", b"P5\n0 3\n255\n", None),
        ("not_a_number", b"P5\n1a 3\n255\n\0\0\0", None),
    ]


def tga_variants():
    rng = np.random.default_rng(19)
    rgba = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    rgba[2:5, 3:11] = rgba[2, 3]                   # runs for the RLE
    out = []
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        src = Image.fromarray(rgba[..., :2], "LA") if mode == "LA" \
            else Image.fromarray(rgba).convert(mode)
        for rle in (False, True):
            if mode == "1" and rle:
                continue                # PIL's own 1-bit RLE is unreadable
            for orient in (1, -1):
                bio = io.BytesIO()
                src.save(bio, "TGA", rle=rle, orientation=orient)
                out.append((f"pil_{mode}{'_rle' if rle else ''}"
                            f"{'_top' if orient == 1 else ''}",
                            bio.getvalue()))
    words = rng.integers(0, 65536, (H, W))
    words[0, :4] = [0x7FFF, 0x001F, 0x8000, 0xFFFF]
    words[3:6, 2:12] = words[3, 2]
    for itype in (2, 10):
        out.append((f"rgb16_type{itype}", ims.write_tga(
            words, itype=itype, depth=16)))
    idx = rng.integers(0, 40, (H, W))
    idx[1:3] = 7
    pal24 = rng.integers(0, 256, (35, 3))
    pal16 = rng.integers(0, 65536, 35)
    for itype in (1, 9):
        out.append((f"cmap24_start5_type{itype}", ims.write_tga(
            idx, itype=itype, depth=8, cmap=pal24, cmap_start=5)))
        out.append((f"cmap16_start5_type{itype}", ims.write_tga(
            idx, itype=itype, depth=8, cmap=pal16, cmap_depth=16,
            cmap_start=5)))
    out.append(("cmap24_256_entries", ims.write_tga(
        rng.integers(0, 256, (H, W)), itype=1, depth=8,
        cmap=rng.integers(0, 256, (256, 3)))))
    for top in (False, True):
        for mirror in (False, True):
            tag = (f"{'top' if top else 'bottom'}_"
                   f"{'mirror' if mirror else 'plain'}")
            out.append((f"rgb24_rle_{tag}", ims.write_tga(
                rgba[..., :3], itype=10, depth=24, top=top, mirror=mirror)))
            out.append((f"rgba32_{tag}", ims.write_tga(
                rgba, itype=2, depth=32, top=top, mirror=mirror)))
    out.append(("rgb24_rle_literals_cross_rows", ims.write_tga(
        rng.integers(0, 256, (H, W, 3)), itype=10, depth=24)))
    out.append(("grey8_rle_cross_rows", ims.write_tga(
        rng.integers(0, 256, (H, W)), itype=11, depth=8)))
    out.append(("la16_rle", ims.write_tga(rgba[..., :2], itype=11,
                                          depth=16)))
    out.append(("grey1", ims.write_tga(rgba[..., 0] > 127, itype=3,
                                       depth=1)))
    out.append(("id_field", ims.write_tga(rgba[..., :3], itype=2, depth=24,
                                          id_field=b"irgs test capture")))
    out.append(("grey8_with_cmap", ims.write_tga(
        idx, itype=3, depth=8, cmap=pal24)))
    return out


def tga_refused():
    rng = np.random.default_rng(20)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    raw = ims.write_tga(rgb, itype=2, depth=24)
    rle = ims.write_tga(rgb, itype=10, depth=24)
    flat = np.zeros((2, 2, 3), np.uint8)
    run_across = (struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, 2, 2,
                              24, 0x20) + bytes([0x83, 1, 2, 3]))
    return [
        ("truncated_raw", raw[:-7], None),
        ("truncated_rle", rle[:-7], None),
        ("run_across_rows", run_across, None),
        ("cmap32", ims.write_tga(np.zeros((2, 2)), itype=1, depth=8,
                                 cmap=np.zeros((4, 4)), cmap_depth=32), None),
        ("cmap15", ims.write_tga(np.zeros((2, 2)), itype=1, depth=8,
                                 cmap=np.zeros(4), cmap_depth=15), None),
        ("cmap_past_256", ims.write_tga(np.zeros((2, 2)), itype=1, depth=8,
                                        cmap=np.zeros((200, 3)),
                                        cmap_start=100), None),
        ("colormapped_without_map", ims.write_tga(
            np.zeros((2, 2)), itype=1, depth=8), None),
        ("rgb_with_cmap", ims.write_tga(flat, itype=2, depth=24,
                                        cmap=np.zeros((4, 3))), None),
        ("grey24", ims.write_tga(np.zeros((2, 2, 3)), itype=3, depth=24),
         None),
        ("grey1_rle", ims.write_tga(np.zeros((2, 8), bool), itype=11,
                                    depth=1)[:18] + bytes([0x81, 0, 0x81,
                                                           0]), None),
        ("short_header", raw[:17], None),
        ("zero_width", raw[:12] + b"\0\0" + raw[14:], None),
        ("depth15", raw[:16] + b"\x0f" + raw[17:], None),
    ]


def _png(arr, mode=None):
    return pil_save(arr, "PNG", mode)


def ico_variants():
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
    img[..., 3] = np.where(rng.random((32, 32)) < 0.3, 0, 255)
    out = [("pil_png_sizes", pil_save(img, "ICO", sizes=[(16, 16), (32, 32),
                                                         (24, 24)]))]
    for mode in ("RGBA", "RGB", "P", "L", "1"):
        out.append((f"pil_bmp_{mode}", pil_save(
            img, "ICO", mode, sizes=[(16, 16)], bitmap_format="bmp")))
    s = 16
    small = img[:s, :s]
    mask = rng.random((s, s)) < 0.25
    pal = rng.integers(0, 256, (16, 3))
    idx4 = rng.integers(0, 16, (s, s))
    pal8 = rng.integers(0, 256, (256, 3))
    idx8 = rng.integers(0, 256, (s, s))
    f4 = ims.dib_frame(idx4, bits=4, palette=pal, and_mask=mask)
    f8 = ims.dib_frame(idx8, bits=8, palette=pal8, and_mask=mask)
    f24 = ims.dib_frame(small[..., :3], bits=24, and_mask=mask)
    f32 = ims.dib_frame(small, bits=32)
    f1 = ims.dib_frame(idx4 & 1, bits=1, palette=[(9, 9, 9), (250, 0, 3)],
                       and_mask=mask)
    png32 = _png(img)
    for name, f, bpp, colors in (("dib4", f4, 4, 16), ("dib8", f8, 8, 0),
                                 ("dib24", f24, 24, 0), ("dib32", f32, 32, 0),
                                 ("dib1", f1, 1, 2)):
        out.append((f"{name}_masked", ims.write_ico([(f, s, s, bpp,
                                                      colors)])))
    # the same size twice: PIL takes the lower colour depth
    out.append(("mixed_bmp_png", ims.write_ico([
        (f4, s, s, 4, 16), (png32, 32, 32, 32, 0),
        (ims.dib_frame(img[..., :3], bits=24, and_mask=rng.random((32, 32))
                       < 0.5), 32, 32, 24, 0), (f8, s, s, 8, 0)])))
    out.append(("png_p_frame", ims.write_ico([
        (_png(img[..., :3], "P"), 32, 32, 8, 0), (f32, s, s, 32, 0)])))
    # a directory that disagrees with its frame's size
    out.append(("frame_size_differs", ims.write_ico([(f24, 20, 20, 24, 0)])))
    # an entry whose bpp field says 32 on an 8-bit DIB: alpha from its bytes
    out.append(("bpp_field_32_on_dib8", ims.write_ico([
        (f8 + bytes(4 * s * s), s, s, 32, 0)])))
    cur32 = ims.dib_frame(small, bits=32, and_mask=mask)
    out.append(("cur_32_alpha", ims.write_ico([(cur32, s, s, 32, 0)],
                                              cur=True, hotspot=(3, 4))))
    out.append(("cur_8_two_entries", ims.write_ico([
        (f4, s, s, 4, 16), (ims.dib_frame(rng.integers(0, 256, (24, 24)),
                                          bits=8, palette=pal8), 24, 24, 8,
                            0)], cur=True)))
    out.append(("cur_24_second_not_larger", ims.write_ico([
        (f24, s, s, 24, 0), (f8, s, s, 8, 0)], cur=True)))
    for mode in ("1", "L", "P", "RGB"):
        out.append((f"dib_pil_{mode}", pil_save(img[..., :3], "DIB", mode)))
    out.append(("dib_rgba_v5_bitfields", ims.write_bmp(
        small, bits=32, header=124, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))[14:]))
    out.append(("dib_rgb555", ims.write_bmp(
        rng.integers(0, 65536, (7, 5)), bits=16)[14:]))
    return out


def ico_refused():
    rng = np.random.default_rng(22)
    s = 16
    mask = rng.random((s, s)) < 0.25
    f24 = ims.dib_frame(rng.integers(0, 256, (s, s, 3)), bits=24,
                        and_mask=mask)
    ico = ims.write_ico([(f24, s, s, 24, 0)])
    return [
        ("mask_cut", ico[:-20], None),
        ("frame_cut", ims.write_ico([(f24[:200], s, s, 24, 0)]), None),
        ("no_entries", b"\0\0\1\0\0\0", None),
        ("directory_cut", ico[:15], None),
        ("cur_no_entries", b"\0\0\2\0\0\0" + bytes(40), None),
        ("dib_cut", ims.write_bmp(rng.integers(0, 256, (s, s, 3)),
                                  bits=24)[14:-30], None),
        ("png_frame_bad_crc", ims.write_ico([(
            _png(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))[:29]
            + b"\0\0\0\0" + _png(rng.integers(0, 256, (8, 8, 3)).astype(
                np.uint8))[33:], 8, 8, 32, 0)]), None),
    ]


def qoi_stream(w, h, channels, ops: bytes) -> bytes:
    return (b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops
            + b"\0" * 7 + b"\1")


def qoi_variants():
    rng = np.random.default_rng(23)
    out = []
    for mode in ("RGB", "RGBA"):
        img = photo(H * 2, W * 2, 3, 4)
        out.append((f"pil_{mode}", pil_save(img, "QOI", mode)))
        out.append((f"pil_{mode}_noise", pil_save(
            rng.integers(0, 256, (H, W, 4)).astype(np.uint8), "QOI", mode)))
    # every op by hand: RGBA in an RGB file, an index never written,
    # DIFF, LUMA, a run past the image
    ops = bytes([0xFF, 10, 20, 30, 128, 0x05, 0x40 | 0x3F, 0x80 | 40, 0x9C,
                 0xFE, 1, 2, 3, 0x00 | ((10 * 3 + 20 * 5 + 30 * 7 + 128 * 11)
                                        % 64), 0xC0 | 61])
    out.append(("ops_rgb", qoi_stream(4, 5, 3, ops)))
    out.append(("ops_rgba", qoi_stream(4, 5, 4, ops)))
    out.append(("channels_7_reads_rgba", qoi_stream(2, 2, 7, bytes(
        [0xC0 | 3]))))
    return out


def qoi_refused():
    data = pil_save(photo(H, W, 4), "QOI")
    return [("truncated", data[:30], None),
            ("cut_rgba_op", qoi_stream(2, 1, 4, bytes([0xFF, 1, 2]))[:17],
             None),
            ("short_header", data[:12], None),
            ("zero_height", qoi_stream(3, 0, 3, b""), None)]


def pcx_variants():
    rng = np.random.default_rng(24)
    out = []
    big = photo(32, 33, 5)
    for mode in ("1", "L", "P", "RGB"):
        out.append((f"pil_{mode}", pil_save(big, "PCX", mode)))
    pal16 = rng.integers(0, 256, (16, 3))
    for planes in (2, 4):
        for w in (13, 16, 21):
            idx = rng.integers(0, 1 << planes, (H, w))
            out.append((f"bits1_planes{planes}_w{w}", ims.write_pcx(
                idx, bits=1, planes=planes, header_palette=pal16)))
            out.append((f"bits1_planes{planes}_w{w}_stride_exact",
                        ims.write_pcx(idx, bits=1, planes=planes,
                                      header_palette=pal16,
                                      stride=(w + 7) // 8)))
    rgb = rng.integers(0, 256, (24, 35, 3))
    out.append(("rgb_odd_width_padded", ims.write_pcx(rgb, bits=8, planes=3)))
    out.append(("rgb_odd_width_exact", ims.write_pcx(rgb, bits=8, planes=3,
                                                     stride=35)))
    grey = rng.integers(0, 256, (30, 31))
    out.append(("grey_ramp_palette", ims.write_pcx(
        grey, bits=8, planes=1, palette=np.repeat(np.arange(256)[:, None], 3,
                                                  1))))
    out.append(("p8_palette_origin", ims.write_pcx(
        grey, bits=8, planes=1, palette=rng.integers(0, 256, (256, 3)),
        origin=(5, 7))))
    out.append(("grey_no_palette", ims.write_pcx(
        grey, bits=8, planes=1) + bytes(800)))
    out.append(("bits1_version0", ims.write_pcx(
        rng.random((H, 19)) < 0.5, bits=1, planes=1, version=0)))
    return out


def pcx_refused():
    rng = np.random.default_rng(25)
    small = ims.write_pcx(rng.integers(0, 256, (4, 4)), bits=8, planes=1)
    rgb = ims.write_pcx(rng.integers(0, 256, (20, 20, 3)), bits=8, planes=3)
    head = bytearray(rgb[:128])
    head[3] = 2
    over = bytearray(ims.write_pcx(np.zeros((2, 4), np.uint8), bits=8,
                                   planes=1)) + bytes(800)
    over[128] = 0xC0 | 9
    return [("p8_shorter_than_palette", small, None),
            ("truncated", rgb[:-40], None),
            ("bits2_planes1", bytes(head) + rgb[128:], None),
            ("run_past_line", bytes(over), None),
            ("empty_box", rgb[:4] + struct.pack("<H", 30) + rgb[6:], None),
            ("short_header", rgb[:60], None)]


def sgi_variants():
    rng = np.random.default_rng(26)
    out = []
    img = photo(H, W, 6, 4)
    for mode in ("L", "RGB", "RGBA"):
        for bpc in (1, 2):
            out.append((f"pil_{mode}_bpc{bpc}", pil_save(img, "SGI", mode,
                                                         bpc=bpc)))
    img16 = img.astype(np.uint16) * 256 + rng.integers(0, 256, img.shape,
                                                       dtype=np.uint16)
    for z, mode in ((1, "L"), (3, "RGB"), (4, "RGBA")):
        a8 = img[..., 0] if z == 1 else img[..., :z]
        a16 = img16[..., 0] if z == 1 else img16[..., :z]
        out.append((f"rle_{mode}", ims.write_sgi(a8, bpc=1)))
        out.append((f"rle_{mode}_bpc2", ims.write_sgi(a16, bpc=2)))
        out.append((f"rle_{mode}_unshared", ims.write_sgi(
            a8, bpc=1, share_rows=False)))
    out.append(("rle_noise", ims.write_sgi(rng.integers(0, 256, (H, W, 3)))))
    out.append(("raw_dimension1", ims.write_sgi(img[:1, :, 0], rle=False,
                                                dimension=1)))
    # a row whose length field is one byte: the decoder stops there, with
    # no error, and the rows not reached stay 0
    data = bytearray(ims.write_sgi(img[..., :3], bpc=1, share_rows=False))
    length_at = 512 + 4 * H * 3 + 4 * 4
    data[length_at:length_at + 4] = struct.pack(">I", 1)
    out.append(("rle_stops_silently", bytes(data)))
    # a row of green ending early: the line buffer keeps the row before
    data = bytearray(ims.write_sgi(img[..., :3], bpc=1, share_rows=False))
    start_at = 512 + 4 * (H + 2)
    (off,) = struct.unpack_from(">I", data, start_at)
    data[off] = 0
    out.append(("rle_row_carries_over", bytes(data)))
    out.append(("raw_dimension1_bpc2", ims.write_sgi(
        img16[:1, :, 0], bpc=2, rle=False, dimension=1)))
    return out


def sgi_refused():
    rng = np.random.default_rng(27)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    rle = bytearray(ims.write_sgi(img, bpc=1))
    past = bytearray(rle)
    past[512:516] = struct.pack(">I", len(rle) + 10)
    raw = pil_save(img, "SGI")
    two = bytearray(raw)
    two[10:12] = struct.pack(">H", 2)
    return [("rle_offset_past_end", bytes(past), None),
            ("rle_offset_in_header", bytes(rle[:512]) + struct.pack(
                ">I", 100) + bytes(rle[516:]), None),
            ("rle_tables_cut", bytes(rle[:600]), None),
            ("raw_truncated", raw[:-9], None),
            ("two_channels", bytes(two), None),
            ("compression_2", raw[:2] + b"\2" + raw[3:], None),
            ("short_header", raw[:11], None)]


VARIANTS = {"ppm": (ppm_variants, ppm_refused),
            "tga": (tga_variants, tga_refused),
            "ico": (ico_variants, ico_refused),
            "qoi": (qoi_variants, qoi_refused),
            "pcx": (pcx_variants, pcx_refused),
            "sgi": (sgi_variants, sgi_refused)}

# the COLMAP capture: (file, layout) for each view of tests/data/webp/colmap
CAPTURE_FRAMES = (("view_000.tga", "targa_rle_rgb"),
                  ("view_001.rgb", "iris_rle_rgb"),
                  ("view_002.ppm", "ppm_p6"),
                  ("view_003.tga", "targa_raw_rgba_bottom_left"))


def write_colmap_capture(root: str) -> None:
    import shutil
    sys.path.insert(0, os.path.dirname(HERE))
    from irgs_tpu_torch.scene import colmap

    src = os.path.join(DATA, "webp", "colmap")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "sparse", "0"))
    for f in ("cameras.bin", "points3D.bin"):
        shutil.copy(os.path.join(src, "sparse", "0", f),
                    os.path.join(root, "sparse", "0", f))
    images = colmap.read_images_bin(os.path.join(src, "sparse", "0",
                                                 "images.bin"))
    with open(os.path.join(root, "sparse", "0", "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for (iid, im), (name, kind) in zip(sorted(images.items()),
                                           CAPTURE_FRAMES):
            with Image.open(os.path.join(src, "images", im["name"])) as pim:
                arr = np.asarray(pim.convert("RGBA"))
            rgb = np.ascontiguousarray(arr[..., :3])
            if kind == "targa_rle_rgb":
                data = pil_save(rgb, "TGA", rle=True)
            elif kind == "iris_rle_rgb":
                data = ims.write_sgi(rgb, bpc=1)
            elif kind == "ppm_p6":
                data = pil_save(rgb, "PPM")
            else:
                data = pil_save(arr, "TGA", orientation=-1)
            with open(os.path.join(root, "images", name), "wb") as fh:
                fh.write(data)
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im["qvec"]))
            f.write(struct.pack("<ddd", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


if __name__ == "__main__":
    for fmt, (variants, refused) in VARIANTS.items():
        ims.save_fixtures(os.path.join(DATA, fmt), variants(), refused(),
                          FORMATS[fmt])
        print(f"wrote {len(variants())} {fmt} fixtures")
    write_colmap_capture(os.path.join(DATA, "tga", "colmap"))
