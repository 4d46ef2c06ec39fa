"""Write the fixtures of Pillow's last small rasters (with PIL, here only):
tests/data/im (Pillow's IM saves in every mode it writes; hand-made
headers for P;2/P;4, RGB3, X 24, the float family F;8 to F;32F, n-bit
L*n images through the bit decoder, I;32, grey and colour LUTs, frame
stacks, CRLF and NUL-ended headers), xbm (Pillow's saves, hotspots,
upper-case hex), xpm (P with #rrggbb colours and a transparent key, more
than 256 colours as RGB, two characters a pixel), sun (depths 1, 4, 8,
24 and 32, raw and RLE, colour maps, type 3; runs across rows), msp
(Pillow's version 1 saves and hand-made version 2 RLE), spider (Pillow's
saves, big-endian, stacks, floats out of 0..255 and NaN), fits (every
BITPIX, NAXIS 1, an extension unit, fits_gzip tiles), dcx (PCX frames in
a DCX table), fli (BRUN, COPY, BLACK, LC and SS2 frames, COLOR_256 and
COLOR_64 palettes with partial packets, a PSTAMP chunk), pcd (the
768x512 base image at orientations 0 and 1), pixar, gbr (versions 1 and
2, L and RGBA), mcidas (L, I;16B and I;32B with a stride and prefix),
imt, xvthumb and iptc (raw grey, a band of an RGB and a CMYK image,
JPEG). Beside each file the ``.npy`` PIL decodes from it (for the
768x512 PhotoCD images the SHA-256 of PIL's array in ``pcd/large.json``
instead) and, in ``modes.json``, its mode, palette and transparency;
``refused/`` holds streams PIL refuses. ``cv2/`` holds Sun raster and
PAM files (cv2's writes and hand-made ones) with the ``.npy`` of
``cv2.imread(..., IMREAD_UNCHANGED)``. Then ``im_sun_xpm_fli/colmap/``:
the four 400x400 views of tests/data/webp/colmap as an RGB IM (Pillow's
encoder), a 24-bit RLE Sun raster, a P XPM of up to 256 colours from
PIL's quantized view, and an FLI frame as BRUN with a COLOR_256 chunk,
with that capture's cameras and points.

    python tests/make_im_sun_xpm_fli_fixtures.py
"""

from __future__ import annotations

import gzip
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
FORMATS = {"im": ".im", "xbm": ".xbm", "xpm": ".xpm", "sun": ".ras",
           "msp": ".msp", "spider": ".spi", "fits": ".fits", "dcx": ".dcx",
           "fli": ".fli", "pcd": ".pcd", "pixar": ".pxr", "gbr": ".gbr",
           "mcidas": ".area", "imt": ".imt", "xvthumb": ".xv",
           "iptc": ".iim"}
H, W = 9, 13


def pil_save(arr, fmt, mode=None, **kw) -> bytes:
    im = Image.fromarray(np.asarray(arr))
    if mode is not None:
        im = im.convert(mode)
    return save_image(im, fmt, **kw)


def save_image(im, fmt, **kw) -> bytes:
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


# ---------------------------------------------------------------- IM
def im_file(lines, data=b"", lut=None, pad=True, crlf=True) -> bytes:
    nl = b"\r\n" if crlf else b"\n"
    head = b"".join(ln.encode("latin-1") + nl for ln in lines)
    if pad:
        head += b"\0" * (511 - len(head))
    head += b"\x1a"
    return head + (lut or b"") + data


def im_variants():
    rng = np.random.default_rng(21)
    rgb = photo(H, W, 1)
    rgba = photo(H, W, 2, 4)
    grey = rgb[..., 0]
    out = []
    for mode, arr in (("1", grey > 100), ("L", grey), ("RGB", rgb),
                      ("RGBA", rgba), ("CMYK", rgba), ("LA", rgba[..., :2]),
                      ("I", (grey.astype(np.int32) - 100) * 70001),
                      ("F", grey.astype(np.float32) * 1.7 - 60.25),
                      ("I;16", grey.astype(np.uint16) * 257)):
        im = Image.fromarray(np.asarray(arr)) if mode not in (
            "CMYK", "LA") else Image.fromarray(arr, "RGBA" if mode == "CMYK"
                                               else "LA")
        if mode == "CMYK":
            im = Image.frombytes("CMYK", im.size, im.tobytes())
        if mode == "I;16":
            im = Image.frombytes("I;16", im.size, arr.astype("<u2").tobytes())
        out.append((f"pil_{mode.replace(';', '')}", save_image(im, "IM")))
    for mode in ("I;16L", "I;16B"):
        im = Image.frombytes(mode, (W, H), rng.integers(
            0, 256, 2 * W * H, np.uint8).tobytes())
        out.append((f"pil_{mode.replace(';', '')}", save_image(im, "IM")))
    im = Image.frombytes("RGBX", (W, H), rgba.tobytes())
    out.append(("pil_RGBX", save_image(im, "IM")))
    im = Image.frombytes("YCbCr", (W, H), rgb.tobytes())
    out.append(("pil_YCbCr", save_image(im, "IM")))
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=40)
    out.append(("pil_P_lut", save_image(pal, "IM")))
    pa = Image.frombytes("PA", (W, H), np.stack(
        [np.asarray(pal), grey], -1).tobytes())
    pa.putpalette(pal.getpalette())
    out.append(("pil_PA_lut", save_image(pa, "IM")))
    size = f"Image size (x*y): {W}*{H}"
    for bits, typ in ((2, "B2"), (4, "B4")):
        row = (W * bits + 7) // 8
        out.append((f"P_{bits}bit", im_file(
            [f"Image type: {typ} image", size],
            rng.integers(0, 256, row * H, np.uint8).tobytes())))
    out.append(("rgb3_planes", im_file(
        ["Image type: RGB3 image", size],
        rng.integers(0, 256, 3 * W * H, np.uint8).tobytes())))
    out.append(("x24", im_file(["Image type: X 24 image", size],
                               rgb[::-1].tobytes(), crlf=False)))
    for typ, nbytes in (("L 8 image", 1), ("L 8S image", 1),
                        ("L 16 image", 2), ("L*16S image", 2),
                        ("L 32 image", 4), ("L 32 F image", 4),
                        ("L 32 S image", 4), ("L 32S image", 4)):
        data = rng.integers(0, 256, nbytes * W * H, np.uint8).tobytes()
        name = "t_" + typ.replace(" ", "_").replace("*", "x")
        out.append((name, im_file([f"Image type: {typ}", size], data)))
    f32 = (rng.random(W * H) * 600 - 150).astype("<f4")
    f32[3] = np.nan
    out.append(("t_L_32F_image", im_file(["Image type: L 32F image", size],
                                         f32.tobytes())))
    for bits in (2, 3, 5, 7, 12, 13, 24, 31):
        data = rng.integers(0, 256, (W * bits + 7) // 8 * H + 8,
                            np.uint8).tobytes()
        out.append((f"bits_{bits}", im_file(
            [f"Image type: L*{bits} image", size], data)))
    # a grey LUT that is not the ramp: PIL keeps it aside, pixels as stored
    lut = bytes((255 - i) for i in range(256)) * 3
    out.append(("grey_lut", im_file(["Image type: Greyscale image", size,
                                     "Lut: 1"], grey[::-1].tobytes(), lut)))
    lut = rng.integers(0, 256, 768, np.uint8).tobytes()
    out.append(("colour_lut_on_L", im_file(
        ["Image type: Greyscale image", size, "Lut: 1"],
        grey[::-1].tobytes(), lut)))
    out.append(("frames_two", im_file(
        ["Image type: Greyscale image", size,
         "File size (no of images): 2", "Comment: first", "Comment: two"],
        rng.integers(0, 256, 2 * W * H, np.uint8).tobytes())))
    out.append(("nul_ended_short_header", im_file(
        [size, "Name: x.im"], grey[::-1].tobytes(), pad=False)))
    return out


def im_refused():
    rng = np.random.default_rng(22)
    size = f"Image size (x*y): {W}*{H}"
    data = rng.integers(0, 256, 4 * W * H, np.uint8).tobytes()
    return [
        ("rlb_unknown_rawmode", im_file(["Image type: RLB image", size],
                                        data), None),
        ("pa_without_lut", im_file(["Image type: PA image", size], data),
         None),
        ("float_size", im_file(["Image size (x*y): 3.5*2"], data), None),
        ("cut_data", im_file(["Image type: RGB image", size], data[:50]),
         None),
        ("bad_size_number", im_file(["Image size (x*y): 3*y"], data), None),
    ]


# ---------------------------------------------------------------- XBM
def xbm_variants():
    grey = photo(H, W, 3)[..., 0]
    img = Image.fromarray(grey > 120)
    out = [("pil_save", save_image(img, "XBM")),
           ("pil_save_hotspot", save_image(img, "XBM", hotspot=(3, 4)))]
    bits = np.packbits(grey[:5, :11] > 90, axis=1, bitorder="little")
    body = ", ".join(f"0x{v:02X}" for v in bits.ravel())
    out.append(("upper_hex_crlf", (
        "#define a_width 11\r\n#define a_height 5\r\n"
        f"static char a_bits[] = {{\r\n{body}\r\n}};\r\n").encode()))
    out.append(("odd_digits", (
        "#define a_width 9\n#define a_height 2\n"
        "static char a_bits[] = { 0xzz, 0x1g, 0xAb, 0x7 , 0x80 };\n"
    ).encode()))
    return out


def xbm_refused():
    grey = photo(H, W, 3)[..., 0]
    data = save_image(Image.fromarray(grey > 120), "XBM")
    return [("cut_data", data[:len(data) // 2], None)]


# ---------------------------------------------------------------- XPM
def xpm_file(w, h, colours, rows, cpp=1, pixels_comment=True) -> bytes:
    out = [b"/* XPM */", b"static char *x[] = {",
           b'"%d %d %d %d",' % (w, h, len(colours), cpp)]
    for key, value in colours:
        out.append(b'"' + key + b" c " + value + b'",')
    if pixels_comment:
        out.append(b"/* pixels */")
    out += [b'"' + r + b'",' for r in rows]
    out.append(b"};")
    return b"\n".join(out) + b"\n"


def xpm_from_p(im, cpp=2, none_key=None) -> bytes:
    """A P image as an XPM: each palette entry #rrggbb, keys of `cpp`
    characters."""
    idx = np.asarray(im)
    pal = np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)
    n = int(idx.max()) + 1
    alphabet = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    keys = [bytes([alphabet[i % 52], alphabet[i // 52]])[:cpp]
            for i in range(n)]
    colours = [(k, b"#%02x%02x%02x" % tuple(pal[i]))
               for i, k in enumerate(keys)]
    if none_key is not None:
        colours.append((none_key, b"None"))
    rows = [b"".join(keys[v] for v in row) for row in idx]
    return xpm_file(idx.shape[1], idx.shape[0], colours, rows, cpp)


def xpm_variants():
    rgb = photo(H, W, 5)
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=30)
    out = [("p_two_chars", xpm_from_p(pal)),
           ("p_one_char", xpm_from_p(pal, cpp=1)),
           ("p_unused_none_key", xpm_from_p(pal, none_key=b"~~"))]
    big = photo(20, 16, 6)
    colours = [(b"%03x" % i, b"#%02x%02x%02x" % tuple(big.reshape(
        -1, 3)[i])) for i in range(300)]
    rows = [b"".join(b"%03x" % ((y * 16 + x) % 300) for x in range(16))
            for y in range(20)]
    out.append(("rgb_over_256_colours", xpm_file(16, 20, colours, rows, 3)))
    out.append(("short_hex_and_extra_keys", xpm_file(
        3, 2, [(b"a", b"#f0 s blue"), (b"b", b"#123456 m white")],
        [b"aba", b"bba"], pixels_comment=False)))
    out.append(("rows_split_unaligned", xpm_file(
        4, 2, [(b"a", b"#ff0000"), (b"b", b"#00ff00")],
        [b"ababa", b"ab", b"a", b"bbbb"])))
    return out


def xpm_refused():
    return [
        ("named_colour", xpm_file(2, 1, [(b"a", b"red")], [b"aa"]), None),
        ("none_key_used", xpm_file(2, 1, [(b"a", b"#ffffff"),
                                          (b"b", b"None")], [b"ab"]), None),
        ("unknown_key", xpm_file(2, 1, [(b"a", b"#ffffff")], [b"ax"]), None),
        ("too_few_rows", xpm_file(2, 3, [(b"a", b"#ffffff")], [b"aa"]),
         None),
    ]


# ---------------------------------------------------------------- SUN
def _sun_rows(rows: np.ndarray) -> bytes:
    """[h, rowbytes] -> rows padded to 16 bits."""
    if rows.shape[1] % 2:
        rows = np.concatenate([rows, np.zeros((len(rows), 1), np.uint8)], 1)
    return rows.tobytes()


def sun_variants():
    rng = np.random.default_rng(23)
    rgb = photo(H, W, 7)
    grey = rgb[..., 0]
    bits = np.packbits(grey > 110, axis=1)
    nib = (grey >> 4)
    nib_rows = np.packbits(np.unpackbits(nib.astype(np.uint8)[..., None],
                                         axis=-1)[..., 4:].reshape(H, -1),
                           axis=1)
    cmap = rng.integers(0, 256, 3 * 200, np.uint8).tobytes()
    out = [
        ("d1_raw", ims.write_sun(W, H, 1, _sun_rows(bits))),
        ("d1_rle", ims.write_sun(W, H, 1, ims.sun_rle(bits.tobytes()), 2)),
        ("d4_raw", ims.write_sun(W, H, 4, _sun_rows(nib_rows))),
        ("d8_raw", ims.write_sun(W, H, 8, _sun_rows(grey))),
        ("d8_rle", ims.write_sun(W, H, 8, ims.sun_rle(grey.tobytes()), 2)),
        ("d8_cmap", ims.write_sun(W, H, 8, _sun_rows(grey), cmap=cmap)),
        ("d8_cmap_rle", ims.write_sun(W, H, 8, ims.sun_rle(grey.tobytes()), 2,
                                 cmap)),
        ("d8_cmap_ragged", ims.write_sun(W, H, 8, _sun_rows(grey // 2),
                                    cmap=cmap[:100])),
        ("d4_cmap", ims.write_sun(W, H, 4, _sun_rows(nib_rows),
                                  cmap=cmap[:48])),
        ("d24_bgr", ims.write_sun(W, H, 24, _sun_rows(
            rgb[..., ::-1].reshape(H, -1)))),
        ("d24_type3_rgb", ims.write_sun(W, H, 24, _sun_rows(
            rgb.reshape(H, -1)), 3)),
        ("d24_rle", ims.write_sun(W, H, 24, ims.sun_rle(
            rgb[..., ::-1].tobytes()), 2)),
        ("d32_xbgr", ims.write_sun(W, H, 32, np.concatenate(
            [np.zeros((H, W, 1), np.uint8), rgb[..., ::-1]], -1).tobytes())),
        ("d32_type3", ims.write_sun(W, H, 32, np.concatenate(
            [rgb, np.full((H, W, 1), 7, np.uint8)], -1).tobytes(), 3)),
        ("type0_old", ims.write_sun(W, H, 8, _sun_rows(grey), 0)),
        ("type4_tiff", ims.write_sun(W, H, 8, _sun_rows(grey), 4)),
        # a run over the end of one row into the next, and one of 256
        ("rle_runs_across_rows", ims.write_sun(5, 3, 8, bytes(
            [0x80, 6, 9, 1, 2, 0x80, 0, 0x80, 4, 3]), 2)),
        ("rle_run_256_across", ims.write_sun(100, 4, 8, bytes(
            [0x80, 255, 7] + [0x80, 99, 1] * 2), 2)),
    ]
    return out


def sun_refused():
    grey = photo(H, W, 7)[..., 0]
    return [
        ("cmap_on_24bit", ims.write_sun(W, H, 24, bytes(3 * W * H + H),
                                   cmap=bytes(48)), None),
        ("cut_raw", ims.write_sun(W, H, 8, _sun_rows(grey)[:40]), None),
        ("cut_rle", ims.write_sun(W, H, 8, ims.sun_rle(grey.tobytes())[:30],
                                  2), None),
    ]


# ---------------------------------------------------------------- MSP
def msp_header(magic, w, h) -> bytes:
    """The 32-byte header: magic, size, and a checksum word that makes the
    sixteen words XOR to 0."""
    words = [0] * 14
    words[0:2] = struct.unpack("<HH", magic)
    words[2], words[3] = w, h
    chk = 0
    for v in words:
        chk ^= v
    return struct.pack("<14H", *words) + struct.pack("<H", chk) + bytes(2)


def msp_rle_row(row: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 255:
            j += 1
        if j - i >= 3:
            out += bytes([0, j - i, row[i]])
            i = j
        else:
            k = i
            while k < len(row) and k - i < 255 and not (
                    k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            out += bytes([k - i]) + row[i:k]
            i = k
    return bytes(out)


def msp_v2(bits: np.ndarray, empty=(), extra_rows=None) -> bytes:
    h, w = bits.shape
    rows = [np.packbits(bits[y]).tobytes() for y in range(h)]
    enc = [b"" if y in empty else msp_rle_row(r) for y, r in enumerate(rows)]
    if extra_rows:
        enc = [extra_rows.get(y, e) for y, e in enumerate(enc)]
    rowmap = struct.pack(f"<{h}H", *[len(e) for e in enc])
    return msp_header(b"LinS", w, h) + rowmap + b"".join(enc)


def msp_variants():
    grey = photo(H, 21, 8)[..., 0]
    bits = grey > 100
    big = photo(40, 64, 9)[..., 0] > 128
    return [
        ("v1_pil", save_image(Image.fromarray(bits), "MSP")),
        ("v1_pil_64", save_image(Image.fromarray(big), "MSP")),
        ("v2_rle", msp_v2(bits)),
        ("v2_rle_64", msp_v2(big)),
        ("v2_empty_rows_white", msp_v2(bits, empty=(2, 5))),
        # a row whose runs give more bytes than a row: the rows after it
        # shift, as PIL concatenates them
        ("v2_long_row_shifts", msp_v2(bits, extra_rows={
            1: bytes([0, 5, 0x55])})),
    ]


def msp_refused():
    bits = photo(H, 21, 8)[..., 0] > 100
    v2 = msp_v2(bits)
    hdr = bytearray(msp_header(b"LinS", 21, H))
    return [
        ("v2_cut_row", v2[:len(v2) - 5], None),
        ("v2_cut_row_map", bytes(hdr) + bytes(6), None),
        ("v2_run_past_row", msp_v2(bits, extra_rows={0: bytes([3, 1, 0])}),
         None),
        ("v1_cut", save_image(Image.fromarray(bits), "MSP")[:40], None),
    ]


# ---------------------------------------------------------------- SPIDER
def spider_header(w, h, order="<", istack=0, imgnumber=0,
                  maxim=0) -> bytes:
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4)
    hdr[0], hdr[1], hdr[2], hdr[4] = 1.0, float(h), float(h), 1.0
    hdr[11], hdr[12], hdr[21], hdr[22] = (float(w), float(labrec),
                                          float(labbyt), float(lenbyt))
    hdr[23], hdr[25], hdr[26] = float(istack), float(maxim), float(imgnumber)
    return struct.pack(f"{order}{len(hdr)}f", *hdr)


def spider_variants():
    rng = np.random.default_rng(24)
    f = (photo(H, W, 10)[..., 0].astype(np.float32) * 1.3 - 40.5)
    f[0, 0], f[1, 1], f[2, 2] = np.nan, 300.25, -7.75
    out = [("pil_save", save_image(Image.fromarray(f, "F"), "SPIDER"))]
    out.append(("big_endian", spider_header(W, H, ">") + f.astype(
        ">f4").tobytes()))
    out.append(("little_endian_wide", spider_header(300, 2, "<") + (
        rng.random(600) * 512 - 128).astype("<f4").tobytes()))
    img2 = rng.random((H, W)).astype(np.float32) * 255
    out.append(("stack_first_image", spider_header(W, H, ">", istack=2,
                                                   maxim=2)
                + spider_header(W, H, ">", imgnumber=1)
                + f.astype(">f4").tobytes()
                + spider_header(W, H, ">", imgnumber=2)
                + img2.astype(">f4").tobytes()))
    return out


def spider_refused():
    f = photo(H, W, 10)[..., 0].astype(np.float32)
    return [
        ("image_in_stack", spider_header(W, H, "<", imgnumber=1)
         + f.tobytes(), None),
        ("cut", spider_header(W, H, "<") + f.tobytes()[:30], None),
    ]


# ---------------------------------------------------------------- FITS
def fits_cards(cards) -> bytes:
    out = b""
    for key, value in cards:
        if key == "END":
            out += b"END".ljust(80)
        else:
            out += (key.ljust(8) + "= " + str(value).rjust(20)).ljust(
                80).encode()
    return out + b" " * (-len(out) % 2880)


def fits_file(bitpix, data: bytes, naxes, extra=()) -> bytes:
    cards = [("SIMPLE", "T"), ("BITPIX", bitpix), ("NAXIS", len(naxes))]
    cards += [(f"NAXIS{i + 1}", n) for i, n in enumerate(naxes)]
    cards += list(extra) + [("END", None)]
    return fits_cards(cards) + data + b"\0" * (-len(data) % 2880)


def fits_gzip_file(w, h, zbitpix, words: np.ndarray) -> bytes:
    """An empty primary unit and a BINTABLE extension whose heap holds one
    gzip stream of 4-byte big-endian words, one a pixel."""
    primary = fits_cards([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0),
                          ("END", None)])
    table = bytes(8 * 1)          # NAXIS1 x NAXIS2 bytes before the heap
    heap = gzip.compress(words.astype(">u4").tobytes(), mtime=0)
    ext = fits_cards([("XTENSION", "'BINTABLE'"), ("BITPIX", 8),
                      ("NAXIS", 2), ("NAXIS1", 8), ("NAXIS2", 1),
                      ("ZIMAGE", "T"), ("ZCMPTYPE", "'GZIP_1  '"),
                      ("ZBITPIX", zbitpix), ("ZNAXIS", 2), ("ZNAXIS1", w),
                      ("ZNAXIS2", h), ("END", None)])
    data = table + heap
    return primary + ext + data + b"\0" * (-len(data) % 2880)


def fits_variants():
    rng = np.random.default_rng(25)
    g = photo(H, W, 11)[..., 0]
    out = [("bitpix8", fits_file(8, g.tobytes(), (W, H)))]
    out.append(("bitpix16", fits_file(16, rng.integers(
        0, 65536, W * H).astype(">u2").tobytes(), (W, H))))
    out.append(("bitpix32", fits_file(32, rng.integers(
        -2 ** 31, 2 ** 31, W * H).astype(">i4").tobytes(), (W, H))))
    out.append(("bitpix_m32", fits_file(-32, (rng.random(W * H) * 400 - 80)
                                        .astype(">f4").tobytes(), (W, H))))
    out.append(("bitpix_m64", fits_file(-64, (rng.random(W * H) * 400)
                                        .astype(">f8").tobytes(), (W, H))))
    out.append(("naxis1", fits_file(8, g[0].tobytes(), (W,))))
    out.append(("comment_and_slash", fits_file(8, g.tobytes(), (W, H), [
        ("OBJECT", "'a / b'"), ("EXPTIME", "1.5 / seconds")])))
    words = rng.integers(0, 2 ** 32, W * H, dtype=np.uint64)
    for zb in (8, 16, 32):
        out.append((f"gzip_zbitpix{zb}", fits_gzip_file(W, H, zb, words)))
    return out


def fits_refused():
    rng = np.random.default_rng(26)
    g = photo(H, W, 11)[..., 0]
    return [
        ("no_data_after_header", fits_cards([
            ("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", W),
            ("NAXIS2", H), ("END", None)]), None),
        ("no_image_data", fits_file(8, b"x" * 100, ()), None),
        ("gzip_float", fits_gzip_file(W, H, -32, rng.integers(
            0, 2 ** 32, W * H, dtype=np.uint64)), None),
        ("cut_data", fits_file(8, g.tobytes(), (W, H))[:2880 + 40], None),
    ]


# ---------------------------------------------------------------- DCX
def dcx_file(frames) -> bytes:
    table = 4 + 4 * (len(frames) + 1)
    offsets, at = [], table
    for f in frames:
        offsets.append(at)
        at += len(f)
    return (struct.pack("<I", 0x3ADE68B1)
            + struct.pack(f"<{len(frames) + 1}I", *offsets, 0)
            + b"".join(frames))


def dcx_variants():
    rgb = photo(H, W, 12)
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=20)
    return [
        ("rgb_one_frame", dcx_file([pil_save(rgb, "PCX")])),
        ("grey_two_frames", dcx_file([pil_save(rgb[..., 0], "PCX"),
                                      pil_save(rgb, "PCX")])),
        ("bilevel", dcx_file([pil_save(rgb[..., 0] > 90, "PCX")])),
        # the palette PIL reads is the file's last 769 bytes
        ("palette_last_frame", dcx_file([save_image(pal, "PCX")])),
    ]


def dcx_refused():
    rgb = photo(H, W, 12)
    data = dcx_file([pil_save(rgb, "PCX")])
    return [("cut_frame", data[:200], None)]


# ---------------------------------------------------------------- FLI
def fli_header(w, h, frames=1, magic=0xAF12, flags=3) -> bytes:
    s = bytearray(128)
    struct.pack_into("<IHHHHHHI", s, 0, 0, magic, frames, w, h, 8, flags, 5)
    return s


def fli_chunk(ctype, data: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(data), ctype) + data


def fli_frame(chunks) -> bytes:
    body = b"".join(chunks)
    return struct.pack("<IHH", 16 + len(body), 0xF1FA, len(chunks)) \
        + bytes(8) + body


def fli_file(w, h, frames, prefix=b"") -> bytes:
    body = prefix + b"".join(frames)
    head = fli_header(w, h, len(frames))
    struct.pack_into("<I", head, 0, 128 + len(body))
    return bytes(head) + body


def colour_chunk(packets, ctype=4) -> bytes:
    """packets: (skip, [rgb, ...])."""
    data = struct.pack("<H", len(packets))
    for skip, cols in packets:
        data += bytes([skip, len(cols) % 256]) + bytes(
            v for c in cols for v in c)
    return fli_chunk(ctype, data + b"\0" * (len(data) % 2))


def brun(img: np.ndarray) -> bytes:
    out = bytearray()
    for row in img:
        out.append(0)
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 127:
                j += 1
            if j - i >= 2:
                out += bytes([j - i, row[i]])
                i = j
            else:
                k = i
                while k < len(row) and k - i < 128 and not (
                        k + 1 < len(row) and row[k] == row[k + 1]):
                    k += 1
                out += bytes([256 - (k - i)]) + row[i:k].tobytes()
                i = k
    return bytes(out + b"\0" * (len(out) % 2))


def lc(y0, rows) -> bytes:
    """Byte delta over rows y0...: each row's packets (skip, literal)."""
    out = bytearray(struct.pack("<HH", y0, len(rows)))
    for packets in rows:
        out.append(len(packets))
        for skip, kind, data in packets:
            if kind == "run":
                out += bytes([skip, 256 - data[0], data[1]])
            else:
                out += bytes([skip, len(data)]) + bytes(data)
    return bytes(out + b"\0" * (len(out) % 2))


def ss2(rows) -> bytes:
    """Word delta: each entry (skip_lines, [(skip, kind, words)])."""
    out = bytearray(struct.pack("<H", len(rows)))
    for skip_lines, packets in rows:
        if skip_lines:
            out += struct.pack("<H", 65536 - skip_lines)
        out += struct.pack("<H", len(packets))
        for skip, kind, data in packets:
            if kind == "run":
                out += bytes([skip, 256 - data[0]]) + bytes(data[1])
            else:
                out += bytes([skip, len(data) // 2]) + bytes(data)
    return bytes(out + b"\0" * (len(out) % 2))


def fli_variants():
    rng = np.random.default_rng(27)
    idx = (photo(H, W, 13)[..., 0] // 8).astype(np.uint8)
    cols = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(40)]
    c64 = [tuple(int(v) for v in rng.integers(0, 64, 3)) for _ in range(40)]
    pal_chunk = colour_chunk([(0, cols[:20]), (5, cols[20:30])])
    out = [
        ("brun_colour256", fli_file(W, H, [fli_frame(
            [pal_chunk, fli_chunk(15, brun(idx))])])),
        ("copy_colour64", fli_file(W, H, [fli_frame(
            [colour_chunk([(2, c64[:16]), (200, c64[16:40])], 11),
             fli_chunk(16, idx.tobytes() + b"\0" * ((W * H) % 2))])])),
        ("black_then_lc", fli_file(W, H, [fli_frame(
            [fli_chunk(13, b""), fli_chunk(12, lc(2, [
                [(1, "lit", [5, 6, 7]), (2, "run", (3, 9))],
                [(0, "run", (4, 1))], []]))])])),
        ("ss2_words", fli_file(12, 6, [fli_frame(
            [fli_chunk(7, ss2([(0, [(0, "lit", [1, 2, 3, 4]),
                                   (2, "run", (2, (7, 8)))]),
                               (2, [(4, "lit", [9, 9])])]))])])),
        ("pstamp_and_two_frames", fli_file(W, H, [
            fli_frame([fli_chunk(18, bytes(10)), pal_chunk,
                       fli_chunk(15, brun(idx))]),
            fli_frame([fli_chunk(13, b"")])])),
        ("magic_af11_flags0", _fli_af11(idx, pal_chunk)),
    ]
    return out


def _fli_af11(idx, pal_chunk) -> bytes:
    frame = fli_frame([pal_chunk, fli_chunk(15, brun(idx))])
    head = fli_header(W, H, 1, 0xAF11, 0)
    struct.pack_into("<I", head, 0, 128 + len(frame))
    return bytes(head) + frame


def fli_refused():
    idx = (photo(H, W, 13)[..., 0] // 8).astype(np.uint8)
    good = fli_file(W, H, [fli_frame([fli_chunk(15, brun(idx))])])
    prefix = struct.pack("<IH", 16, 0xF100) + bytes(10)
    return [
        ("cut_frame", good[:200], None),
        ("unknown_chunk", fli_file(W, H, [fli_frame(
            [fli_chunk(99, bytes(8))])]), None),
        # PIL skips the prefix chunk in _open but decodes from byte 128
        ("prefix_chunk", fli_file(W, H, [fli_frame(
            [fli_chunk(15, brun(idx))])], prefix=prefix), None),
    ]


# ---------------------------------------------------------------- PCD
def pcd_file(orientation: int, seed: int) -> bytes:
    """A PhotoCD file cut to its base image: the 'PCD_' sector at 2,048
    (orientation in byte 3,586) and 768x512 YCC at sector 96."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:512, 0:768]
    luma = (96 + 60 * np.sin(x / 47.0) * np.cos(y / 31.0)
            + rng.normal(0, 3, (512, 768))).clip(0, 255).astype(np.uint8)
    cy, cx = np.mgrid[0:256, 0:384]
    cb = (156 + 40 * np.sin(cx / 29.0)).clip(0, 255).astype(np.uint8)
    cr = (137 + 40 * np.cos(cy / 23.0)).clip(0, 255).astype(np.uint8)
    head = bytearray(96 * 2048)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    body = b"".join(luma[2 * k].tobytes() + luma[2 * k + 1].tobytes()
                    + cb[k].tobytes() + cr[k].tobytes() for k in range(256))
    return bytes(head) + body


def pcd_variants():
    return [("base_orientation0", pcd_file(0, 1)),
            ("base_orientation1", pcd_file(1, 2))]


def pcd_refused():
    return [("cut_base", pcd_file(3, 3)[:96 * 2048 + 5000], None)]


# ---------------------------------------------------------------- PIXAR
def pixar_file(w, h, data) -> bytes:
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + data


def pixar_variants():
    rgb = photo(H, W, 14)
    return [("rgb", pixar_file(W, H, rgb.tobytes())),
            ("rgb_64", pixar_file(64, 40, photo(40, 64, 15).tobytes()))]


def pixar_refused():
    return [("cut", pixar_file(W, H, photo(H, W, 14).tobytes()[:20]),
             None)]


# ---------------------------------------------------------------- GBR
def gbr_file(w, h, depth, data, version=2, comment=b"brush\0",
             spacing=25) -> bytes:
    size = (28 if version == 2 else 20) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", spacing)
    return head + comment + data


def gbr_variants():
    rgba = photo(H, W, 16, 4)
    return [("v1_grey", gbr_file(W, H, 1, rgba[..., 0].tobytes(), 1,
                                 b"old brush\0")),
            ("v2_grey", gbr_file(W, H, 1, rgba[..., 1].tobytes())),
            ("v2_rgba", gbr_file(W, H, 4, rgba.tobytes(), spacing=7)),
            ("v2_long_comment", gbr_file(W, H, 1, rgba[..., 2].tobytes(),
                                         comment=b"a much longer name\0"))]


def gbr_refused():
    return [("cut", gbr_file(W, H, 4, bytes(30)), None)]


# ---------------------------------------------------------------- McIdas
def mcidas_file(w, h, nbytes, data, prefix=0, bands=1, at=256) -> bytes:
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10] = h, w, nbytes
    words[13], words[14], words[33] = bands, prefix, at
    return struct.pack("!64i", *words) + bytes(max(0, at - 256)) + data


def mcidas_variants():
    rng = np.random.default_rng(28)
    g = photo(H, W, 17)[..., 0]
    out = [("L", mcidas_file(W, H, 1, g.tobytes()))]
    rows = rng.integers(0, 256, (H, 2 * W + 3), np.uint8)
    out.append(("I16B_prefix", mcidas_file(W, H, 2, rows.tobytes(), 3)))
    out.append(("I32B", mcidas_file(W, H, 4, rng.integers(
        0, 256, 4 * W * H, np.uint8).tobytes(), 0, 1, 300)))
    out.append(("L_two_bands_stride", mcidas_file(W, H, 1, rng.integers(
        0, 256, 2 * W * H, np.uint8).tobytes(), 0, 2)))
    return out


def mcidas_refused():
    return [("cut", mcidas_file(W, H, 2, bytes(20)), None)]


# ---------------------------------------------------------------- IMT
def imt_file(w, h, data, extra=b"") -> bytes:
    return (b"width %d\nheight %d\n* a comment\n%spixel n8\n\x0c"
            % (w, h, extra)) + data


def imt_variants():
    g = photo(H, W, 18)[..., 0]
    return [("L", imt_file(W, H, g.tobytes())),
            ("L_64", imt_file(64, 40, photo(40, 64, 19)[..., 0].tobytes(),
                              b"xyz 12\n"))]


def imt_refused():
    return [("cut", imt_file(W, H, bytes(30)), None)]


# ---------------------------------------------------------------- XVThumb
def xv_file(w, h, data, comments=(b"#IMGINFO:x", b"#END_OF_COMMENTS")):
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments)
            + b"%d %d 255\n" % (w, h) + data)


def xvthumb_variants():
    g = photo(H, W, 20)[..., 1]
    return [("p332", xv_file(W, H, g.tobytes())),
            ("no_comments", xv_file(5, 3, bytes(range(15)), ()))]


def xvthumb_refused():
    return [("cut", xv_file(W, H, bytes(30)), None),
            ("bad_size_line", xv_file(W, H, bytes(200))
             .replace(b"13 9 255", b"13x9"), None)]


# ---------------------------------------------------------------- IPTC
def iptc_field(record, tag, data: bytes) -> bytes:
    return bytes([0x1C, record, tag]) + struct.pack(">H", len(data)) + data


def iptc_file(w, h, layers, component, comp, payload, band=None,
              chunk=40) -> bytes:
    out = iptc_field(2, 5, b"title") + iptc_field(3, 60, bytes(
        [layers, component]))
    out += iptc_field(3, 20, struct.pack(">H", w))
    out += iptc_field(3, 30, struct.pack(">H", h))
    out += iptc_field(3, 120, bytes([comp]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    for k in range(0, len(payload), chunk):
        out += iptc_field(8, 10, payload[k:k + chunk])
    return out + bytes(5)


def iptc_variants():
    g = photo(H, W, 21)[..., 0]
    jpg = pil_save(g, "JPEG", quality=90)
    return [("raw_grey", iptc_file(W, H, 1, 0, 1, g.tobytes())),
            ("raw_band2_of_rgb", iptc_file(W, H, 3, 1, 1, g.tobytes(), 2)),
            ("raw_band4_of_cmyk", iptc_file(W, H, 4, 1, 1, g.tobytes(), 4)),
            ("jpeg_grey", iptc_file(W, H, 1, 0, 5, jpg, chunk=200))]


def iptc_refused():
    g = photo(H, W, 21)[..., 0]
    return [("unknown_compression", iptc_file(W, H, 1, 0, 3, g.tobytes()),
             None),
            ("cut_stream", iptc_file(W, H, 1, 0, 1, g.tobytes()[:50]),
             None)]


VARIANTS = {"im": (im_variants, im_refused),
            "xbm": (xbm_variants, xbm_refused),
            "xpm": (xpm_variants, xpm_refused),
            "sun": (sun_variants, sun_refused),
            "msp": (msp_variants, msp_refused),
            "spider": (spider_variants, spider_refused),
            "fits": (fits_variants, fits_refused),
            "dcx": (dcx_variants, dcx_refused),
            "fli": (fli_variants, fli_refused),
            "pcd": (pcd_variants, pcd_refused),
            "pixar": (pixar_variants, pixar_refused),
            "gbr": (gbr_variants, gbr_refused),
            "mcidas": (mcidas_variants, mcidas_refused),
            "imt": (imt_variants, imt_refused),
            "xvthumb": (xvthumb_variants, xvthumb_refused),
            "iptc": (iptc_variants, iptc_refused)}


# ---------------------------------------------------------------- cv2
def pam_file(w, h, depth, maxval, data, tupltype=None) -> bytes:
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"ENDHDR\n" + data


def cv2_files():
    """(name, bytes) that cv2.imread reads: its own Sun raster and PAM
    writes and hand-made ones."""
    import cv2
    rng = np.random.default_rng(29)
    bgr = photo(H, W, 22)
    grey = bgr[..., 0]
    out = []
    for name, arr, ext in (("cv2_bgr", bgr, ".ras"),
                           ("cv2_grey_reads_zero", grey, ".ras"),
                           ("cv2_bgr", bgr, ".pam"),
                           ("cv2_grey", grey, ".pam")):
        ok, b = cv2.imencode(ext, arr)
        out.append((name + ext.replace(".", "_"), b.tobytes()))
    cmap = rng.integers(0, 256, 3 * 256, np.uint8).tobytes()
    ramp = bytes(range(256)) * 3
    bits = np.packbits(grey > 100, axis=1)
    out += [
        ("sun_d8_cmap_colour", ims.write_sun(W, H, 8, _sun_rows(grey),
                                             cmap=cmap)),
        ("sun_d8_cmap_grey", ims.write_sun(W, H, 8, _sun_rows(grey),
                                      cmap=ramp[::-1])),
        ("sun_d1_cmap", ims.write_sun(W, H, 1, _sun_rows(bits),
                                 cmap=bytes([0, 255, 10, 200, 30, 90]))),
        ("sun_d32_xbgr", ims.write_sun(W, H, 32, rng.integers(
            0, 256, 4 * W * H, np.uint8).tobytes(), 0)),
        ("pam_rgb_alpha", pam_file(W, H, 4, 255, rng.integers(
            0, 256, 4 * W * H, np.uint8).tobytes(), b"RGB_ALPHA")),
        ("pam_grey_alpha_16", pam_file(W, H, 2, 4095, rng.integers(
            0, 256, 4 * W * H, np.uint8).tobytes(), b"GRAYSCALE_ALPHA")),
        ("pam_rgb_16", pam_file(W, H, 3, 65535, rng.integers(
            0, 256, 6 * W * H, np.uint8).tobytes(), b"RGB")),
        ("pam_blackandwhite", pam_file(W, H, 1, 1, rng.integers(
            0, 256, W * H, np.uint8).tobytes(), b"BLACKANDWHITE")),
    ]
    return out


def save_cv2(out: str) -> None:
    import json
    import shutil

    import cv2
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    notes = {}
    for name, data in cv2_files():
        path = os.path.join(out, name + ".hdr")
        with open(path, "wb") as f:
            f.write(data)
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert arr is not None, name
        np.save(os.path.join(out, name + ".npy"), arr)
        notes[name] = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
    with open(os.path.join(out, "cv2.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


# ---------------------------------------------------------------- capture
CAPTURE_FRAMES = (("view_000.im", "im_rgb"), ("view_001.ras", "sun_rle"),
                  ("view_002.xpm", "xpm_p256"), ("view_003.fli", "fli_brun"))


def capture_frame(rgb: np.ndarray, kind: str) -> bytes:
    h, w = rgb.shape[:2]
    if kind == "im_rgb":
        return pil_save(rgb, "IM")
    if kind == "sun_rle":
        return ims.write_sun(w, h, 24, ims.sun_rle(rgb[..., ::-1].tobytes()),
                             2)
    pal = Image.fromarray(rgb).quantize(256)
    if kind == "xpm_p256":
        return xpm_from_p(pal)
    idx = np.asarray(pal)
    cols = np.asarray(pal.getpalette(), np.uint8).reshape(-1, 3)
    n = int(idx.max()) + 1
    packets = [(0, [tuple(int(v) for v in c) for c in cols[:n]])]
    return fli_file(w, h, [fli_frame([colour_chunk(packets),
                                      fli_chunk(15, brun(idx))])])


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
                rgb = np.asarray(pim.convert("RGB"))
            with open(os.path.join(root, "images", name), "wb") as fh:
                fh.write(capture_frame(rgb, kind))
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im["qvec"]))
            f.write(struct.pack("<ddd", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def hash_pcd(folder: str) -> None:
    """Replace the PhotoCD fixtures' .npy (1.2 MB each) by the mode, shape
    and SHA-256 of PIL's array in large.json."""
    import hashlib
    import json
    with open(os.path.join(folder, "modes.json")) as f:
        modes = json.load(f)
    notes = {}
    for name, want in modes.items():
        arr = np.load(os.path.join(folder, name + ".npy"))
        notes[name] = {"mode": want["mode"], "shape": list(arr.shape),
                       "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
        os.remove(os.path.join(folder, name + ".npy"))
    with open(os.path.join(folder, "large.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


if __name__ == "__main__":
    for fmt, (variants, refused) in VARIANTS.items():
        ims.save_fixtures(os.path.join(DATA, fmt), variants(), refused(),
                          FORMATS[fmt])
        print(f"wrote {len(variants())} {fmt} fixtures")
    hash_pcd(os.path.join(DATA, "pcd"))
    save_cv2(os.path.join(DATA, "sun", "cv2"))
    write_colmap_capture(os.path.join(DATA, "im_sun_xpm_fli", "colmap"))
