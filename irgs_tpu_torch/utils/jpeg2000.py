"""JPEG 2000 (ISO 15444-1) frames as the JAX loaders read them:
``np.asarray(PIL.Image.open(p))`` (`read_jpeg2000_like_pil`) and
``cv2.imread(p, cv2.IMREAD_UNCHANGED)`` (`imread_jpeg2000`). Both
libraries decode through OpenJPEG 2.5; the port's decoder is
utils/j2k.py with csrc/j2k_decode.cpp, equal to OpenJPEG bit for bit.

PIL (Pillow 12's Jpeg2KDecode.c) decodes tile by tile (opj_read_tile_header
and opj_decode_tile_data), so OpenJPEG's JP2 colour steps (pclr, cmap,
cdef) never run on its path: the mode comes from the header
(utils/jp2.pil_open) and each tile is unpacked into it by one of Pillow's
unpackers, chosen by mode, colour space (the JP2 ``colr`` box's
enumerated space; without one, as for a raw codestream or an ICC profile,
1 or 2 components count as grey, 3 or 4 as sRGB, or as sYCC where the
first plane is full and the second or third subsampled), component count
and subsampling. Each sample is offset by half its range where it is
signed, then shifted to 8 bits (16 for I;16): left below, right above, with
half a step added first, in 32-bit unsigned arithmetic stored to the
mode's byte (so a 12-bit 4095 rounds up to 256 and is stored as 0). A
subsampled component is read at ``(y // dy) * (w // dx) + x // dx`` of
the tile's samples, from Pillow's tile buffer (zeroed for each tile, as
big as the tile at full size: where OpenJPEG wrote fewer samples, as for
a tile whose packets stop below the top resolution, the rest reads 0). sYCC goes through PIL's
ImagingConvertYCbCr2RGB. A colour space PIL has no unpacker for (CMYK on
three components, e-sYCC, grey on RGB) or any decoding error raises
`Jpeg2000Error`: PIL's "broken data stream".

cv2 (OpenCV 5's grfmt_jpeg2000_openjpeg.cpp) decodes the whole image with
opj_decode, so the JP2 colour steps apply (palette expansion through
``cmap``, ``cdef``'s channel order); it refuses signed components, fewer
than 8 bits, 2 channels, subsampled or offset images; samples above 8 bits
are 16-bit (up to 16), cast to the output type as they are (a 16-bit
palette in an 8-bit image keeps its low byte); BGR(A) order, grey as
[H, W]; sYCC through cvtColor's YUV2BGR, and three components into one
channel (a palette on a grey codestream) through its BGR2GRAY.
"""

from __future__ import annotations

import numpy as np

from . import j2k, jp2
from .image import UnreadableImageError, check_size

UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


class Jpeg2000Error(ValueError):
    """OpenJPEG or the reader's wrapper refuses the stream."""


def _codestream(buf: bytes, name: str, jp2_container: bool):
    """(Codestream, colour space, boxes or None) after opj_read_header."""
    try:
        if jp2_container:
            boxes = jp2.opj_boxes(buf)
            cs = j2k.Codestream(buf, boxes.codestream,
                                ihdr_size=(boxes.w, boxes.h), name=name)
            return cs, _ENUMCS.get(boxes.enumcs, UNSPECIFIED), boxes
        return j2k.Codestream(buf, 0, name=name), UNSPECIFIED, None
    except j2k.J2kError as e:
        raise Jpeg2000Error(f"{name}: broken data stream when reading image "
                            f"file ({e})") from e


# ---------------------------------------------------------------- PIL
# Pillow's j2k_unpackers: (mode, colour space, components, subsampling
# allowed, unpacker)
_UNPACKERS = (
    ("L", GRAY, 1, False, "gray_l"), ("P", SRGB, 1, False, "gray_l"),
    ("PA", SRGB, 2, False, "graya_la"), ("I;16", GRAY, 1, False, "gray_i"),
    ("I;16B", GRAY, 1, False, "gray_i"), ("LA", GRAY, 2, False, "graya_la"),
    ("RGB", GRAY, 1, False, "gray_rgb"), ("RGB", GRAY, 2, False, "gray_rgb"),
    ("RGB", SRGB, 3, True, "srgb_rgb"), ("RGB", SYCC, 3, True, "sycc_rgb"),
    ("RGB", SRGB, 4, True, "srgb_rgb"), ("RGB", SYCC, 4, True, "sycc_rgb"),
    ("RGBA", GRAY, 1, False, "gray_rgb"), ("RGBA", GRAY, 2, False,
                                            "graya_la"),
    ("RGBA", SRGB, 3, True, "srgb_rgb"), ("RGBA", SYCC, 3, True, "sycc_rgb"),
    ("RGBA", SRGB, 4, True, "srgba_rgba"), ("RGBA", SYCC, 4, True,
                                             "sycca_rgba"),
    ("CMYK", CMYK, 4, True, "srgba_rgba"),
)


def _csiz(prec: int) -> int:
    c = (prec + 7) >> 3
    return 4 if c == 3 else c


def _words(buf: np.ndarray, offsets: np.ndarray, csiz: int) -> np.ndarray:
    """The native-endian unsigned words of `csiz` bytes at `offsets`."""
    v = np.zeros(offsets.shape, np.uint64)
    for k in range(csiz):
        v |= buf[offsets + k].astype(np.uint64) << np.uint64(8 * k)
    return v


def _shifted(word: np.ndarray, comp, target_bits: int) -> np.ndarray:
    """j2ku_shift(offset + word, shift) in unsigned 32-bit arithmetic."""
    shift = target_bits - comp.prec
    offset = (1 << (comp.prec - 1)) if comp.sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    x = (word + np.uint64(offset)) & np.uint64(0xFFFFFFFF)
    if shift < 0:
        return x >> np.uint64(-shift)
    return (x << np.uint64(shift)) & np.uint64(0xFFFFFFFF)


# PIL's YCbCr -> RGB (ImagingConvertYCbCr2RGB, ConvertYCbCr.c): R and B
# add R_CR[cr] and B_CB[cb] (its tables already shifted right by 6), G adds
# (G_CB[cb] + G_CR[cr]) >> 6; any tables that give the same sums are
# equivalent, these were solved from Image.convert over every (Cb, Cr) and
# tests/test_torch_jpeg2000.py holds them against it at every Y.
R_CR = np.array([
    -180, -179, -177, -176, -174, -173, -172, -170, -169, -167, -166, -165,
    -163, -162, -160, -159, -158, -156, -155, -153, -152, -150, -149, -148,
    -146, -145, -143, -142, -141, -139, -138, -136, -135, -134, -132, -131,
    -129, -128, -127, -125, -124, -122, -121, -120, -118, -117, -115, -114,
    -113, -111, -110, -108, -107, -106, -104, -103, -101, -100, -99, -97,
    -96, -94, -93, -92, -90, -89, -87, -86, -85, -83, -82, -80, -79, -78,
    -76, -75, -73, -72, -71, -69, -68, -66, -65, -64, -62, -61, -59, -58,
    -57, -55, -54, -52, -51, -50, -48, -47, -45, -44, -43, -41, -40, -38,
    -37, -36, -34, -33, -31, -30, -29, -27, -26, -24, -23, -22, -20, -19,
    -17, -16, -14, -13, -12, -10, -9, -7, -6, -5, -3, -2, 0, 1, 2, 4, 5, 7,
    8, 9, 11, 12, 14, 15, 16, 18, 19, 21, 22, 23, 25, 26, 28, 29, 30, 32,
    33, 35, 36, 37, 39, 40, 42, 43, 44, 46, 47, 49, 50, 51, 53, 54, 56, 57,
    58, 60, 61, 63, 64, 65, 67, 68, 70, 71, 72, 74, 75, 77, 78, 79, 81, 82,
    84, 85, 86, 88, 89, 91, 92, 93, 95, 96, 98, 99, 100, 102, 103, 105, 106,
    107, 109, 110, 112, 113, 114, 116, 117, 119, 120, 121, 123, 124, 126,
    127, 128, 130, 131, 133, 134, 136, 137, 138, 140, 141, 143, 144, 145,
    147, 148, 150, 151, 152, 154, 155, 157, 158, 159, 161, 162, 164, 165,
    166, 168, 169, 171, 172, 173, 175, 176, 178], np.int64)
B_CB = np.array([
    -227, -226, -224, -222, -220, -218, -217, -215, -213, -211, -210, -208,
    -206, -204, -202, -201, -199, -197, -195, -194, -192, -190, -188, -187,
    -185, -183, -181, -179, -178, -176, -174, -172, -171, -169, -167, -165,
    -164, -162, -160, -158, -156, -155, -153, -151, -149, -148, -146, -144,
    -142, -140, -139, -137, -135, -133, -132, -130, -128, -126, -125, -123,
    -121, -119, -117, -116, -114, -112, -110, -109, -107, -105, -103, -101,
    -100, -98, -96, -94, -93, -91, -89, -87, -86, -84, -82, -80, -78, -77,
    -75, -73, -71, -70, -68, -66, -64, -62, -61, -59, -57, -55, -54, -52,
    -50, -48, -47, -45, -43, -41, -39, -38, -36, -34, -32, -31, -29, -27,
    -25, -24, -22, -20, -18, -16, -15, -13, -11, -9, -8, -6, -4, -2, 0, 1,
    3, 5, 7, 8, 10, 12, 14, 15, 17, 19, 21, 23, 24, 26, 28, 30, 31, 33, 35,
    37, 38, 40, 42, 44, 46, 47, 49, 51, 53, 54, 56, 58, 60, 62, 63, 65, 67,
    69, 70, 72, 74, 76, 77, 79, 81, 83, 85, 86, 88, 90, 92, 93, 95, 97, 99,
    101, 102, 104, 106, 108, 109, 111, 113, 115, 116, 118, 120, 122, 124,
    125, 127, 129, 131, 132, 134, 136, 138, 139, 141, 143, 145, 147, 148,
    150, 152, 154, 155, 157, 159, 161, 163, 164, 166, 168, 170, 171, 173,
    175, 177, 178, 180, 182, 184, 186, 187, 189, 191, 193, 194, 196, 198,
    200, 202, 203, 205, 207, 209, 210, 212, 214, 216, 217, 219, 221, 223,
    225], np.int64)
G_CB = np.array([
    2817, 2807, 2761, 2753, 2707, 2697, 2687, 2643, 2633, 2621, 2579, 2567,
    2557, 2514, 2501, 2493, 2448, 2437, 2428, 2382, 2373, 2362, 2318, 2308,
    2297, 2254, 2242, 2233, 2187, 2177, 2168, 2121, 2113, 2102, 2057, 2048,
    2003, 1993, 1982, 1939, 1928, 1917, 1875, 1862, 1853, 1809, 1797, 1789,
    1743, 1733, 1723, 1678, 1669, 1657, 1614, 1603, 1593, 1549, 1537, 1529,
    1483, 1473, 1464, 1417, 1409, 1398, 1353, 1344, 1299, 1289, 1277, 1235,
    1223, 1213, 1170, 1157, 1149, 1104, 1093, 1084, 1038, 1029, 1018, 974,
    964, 953, 910, 898, 889, 844, 833, 825, 778, 769, 759, 713, 705, 659,
    649, 639, 595, 585, 573, 531, 519, 509, 466, 453, 445, 399, 389, 379,
    334, 325, 313, 270, 259, 249, 205, 193, 185, 139, 129, 120, 73, 65, 54,
    9, 0, -45, -55, -65, -109, -119, -131, -173, -185, -195, -238, -251,
    -259, -304, -315, -324, -370, -379, -390, -434, -444, -455, -499, -511,
    -519, -565, -575, -584, -631, -639, -650, -695, -704, -749, -759, -770,
    -813, -824, -835, -877, -890, -899, -943, -955, -963, -1009, -1019,
    -1029, -1074, -1083, -1095, -1138, -1149, -1159, -1203, -1215, -1223,
    -1269, -1279, -1288, -1335, -1343, -1389, -1399, -1409, -1453, -1463,
    -1475, -1517, -1529, -1539, -1582, -1595, -1603, -1648, -1659, -1668,
    -1714, -1723, -1734, -1778, -1788, -1799, -1842, -1854, -1863, -1908,
    -1919, -1927, -1974, -1983, -1993, -2039, -2047, -2093, -2103, -2113,
    -2157, -2167, -2179, -2221, -2234, -2243, -2287, -2299, -2307, -2353,
    -2363, -2373, -2418, -2427, -2439, -2482, -2493, -2503, -2547, -2559,
    -2567, -2613, -2623, -2632, -2679, -2687, -2698, -2743, -2752, -2797,
    -2807], np.int64)
G_CR = np.array([
    5869, 5815, 5759, 5703, 5682, 5627, 5571, 5549, 5495, 5439, 5383, 5362,
    5307, 5251, 5229, 5175, 5119, 5063, 5043, 4987, 4931, 4909, 4855, 4799,
    4743, 4723, 4667, 4611, 4589, 4535, 4479, 4423, 4403, 4347, 4291, 4270,
    4215, 4159, 4103, 4083, 4027, 3971, 3950, 3895, 3839, 3784, 3763, 3707,
    3651, 3630, 3575, 3519, 3464, 3443, 3387, 3331, 3310, 3255, 3199, 3144,
    3123, 3067, 3012, 2990, 2935, 2879, 2824, 2803, 2747, 2692, 2670, 2615,
    2559, 2504, 2483, 2427, 2372, 2350, 2295, 2240, 2184, 2163, 2107, 2052,
    2030, 1975, 1920, 1864, 1843, 1787, 1732, 1710, 1655, 1600, 1544, 1523,
    1468, 1412, 1390, 1335, 1280, 1224, 1203, 1148, 1092, 1070, 1016, 960,
    904, 883, 828, 772, 750, 696, 640, 584, 563, 508, 452, 430, 376, 320,
    264, 244, 188, 132, 110, 56, 0, -55, -75, -131, -187, -209, -263, -319,
    -375, -395, -451, -507, -528, -583, -639, -695, -715, -771, -827, -848,
    -903, -959, -1015, -1035, -1091, -1147, -1168, -1223, -1279, -1334,
    -1355, -1411, -1467, -1488, -1543, -1599, -1654, -1675, -1731, -1786,
    -1808, -1863, -1919, -1974, -1995, -2051, -2106, -2128, -2183, -2239,
    -2294, -2315, -2371, -2426, -2448, -2503, -2558, -2614, -2635, -2691,
    -2746, -2768, -2823, -2878, -2934, -2955, -3011, -3066, -3088, -3143,
    -3198, -3254, -3275, -3330, -3386, -3408, -3463, -3518, -3574, -3595,
    -3650, -3706, -3728, -3783, -3838, -3894, -3915, -3970, -4026, -4048,
    -4102, -4158, -4214, -4235, -4290, -4346, -4368, -4422, -4478, -4534,
    -4554, -4610, -4666, -4688, -4742, -4798, -4854, -4874, -4930, -4986,
    -5008, -5062, -5118, -5174, -5194, -5250, -5306, -5327, -5382, -5438,
    -5494, -5514, -5570, -5626, -5647, -5702, -5758, -5780], np.int64)


def _ycbcr2rgb(rows: np.ndarray) -> np.ndarray:
    """ImagingConvertYCbCr2RGB on [..., 4] uint8 pixels (alpha kept)."""
    y = rows[..., 0].astype(np.int64)
    cb, cr = rows[..., 1], rows[..., 2]
    out = rows.copy()
    out[..., 0] = np.clip(y + R_CR[cr], 0, 255)
    out[..., 1] = np.clip(y + ((G_CB[cb] + G_CR[cr]) >> 6), 0, 255)
    out[..., 2] = np.clip(y + B_CB[cb], 0, 255)
    return out


def _unpack(kind, comps, buf, w, h):
    """One tile through Pillow's unpacker `kind`: [h, w] (L, P, I;16) or
    [h, w, 4] uint8 pixels."""
    yy, xx = np.mgrid[0:h, 0:w]
    if kind in ("gray_l", "gray_i", "gray_rgb"):
        c = comps[0]
        cs = _csiz(c.prec)
        v = _shifted(_words(buf, cs * (yy * w + xx), cs), c,
                     16 if kind == "gray_i" else 8)
        if kind == "gray_i":
            return (v & np.uint64(0xFFFF)).astype(np.uint16)
        v = (v & np.uint64(0xFF)).astype(np.uint8)
        if kind == "gray_l":
            return v
        return np.stack([v, v, v, np.full_like(v, 255)], -1)
    if kind == "graya_la":
        c, a = comps[0], comps[1]
        cs, acs = _csiz(c.prec), _csiz(a.prec)
        v = _shifted(_words(buf, cs * (yy * w + xx), cs), c, 8)
        av = _shifted(_words(buf, cs * w * h + acs * (yy * w + xx), acs), a,
                      8)
        v = (v & np.uint64(0xFF)).astype(np.uint8)
        return np.stack([v, v, v, (av & np.uint64(0xFF)).astype(np.uint8)],
                        -1)
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    out = np.full((h, w, 4), 255, np.uint8)
    at = 0
    for k in range(n):
        c = comps[k]
        cs = _csiz(c.prec)
        cw, ch = w // c.dx, h // c.dy
        off = at + cs * ((yy // c.dy) * cw + xx // c.dx)
        out[..., k] = (_shifted(_words(buf, off, cs), c, 8)
                       & np.uint64(0xFF)).astype(np.uint8)
        at += cs * cw * ch
    if kind in ("sycc_rgb", "sycca_rgba"):
        out = _ycbcr2rgb(out)
    return out


def _opj_tile_bytes(cs, comps) -> bytes:
    """opj_tcd_update_tile_data's layout of a decoded tile."""
    parts = []
    for c, a in zip(cs.comps, comps):
        size = _csiz(c.prec)
        dt = {1: np.uint8, 2: "<u2", 4: "<u4"}[size]
        mask = (1 << (8 * size)) - 1
        parts.append((a.astype(np.int64) & mask).astype(dt).tobytes())
    return b"".join(parts)


def decode_like_pil(buf: bytes, header, name: str = "JPEG2000"):
    """PIL's load of a JPEG 2000 file whose _open gave `header`
    (jp2.PilHeader): the array np.asarray gives."""
    cs, space, _ = _codestream(buf, name, header.codec == "jp2")
    broken = Jpeg2000Error(f"{name}: broken data stream when reading image "
                           f"file")
    if not 1 <= len(cs.comps) <= 4:
        raise broken
    c = cs.comps
    if space == UNSPECIFIED and len(c) >= 3 and c[0].dx == c[0].dy == 1 \
            and any(k.dx != 1 or k.dy != 1 for k in c[1:3]):
        space = SYCC           # chroma subsampled against a full first plane
    elif space == UNSPECIFIED:
        space = GRAY if len(c) <= 2 else SRGB
    subsampling = any(c.dx != 1 or c.dy != 1 for c in cs.comps)
    kind = next((k for m, s, n, sub, k in _UNPACKERS
                 if s == space and n == len(cs.comps)
                 and (sub or not subsampling) and m == header.mode), None)
    if kind is None:
        raise broken
    W, H = header.size
    if header.mode in ("L", "P"):
        im = np.zeros((H, W), np.uint8)
    elif header.mode.startswith("I;16"):
        im = np.zeros((H, W), np.uint16)
    else:
        im = np.zeros((H, W, 4), np.uint8)
    try:
        for _, (x0, y0, x1, y1), comps in cs.tiles():
            if (x0 >= x1 or y0 >= y1 or x0 < cs.x0 or y0 < cs.y0
                    or x1 - cs.x0 > W or y1 - cs.y0 > H):
                raise broken
            w, h = x1 - x0, y1 - y0
            data_size = 0
            for c in cs.comps:
                tw = -(-x1 // c.dx) - -(-x0 // c.dx)
                th = -(-y1 // c.dy) - -(-y0 // c.dy)
                data_size += _csiz(c.prec) * tw * th
            tile_bytes = sum(_csiz(c.prec) * w * h for c in cs.comps)
            data_size = max(data_size, tile_bytes)
            tilebuf = np.zeros(data_size, np.uint8)
            raw = np.frombuffer(_opj_tile_bytes(cs, comps), np.uint8)
            tilebuf[:len(raw)] = raw
            px = _unpack(kind, cs.comps, tilebuf, w, h)
            im[y0 - cs.y0:y1 - cs.y0, x0 - cs.x0:x1 - cs.x0] = px
    except j2k.J2kError as e:
        raise Jpeg2000Error(f"{name}: broken data stream when reading image "
                            f"file ({e})") from e
    if header.mode in ("LA", "PA"):
        return np.ascontiguousarray(im[..., [0, 3]])
    if header.mode == "RGB":
        return np.ascontiguousarray(im[..., :3])
    if header.mode.startswith("I;16"):
        return im.astype("<u2")
    return im


def read_jpeg2000_like_pil(path: str):
    """(array, mode, info) of ``PIL.Image.open(path)`` for a JP2 file or a
    raw J2K codestream: ``np.asarray(im)``, ``im.mode`` and ``im.info``
    (dpi, comment; the palette of P and PA)."""
    with open(path, "rb") as f:
        buf = f.read()
    try:
        header = jp2.pil_open(buf)
    except jp2.Jp2Error as e:
        raise Jpeg2000Error(f"{path}: {e}") from e
    check_size(*header.size, path)
    arr = decode_like_pil(buf, header, path)
    info = dict(header.info)
    if header.palette is not None:
        info["palette"] = np.asarray(header.palette, np.uint8).reshape(-1, 3)
    return arr, header.mode, info


# ---------------------------------------------------------------- cv2
def _opj_decode(buf: bytes, name: str):
    """opj_read_header + opj_decode as cv2 calls them: (components as int
    arrays, their (prec, sgnd, dx, dy, x0, y0, alpha), colour space, header
    component count and max precision)."""
    is_jp2 = buf[:12] == jp2.SIGNATURE
    cs, space, boxes = _codestream(buf, name, is_jp2)
    n = len(cs.comps)
    if not 1 <= n <= 4:
        raise Jpeg2000Error(f"{name}: Unsupported number of components")
    if any(c.sgnd for c in cs.comps):
        raise Jpeg2000Error(f"{name}: OpenJPEG2000: Component is signed")
    maxprec = max(c.prec for c in cs.comps)
    if maxprec < 8:
        raise Jpeg2000Error(f"{name}: OpenJPEG2000: Precision < 8 not "
                            f"supported")
    w, h = cs.x1 - cs.x0, cs.y1 - cs.y0
    if w > 1 << 20 or h > 1 << 20 or w * h > 1 << 30:
        raise Jpeg2000Error(f"{name}: cv2's validateInputImageSize refuses "
                            f"{w}x{h}")
    if maxprec > 16:
        raise UnreadableImageError(f"{name}: a JPEG 2000 image above 16 "
                                   f"bits as cv2.imread reads it is not "
                                   f"ported")
    geo = []
    for c in cs.comps:
        cx0, cy0 = -(-cs.x0 // c.dx), -(-cs.y0 // c.dy)
        cw, ch = -(-cs.x1 // c.dx) - cx0, -(-cs.y1 // c.dy) - cy0
        geo.append((cx0, cy0, cw, ch))
    data = [None] * n
    ntiles = 0
    try:
        for _, (x0, y0, x1, y1), comps in cs.tiles():
            for k, a in enumerate(comps):
                # opj_j2k_update_image_data: the region at its resolution's
                # coordinates, clipped to the component
                cx0, cy0, cw, ch = geo[k]
                if data[k] is None:
                    data[k] = np.zeros((ch, cw), np.int64)
                h, w = a.shape
                sx, sy = max(cx0 - a.x0, 0), max(cy0 - a.y0, 0)
                dx0, dy0 = max(a.x0 - cx0, 0), max(a.y0 - cy0, 0)
                n_x = min(w - sx, cw - dx0)
                n_y = min(h - sy, ch - dy0)
                if n_x > 0 and n_y > 0:
                    data[k][dy0:dy0 + n_y, dx0:dx0 + n_x] = \
                        a[sy:sy + n_y, sx:sx + n_x]
            ntiles += 1
            if ntiles == cs.tw * cs.th:
                break
    except j2k.J2kError as e:
        raise Jpeg2000Error(f"{name}: OpenJPEG2000: Decoding is failed "
                            f"({e})") from e
    if any(d is None for d in data):
        raise Jpeg2000Error(f"{name}: Failed to decode all used components")
    comps = [dict(data=d, prec=c.prec, sgnd=c.sgnd, dx=c.dx, dy=c.dy,
                  x0=g[0], y0=g[1], alpha=0)
             for d, c, g in zip(data, cs.comps, geo)]
    if boxes is not None:
        comps = _jp2_colour(boxes, comps, name)
    return comps, space, n, maxprec


def _jp2_colour(b, comps, name):
    """opj_jp2_decode's colour steps: opj_jp2_check_color, then pclr with
    cmap, then cdef."""
    bad = Jpeg2000Error(f"{name}: OpenJPEG2000: Decoding is failed (colour "
                        f"boxes)")
    if b.cdef is not None:
        nch = len(b.pclr[1]) if b.pclr is not None and b.cmap else len(comps)
        for cn, _, asoc in b.cdef:
            if cn >= nch or (asoc != 65535 and asoc > 0
                             and asoc - 1 >= nch):
                raise bad
        for k in range(nch):
            if not any(cn == k for cn, _, _ in b.cdef):
                raise bad
    if b.pclr is not None and b.cmap:
        entries, sizes, signs = b.pclr
        nch = len(sizes)
        cmap = [list(m) for m in b.cmap]
        used, sane = [False] * nch, True
        for cmp, _, _ in cmap:
            if cmp >= len(comps):
                sane = False
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= nch or (used[pcol] and mtyp == 1) \
                    or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        for i in range(nch):
            if not used[i] and cmap[i][1] != 0:
                sane = False
        if sane and len(comps) == 1 and not all(used):
            for i in range(nch):
                cmap[i][1:] = [1, i]
        if not sane:
            raise bad
        top = len(entries) - 1
        pal = np.asarray(entries, np.int64)
        new = []
        for i, (cmp, mtyp, pcol) in enumerate(cmap):
            c = dict(comps[cmp])
            src = comps[cmp]["data"]
            if mtyp == 0:
                c["data"] = src.copy()
            else:
                c["data"] = pal[np.clip(src, 0, top), pcol]
            c["prec"], c["sgnd"] = sizes[i], signs[i]
            new.append(c)
        comps = new
    if b.cdef is not None:
        info = [list(d) for d in b.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            if cn >= len(comps):
                continue
            if asoc in (0, 65535):
                comps[cn]["alpha"] = typ
                continue
            acn = asoc - 1
            if acn >= len(comps):
                continue
            if cn != acn and typ == 0:
                comps[cn], comps[acn] = comps[acn], comps[cn]
                for j in range(i + 1, len(info)):
                    if info[j][0] == cn:
                        info[j][0] = acn
                    elif info[j][0] == acn:
                        info[j][0] = cn
            comps[cn]["alpha"] = typ
    return comps


def _descale14(x):
    return (x + (1 << 13)) >> 14


def _yuv2bgr(y, u, v, delta, top):
    """cv2.cvtColor(COLOR_YUV2BGR)'s fixed-point path (14-bit
    coefficients 2.032, -0.395, -0.581, 1.140), as cv2 converts sYCC."""
    u, v = u - delta, v - delta
    b = y + _descale14(u * 33292)
    g = y + _descale14(v * -9519 + u * -6472)
    r = y + _descale14(v * 18678)
    return [np.clip(c, 0, top) for c in (b, g, r)]


def _bgr2gray(b, g, r):
    """cv2.cvtColor(COLOR_BGR2GRAY) on 8-bit planes (its 15-bit fixed
    point, equal over every 8-bit B, G, R)."""
    return (b * 3735 + g * 19235 + r * 9798 + (1 << 14)) >> 15


def imread_jpeg2000(buf: bytes, name: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` of a JPEG 2000 file;
    Jpeg2000Error where cv2 gives None."""
    comps, space, channels, maxprec = _opj_decode(buf, name)
    if channels == 2:
        raise Jpeg2000Error(f"{name}: OpenJPEG2000: Unsupported number of "
                            f"output channels")
    if space in (EYCC, CMYK):
        raise Jpeg2000Error(f"{name}: OpenJPEG2000: Unsupported color space "
                            f"conversion")
    dtype, outprec = (np.uint8, 8) if maxprec == 8 else (np.uint16, 16)
    shift = 0 if outprec > maxprec else maxprec - outprec
    h, w = comps[0]["data"].shape
    for c in comps:
        if c["dx"] != 1 or c["dy"] != 1 or c["x0"] or c["y0"] \
                or c["data"].shape != (h, w):
            raise Jpeg2000Error(f"{name}: OpenJPEG2000: tiles are not "
                                f"supported")
    data = [c["data"] for c in comps]
    nin = len(data)
    if space == GRAY:
        if channels not in (1, 3):
            raise Jpeg2000Error(f"{name}: unsupported conversion")
        planes = [data[0]] * channels
    elif space == SYCC:
        if channels == 1:
            planes = [data[0]]
        elif channels == 3 and nin >= 3:
            yuv = [(p >> shift).astype(dtype).astype(np.int64)
                   for p in data[:3]]
            top = np.iinfo(dtype).max
            planes = _yuv2bgr(*yuv, (top + 1) // 2, top)
        else:
            raise Jpeg2000Error(f"{name}: OpenJPEG2000: unsupported sYCC "
                                f"conversion")
    else:
        if channels == 1 and nin <= 2:
            planes = [data[0]]
        elif channels == 1 and dtype == np.uint8:
            r, g, b = [(p >> shift).astype(dtype).astype(np.int64)
                       for p in data[:3]]
            planes = [_bgr2gray(b, g, r)]
        elif channels == 3 and nin >= 3:
            planes = [data[2], data[1], data[0]]
        elif channels == 4 and nin >= 4:
            planes = [data[2], data[1], data[0], data[3]]
        elif channels == 3 and nin <= 2:
            planes = [data[0]] * 3
        else:
            raise UnreadableImageError(
                f"{name}: {nin} components into {channels} channels as "
                f"cv2.imread reads them is not ported")
    out = np.stack([(p >> shift).astype(dtype) for p in planes], -1)
    return out[..., 0] if channels == 1 else out
