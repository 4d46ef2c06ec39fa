"""Write the fixtures of the Photoshop and GPU-texture readers (with PIL,
here only): tests/data/dds (Pillow's DXT1/3/5, BC2/3/5 and uncompressed
saves; hand-made DX10 files of seeded random BC1-BC7 blocks, BC5S and
both BC6H forms, typeless and SRGB formats, R8G8B8A8, the FourCCs
ATI1/ATI2/BC4U/BC5U/BC5S, RGB masks at 16, 24 and 32 bits, L, LA, P;
sizes that are not multiples of 4), ftex (DXT1 and raw RGB), blp
(Pillow's BLP1 and BLP2 palette saves; BLP1 JPEG in colour, grey and
CMYK, with skipped bytes and the alpha flag; BLP1 palettes with alpha;
BLP2 DXT1/3/5 and palettes), psd (raw and PackBits composites in every
mode PIL maps, colour-mode data, image resources with an ICC profile,
two layers whose composite differs from both) and icns (RLE and
uncompressed RGB with masks, PNG and JPEG 2000 entries).
Beside each file the ``.npy`` PIL decodes from it and, in
``modes.json``, its mode and palette; ``refused/`` holds streams PIL
refuses. Then ``dds/large/`` (a 1297x840 BC7 frame and the SHA-256 of
PIL's array) and ``texture/colmap/``: the four 400x400 views of
tests/data/webp/colmap as DXT1 and DXT5 DDS (Pillow's encoder), an RGB
PackBits PSD with one layer, and a BLP1 JPEG, with that capture's
cameras and points.

    python tests/make_texture_fixtures.py
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
FORMATS = {"dds": ".dds", "ftex": ".ftc", "blp": ".blp", "psd": ".psd",
           "icns": ".icns"}
H, W = 9, 13
# the 1297x840 frame the chip smoke times
LARGE = ("large_bc7.dds",)


def pil_save(arr, fmt, mode=None, **kw) -> bytes:
    im = Image.fromarray(np.asarray(arr))
    if mode is not None:
        im = im.convert(mode)
    bio = io.BytesIO()
    im.save(bio, fmt, **kw)
    return bio.getvalue()


def _save_image(im, fmt, **kw) -> bytes:
    bio = io.BytesIO()
    im.save(bio, fmt, **kw)
    return bio.getvalue()


def photo(h, w, seed, c=3):
    """Smooth colours with flat patches and some noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 17 + y * 3) % 256, (y * 23) % 256,
                     ((x + y) * 11) % 256, 255 - (x * y) % 256][:c], -1)
    img = np.clip(base + rng.integers(-3, 4, base.shape), 0, 255)
    img = img.astype(np.uint8)
    img[h // 3:h // 2] = img[h // 3, 0]
    return img


def blocks(seed: int, n: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n * size,
                                                np.uint8).tobytes()


def nblocks(w, h):
    return ((w + 3) // 4) * ((h + 3) // 4)


# ---------------------------------------------------------------- DDS
DXGI = {"BC1": 71, "BC1_TYPELESS": 70, "BC2_TYPELESS": 73, "BC3": 77,
        "BC3_TYPELESS": 76, "BC4": 80, "BC4_TYPELESS": 79, "BC5": 83,
        "BC5_TYPELESS": 82, "BC5S": 84, "BC6H": 95, "BC6HS": 96, "BC7": 98,
        "BC7_TYPELESS": 97, "BC7_SRGB": 99, "RGBA": 28, "RGBA_TYPELESS": 27,
        "RGBA_SRGB": 29}


def _bsize(fmt):
    return 8 if fmt.split("_")[0] in ("BC1", "BC4") else 16


def dds_variants():
    rgba = photo(H, W, 1, 4)
    rgba[..., 3] = np.where(np.arange(W) % 3 == 0, 255, rgba[..., 3] // 2)
    rgb = rgba[..., :3]
    out = [(f"pil_{f.lower()}", pil_save(rgba, "DDS", pixel_format=f))
           for f in ("DXT1", "DXT3", "DXT5", "BC2", "BC3")]
    out.append(("pil_bc5", pil_save(rgb, "DDS", pixel_format="BC5")))
    for m in ("RGB", "RGBA", "L", "LA"):
        out.append((f"pil_{m.lower()}", pil_save(rgba, "DDS", m)))
    # DX10 files of random blocks, 20x12 and cut at odd sizes
    for k, fmt in enumerate(DXGI):
        if fmt.startswith("RGBA"):
            continue
        for w, h in ((20, 12), (13, 9)):
            out.append((f"dx10_{fmt.lower()}_{w}x{h}", ims.write_dds(
                w, h, blocks(100 + k * 2 + (w == 13), nblocks(w, h),
                             _bsize(fmt)), dxgi=DXGI[fmt])))
    for fmt in ("RGBA", "RGBA_TYPELESS", "RGBA_SRGB"):
        out.append((f"dx10_{fmt.lower()}", ims.write_dds(
            W, H, rgba.tobytes(), dxgi=DXGI[fmt])))
    for cc in (b"DXT1", b"DXT3", b"DXT5", b"ATI1", b"ATI2", b"BC4U", b"BC5U",
               b"BC5S"):
        size = 8 if cc in (b"DXT1", b"ATI1", b"BC4U") else 16
        out.append((f"fourcc_{cc.decode().lower()}", ims.write_dds(
            W, H, blocks(cc[3] + cc[0], nblocks(W, H), size), fourcc=cc)))
    # a 4x4 image of one BC7 block of each mode, mode 8 (a zero byte) too
    rng = np.random.default_rng(7)
    for mode in range(9):
        b = rng.integers(0, 256, 16, np.uint8)
        b[0] = 0 if mode == 8 else ((b[0] >> (mode + 1)) << (mode + 1)) | (
            1 << mode)
        out.append((f"bc7_mode{mode}", ims.write_dds(4, 4, b.tobytes(),
                                                     dxgi=98)))
    out.append(("bc7_mode6_photo", ims.write_dds(
        16, 12, ims.bc7_mode6_encode(photo(12, 16, 2, 4)), dxgi=98)))
    # uncompressed RGB through the masks
    v16 = (rgb[..., 0] >> 3).astype(np.uint16) << 11 | (
        rgb[..., 1] >> 2).astype(np.uint16) << 5 | rgb[..., 2] >> 3
    out.append(("rgb565", ims.write_dds(W, H, v16.astype("<u2").tobytes(),
                                        pfflags=0x40, bitcount=16,
                                        masks=(0xF800, 0x7E0, 0x1F, 0))))
    v4444 = sum((rgba[..., k] >> 4).astype(np.uint16) << (4 * (3 - k))
                for k in range(4))
    out.append(("rgba4444", ims.write_dds(
        W, H, v4444.astype("<u2").tobytes(), pfflags=0x41, bitcount=16,
        masks=(0xF000, 0xF00, 0xF0, 0xF))))
    out.append(("bgr24", ims.write_dds(W, H, rgb[..., ::-1].tobytes(),
                                       pfflags=0x40, bitcount=24,
                                       masks=(0xFF0000, 0xFF00, 0xFF, 0))))
    out.append(("rgb_odd_masks", ims.write_dds(
        W, H, rgba.tobytes(), pfflags=0x40, bitcount=32,
        masks=(0x00000505, 0x00F0F000, 0, 0xFF000000))))
    cut = ims.write_dds(W, H, rgba.tobytes(), pfflags=0x41, bitcount=32,
                        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    out.append(("rgba32_cut_reads_zeros", cut[:128 + 4 * W * H // 2]))
    pal = photo(16, 16, 3, 4).reshape(256, 4)
    idx = photo(H, W, 4, 1)[..., 0]
    out.append(("palette", ims.write_dds(W, H, pal.tobytes() + idx.tobytes(),
                                         pfflags=0x20, bitcount=8)))
    out.append(("luminance_l", ims.write_dds(W, H, idx.tobytes(),
                                             pfflags=0x20000, bitcount=8)))
    return out


def dds_refused():
    rgba = photo(H, W, 5, 4)
    dxt1 = pil_save(rgba, "DDS", pixel_format="DXT1")
    return [
        ("header_size_100", dxt1[:4] + struct.pack("<I", 100) + dxt1[8:],
         None),
        ("header_incomplete", dxt1[:60], None),
        ("fourcc_unknown", ims.write_dds(W, H, b"\0" * 64, fourcc=b"DXT2"),
         None),
        ("dxgi_bc1_srgb", ims.write_dds(W, H, b"\0" * 64, dxgi=72), None),
        ("dxgi_r16_float", ims.write_dds(W, H, b"\0" * 64, dxgi=54), None),
        ("luminance_16_no_alpha", ims.write_dds(W, H, b"\0" * 300,
                                                pfflags=0x20000,
                                                bitcount=16), None),
        ("no_pixel_format", ims.write_dds(W, H, b"\0" * 64, pfflags=0),
         None),
        ("dxt1_truncated", dxt1[:-9], None),
        ("bc7_truncated", ims.write_dds(W, H, blocks(9, 11, 16), dxgi=98),
         None),
        ("luminance_truncated", ims.write_dds(W, H, b"\0" * 50,
                                              pfflags=0x20000, bitcount=8),
         None),
    ]


# ---------------------------------------------------------------- FTEX
def write_ftex(w, h, fmt, data, format_count=1, where=None,
               size=None) -> bytes:
    where = 32 if where is None else where
    head = b"FTEX" + struct.pack("<5i", 0x3F800000, w, h, 1, format_count)
    head += struct.pack("<2i", fmt, where)
    head += b"\0" * (where - len(head))
    return head + struct.pack("<i", len(data) if size is None else size) \
        + data


def ftex_variants():
    rgb = photo(H, W, 6)
    dxt1 = pil_save(np.concatenate([rgb, np.full((H, W, 1), 255, np.uint8)],
                                   -1), "DDS", pixel_format="DXT1")[128:]
    return [("dxt1", write_ftex(W, H, 0, dxt1)),
            ("dxt1_random", write_ftex(16, 8, 0, blocks(11, 8, 8))),
            ("raw_rgb", write_ftex(W, H, 1, rgb.tobytes())),
            ("raw_at_offset", write_ftex(W, H, 1, rgb.tobytes(), where=48)),
            ("raw_size_minus1", write_ftex(W, H, 1, rgb.tobytes(), size=-1))]


def ftex_refused():
    rgb = photo(H, W, 7)
    return [("two_formats", write_ftex(W, H, 1, rgb.tobytes(), 2), None),
            ("format_2", write_ftex(W, H, 2, rgb.tobytes()), None),
            ("raw_truncated", write_ftex(W, H, 1, rgb.tobytes()[:-5]), None),
            ("dxt1_truncated", write_ftex(W, H, 0, blocks(12, 11, 8)),
             None)]


# ---------------------------------------------------------------- BLP
def blp1(w, h, compression, encoding, alpha, body, offsets=(), lengths=()):
    head = b"BLP1" + struct.pack("<iIIIii", compression, alpha, w, h,
                                 encoding, 0)
    offs = (list(offsets) + [0] * 16)[:16]
    lens = (list(lengths) + [0] * 16)[:16]
    return head + struct.pack("<16I", *offs) + struct.pack("<16I", *lens) \
        + body


def blp1_jpeg(jpeg: bytes, w, h, alpha=0, skip=b"") -> bytes:
    """A BLP1 JPEG: the stream split at its first SOS into the shared
    header and the mipmap, `skip` bytes between them."""
    sos = jpeg.index(b"\xff\xda")
    header, mip = jpeg[:sos], jpeg[sos:]
    start = 28 + 128 + 4 + len(header) + len(skip)
    return blp1(w, h, 0, 0, alpha,
                struct.pack("<I", len(header)) + header + skip + mip,
                [start], [len(mip)])


def blp2(w, h, encoding, alpha_depth, alpha_encoding, palette, data,
         compression=1) -> bytes:
    head = b"BLP2" + struct.pack("<i4B", compression, encoding, alpha_depth,
                                 alpha_encoding, 0) + struct.pack("<II", w, h)
    start = 20 + 128 + 1024
    return head + struct.pack("<16I", start, *[0] * 15) + struct.pack(
        "<16I", len(data), *[0] * 15) + palette + data


def blp_variants():
    rgb = photo(16, 24, 8)
    out = [("pil_blp1", pil_save(rgb, "BLP", "P", blp_version="BLP1")),
           ("pil_blp2", pil_save(rgb, "BLP", "P")),
           ("pil_blp2_rgba_palette", _save_image(
               Image.fromarray(photo(16, 24, 9, 4)).quantize(
                   64, method=Image.Quantize.FASTOCTREE), "BLP"))]
    jpg = pil_save(rgb, "JPEG", quality=90)
    out.append(("blp1_jpeg_rgb", blp1_jpeg(jpg, 24, 16)))
    out.append(("blp1_jpeg_skip", blp1_jpeg(jpg, 24, 16, skip=b"\xde\xad")))
    out.append(("blp1_jpeg_alpha", blp1_jpeg(jpg, 24, 16, alpha=8)))
    out.append(("blp1_jpeg_grey", blp1_jpeg(pil_save(rgb[..., 1], "JPEG"),
                                            24, 16)))
    out.append(("blp1_jpeg_cmyk", blp1_jpeg(pil_save(photo(16, 24, 10, 4),
                                                     "JPEG", "CMYK"), 24,
                                            16)))
    out.append(("blp1_jpeg_smaller_header", blp1_jpeg(jpg, 20, 16)))
    # YCCK (Adobe transform 2) decoded as CMYK: PIL sets the colour space
    with open(os.path.join(DATA, "jpeg", "ycck_q75_17x9.jpg"), "rb") as f:
        out.append(("blp1_jpeg_ycck", blp1_jpeg(f.read(), 17, 9)))
    pal = photo(16, 16, 11, 4).reshape(256, 4).tobytes()
    idx = photo(H, W, 12, 1)[..., 0].tobytes()
    for enc, alpha in ((4, 0), (5, 0), (5, 8)):
        out.append((f"blp1_palette_e{enc}_a{alpha}", blp1(
            W, H, 1, enc, alpha, pal + idx, [1180], [len(idx)])))
    for alpha_enc, size in ((0, 8), (1, 16), (7, 16)):
        for alpha in (0, 1):
            for w, h in ((16, 8), (13, 9)):
                data = blocks(20 + alpha_enc + alpha + w, nblocks(w, h), size)
                out.append((f"blp2_dxt{ {0: 1, 1: 3, 7: 5}[alpha_enc]}"
                            f"_a{alpha}_{w}x{h}",
                            blp2(w, h, 2, alpha, alpha_enc, pal, data)))
    out.append(("blp2_palette_alpha", blp2(W, H, 1, 8, 0, pal, idx)))
    return out


def blp_refused():
    pal = photo(16, 16, 13, 4).reshape(256, 4).tobytes()
    idx = photo(H, W, 14, 1)[..., 0].tobytes()
    jpg = pil_save(photo(16, 24, 15), "JPEG")
    good = blp1_jpeg(jpg, 24, 16)
    return [
        ("blp2_encoding_3", blp2(W, H, 3, 0, 0, pal, idx * 4), None),
        ("blp2_jpeg", blp2(W, H, 1, 0, 0, pal, idx, compression=0), None),
        ("blp2_alpha_encoding_3", blp2(W, H, 2, 0, 3, pal, idx * 4), None),
        ("blp1_encoding_3", blp1(W, H, 1, 3, 0, pal + idx, [1180],
                                 [len(idx)]), None),
        ("blp1_compression_2", blp1(W, H, 2, 4, 0, pal + idx, [1180],
                                    [len(idx)]), None),
        ("blp1_palette_short", blp1(W, H, 1, 4, 0, pal + idx[:-20], [1180],
                                    [len(idx)]), None),
        ("blp1_jpeg_truncated", good[:-40], None),
        ("blp1_jpeg_larger_header", blp1_jpeg(jpg, 24, 20), None),
        ("blp2_dxt1_truncated", blp2(W, H, 2, 0, 0, pal, blocks(16, 9, 8)),
         None),
    ]


# ---------------------------------------------------------------- PSD
def _planes(img):
    return [np.ascontiguousarray(img[..., k]) for k in range(img.shape[-1])]


def _icc() -> bytes:
    from PIL import ImageCms
    return ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes()


def psd_variants():
    rgba = photo(H, W, 16, 4)
    rgb = rgba[..., :3]
    grey = rgba[..., 0]
    out = []
    for comp in (0, 1):
        tag = "raw" if comp == 0 else "packbits"
        out.append((f"rgb_{tag}", ims.write_psd(_planes(rgb), mode=3,
                                                compression=comp)))
        out.append((f"rgba_{tag}", ims.write_psd(_planes(rgba), mode=3,
                                                 compression=comp)))
        out.append((f"grey_{tag}", ims.write_psd([grey], mode=1,
                                                 compression=comp)))
        out.append((f"cmyk_{tag}", ims.write_psd(_planes(rgba), mode=4,
                                                 compression=comp)))
    pal = photo(16, 16, 17, 3).reshape(256, 3)
    planar = pal.T.tobytes()
    out.append(("indexed_palette", ims.write_psd([grey], mode=2,
                                                 color_data=planar)))
    out.append(("indexed_no_palette", ims.write_psd([grey], mode=2,
                                                    color_data=planar[:300])))
    bits = np.packbits(grey > 120, axis=1)
    out.append(("bitmap_raw", ims.write_psd([bits], mode=0, bits=1,
                                            compression=0, size=(W, H))))
    out.append(("bitmap_packbits", ims.write_psd([bits], mode=0, bits=1,
                                                 size=(W, H))))
    out.append(("lab", ims.write_psd(_planes(rgb), mode=9)))
    out.append(("duotone", ims.write_psd([grey], mode=8,
                                         color_data=b"\0" * 40)))
    out.append(("multichannel", ims.write_psd(_planes(rgb), mode=7)))
    out.append(("grey_with_alpha", ims.write_psd(_planes(rgba[..., :2]),
                                                 mode=1)))
    out.append(("rgb_five_channels_reads_three", ims.write_psd(
        _planes(np.concatenate([rgba, rgb[..., :1]], -1)), mode=3,
        compression=0)))
    out.append(("rgb_icc_resources", ims.write_psd(
        _planes(rgb), mode=3, resources=[(1005, b"\0" * 16),
                                         (1039, _icc()), (1060, b"xmp!!")])))
    # two layers, the composite unlike either
    a, b = photo(6, 8, 18), photo(5, 7, 19)
    layers = ims.psd_layer_section([(1, 2, _planes(a), b"back"),
                                    (3, 4, _planes(b), b"front layer")])
    out.append(("two_layers", ims.write_psd(_planes(rgb), mode=3,
                                            layers=layers)))
    # a run that crosses a row's end: libImaging drops the rest of it; a
    # no-op byte (0x80) before the first row
    head = ims.write_psd([grey], mode=1, compression=0)[:38]
    out.append(("packbits_run_crosses_row", head + struct.pack(">H", 1)
                + struct.pack(">H", 2) * H + bytes([257 - 20, 77]) * H))
    nop = ims.write_psd([grey], mode=1)
    first = struct.unpack_from(">H", nop, 40)[0] + 1
    out.append(("packbits_nop", nop[:40] + struct.pack(">H", first)
                + nop[42:40 + 2 * H] + b"\x80" + nop[40 + 2 * H:]))
    return out


def psd_refused():
    rgb = photo(H, W, 20)
    good = ims.write_psd(_planes(rgb), mode=3)
    return [
        ("depth_16", ims.write_psd(_planes(rgb), mode=3, bits=16), None),
        ("version_2", good[:4] + b"\0\2" + good[6:], None),
        ("not_enough_channels", ims.write_psd(_planes(rgb)[:2], mode=3),
         None),
        ("zip_compression", ims.write_psd(_planes(rgb), mode=3,
                                          compression=2), None),
        ("packbits_truncated", good[:-30], None),
        ("raw_truncated", ims.write_psd(_planes(rgb), mode=3,
                                        compression=0)[:-1], None),
        ("counts_cut", good[:26 + 12 + 2 + 10], None),
    ]


# ---------------------------------------------------------------- ICNS
def icns_rle(plane: np.ndarray) -> bytes:
    """IcnsImagePlugin.read_32's RLE of one plane: runs of 3-130 equal
    bytes, literals of 1-128."""
    data, out, i = plane.tobytes(), bytearray(), 0
    lit = bytearray()

    def flush():
        out.append(len(lit) - 1)
        out.extend(lit)
        lit.clear()
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 129:
            j += 1
        if j - i >= 2:
            if lit:
                flush()
            out += bytes([j - i + 1 + 125, data[i]])
            i = j + 1
            continue
        lit.append(data[i])
        i += 1
        if len(lit) == 128:
            flush()
    if lit:
        flush()
    return bytes(out)


def write_icns(entries) -> bytes:
    body = b"".join(sig + struct.pack(">I", 8 + len(d)) + d
                    for sig, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def _rgb32(img, rle=True):
    if not rle:
        return img[..., :3].tobytes()
    return b"".join(icns_rle(img[..., k]) for k in range(3))


def _png(arr, mode=None):
    return pil_save(arr, "PNG", mode)


def icns_variants():
    i16, i32, i48 = photo(16, 16, 21, 4), photo(32, 32, 22, 4), \
        photo(48, 48, 23, 4)
    i128 = np.repeat(np.repeat(photo(32, 32, 24, 4), 4, 0), 4, 1)
    out = [
        ("is32_s8mk", write_icns([(b"is32", _rgb32(i16)),
                                  (b"s8mk", i16[..., 3].tobytes())])),
        ("is32_no_mask", write_icns([(b"is32", _rgb32(i16))])),
        ("il32_raw_l8mk", write_icns([(b"il32", _rgb32(i32, False)),
                                      (b"l8mk", i32[..., 3].tobytes())])),
        ("ih32_h8mk", write_icns([(b"ih32", _rgb32(i48)),
                                  (b"h8mk", i48[..., 3].tobytes())])),
        ("it32_t8mk", write_icns([(b"it32", b"\0\0\0\0" + _rgb32(i128)),
                                  (b"t8mk", i128[..., 3].tobytes())])),
        ("best_of_three", write_icns([(b"is32", _rgb32(i16)),
                                      (b"ih32", _rgb32(i48)),
                                      (b"il32", _rgb32(i32))])),
        ("icp4_png", write_icns([(b"TOC ", b"\0" * 8),
                                 (b"icp4", _png(i16))])),
        ("icp5_png_rgb", write_icns([(b"icp5", _png(i32[..., :3]))])),
        ("ic07_png_half_size", write_icns([(b"ic07", _png(i48[:32, :32]))])),
        ("ic07_png_beside_it32", write_icns([
            (b"it32", b"\0\0\0\0" + _rgb32(i128)),
            (b"ic07", _png(i128[..., :3])),
            (b"t8mk", i128[..., 3].tobytes())])),
        ("icp5_j2k", write_icns([(b"icp5", pil_save(
            i32[..., :3], "JPEG2000", no_jp2=True))])),
        ("icp4_jp2_grey", write_icns([(b"icp4", pil_save(
            i16[..., 0], "JPEG2000"))])),
        ("icp4_jp2_rgba", write_icns([(b"icp4", pil_save(i16,
                                                         "JPEG2000"))])),
    ]
    return out


def icns_pil_save() -> bytes:
    """Pillow's ICNS save (PNG entries up to 1024x1024) of a two-colour
    image; written by the tests, not committed (its array is 4 MB)."""
    flat = np.zeros((24, 24, 4), np.uint8)
    flat[:12] = (200, 30, 60, 255)
    flat[12:] = (20, 90, 220, 128)
    return pil_save(flat, "ICNS")


def icns_refused():
    i16 = photo(16, 16, 25, 4)
    rle = _rgb32(i16)
    return [
        ("no_32bit_entry", write_icns([(b"TOC ", b"\0" * 8),
                                       (b"ics#", b"\0" * 64)]), None),
        ("zero_block", b"icns" + struct.pack(">I", 40) + b"is32" + b"\0" * 4
         + b"\0" * 24, None),
        ("it32_bad_signature", write_icns([(b"it32", b"\1\0\0\0"
                                            + _rgb32(np.zeros((128, 128, 3),
                                                              np.uint8)))]),
         None),
        ("rle_overshoots", write_icns([(b"is32", bytes([0xFF, 7]) * 7
                                        + rle)]), None),
        ("rle_truncated", write_icns([(b"is32", rle[:-7])])[:-7], None),
        ("unsupported_subimage", write_icns([(b"icp4", b"GIF89a" + b"\0" *
                                              40)]), None),
        ("mask_short", write_icns([(b"is32", rle),
                                   (b"s8mk", i16[..., 3].tobytes()[:100])]),
         None),
        ("png_wrong_size", write_icns([(b"ic07", _png(i16[:12, :12]))]),
         None),
        # np.asarray of the fresh image finds no packer from these modes to
        # RGBA (convert("RGB") reads them)
        ("icp5_png_palette", write_icns([(b"icp5", _png(photo(32, 32, 26),
                                                        "P"))]), None),
        ("icp5_png_grey", write_icns([(b"icp5", _png(i16[..., 0]))]), None),
    ]


VARIANTS = {"dds": (dds_variants, dds_refused),
            "ftex": (ftex_variants, ftex_refused),
            "blp": (blp_variants, blp_refused),
            "psd": (psd_variants, psd_refused),
            "icns": (icns_variants, icns_refused)}


# ---------------------------------------------------------------- large
def large_frames():
    import make_webp_fixtures as mw
    frame = mw.photo(840, 1297, 5, alpha=True)
    pad = np.pad(np.clip(frame, 0, 255).astype(np.uint8),
                 ((0, 0), (0, 3), (0, 0)), mode="edge")
    return [("large_bc7.dds", ims.write_dds(1297, 840, ims.bc7_mode6_encode(
        pad), dxgi=98))]


def save_large(out: str) -> None:
    import hashlib
    import json
    os.makedirs(out, exist_ok=True)
    notes = {}
    for name, data in large_frames():
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.asarray(im)
            notes[name] = {"mode": im.mode, "shape": list(arr.shape),
                           "sha256": hashlib.sha256(
                               np.ascontiguousarray(arr).tobytes())
                           .hexdigest()}
    with open(os.path.join(out, "large.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


# ---------------------------------------------------------------- capture
CAPTURE_FRAMES = (("view_000.dds", "dxt1"), ("view_001.dds", "dxt5"),
                  ("view_002.psd", "psd_packbits_one_layer"),
                  ("view_003.blp", "blp1_jpeg"))


def capture_frame(rgb: np.ndarray, kind: str) -> bytes:
    if kind in ("dxt1", "dxt5"):
        return pil_save(rgb, "DDS", "RGBA", pixel_format=kind.upper())
    if kind == "psd_packbits_one_layer":
        layer = ims.psd_layer_section([(100, 120, _planes(
            rgb[100:200, 120:260]), b"crop")])
        return ims.write_psd(_planes(rgb), mode=3, layers=layer)
    h, w = rgb.shape[:2]
    return blp1_jpeg(pil_save(rgb, "JPEG", quality=92), w, h,
                     skip=b"\0" * 6)


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


if __name__ == "__main__":
    for fmt, (variants, refused) in VARIANTS.items():
        ims.save_fixtures(os.path.join(DATA, fmt), variants(), refused(),
                          FORMATS[fmt])
        print(f"wrote {len(variants())} {fmt} fixtures")
    save_large(os.path.join(DATA, "dds", "large"))
    write_colmap_capture(os.path.join(DATA, "texture", "colmap"))
