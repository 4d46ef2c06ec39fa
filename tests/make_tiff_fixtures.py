"""Write the TIFF fixtures of tests/data/tiff/ (with PIL, here only).

One small file per layout the port's reader (irgs_tpu_torch/utils/tiff.py)
takes: bilevel and grey at 1 to 32 bits (signed, unsigned, float), grey +
alpha, RGB(A) at 8 and 16 bits with each kind of extra sample, palettes at
1 to 8 bits, CMYK, CIELab; each compression (none, PackBits, LZW, Adobe
Deflate, Deflate) with predictors 1 and 2; strips and tiles, planar
configurations 1 and 2, both byte orders, fill order 2, BigTIFF, the eight
EXIF orientations; and files PIL's own TIFF writer makes. Then the codecs
of `codec_variants`: JPEG-in-TIFF, YCbCr, Zstandard, LZMA and CCITT (with
damaged fax strips that pin libtiff's recovery). Beside each
``<name>.tif`` the ``<name>.npy`` PIL decodes from it and, in
``modes.json``, its PIL mode and palette, so a machine without PIL checks
the reader. ``refused/`` holds streams PIL refuses and streams PIL reads
that the port does not yet (``refused/refused.json`` says which).
``large/`` holds the four frames the chip smoke times and the SHA-256 of
PIL's arrays; ``colmap/`` a COLMAP capture of four TIFF frames (the views
of tests/data/webp/colmap/ in four codecs). ``legacy/`` holds the layouts
the reader once refused (tests/test_torch_tiff_legacy.py) and, in
``legacy/large/``, their 1297x840 frames with the SHA-256 of PIL's
arrays; ``legacy_colmap/`` the same four views as old-style JPEG, old-style
LZW, planar YCbCr and planar 16-bit RGB with predictor 2.

    python tests/make_tiff_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image

import image_streams as ims

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "tiff")
H, W = 11, 19


def _samples(rng, bits, spp, fmt=1):
    if fmt == 3:
        return (rng.standard_normal((H, W, spp)) * 100).astype(np.float32)
    hi = 1 << bits
    a = rng.integers(0, hi, (H, W, spp), dtype=np.uint64)
    a[:, : W // 2] = a[:, :1]                 # runs for PackBits and LZW
    return a


def variants():
    """(name, file bytes) of every fixture."""
    rng = np.random.default_rng(14)
    out = []

    def add(name, arr, **kw):
        out.append((name, ims.write_tiff(arr, **kw)))

    for name, photo, bits, fmt, extra, spp in [
            ("bw", 1, 1, 1, (), 1), ("bw_minwhite", 0, 1, 1, (), 1),
            ("grey2", 1, 2, 1, (), 1), ("grey4_minwhite", 0, 4, 1, (), 1),
            ("grey8", 1, 8, 1, (), 1), ("grey8_minwhite", 0, 8, 1, (), 1),
            ("grey8_signed", 1, 8, 2, (), 1), ("grey16", 1, 16, 1, (), 1),
            ("grey16_signed", 1, 16, 2, (), 1), ("grey32", 1, 32, 1, (), 1),
            ("grey32_signed", 1, 32, 2, (), 1), ("float32", 1, 32, 3, (), 1),
            ("grey_alpha", 1, 8, 1, (2,), 2), ("rgb", 2, 8, 1, (), 3),
            ("rgba", 2, 8, 1, (2,), 4), ("rgba_associated", 2, 8, 1, (1,), 4),
            ("rgb_padding", 2, 8, 1, (0,), 4), ("rgba_no_extra", 2, 8, 1, (), 4),
            ("rgba_padding", 2, 8, 1, (2, 0), 5), ("rgb16", 2, 16, 1, (), 3),
            ("rgba16", 2, 16, 1, (2,), 4),
            ("rgba16_associated", 2, 16, 1, (1,), 4),
            ("palette1", 3, 1, 1, (), 1), ("palette2", 3, 2, 1, (), 1),
            ("palette4", 3, 4, 1, (), 1), ("palette8", 3, 8, 1, (), 1),
            ("palette_alpha", 3, 8, 1, (2,), 2), ("cmyk", 5, 8, 1, (), 4),
            ("cmyk16", 5, 16, 1, (), 4), ("lab", 8, 8, 1, (), 3)]:
        cmap = rng.integers(0, 65536, (3, 1 << bits)) if photo == 3 else None
        a = _samples(rng, bits, spp, fmt)
        kw = dict(photometric=photo, bits=bits, sample_format=fmt,
                  extra_samples=extra, colormap=cmap)
        add(name, a, **kw)
        mm = name != "grey32"             # PIL reads unsigned 32 bits as II only
        add(name + ("_lzw_mm" if mm else "_lzw"), a, compression="lzw",
            order="MM" if mm else "II", **kw)
    rgb = _samples(rng, 8, 3)
    for comp in ("packbits", "lzw", "adobe_deflate", "deflate"):
        for pred in ((1, 2) if comp != "packbits" else (1,)):
            add(f"rgb_{comp}_p{pred}", rgb, photometric=2, bits=8,
                compression=comp, predictor=pred, layout=("strips", 4))
    for comp in ("none", "lzw"):
        add(f"rgb_tiles_{comp}", rgb, photometric=2, bits=8, compression=comp,
            layout=("tiles", 16, 16))
        add(f"rgb_planar2_{comp}", rgb, photometric=2, bits=8,
            compression=comp, planar=2, layout=("strips", 5))
        add(f"rgb_planar2_tiles_{comp}", rgb, photometric=2, bits=8,
            compression=comp, planar=2, layout=("tiles", 16, 16))
    g16 = _samples(rng, 16, 1)
    add("grey16_deflate_p2_mm", g16, photometric=1, bits=16,
        compression="adobe_deflate", predictor=2, order="MM")
    add("float32_lzw_p2_mm", _samples(rng, 32, 1, 3), photometric=1,
        bits=32, sample_format=3, compression="lzw", predictor=2, order="MM")
    add("grey16_signed_lzw_p2_mm", _samples(rng, 16, 1), photometric=1,
        bits=16, sample_format=2, compression="lzw", predictor=2, order="MM")
    add("rgb16_deflate_p2_tiles_mm", _samples(rng, 16, 3), photometric=2,
        bits=16, compression="adobe_deflate", predictor=2, order="MM",
        layout=("tiles", 16, 16))
    for comp in ("none", "lzw"):
        add(f"lab_planar2_{comp}", _samples(rng, 8, 3), photometric=8,
            bits=8, compression=comp, planar=2)
        add(f"cmyk_planar2_{comp}", _samples(rng, 8, 4), photometric=5,
            bits=8, compression=comp, planar=2)
    add("rgba_associated_planar2_lzw", _samples(rng, 8, 4), photometric=2,
        bits=8, extra_samples=(1,), compression="lzw", planar=2)
    add("grey_alpha_planar2_lzw", _samples(rng, 8, 2), photometric=1, bits=8,
        extra_samples=(2,), compression="lzw", planar=2)
    add("rgb16_planar2_lzw", _samples(rng, 16, 3), photometric=2, bits=16,
        compression="lzw", planar=2)
    add("bw_fill2_packbits", _samples(rng, 1, 1), photometric=1, bits=1,
        compression="packbits", fill_order=2)
    add("palette4_fill2_lzw", _samples(rng, 4, 1), photometric=3, bits=4,
        fill_order=2, compression="lzw",
        colormap=rng.integers(0, 65536, (3, 16)))
    add("grey8_fill2_lzw", _samples(rng, 8, 1), photometric=1, bits=8,
        fill_order=2, compression="lzw")
    add("bigtiff", rgb, photometric=2, bits=8, big=True)
    add("bigtiff_lzw", rgb, photometric=2, bits=8, big=True,
        compression="lzw", layout=("strips", 3))
    for o in range(2, 9):
        add(f"orientation{o}", rgb, photometric=2, bits=8, orientation=o)
    # PIL's own writer (libtiff for the compressed ones)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    img[:, : W // 2] = img[:, :1]
    base = Image.fromarray(img)
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA", "I;16", "I", "F",
                 "CMYK"):
        im = base.convert(mode) if mode not in ("I;16",) else \
            Image.fromarray((img[..., 0].astype(np.uint16) * 257))
        for comp in ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"):
            bio = io.BytesIO()
            im.save(bio, "TIFF", compression=comp)
            out.append((f"pil_{mode.replace(';', '')}_{comp}", bio.getvalue()))
    return out + codec_variants()


def pil_tiff(im, **kw) -> bytes:
    bio = io.BytesIO()
    im.save(bio, "TIFF", **kw)
    return bio.getvalue()


def pil_jpeg(block: np.ndarray, quality=90, subsampling=2) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(block).save(bio, "JPEG", quality=quality,
                                subsampling=subsampling)
    return bio.getvalue()


def split_jpeg(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG stream -> (its DQT and DHT segments as a tables-only stream,
    SOI..EOI; the stream without them and without APPn: abbreviated)."""
    tables, rest, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while True:
        m = stream[pos + 1]
        if m == 0xDA:
            rest += stream[pos:]
            break
        n = int.from_bytes(stream[pos + 2:pos + 4], "big")
        seg = stream[pos:pos + 2 + n]
        if m in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= m <= 0xEF:
            rest += seg
        pos += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(rest)


def jpeg_tiff(img: np.ndarray, layout, sampling=(2, 2), tables=True,
              photometric=6, subsampling_tag=True, **kw) -> bytes:
    """JPEG-in-TIFF strips or tiles of PIL-encoded JPEG streams (YCbCr
    with `sampling` (h, v) of luma, or grey), abbreviated with a shared
    JPEGTables tag where `tables`."""
    h, w = img.shape[:2]
    blocks = []
    if layout[0] == "strips":
        rps = layout[1] or h
        for y in range(0, h, rps):
            blocks.append(img[y:y + rps])
    else:
        tw, th = layout[1], layout[2]
        for y in range(0, h, th):
            for x in range(0, w, tw):
                part = img[y:y + th, x:x + tw]
                pad = [(0, th - part.shape[0]), (0, tw - part.shape[1])]
                blocks.append(np.pad(part, pad + [(0, 0)] * (img.ndim - 2),
                                     mode="edge"))
    sub = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[sampling]
    streams = [pil_jpeg(b, subsampling=sub) for b in blocks]
    extra = dict(kw.pop("tags", {}))
    if tables:
        shared = split_jpeg(streams[0])[0]
        streams = [split_jpeg(st)[1] for st in streams]
        extra[347] = (7, list(shared))
    if photometric == 6 and subsampling_tag:
        extra[530] = (3, list(sampling))
    return ims.write_tiff(img, photometric=photometric, bits=8,
                          compression="jpeg", layout=layout, chunks=streams,
                          tags=extra, **kw)


def _jpeg_segments(stream: bytes):
    """A baseline JPEG stream -> ({marker: [segment payloads]}, its
    entropy-coded data split at the restart markers)."""
    segs, pos = {}, 2
    while True:
        m = stream[pos + 1]
        n = int.from_bytes(stream[pos + 2:pos + 4], "big")
        segs.setdefault(m, []).append(stream[pos + 4:pos + 2 + n])
        pos += 2 + n
        if m == 0xDA:
            break
    data = stream[pos:stream.rindex(b"\xff\xd9")]
    parts, start, i = [], 0, 0
    while i < len(data) - 1:
        if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7:
            parts.append(data[start:i])
            start = i = i + 2
            continue
        i += 1
    parts.append(data[start:])
    return segs, parts


def _tiff_with_blobs(img_shape, blobs, entries_of) -> bytes:
    """A little-endian one-page TIFF: `blobs` laid out after the header
    (each at an even offset), then the IFD of `entries_of(offsets)`
    ({tag: (type, values)})."""
    import struct
    body, offsets = bytearray(), []
    for b in blobs:
        offsets.append(8 + len(body))
        body += b + bytes(len(b) % 2)
    entries = entries_of(offsets)
    ifd_at = 8 + len(body)
    tags = sorted(entries)
    ifd = bytearray(struct.pack("<H", len(tags)))
    extra = bytearray()
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    codes = {3: "H", 4: "I"}
    for t in tags:
        typ, vals = entries[t]
        data = struct.pack("<" + codes[typ] * len(vals), *vals)
        head = struct.pack("<HHI", t, typ, len(vals))
        if len(data) <= 4:
            ifd += head + data.ljust(4, b"\0")
        else:
            ifd += head + struct.pack("<I", extra_at + len(extra))
            extra += data
    ifd += bytes(4)
    return b"II*\0" + struct.pack("<I", ifd_at) + bytes(body + ifd + extra)


def ojpeg_tiff(img: np.ndarray, kind: str = "jif", rps=None,
               sampling=(2, 2), quality=90, subsampling_tag=True) -> bytes:
    """An old-style JPEG (compression 6) YCbCr TIFF of a PIL-encoded
    baseline stream. kind "jif": one strip holding the whole stream,
    JPEGInterchangeFormat(Length) pointing at it; "tables": the stream's
    tables in JPEGQTables, JPEGDCTables and JPEGACTables (JPEGProc 1), each
    strip one restart interval of the entropy-coded data (libtiff puts the
    RST markers back)."""
    h, w = img.shape[:2]
    rps = rps or h
    sh, sv = sampling
    sub = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[sampling]
    kw = {}
    if rps < h:
        kw["restart_marker_blocks"] = -(-w // (8 * sh)) * (rps // (8 * sv))
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", quality=quality, subsampling=sub,
                              **kw)
    stream = bio.getvalue()
    base = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
            259: (3, [6]), 262: (3, [6]), 277: (3, [3]), 278: (4, [rps])}
    if subsampling_tag:
        base[530] = (3, [sh, sv])
    if kind == "jif":
        return _tiff_with_blobs(img.shape, [stream], lambda o: {
            **base, 273: (4, o), 279: (4, [len(stream)]),
            513: (4, o), 514: (4, [len(stream)])})
    segs, parts = _jpeg_segments(stream)
    qts = {}
    for p in segs[0xDB]:
        while p:
            qts[p[0] & 15], p = p[1:65], p[65:]
    dcs, acs = {}, {}
    for p in segs[0xC4]:
        while p:
            n = 17 + sum(p[1:17])
            (acs if p[0] >> 4 else dcs)[p[0] & 15] = p[1:n]
            p = p[n:]
    sof = segs[0xC0][0]
    tq = [sof[6 + 3 * c + 2] for c in range(3)]
    sos = segs[0xDA][0]
    td = [sos[2 + 2 * c] >> 4 for c in range(3)]
    ta = [sos[2 + 2 * c] & 15 for c in range(3)]
    tables = [qts[t] for t in tq] + [dcs[t] for t in td] + [acs[t]
                                                           for t in ta]
    blobs = tables + parts

    def entries(o):
        return {**base, 273: (4, o[9:]), 279: (4, [len(p) for p in parts]),
                512: (3, [1]), 519: (4, o[0:3]), 520: (4, o[3:6]),
                521: (4, o[6:9])}
    return _tiff_with_blobs(img.shape, blobs, entries)


def _photo(h, w, seed):
    """Smooth, photo-like RGB (gradients and rings)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 5.0 + y / 7.0 + seed),
                    128 + 90 * np.cos(np.hypot(x - w / 3, y - h / 2) / 3.0),
                    128 + 110 * np.sin(x * y / 60.0 + seed)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _bilevel(h, w, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((h, w), bool)
    a[h // 6:h * 5 // 6, w // 7:w * 6 // 7] = rng.random(
        (h * 5 // 6 - h // 6, w * 6 // 7 - w // 7)) > 0.6
    a[h // 2] = True                                 # a long black run
    return a


def codec_variants():
    """The codecs libtiff decodes for PIL beyond PackBits, LZW and Deflate:
    JPEG (7) in every mode PIL writes and as YCbCr at 1x1, 2x1 and 2x2 in
    strips and tiles, with and without JPEGTables; YCbCr under the other
    codecs (libtiff's RGBA interface) at every subsampling it converts,
    with its coefficients, reference black and white and orientation;
    uncompressed YCbCr (PIL's "RGBX"); Zstandard and LZMA in every mode,
    with predictor 2, tiles, planar configuration 2, both byte orders and
    fill order 2, and an LZMA stream whose check is damaged; CCITT
    modified Huffman, T.4 (1D, 2D, fill bits) and T.6 in strips, with
    fill order 2 and min-is-white, and damaged fax strips that pin
    libtiff's recovery."""
    rng = np.random.default_rng(16)
    out = []
    img = _photo(37, 45, 1)
    base = Image.fromarray(img)
    # JPEG as PIL's writer makes it (RGB is photometric 2, YCbCr 6 at 1x1)
    for mode in ("L", "LA", "RGB", "RGBA", "CMYK", "YCbCr"):
        out.append((f"pil_{mode}_jpeg",
                    pil_tiff(base.convert(mode), compression="jpeg")))
    out.append(("pil_RGB_jpeg_q50_strips", pil_tiff(
        base, compression="jpeg", quality=50, tiffinfo={278: 16})))
    # subsampled YCbCr JPEG-in-TIFF, strips and tiles
    for sampling in ((1, 1), (2, 1), (2, 2)):
        tag = f"{sampling[0]}{sampling[1]}"
        out.append((f"ycbcr_jpeg_{tag}_strips", jpeg_tiff(
            img, ("strips", 16), sampling)))
        out.append((f"ycbcr_jpeg_{tag}_tiles", jpeg_tiff(
            img, ("tiles", 16, 16), sampling)))
    out.append(("ycbcr_jpeg_22_no_tables", jpeg_tiff(
        img, ("strips", 16), (2, 2), tables=False)))
    out.append(("ycbcr_jpeg_22_no_subsampling_tag", jpeg_tiff(
        img, ("strips", 32), (2, 2), subsampling_tag=False)))
    out.append(("ycbcr_jpeg_22_one_strip_mm", jpeg_tiff(
        img, ("strips", None), (2, 2), order="MM")))
    out.append(("ycbcr_jpeg_22_orientation6", jpeg_tiff(
        img, ("strips", 16), (2, 2), orientation=6)))
    out.append(("rgb_jpeg_tiles", jpeg_tiff(
        img, ("tiles", 16, 16), (1, 1), photometric=2)))
    out.append(("grey_jpeg_tiles", jpeg_tiff(
        img[..., 1], ("tiles", 32, 16), (1, 1), photometric=1)))
    # YCbCr through libtiff's RGBA interface
    ycc = np.asarray(base.convert("YCbCr"))
    for sub in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
        tag = f"{sub[0]}{sub[1]}"
        a = ycc if sub != (4, 4) else ycc[:, :40]
        out.append((f"ycbcr_lzw_{tag}", ims.write_tiff(
            a, photometric=6, bits=8, compression="lzw", units=sub,
            layout=("strips", 4))))
    for comp in ("none", "packbits", "adobe_deflate", "zstd", "lzma"):
        if comp == "none":
            continue
        out.append((f"ycbcr_{comp}_22", ims.write_tiff(
            ycc, photometric=6, bits=8, compression=comp, units=(2, 2),
            layout=("strips", 8))))
    out.append(("ycbcr_lzw_22_tiles", ims.write_tiff(
        ycc, photometric=6, bits=8, compression="lzw", units=(2, 2),
        layout=("tiles", 16, 16))))
    out.append(("ycbcr_lzw_11_p2", ims.write_tiff(
        ycc, photometric=6, bits=8, compression="lzw", units=(1, 1),
        predictor=2)))
    out.append(("ycbcr_lzw_22_bt709_studio", ims.write_tiff(
        ycc, photometric=6, bits=8, compression="lzw", units=(2, 2),
        tags={529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
              532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])})))
    for o in (2, 3, 4, 5, 6, 7, 8):
        out.append((f"ycbcr_lzw_22_orientation{o}", ims.write_tiff(
            ycc, photometric=6, bits=8, compression="lzw", units=(2, 2),
            orientation=o)))
    out.append(("ycbcr_raw_rgbx", ims.write_tiff(
        ycc, photometric=6, bits=8, raw_rowbytes=4 * ycc.shape[1])))
    # Zstandard and LZMA
    for comp in ("zstd", "lzma"):
        for mode in ("1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "I;16",
                     "I", "F"):
            im = base.convert(mode) if mode != "I;16" else Image.fromarray(
                (img[..., 0].astype(np.uint16) * 257))
            out.append((f"pil_{mode.replace(';', '')}_{comp}",
                        pil_tiff(im, compression=comp)))
        out.append((f"pil_RGB_{comp}_p2_strips", pil_tiff(
            base, compression=comp, tiffinfo={317: 2, 278: 8})))
        out.append((f"rgba_{comp}_p2_tiles", ims.write_tiff(
            _samples(rng, 8, 4), photometric=2, bits=8, extra_samples=(2,),
            compression=comp, predictor=2, layout=("tiles", 16, 16))))
        out.append((f"grey16_{comp}_p2_mm", ims.write_tiff(
            _samples(rng, 16, 1), photometric=1, bits=16, compression=comp,
            predictor=2, order="MM")))
        out.append((f"rgb_{comp}_planar2", ims.write_tiff(
            _samples(rng, 8, 3), photometric=2, bits=8, compression=comp,
            planar=2, layout=("strips", 5))))
        out.append((f"grey8_{comp}_fill2", ims.write_tiff(
            _samples(rng, 8, 1), photometric=1, bits=8, compression=comp,
            fill_order=2)))
    out.append(("rgb_lzma_crc64", ims.write_tiff(
        _samples(rng, 8, 3), photometric=2, bits=8, compression="lzma",
        xz_check="crc64")))
    # the check (the 8 bytes before the index) damaged: libtiff never reads
    # it, so PIL decodes the strip
    out.append(("corrupt_lzma_check", _damage_xz_check(ims.write_tiff(
        _samples(rng, 8, 3), photometric=2, bits=8, compression="lzma",
        xz_check="crc64"))))
    # CCITT
    bi = _bilevel(30, 45, 1)
    im1 = Image.fromarray(bi)
    for comp in ("tiff_ccitt", "group3", "group4"):
        out.append((f"pil_{comp}", pil_tiff(im1, compression=comp)))
        out.append((f"pil_{comp}_strips_fill2_minwhite", pil_tiff(
            im1, compression=comp, tiffinfo={278: 8, 266: 2, 262: 0})))
    for opt in (1, 4, 5):
        out.append((f"pil_group3_t4_{opt}", pil_tiff(
            im1, compression="group3", tiffinfo={292: opt, 278: 8})))
    wide = Image.fromarray(_bilevel(20, 1728, 2))
    out.append(("pil_group4_1728", pil_tiff(wide, compression="group4")))
    out += _fax_recoveries(bi)
    return out


def _damage_xz_check(data: bytes) -> bytes:
    """Flip a bit of the CRC64 check of the first strip's .xz stream: the
    8 bytes before its index, whose length the footer gives."""
    im = Image.open(io.BytesIO(data))
    off, cnt = im.tag_v2[273][0], im.tag_v2[279][0]
    stream = bytearray(data[off:off + cnt])
    index_len = (int.from_bytes(stream[-8:-4], "little") + 1) * 4
    check_at = len(stream) - 12 - index_len - 8
    stream[check_at] ^= 0x10
    return data[:off] + bytes(stream) + data[off + cnt:]


def _fax_recoveries(bi: np.ndarray):
    """Damaged fax strips whose PIL output is deterministic, one per rule
    of libtiff's recovery: T.4 1D and 2D strips whose second half is zero
    bytes (an EOL whose zeros run to the end: the rest decodes in "no EOL"
    mode), a code no table knows (the row's rest white), a T.6 strip cut
    short after the first strip (the rows it leaves keep the strip
    buffer's previous strip) and a T.6 extension code."""
    im = Image.fromarray(bi)
    out = []
    g3 = pil_tiff(im, compression="group3", tiffinfo={278: 8})
    zeros_after_half = lambda s: s[:len(s) // 2] + bytes(len(s) - len(s) // 2)
    out.append(("corrupt_group3_no_eol", _edit_strip(g3, 3,
                                                     zeros_after_half)))
    out.append(("corrupt_group3_bad_code", _edit_strip(
        g3, 1, lambda s: s[:6] + b"\x00\x3f" + s[8:])))
    g4 = pil_tiff(im, compression="group4", tiffinfo={278: 8})
    out.append(("corrupt_group4_cut", _edit_strip(
        g4, 2, lambda s: s[:len(s) // 3])))
    out.append(("corrupt_group4_bad_code", _edit_strip(
        g4, 1, lambda s: s[:5] + b"\x00\x00\xff" + s[8:])))
    g32 = pil_tiff(im, compression="group3", tiffinfo={278: 8, 292: 1})
    out.append(("corrupt_group3_2d_no_eol", _edit_strip(g32, 2,
                                                        zeros_after_half)))
    return out


def _edit_strip(data: bytes, k: int, edit) -> bytes:
    """The TIFF with strip `k` replaced by edit(strip) (the strip moved to
    the end of the file, its offset and byte count updated)."""
    import struct
    im = Image.open(io.BytesIO(data))
    offs, cnts = list(im.tag_v2[273]), list(im.tag_v2[279])
    new = edit(data[offs[k]:offs[k] + cnts[k]])
    out = bytearray(data)
    at = len(out) + (len(out) & 1)
    out += b"\x00" * (at - len(out)) + new
    e = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "I", data, 4)[0]
    n = struct.unpack_from(e + "H", data, ifd)[0]
    for i in range(n):
        tag, typ, count = struct.unpack_from(e + "HHI", data, ifd + 2 + 12 * i)
        if tag not in (273, 279):
            continue
        vals = offs if tag == 273 else cnts
        vals[k] = at if tag == 273 else len(new)
        size = {3: 2, 4: 4}[typ]
        fmt = e + {3: "H", 4: "I"}[typ] * count
        where = ifd + 2 + 12 * i + 8
        if count * size > 4:
            where = struct.unpack_from(e + "I", data, where)[0]
        struct.pack_into(fmt, out, where, *vals)
    return bytes(out)


def refused():
    """(name, bytes, why) of streams the port refuses: why None where PIL
    refuses them too, else what is not ported."""
    rng = np.random.default_rng(15)
    rgb = _samples(rng, 8, 3)
    raw = ims.write_tiff(rgb, photometric=2, bits=8)
    lzw = ims.write_tiff(rgb, photometric=2, bits=8, compression="lzw")
    ycbcr = ims.write_tiff(rgb, photometric=6, bits=8)
    img = _photo(20, 24, 2)
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
    unported = [
        ("ojpeg", jpeg_tiff(img, ("strips", 16), (2, 2),
                            tags={259: (3, [6])}),
         "old-style JPEG (compression 6)"),
        ("webp_in_tiff", ims.write_tiff(
            img, photometric=2, bits=8, compression="webp",
            chunks=[_webp(img)]), "WebP-in-TIFF (50001)"),
        ("sgilog", ims.write_tiff(img, photometric=2, bits=8,
                                  compression="sgilog",
                                  chunks=[bytes(img)]), "SGILog (34676)"),
        ("thunderscan", ims.write_tiff(
            img[..., 0] >> 4, photometric=1, bits=4, compression="thunderscan",
            chunks=[bytes(img[..., 0] >> 4)]), "ThunderScan (32809)"),
        ("grey12_jpeg", _jpeg12(), "12-bit JPEG"),
    ]
    # each `why` stands where PIL reads the stream, else None
    unported = [(n, d, why if _pil_reads(d) else None)
                for n, d, why in unported]
    return [
        ("truncated_raw", raw[:200], None),
        ("truncated_lzw", lzw[:len(lzw) // 2] + lzw[-400:], None),
        ("not_tiff", b"II\x2a\x00" + bytes(4), None),
        ("grey4_predictor2", ims.write_tiff(_samples(rng, 4, 1),
                                            photometric=1, bits=4,
                                            compression="lzw", predictor=2),
         None),
        ("palette4_fill2_raw", ims.write_tiff(
            _samples(rng, 4, 1), photometric=3, bits=4, fill_order=2,
            colormap=rng.integers(0, 65536, (3, 16))), None),
        ("bigtiff_mm", ims.write_tiff(rgb, photometric=2, bits=8, big=True,
                                      order="MM"), None),
        ("ycbcr", ycbcr, None),
    ] + unported


def legacy():
    """(name, bytes) of the layouts the reader once refused, now checked
    against PIL by tests/test_torch_tiff_legacy.py (tests/data/tiff/
    legacy/, no .npy: the YCbCr 4x4 file has pixels PIL reads from memory
    libtiff never wrote)."""
    rng = np.random.default_rng(15)
    _samples(rng, 8, 3), _samples(rng, 4, 1), _samples(rng, 4, 1)
    rng.integers(0, 65536, (3, 16))
    img = _photo(20, 24, 2)
    ycc = np.asarray(Image.fromarray(img).convert("YCbCr"))
    return [
        ("rgb16_planar2_raw", ims.write_tiff(_samples(rng, 16, 3),
                                             photometric=2, bits=16,
                                             planar=2)),
        ("ycbcr_lzw_planar2", ims.write_tiff(
            ycc, photometric=6, bits=8, compression="lzw", planar=2,
            tags={530: (3, [1, 1])})),
        ("ycbcr_lzw_44_odd_units", ims.write_tiff(
            ycc[:, :20], photometric=6, bits=8, compression="lzw",
            units=(4, 4), layout=("strips", 8))),
    ]


def _pil_reads(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            np.asarray(im)
        return True
    except Exception:
        return False


def _webp(img: np.ndarray) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "WEBP", lossless=True)
    return bio.getvalue()


def _jpeg12() -> bytes:
    """A grey JPEG-in-TIFF strip whose frame says 12-bit samples."""
    data = pil_tiff(Image.fromarray(_photo(16, 16, 3)[..., 0]),
                    compression="jpeg")
    i = data.index(b"\xff\xc0")
    return data[:i + 4] + bytes([12]) + data[i + 5:]


def _page(h: int, w: int, seed: int) -> np.ndarray:
    """A bilevel page: lines of word-like black blocks on white."""
    rng = np.random.default_rng(seed)
    page = np.zeros((h, w), bool)
    for y in range(60, h - 60, 28):
        x = 80
        while x < w - 120:
            n = int(rng.integers(12, 90))
            page[y:y + 14, x:x + n] = rng.random((14, n)) < 0.7
            x += n + int(rng.integers(8, 20))
    return page


# the four 1297x840 frames (a 1728-wide page for T.6) the chip smoke times;
# Zstandard and LZMA with predictor 2 (PIL's writer for LZMA)
def large_frames():
    import make_webp_fixtures as mw
    frame = mw.photo(840, 1297, 5, noise=0.0, scale=16.0)
    return [("large_ycbcr_jpeg_420", jpeg_tiff(frame, ("strips", 16),
                                               (2, 2))),
            ("large_zstd_p2", ims.write_tiff(frame, photometric=2, bits=8,
                                             compression="zstd", predictor=2,
                                             layout=("strips", 8))),
            ("large_lzma", pil_tiff(Image.fromarray(frame),
                                    compression="lzma", tiffinfo={317: 2})),
            ("large_group4", pil_tiff(Image.fromarray(_page(1100, 1728, 7)),
                                      compression="group4"))]


def save_large(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    notes = {}
    for name, data in large_frames():
        path = os.path.join(out, name + ".tif")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.asarray(im)
            notes[name] = {"mode": im.mode, "shape": list(arr.shape),
                           "sha256": sha256_of(arr)}
    with open(os.path.join(out, "large.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


def sha256_of(arr: np.ndarray) -> str:
    """The SHA-256 of an array's values (bool as 0/1 bytes: PIL's mode "1"
    arrays hold 255 for True)."""
    arr = arr.astype(np.uint8) if arr.dtype == bool else arr
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


# the COLMAP capture: the four 400x400 views of tests/data/webp/colmap/ as
# PIL decodes them, saved as TIFF frames in four codecs, with that
# capture's cameras and points and an images.bin naming the .tif files
CAPTURE_FRAMES = (("view_000.tif", "ycbcr_jpeg_420"),
                  ("view_001.tif", "rgb_jpeg"),
                  ("view_002.tif", "ycbcr_lzw_22"),
                  ("view_003.tif", "rgba_zstd_p2_tiles"))


def write_colmap_capture(root: str, frames=CAPTURE_FRAMES,
                         encode=None) -> None:
    import shutil
    import struct
    import sys
    sys.path.insert(0, os.path.dirname(HERE))
    from irgs_tpu_torch.scene import colmap

    src = os.path.join(HERE, "data", "webp", "colmap")
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
        for (iid, im), (name, kind) in zip(sorted(images.items()), frames):
            with Image.open(os.path.join(src, "images", im["name"])) as pim:
                pim.load()
                arr = np.asarray(pim)
            rgb = np.ascontiguousarray(arr[..., :3])
            if encode is not None:
                data = encode(rgb, kind)
            elif kind == "ycbcr_jpeg_420":
                data = jpeg_tiff(rgb, ("strips", 16), (2, 2))
            elif kind == "rgb_jpeg":
                data = pil_tiff(Image.fromarray(rgb), compression="jpeg")
            elif kind == "ycbcr_lzw_22":
                data = ims.write_tiff(
                    np.asarray(Image.fromarray(rgb).convert("YCbCr")),
                    photometric=6, bits=8, compression="lzw", units=(2, 2),
                    layout=("strips", 16))
            else:
                data = ims.write_tiff(arr, photometric=2, bits=8,
                                      extra_samples=(2,), compression="zstd",
                                      predictor=2, layout=("tiles", 64, 64))
            with open(os.path.join(root, "images", name), "wb") as fh:
                fh.write(data)
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im["qvec"]))
            f.write(struct.pack("<ddd", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


# the legacy layouts' 1297x840 frames the chip smoke times (a 1728-wide
# page for RLEW), with the SHA-256 of PIL's arrays
def _legacy_tests():
    """tests/test_torch_tiff_legacy.py, whose writers make the legacy
    layouts (it imports the port: the repository goes on the path)."""
    import sys
    sys.path.insert(0, os.path.dirname(HERE))
    import test_torch_tiff_legacy as tl
    return tl


def legacy_large_frames():
    import make_webp_fixtures as mw
    tl = _legacy_tests()
    frame = mw.photo(840, 1297, 5, noise=0.0, scale=16.0)
    grey = np.asarray(Image.fromarray(frame).convert("L"))
    ycc = np.asarray(Image.fromarray(frame).convert("YCbCr"))
    page = _page(1100, 1728, 7)
    f32 = grey.astype(np.float32)[..., None] / 7.0
    rows = 64
    return [
        ("large_ojpeg", ojpeg_tiff(frame, "tables", rps=16)),
        ("large_old_lzw_p2", tl._old_lzw(frame, predictor=2, rps=rows)),
        ("large_ycbcr_lzw_planar2", ims.write_tiff(
            ycc, photometric=6, bits=8, compression="lzw", planar=2,
            layout=("strips", rows), tags={530: (3, [1, 1])})),
        ("large_rgb16_lzw_p2_planar2", ims.write_tiff(
            frame.astype(np.uint16) * 257, photometric=2, bits=16,
            planar=2, compression="lzw", predictor=2,
            layout=("strips", rows))),
        ("large_float_p3", ims.write_tiff(
            f32, photometric=1, bits=32, sample_format=3,
            compression="adobe_deflate", layout=("strips", rows),
            chunks=[zlib_compress(ims.fp_predict(f32[y:y + rows]))
                    for y in range(0, 840, rows)], tags={317: (3, [3])})),
        ("large_grey12", ims.write_tiff(
            grey[..., None].astype(np.uint16) * 16, photometric=1, bits=12,
            compression="adobe_deflate", layout=("strips", rows),
            chunks=[zlib_compress(tl.pack12(grey[y:y + rows].astype(
                np.int64) * 16)) for y in range(0, 840, rows)])),
        ("large_thunderscan", ims.write_tiff(
            (grey >> 4)[..., None], photometric=1, bits=4,
            compression="thunderscan", layout=("strips", rows),
            chunks=[ims.thunderscan_encode(grey[y:y + rows] >> 4)
                    for y in range(0, 840, rows)])),
        ("large_rlew", tl._rlew(page)),
    ]


def zlib_compress(raw: bytes) -> bytes:
    import zlib
    return zlib.compress(raw, 6)


LEGACY_LARGE_NAMES = (("large_ojpeg", "old-style JPEG 4:2:0, 16-row strips"),
                      ("large_old_lzw_p2", "old-style LZW RGB, predictor 2"),
                      ("large_ycbcr_lzw_planar2", "YCbCr 1x1 planar, LZW"),
                      ("large_rgb16_lzw_p2_planar2",
                       "16-bit RGB planar, LZW, predictor 2"),
                      ("large_float_p3", "float grey, Deflate, predictor 3"),
                      ("large_grey12", "12-bit grey, Deflate"),
                      ("large_thunderscan", "4-bit grey ThunderScan"),
                      ("large_rlew", "CCITT RLEW page, 1728 wide"))


def save_legacy_large(out: str) -> None:
    os.makedirs(out, exist_ok=True)
    notes = {}
    for name, data in legacy_large_frames():
        path = os.path.join(out, name + ".tif")
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.asarray(im)
            notes[name] = {"mode": im.mode, "shape": list(arr.shape),
                           "sha256": sha256_of(arr)}
    with open(os.path.join(out, "large.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


# the legacy capture: the same four views in the layouts this reader once
# refused
LEGACY_CAPTURE_FRAMES = (("view_000.tif", "ojpeg_ycbcr_420"),
                         ("view_001.tif", "old_lzw_rgb"),
                         ("view_002.tif", "ycbcr_lzw_planar2"),
                         ("view_003.tif", "rgb16_lzw_p2_planar2"))


def legacy_capture_frame(rgb: np.ndarray, kind: str) -> bytes:
    tl = _legacy_tests()
    if kind == "ojpeg_ycbcr_420":
        return ojpeg_tiff(rgb, "tables", rps=16)
    if kind == "old_lzw_rgb":
        return tl._old_lzw(rgb, rps=64)
    if kind == "ycbcr_lzw_planar2":
        return ims.write_tiff(
            np.asarray(Image.fromarray(rgb).convert("YCbCr")), photometric=6,
            bits=8, compression="lzw", planar=2, layout=("strips", 64),
            tags={530: (3, [1, 1])})
    return ims.write_tiff(rgb.astype(np.uint16) * 257, photometric=2,
                          bits=16, planar=2, compression="lzw", predictor=2,
                          layout=("strips", 64))


if __name__ == "__main__":
    ims.save_fixtures(OUT, variants(), refused(), ".tif")
    save_large(os.path.join(OUT, "large"))
    os.makedirs(os.path.join(OUT, "legacy"), exist_ok=True)
    for name, data in legacy():
        with open(os.path.join(OUT, "legacy", name + ".tif"), "wb") as f:
            f.write(data)
    write_colmap_capture(os.path.join(OUT, "colmap"))
    save_legacy_large(os.path.join(OUT, "legacy", "large"))
    write_colmap_capture(os.path.join(OUT, "legacy_colmap"),
                         LEGACY_CAPTURE_FRAMES, legacy_capture_frame)
    print(f"wrote {len(variants())} fixtures to {OUT}")
