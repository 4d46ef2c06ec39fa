"""The TIFF codecs and layouts utils/tiff.py read since the port's first
TIFF reader refused them, each against ``PIL.Image.open`` (Pillow 12.1,
libtiff 4.7.1) on files written here: 12-bit grey (PIL's I;12 unpacker)
uncompressed and under each codec, the floating-point predictor 3,
ThunderScan, old-style LZW, CCITT RLEW (32771), planar configuration 2
(YCbCr, 16-bit planes uncompressed, no ExtraSamples tag) and YCbCr 4x4
strips whose data units libtiff reads in part; what PIL refuses here
(SGILog, WebP-in-TIFF, 12-bit big-endian, a float predictor on integers,
...) raises where PIL raises, as "cannot identify" where PIL's _open
fails, and never as "not ported"; damaged strips of the new codecs decode
as libtiff decodes them, or raise where it fails.

Tolerance: bit for bit, array, mode and ``convert("RGB")``; pixels PIL
reads from memory libtiff never wrote (`report["undefined"]`) are not
compared.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

import fixture_checks as fc
import image_streams as ims
import make_tiff_fixtures as mk
from irgs_tpu_torch.utils import image, tiff

H, W = 11, 19
LEGACY = os.path.join(fc.DATA, "tiff", "legacy")


def pack12(v: np.ndarray) -> bytes:
    """[rows, cols] 12-bit values -> rows packed MSB-first, byte-aligned."""
    out = bytearray()
    for r in np.asarray(v, np.int64).reshape(v.shape[0], -1):
        bits = "".join(f"{x:012b}" for x in r)
        bits += "0" * (-len(bits) % 8)
        out += int(bits, 2).to_bytes(len(bits) // 8, "big")
    return bytes(out)


def _codec(comp, raw):
    return {"none": lambda b: b, "lzw": ims.lzw_encode_tiff,
            "packbits": ims.packbits_encode,
            "adobe_deflate": lambda b: __import__("zlib").compress(b, 6),
            "zstd": ims.zstd_compress, "lzma": ims.xz_compress}[comp](raw)


def _photo(h, w, seed):
    """Smooth 8-bit RGB with some texture (runs and small deltas)."""
    y, x = np.mgrid[:h, :w]
    rng = np.random.default_rng(seed)
    img = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                    (x + y) * 3 % 256], -1)
    img = img + rng.integers(-3, 4, img.shape) * (rng.random(img.shape[:2])
                                                  < 0.3)[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def _twelve(comp, layout=("strips", None), w=W):
    v = np.random.default_rng(12).integers(0, 4096, (H, w))
    v[:, :w // 3] = v[:, :1]
    if layout[0] == "tiles":
        tw, th = layout[1], layout[2]
        chunks = []
        for y in range(0, H, th):
            for x in range(0, w, tw):
                t = np.zeros((th, tw), np.int64)
                part = v[y:y + th, x:x + tw]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(_codec(comp, pack12(t)))
    else:
        rps = layout[1] or H
        chunks = [_codec(comp, pack12(v[y:y + rps]))
                  for y in range(0, H, rps)]
    return ims.write_tiff(v[..., None].astype(np.uint16), photometric=1,
                          bits=12, compression=comp, layout=layout,
                          chunks=chunks)


def _float_p3(comp, layout=("strips", None), order="II", spp=1):
    f = (np.random.default_rng(3).standard_normal((H, W, spp)) * 50
         ).astype(np.float32)
    f[:, :5] = f[:, :1]
    if layout[0] == "tiles":
        tw, th = layout[1], layout[2]
        chunks = []
        for y in range(0, H, th):
            for x in range(0, W, tw):
                t = np.zeros((th, tw, spp), np.float32)
                part = f[y:y + th, x:x + tw]
                t[:part.shape[0], :part.shape[1]] = part
                chunks.append(_codec(comp, ims.fp_predict(t)))
    else:
        rps = layout[1] or H
        chunks = [_codec(comp, ims.fp_predict(f[y:y + rps]))
                  for y in range(0, H, rps)]
    return ims.write_tiff(f, photometric=1, bits=32, sample_format=3,
                          compression=comp, layout=layout, order=order,
                          chunks=chunks, tags={317: (3, [3])})


def _thunder(photometric=1, rps=None, w=W, seed=4):
    rng = np.random.default_rng(seed)
    g = np.clip(np.cumsum(rng.integers(-1, 2, (H, w)), 1) + 7, 0, 15)
    g[2, 3:12] = 9
    g[5] = rng.integers(0, 16, w)
    rps = rps or H
    chunks = [ims.thunderscan_encode(g[y:y + rps]) for y in range(0, H, rps)]
    return ims.write_tiff(g[..., None], photometric=photometric, bits=4,
                          compression="thunderscan", layout=("strips", rps),
                          chunks=chunks)


def _old_lzw(arr, photometric=2, bits=8, predictor=1, rps=None):
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h = arr.shape[0]
    rps = rps or h
    e = np.dtype(f"<u{bits // 8}")
    chunks = []
    for y in range(0, h, rps):
        block = arr[y:y + rps].astype(np.int64)
        if predictor == 2:
            block = np.concatenate([block[:, :1], np.diff(block, axis=1)], 1)
        raw = (block & ((1 << bits) - 1)).astype(e).tobytes()
        chunks.append(ims.lzw_encode_tiff_compat(raw))
    return ims.write_tiff(arr, photometric=photometric, bits=bits,
                          compression="lzw", predictor=predictor,
                          layout=("strips", rps), chunks=chunks)


def _rlew(bi: np.ndarray) -> bytes:
    """CCITT RLEW (32771): each row's modified Huffman code (PIL's CCITT
    RLE writer, one row at a time), padded to a 16-bit word."""
    data = bytearray()
    for row in bi:
        b = io.BytesIO()
        Image.fromarray(row[None]).save(b, "TIFF", compression="tiff_ccitt")
        with Image.open(io.BytesIO(b.getvalue())) as im:
            off, cnt = im.tag_v2[273][0], im.tag_v2[279][0]
        code = b.getvalue()[off:off + cnt]
        data += code + bytes(len(code) % 2)
    return ims.write_tiff(bi[..., None].astype(np.uint8), photometric=0,
                          bits=1, chunks=[bytes(data)],
                          tags={259: (3, [32771])})


def _pil_rlew(bi: np.ndarray) -> bytes:
    """PIL's own RLEW file: libtiff's encoder does not word-align the rows,
    so its decoder meets bad code words (damaged rows, whitened)."""
    b = io.BytesIO()
    Image.fromarray(bi).save(b, "TIFF", compression="tiff_raw_16")
    return b.getvalue()


def _ycc(h=H, w=W, seed=6):
    return np.asarray(Image.fromarray(_photo(h, w, seed)).convert("YCbCr"))


def readable():
    rng = np.random.default_rng(18)
    rgb = _photo(H, W, 1)
    bi = rng.random((13, 37)) < 0.3
    bi[:, 20:] = False
    grey = _photo(64, 200, 2)[..., 0]
    r16 = rng.integers(0, 65536, (H, W, 4))
    cases = {
        "g12_raw": _twelve("none"),
        "g12_raw_odd_width": _twelve("none", w=7),
        "g12_lzw": _twelve("lzw"),
        "g12_packbits_strips": _twelve("packbits", ("strips", 4)),
        "g12_adobe_deflate": _twelve("adobe_deflate"),
        "g12_zstd": _twelve("zstd"),
        "g12_lzma": _twelve("lzma"),
        "g12_lzw_tiles": _twelve("lzw", ("tiles", 16, 16)),
        "fp3_lzw": _float_p3("lzw"),
        "fp3_lzw_mm": _float_p3("lzw", order="MM"),
        "fp3_deflate_tiles": _float_p3("adobe_deflate", ("tiles", 16, 16)),
        "fp3_zstd_strips": _float_p3("zstd", ("strips", 3)),
        "fp3_lzma": _float_p3("lzma"),
        "thunder": _thunder(),
        "thunder_strips": _thunder(rps=4),
        "thunder_minwhite": _thunder(photometric=0),
        "thunder_odd_width": _thunder(w=8, seed=5),
        "old_lzw_rgb": _old_lzw(rgb),
        "old_lzw_grey_long": _old_lzw(grey, photometric=1),
        "old_lzw_grey_strips_p2": _old_lzw(grey, photometric=1, predictor=2,
                                           rps=20),
        "old_lzw_rgb16": _old_lzw(r16[..., :3], bits=16),
        "rlew": _rlew(bi),
        "rlew_as_pil_writes": _pil_rlew(bi),
        "ycbcr_lzw_planar2": ims.write_tiff(
            _ycc(), photometric=6, bits=8, compression="lzw", planar=2,
            tags={530: (3, [1, 1])}),
        "ycbcr_raw_planar2": ims.write_tiff(
            _ycc(), photometric=6, bits=8, planar=2, tags={530: (3, [1, 1])}),
        "ycbcr_zstd_planar2_tiles": ims.write_tiff(
            _ycc(), photometric=6, bits=8, compression="zstd", planar=2,
            layout=("tiles", 16, 16), tags={530: (3, [1, 1])}),
        "rgb16_planar2_raw": ims.write_tiff(r16[..., :3], photometric=2,
                                            bits=16, planar=2),
        "rgb16_planar2_raw_mm": ims.write_tiff(r16[..., :3], photometric=2,
                                               bits=16, planar=2, order="MM"),
        "rgb16_planar2_raw_strips": ims.write_tiff(
            r16[..., :3], photometric=2, bits=16, planar=2,
            layout=("strips", 4)),
        "rgb16_planar2_raw_tiles": ims.write_tiff(
            r16[..., :3], photometric=2, bits=16, planar=2,
            layout=("tiles", 16, 16)),
        "rgba16_planar2_raw": ims.write_tiff(r16, photometric=2, bits=16,
                                             planar=2, extra_samples=(2,)),
        "cmyk16_planar2_raw": ims.write_tiff(r16, photometric=5, bits=16,
                                             planar=2),
        "rgb16_planar2_lzw_p2": ims.write_tiff(
            r16[..., :3], photometric=2, bits=16, planar=2,
            compression="lzw", predictor=2),
        "rgba_planar2_no_extra_raw": ims.write_tiff(
            r16.astype(np.uint8), photometric=2, bits=8, planar=2),
        "rgba_planar2_no_extra_raw_tiles": ims.write_tiff(
            r16.astype(np.uint8), photometric=2, bits=8, planar=2,
            layout=("tiles", 16, 16)),
        "rgba_planar2_no_extra_lzw": ims.write_tiff(
            r16.astype(np.uint8), photometric=2, bits=8, planar=2,
            compression="lzw"),
    }
    cases.update({
        "ojpeg_jif_22": mk.ojpeg_tiff(_photo(29, 37, 3)),
        "ojpeg_jif_11": mk.ojpeg_tiff(_photo(29, 37, 3), sampling=(1, 1)),
        "ojpeg_jif_21_no_subsampling_tag": mk.ojpeg_tiff(
            _photo(29, 37, 3), sampling=(2, 1), subsampling_tag=False),
        "ojpeg_tables_22": mk.ojpeg_tiff(_photo(29, 37, 4), "tables"),
        "ojpeg_tables_22_strips": mk.ojpeg_tiff(_photo(48, 37, 4), "tables",
                                                rps=16),
        "ojpeg_tables_21_strips": mk.ojpeg_tiff(_photo(40, 37, 5), "tables",
                                                rps=8, sampling=(2, 1)),
        "ojpeg_tables_11_strips_q50": mk.ojpeg_tiff(
            _photo(40, 37, 5), "tables", rps=8, sampling=(1, 1), quality=50),
    })
    for name in sorted(os.listdir(LEGACY)):
        if name.endswith(".tif"):
            with open(os.path.join(LEGACY, name), "rb") as f:
                cases["file_" + name[:-4]] = f.read()
    return cases


READABLE = readable()


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        arr = np.asarray(im)
        try:
            rgb = np.asarray(im.convert("RGB"))
        except (ValueError, OSError):
            rgb = None
        return arr, im.mode, rgb


def _check(data):
    """The port against PIL on `data`: equal where PIL reads it (pixels
    libtiff never wrote aside), a TiffError where PIL raises. Returns
    (PIL read it, undefined pixels)."""
    try:
        want, mode, rgb = _pil(data)
    except UnidentifiedImageError:
        with pytest.raises(tiff.TiffHeaderError):
            tiff.decode_tiff(data)
        return False, 0
    except Exception:
        with pytest.raises(tiff.TiffError) as err:
            tiff.decode_tiff(data)
        assert isinstance(err.value, image.NotThisFormat) is False
        return False, 0
    report = {}
    arr, got_mode, info = tiff.decode_tiff(data, report=report)
    keep = ~report["undefined"]
    assert got_mode == mode and arr.dtype == want.dtype
    assert arr.shape == want.shape
    np.testing.assert_array_equal(arr[keep], want[keep])
    if rgb is not None:
        np.testing.assert_array_equal(image.to_rgb_like_pil(
            arr, mode, info.get("palette"))[keep], rgb[keep])
    return True, int((~keep).sum())


@pytest.mark.parametrize("name", sorted(READABLE))
def test_legacy_layout_equals_pil(name):
    read, undefined = _check(READABLE[name])
    assert read, name
    assert undefined == 0 or "44" in name


def test_ycbcr_44_units_read_in_part():
    """A 4x4 YCbCr strip whose row of data units does not divide by 4:
    libtiff reads the strip's units in part, and the pixels of the units'
    unread bytes are reported, the rest equal PIL's."""
    data = READABLE["file_ycbcr_lzw_44_odd_units"]
    read, undefined = _check(data)
    assert read and undefined > 0
    arr, _, _ = tiff.decode_tiff(data, report={})
    assert arr.shape[:2] == (20, 20)


def refused():
    rng = np.random.default_rng(19)
    rgb = _photo(H, W, 3)
    g12 = rng.integers(0, 4096, (H, W))
    f16 = rng.standard_normal((H, W, 1)).astype(np.float16)
    return {
        "sgilog_under_rgb": ims.write_tiff(rgb, photometric=2, bits=8,
                                           compression="sgilog",
                                           chunks=[bytes(rgb)]),
        "sgilog_logluv": ims.write_tiff(rgb, photometric=32845, bits=8,
                                        compression="sgilog",
                                        chunks=[bytes(rgb)]),
        "sgilog24_logl": ims.write_tiff(rgb[..., :1], photometric=32844,
                                        bits=8, chunks=[bytes(H * W)],
                                        tags={259: (3, [34677])}),
        "webp_in_tiff": ims.write_tiff(rgb, photometric=2, bits=8,
                                       compression="webp",
                                       chunks=[bytes(64)]),
        "g12_big_endian": ims.write_tiff(
            g12[..., None].astype(np.uint16), photometric=1, bits=12,
            order="MM", chunks=[pack12(g12)]),
        "g12_min_is_white": ims.write_tiff(
            g12[..., None].astype(np.uint16), photometric=0, bits=12,
            chunks=[pack12(g12)]),
        "g12_predictor2": ims.write_tiff(
            g12[..., None].astype(np.uint16), photometric=1, bits=12,
            compression="lzw", chunks=[ims.lzw_encode_tiff(pack12(g12))],
            tags={317: (3, [2])}),
        "unknown_compression": ims.write_tiff(rgb, photometric=2, bits=8,
                                              chunks=[bytes(rgb)],
                                              tags={259: (3, [34712])}),
        "rlew_8_bit": ims.write_tiff(rgb, photometric=2, bits=8,
                                     chunks=[bytes(rgb)],
                                     tags={259: (3, [32771])}),
        "float16_predictor3": ims.write_tiff(
            f16, photometric=1, bits=16, sample_format=3, compression="lzw",
            chunks=[ims.lzw_encode_tiff(ims.fp_predict(f16))],
            tags={317: (3, [3])}),
        "int32_predictor3": ims.write_tiff(
            g12[..., None].astype(np.int32), photometric=1, bits=32,
            sample_format=2, compression="lzw",
            chunks=[ims.lzw_encode_tiff(bytes(4 * H * W))],
            tags={317: (3, [3])}),
        "thunderscan_8_bit": ims.write_tiff(
            rgb[..., :1], photometric=1, bits=8, compression="thunderscan",
            chunks=[bytes(H * W)]),
        "ycbcr_22_planar2": ims.write_tiff(
            _ycc(), photometric=6, bits=8, compression="lzw", planar=2),
        "la_planar2_no_extra": ims.write_tiff(rgb[..., :2], photometric=1,
                                              bits=8, planar=2),
        "thunderscan_short": _thunder()[:-60] + bytes(60),
    }


REFUSED = refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_where_pil_refuses(name):
    data = REFUSED[name]
    read, _ = _check(data)
    assert not read, name
    with pytest.raises(tiff.TiffError) as err:
        tiff.decode_tiff(data)
    assert "not ported" not in str(err.value)


DAMAGED = ["thunder_strips", "old_lzw_grey_strips_p2", "g12_lzw",
           "fp3_lzw", "rlew", "rgb16_planar2_lzw_p2", "ojpeg_jif_22",
           "ojpeg_tables_22_strips"]


@pytest.mark.parametrize("name", DAMAGED)
def test_damaged_strips_as_pil(name):
    """40 seeded one-bit flips in each file's strips: PIL's array where
    PIL decodes it (pixels libtiff never wrote aside), TiffError where PIL
    raises."""
    data = READABLE[name]
    with Image.open(io.BytesIO(data)) as im:
        spans = list(zip(im.tag_v2[273], im.tag_v2[279]))
    rng = np.random.default_rng([18, DAMAGED.index(name)])
    decoded = 0
    for _ in range(40):
        off, cnt = spans[rng.integers(len(spans))]
        out = bytearray(data)
        out[off + rng.integers(cnt)] ^= 1 << rng.integers(8)
        decoded += _check(bytes(out))[0]
    assert decoded > 0


LARGE = os.path.join(LEGACY, "large")
CAPTURE = os.path.join(fc.DATA, "tiff", "legacy_colmap")


@pytest.mark.parametrize("name", sorted(n for n, _ in
                                        mk.LEGACY_LARGE_NAMES))
def test_large_legacy_frame_equals_pil(name):
    """The 1297x840 frames the chip smoke times (tests/data/tiff/legacy/
    large/), against PIL and the SHA-256 the card checks."""
    import json
    path = os.path.join(LARGE, name + ".tif")
    with open(os.path.join(LARGE, "large.json")) as f:
        want = json.load(f)[name]
    arr, mode, _ = tiff.read_tiff_like_pil(path)
    assert (mode, list(arr.shape)) == (want["mode"], want["shape"])
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))
    assert mk.sha256_of(arr) == want["sha256"]


def test_load_scene_legacy_capture_matches_jax():
    """The COLMAP capture of legacy TIFF frames (old-style JPEG 4:2:0,
    old-style LZW, planar YCbCr, planar 16-bit RGB with predictor 2): the
    JAX loaders against the port's."""
    from irgs_tpu.scene import colmap as jcolmap
    from irgs_tpu.scene import datasets as jds
    from irgs_tpu_torch.scene import colmap as tcolmap
    from irgs_tpu_torch.scene import datasets as tds
    from test_torch_colmap import _assert_info_equal
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.LEGACY_CAPTURE_FRAMES)
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    _assert_info_equal(jcolmap.read_colmap_scene(CAPTURE),
                       tcolmap.read_colmap_scene(CAPTURE))
