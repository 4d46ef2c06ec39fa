"""A ``.hdr`` path whose bytes are not Radiance, as the JAX loader reads it
(``cv2.imread(path, IMREAD_UNCHANGED)``, BGR flipped, float32 without a
division by 255): utils/imread.imread_unchanged against cv2.imread on PNG,
JPEG, TIFF, BMP, WebP, GIF, PNM, PFM, JPEG 2000, Sun raster and PAM
content of every layout it reads, and the port's ``_load_image_any``
against the JAX one on the same files. Content cv2 cannot decode (EXR with
OpenEXR off, Targa, QOI, bytes no decoder takes, a header its decoder
refuses, JPEG 2000 with grey + alpha or signed samples, a cut codestream,
an XV thumbnail, which reaches the PAM decoder, and one file of each of
Pillow's last small rasters) raises OSError in both; content cv2 decodes
and the port does not (AVIF) raises "not ported", and where the AVIF
decoder's checks end is probed against cv2.

Tolerance: bit for bit (both decode the same bytes the same way).
"""

import io
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import exr, image
from irgs_tpu_torch.utils.imread import imread_unchanged


def _pil(im, fmt, **kw):
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _contents():
    rng = np.random.default_rng(18)
    rgb = rng.integers(0, 256, (12, 17, 3), dtype=np.uint8)
    rgba = np.dstack([rgb, rgb[..., :1]])
    grey = rgb[..., 0]
    u16 = rng.integers(0, 65536, (12, 17, 3)).astype(np.uint16)
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE,
                                       colors=5)
    greypal = Image.fromarray(grey // 2).convert("P")
    greypal.putpalette([i // 2 for i in range(256) for _ in range(3)])
    f32 = rng.random((12, 17)).astype(np.float32)
    c = {
        "png_rgb": _pil(Image.fromarray(rgb), "PNG"),
        "png_rgba": _pil(Image.fromarray(rgba), "PNG"),
        "png_L": _pil(Image.fromarray(grey), "PNG"),
        "png_LA": _pil(Image.fromarray(rgb[..., :2].copy(), "LA"), "PNG"),
        "png_1": _pil(Image.fromarray(grey > 128), "PNG"),
        "png_I16": _pil(Image.fromarray(u16[..., 0]), "PNG"),
        "png_P": _pil(pal, "PNG"),
        "png_P_trns": _pil(pal, "PNG", transparency=1),
        "png_L_trns": _pil(Image.fromarray(grey), "PNG", transparency=7),
        "png_rgb_trns": _pil(Image.fromarray(rgb), "PNG", transparency=tuple(
            int(v) for v in rgb[0, 0])),
        "jpg_rgb": _pil(Image.fromarray(rgb), "JPEG"),
        "jpg_L": _pil(Image.fromarray(grey), "JPEG"),
        "jpg_cmyk": _pil(Image.fromarray(rgb).convert("CMYK"), "JPEG"),
        "tif_rgb": _pil(Image.fromarray(rgb), "TIFF"),
        "tif_rgba": _pil(Image.fromarray(rgba), "TIFF"),
        "tif_L": _pil(Image.fromarray(grey), "TIFF"),
        "tif_1": _pil(Image.fromarray(grey > 128), "TIFF"),
        "tif_I16": _pil(Image.fromarray(u16[..., 0]), "TIFF"),
        "tif_F": _pil(Image.fromarray(f32), "TIFF"),
        "tif_lzw": _pil(Image.fromarray(rgb), "TIFF", compression="tiff_lzw"),
        "tif_P": _pil(pal, "TIFF"),
        "bmp_rgb": _pil(Image.fromarray(rgb), "BMP"),
        "bmp_L": _pil(Image.fromarray(grey), "BMP"),
        "bmp_P": _pil(pal, "BMP"),
        "bmp_grey_palette": _pil(greypal, "BMP"),
        "bmp_1": _pil(Image.fromarray(grey > 128), "BMP"),
        "webp_lossy": _pil(Image.fromarray(rgb), "WEBP"),
        "webp_lossless_alpha": _pil(Image.fromarray(rgba), "WEBP",
                                    lossless=True),
        "gif": _pil(pal, "GIF"),
        "gif_trns": _pil(pal, "GIF", transparency=1),
        "ppm_P6": _pil(Image.fromarray(rgb), "PPM"),
        "ppm_P5": _pil(Image.fromarray(grey), "PPM"),
        "ppm_P4": _pil(Image.fromarray(grey > 128), "PPM"),
        "ppm_P5_16": _pil(Image.fromarray(u16[..., 0].astype(np.int32), "I"),
                          "PPM"),
        "ppm_P2_100": b"P2\n3 2\n100\n0 50 100 1 2 300\n",
        "ppm_P2_1000": b"P2\n# a comment\n3 1\n1000\n0 500 1000\n",
        "ppm_P3": b"P3\n2 1\n255\n1 2 3 4 5 6\n",
        "ppm_P1": b"P1\n3 2\n010\n1 1 0\n",
        "ppm_P5_200": b"P5\n4 1\n200\n" + bytes([0, 1, 100, 250]),
        "ppm_P6_16": b"P6\n2 1\n65535\n" + np.array(
            [1, 2, 3, 60000, 5, 6], ">u2").tobytes(),
        "pfm_Pf": _pil(Image.fromarray(f32, "F"), "PPM"),
        "pfm_PF_scaled": b"PF\n3 2\n-2.5\n" + (rng.random(18) * 9).astype(
            "<f4").tobytes(),
        "pfm_Pf_big_endian": b"Pf\n2 2\n3.0\n" + rng.random(4).astype(
            ">f4").tobytes(),
    }
    c["tif_rgba16"] = _tiff16(u16, rng)
    return c


def _tiff16(u16, rng):
    """A 16-bit RGBA TIFF, unassociated alpha, written byte by byte."""
    a = rng.integers(0, 65536, u16.shape[:2] + (1,)).astype(np.uint16)
    data = np.concatenate([u16, a], -1).astype("<u2").tobytes()
    h, w = u16.shape[:2]
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 4, None),
               (262, 3, 1, 2), (273, 4, 1, None), (277, 3, 1, 4),
               (278, 3, 1, h), (279, 4, 1, len(data)), (338, 3, 1, 2)]
    ifd_at = 8
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    data_at = extra_at + 8
    out = bytearray(b"II*\0" + ifd_at.to_bytes(4, "little"))
    out += len(entries).to_bytes(2, "little")
    for tag, typ, n, v in entries:
        if tag == 258:
            v = extra_at
        elif tag == 273:
            v = data_at
        out += (tag.to_bytes(2, "little") + typ.to_bytes(2, "little")
                + n.to_bytes(4, "little") + v.to_bytes(4, "little"))
    out += bytes(4) + np.array([16] * 4, "<u2").tobytes() + data
    return bytes(out)


def _jpeg2000_contents():
    """JPEG 2000 fixtures cv2 reads: a JP2 and a raw codestream, 8, 12 and
    16 bits, grey, RGB, RGBA, sYCC, a palette on a grey codestream."""
    import os
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jp2")
    names = {"jp2_rgb": "rgb_97_layers.jp2", "j2k_L": "L_97_layers.j2k",
             "jp2_rgba": "RGBA.jp2", "j2k_rgb12": "rgb_12bit_97.j2k",
             "j2k_I16": "I16_97.j2k", "jp2_sycc": "colr_sycc.jp2",
             "jp2_pclr": "pclr_L.jp2", "j2k_tiles_sop_eph": "sop_eph_tiles.j2k"}
    out = {}
    for key, name in names.items():
        with open(os.path.join(data, name), "rb") as f:
            out[key] = f.read()
    return out


def _sun_pam_contents():
    """The committed Sun raster and PAM files cv2 reads (cv2's writes and
    hand-made ones, tests/make_im_sun_xpm_fli_fixtures.py)."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "sun", "cv2")
    out = {}
    for name in sorted(os.listdir(folder)):
        if name.endswith(".hdr"):
            with open(os.path.join(folder, name), "rb") as f:
                out["sunpam_" + name[:-4]] = f.read()
    return out


CONTENTS = {**_contents(), **_jpeg2000_contents(), **_sun_pam_contents()}


@pytest.mark.parametrize("name", sorted(CONTENTS))
def test_hdr_path_by_content_as_cv2(tmp_path, name):
    path = str(tmp_path / f"{name}.hdr")
    with open(path, "wb") as f:
        f.write(CONTENTS[name])
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert want is not None, name
    got = imread_unchanged(path)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    j, t = jds._load_image_any(path), tds._load_image_any(path)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)


def _unreadable():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    return {
        "garbage": b"hello world" * 10,
        "targa": _pil(Image.fromarray(rgb), "TGA"),
        "qoi": _pil(Image.fromarray(rgb), "QOI"),
        "tiff_pil_only_magic": b"MM\x2a\x00" + bytes(40),
        "ppm_bad_header": b"P6\nx 1\n255\n" + bytes(3),
        "ppm_truncated": b"P6\n4 4\n255\n" + bytes(10),
        "radiance_no_format": b"#?RADIANCE\n\n-Y 1 +X 1\n" + bytes(4),
        "jp2_grey_alpha": _pil(Image.fromarray(rgb[..., :2].copy(), "LA"),
                               "JPEG2000"),
        "j2k_signed": _pil(Image.fromarray(rgb), "JPEG2000", signed=True,
                           no_jp2=True),
        "j2k_cut": _pil(Image.fromarray(rgb), "JPEG2000", no_jp2=True)[:80],
    }


UNREADABLE = _unreadable()


@pytest.mark.parametrize("name", sorted(UNREADABLE) + ["exr"])
def test_hdr_path_cv2_cannot_read(tmp_path, name):
    path = str(tmp_path / f"{name}.hdr")
    if name == "exr":
        exr.write_exr(str(tmp_path / "e.exr"), np.ones((2, 3, 3), np.float32))
        (tmp_path / f"{name}.hdr").write_bytes(
            (tmp_path / "e.exr").read_bytes())
    else:
        (tmp_path / f"{name}.hdr").write_bytes(UNREADABLE[name])
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jds._load_image_any(path)
    with pytest.raises(OSError):
        tds._load_image_any(path)


def _avif() -> bytes:
    rgb = np.random.default_rng(21).integers(0, 256, (16, 16, 3), np.uint8)
    return _pil(Image.fromarray(rgb), "AVIF")


def test_hdr_path_cv2_reads_and_port_does_not(tmp_path):
    """An AVIF file named .hdr: cv2.imread reads it (libavif), the port
    names it not ported instead of saying that cv2 cannot read it."""
    path = str(tmp_path / "avif.hdr")
    (tmp_path / "avif.hdr").write_bytes(_avif())
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED).shape == (16, 16, 3)
    with pytest.raises(image.UnreadableImageError, match="AVIF.*not ported"):
        tds._load_image_any(path)


def _brands(data, major, compat):
    """`data`'s 32-byte ftyp box with other brands, its size kept (the
    item locations are absolute offsets)."""
    assert data[:4] == b"\0\0\0 " and len(compat) == 4
    return data[:8] + major + data[12:16] + b"".join(compat) + data[32:]


def _avif_probes():
    data = _avif()
    return {"avif_major": (data, True),
            "avif_compatible_only": (_brands(data, b"mif1", [
                b"mif1", b"avif", b"miaf", b"MA1B"]), True),
            "mif1_alone": (_brands(data, b"mif1", [
                b"mif1", b"miaf", b"MA1B", b"MA1B"]), False),
            "avis_compatible_only": (_brands(data, b"mif1", [
                b"mif1", b"avis", b"miaf", b"MA1B"]), False),
            "ftyp_cut": (data[:20], False),
            "file_cut_after_ftyp": (data[:40], False),
            "ftyp_size_zero": (bytes(4) + data[4:], False)}


AVIF_PROBES = _avif_probes()


@pytest.mark.parametrize("name", sorted(AVIF_PROBES))
def test_hdr_path_avif_boundary_as_cv2(tmp_path, name):
    """Where cv2 reads an ftyp-branded file the port names AVIF not
    ported; where cv2 gives None (no avif brand, a cut box) both loaders
    raise the JAX loader's IOError."""
    data, reads = AVIF_PROBES[name]
    path = str(tmp_path / f"{name}.hdr")
    (tmp_path / f"{name}.hdr").write_bytes(data)
    assert (cv2.imread(path, cv2.IMREAD_UNCHANGED) is not None) == reads
    if reads:
        with pytest.raises(image.UnreadableImageError, match="not ported"):
            tds._load_image_any(path)
        return
    with pytest.raises(IOError):
        jds._load_image_any(path)
    with pytest.raises(OSError):
        tds._load_image_any(path)


# one committed fixture of each Photoshop and GPU-texture format
# (tests/make_texture_fixtures.py), which cv2.imread does not read
TEXTURES = {"dds": "dds/pil_dxt5.dds", "psd": "psd/rgb_packbits.psd",
            "blp": "blp/blp1_jpeg_rgb.blp", "ftex": "ftex/raw_rgb.ftc",
            "icns": "icns/is32_s8mk.icns"}


@pytest.mark.parametrize("name", sorted(TEXTURES))
def test_hdr_path_texture_formats_cv2_cannot_read(tmp_path, name):
    """A DDS, PSD, BLP, FTEX or ICNS file named .hdr: cv2.imread returns
    None, the JAX loader raises its IOError, and so does the port (the
    .hdr path reads by content as cv2 does, never through PIL's
    readers)."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       TEXTURES[name])
    path = str(tmp_path / f"{name}.hdr")
    with open(src, "rb") as f:
        (tmp_path / f"{name}.hdr").write_bytes(f.read())
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jds._load_image_any(path)
    with pytest.raises(OSError):
        tds._load_image_any(path)
    assert image.read_image_like_pil(src)[0].size > 0


# one committed fixture of each of Pillow's last small rasters
# (tests/make_im_sun_xpm_fli_fixtures.py) that cv2.imread does not read:
# the Sun raster is RLE, which OpenCV's decoder refuses; the XV thumbnail
# (P7 332) reaches the PAM decoder, which refuses its header
SMALL_RASTERS = {"im": "im/pil_RGB.im", "xbm": "xbm/pil_save.xbm",
                 "xpm": "xpm/p_two_chars.xpm", "sun_rle": "sun/d8_rle.ras",
                 "msp": "msp/v1_pil.msp", "spider": "spider/pil_save.spi",
                 "fits": "fits/bitpix8.fits", "dcx": "dcx/rgb_one_frame.dcx",
                 "fli": "fli/brun_colour256.fli",
                 "pcd": "pcd/base_orientation0.pcd", "pixar": "pixar/rgb.pxr",
                 "gbr": "gbr/v2_rgba.gbr", "mcidas": "mcidas/L.area",
                 "imt": "imt/L.imt", "xvthumb": "xvthumb/p332.xv",
                 "iptc": "iptc/raw_grey.iim"}


@pytest.mark.parametrize("name", sorted(SMALL_RASTERS))
def test_hdr_path_small_rasters_cv2_cannot_read(tmp_path, name):
    """Each such file named .hdr: cv2.imread returns None, the JAX loader
    raises its IOError, and so does the port, which PIL's reader
    (utils/image.py) reads under the file's own name."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       SMALL_RASTERS[name])
    path = str(tmp_path / f"{name}.hdr")
    with open(src, "rb") as f:
        (tmp_path / f"{name}.hdr").write_bytes(f.read())
    assert cv2.imread(path, cv2.IMREAD_UNCHANGED) is None
    with pytest.raises(IOError):
        jds._load_image_any(path)
    with pytest.raises(OSError):
        tds._load_image_any(path)
    assert image.read_image_like_pil(src)[0].size > 0
