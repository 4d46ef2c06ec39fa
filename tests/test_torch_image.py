"""The port's image helpers against what the JAX package's CLIs use: the
Radiance .hdr reader (utils/hdr.py) against cv2.imread on files cv2.imwrite
wrote, flat and run-length encoded, and on headers cv2 takes or refuses
(signature, FORMAT line, CRLF, the resolution line as sscanf parses it);
the choice of decoder by content (utils/image.read_image_like_pil) on
files whose extension lies, against the JAX ``_load_image_any`` and its
COLMAP reader (with a TIFF and a BMP frame); and `resize_bilinear`
(utils/image.py) against jax.image.resize(..., "bilinear") at 800 -> 400
(antialiased), at an upscale and at a mixed resize.

Tolerances: the readers bit for bit (both decode the same bytes the same
way); the resize rtol 1e-5 / atol 1e-6 (float32 sums of a few taps).
"""

import io
import os
import shutil
import struct

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, UnidentifiedImageError

import fixture_checks as fc
import image_streams as ims
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene.datasets import _load_image_any
from irgs_tpu_torch.utils import hdr, image
from irgs_tpu_torch.utils.image import resize_bilinear
from test_torch_colmap import _assert_info_equal, write_colmap
from test_torch_mis import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _hdr_image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = np.exp(rng.normal(0.0, 3.0, (h, w, 3))).astype(np.float32)
    img[0, :2] = 0.0                              # exponent byte 0
    img[1, : w // 2] = img[1, :1]                 # runs for the RLE coder
    img[2, 1] = 6.0e4
    return img


@pytest.mark.parametrize("h,w", [(16, 64), (9, 4), (3, 40000), (5, 300)])
def test_read_hdr_matches_cv2(tmp_path, h, w):
    """cv2 writes widths 8..32767 run-length encoded and others flat."""
    path = str(tmp_path / "env.hdr")
    assert cv2.imwrite(path, _hdr_image(h * w, h, w))
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]      # BGR -> RGB
    got = hdr.read_hdr(path)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_load_image_any(path), want)


def test_read_hdr_flat_scanlines_of_a_wide_image(tmp_path):
    """A file whose scanlines are stored flat although RLE would be allowed
    (other writers do this), built here byte by byte."""
    rgbe = np.random.default_rng(3).integers(0, 256, (4, 12, 4), np.uint8)
    rgbe[0, 0, 0] = 1            # not the RLE marker (2, 2, ...)
    path = tmp_path / "flat.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 4 +X 12\n"
                     + rgbe.tobytes())
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(hdr.read_hdr(str(path)), want)


def test_read_hdr_rejects_other_files(tmp_path):
    p = tmp_path / "x.hdr"
    p.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(hdr.HdrError):
        hdr.read_hdr(str(p))
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 2 +X 2\n" + bytes(16))
    with pytest.raises(hdr.HdrError, match="orientation"):
        hdr.read_hdr(str(p))


# .hdr headers: cv2 takes #?RADIANCE and #?RGBE only, needs the FORMAT
# line, reads lines up to "\\n" only, and parses the resolution line with
# sscanf("-Y %d +X %d"), ignoring what follows
HDR_HEADERS = {
    "radiance": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "rgbe": b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "other_magic": b"#?FOO\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "no_format": b"#?RADIANCE\nEXPOSURE=1\n\n-Y 5 +X 12\n",
    "crlf": b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n-Y 5 +X 12\r\n",
    "resolution_junk": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                       b"-Y 5 +X 12 junk\n",
    "resolution_no_spaces": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y5+X12\n",
    "resolution_leading_space": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                                b" -Y 5 +X 12\n",
    "format_xyze": b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 5 +X 12\n",
    "comment_before_format": b"#?RADIANCE\n# by a test\n"
                             b"FORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "format_past_127_bytes": b"#?RADIANCE\n" + b"B" * 126
                             + b"FORMAT=32-bit_rle_rgbe\n\n-Y 5 +X 12\n",
    "negative_width": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 5 +X -12\n",
}


@pytest.mark.parametrize("case", sorted(HDR_HEADERS))
def test_read_hdr_header_as_cv2(tmp_path, case):
    """Taken or refused as cv2.imread takes or refuses it; what both take
    decodes to the same bits. The JAX reader raises IOError where cv2
    refuses, the port HdrError."""
    rgbe = np.random.default_rng(3).integers(1, 256, (5, 12, 4), np.uint8)
    rgbe[..., 0] = 1                     # flat scanlines, no RLE marker
    path = str(tmp_path / "env.hdr")
    with open(path, "wb") as f:
        f.write(HDR_HEADERS[case] + rgbe.tobytes())
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if want is None:
        with pytest.raises(IOError):
            jds._load_image_any(path)
        with pytest.raises(hdr.HdrError):
            hdr.read_hdr(path)
        return
    np.testing.assert_array_equal(hdr.read_hdr(path), want[..., ::-1])
    np.testing.assert_array_equal(_load_image_any(path),
                                  jds._load_image_any(path))


# files whose extension is not their format: PIL, and the port, read them
# by their content
MISLABELLED = {"jpeg_as_png": ("jpeg", ".jpg", ".png"),
               "png_as_jpg": ("png", ".png", ".jpg"),
               "jpeg_as_jfif": ("jpeg", ".jpg", ".jfif"),
               "tiff_as_png": ("tiff", ".tif", ".png"),
               "gif_as_bmp": ("gif", ".gif", ".bmp")}


def _a_fixture(fmt, ext):
    names = sorted(n for n in os.listdir(os.path.join(DATA, fmt))
                   if n.endswith(ext))
    return os.path.join(DATA, fmt, names[len(names) // 2])


@pytest.mark.parametrize("case", sorted(MISLABELLED))
def test_mislabelled_file_reads_as_jax(tmp_path, case):
    fmt, ext, new_ext = MISLABELLED[case]
    path = str(tmp_path / ("frame" + new_ext))
    shutil.copy(_a_fixture(fmt, ext), path)
    want = jds._load_image_any(path)
    got = _load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_unidentified_and_queued_files_raise(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"#define im_width 1\n#define im_height 1\nstatic char "
                  b"im_bits[] = {0x00};\n")
    # XBM, once queued, reads as PIL reads it (by content, named .png)
    arr, mode, _ = image.read_image_like_pil(str(p))
    with Image.open(p) as im:
        assert im.format == "XBM"
        assert mode == im.mode == "1"
        np.testing.assert_array_equal(arr, np.asarray(im))
    # PPM, once queued, reads as PIL reads it
    p.write_bytes(b"P6\n1 1\n255\n\x00\x07\x00")
    arr, mode, _ = image.read_image_like_pil(str(p))
    with Image.open(p) as im:
        assert mode == im.mode == "RGB"
        np.testing.assert_array_equal(arr, np.asarray(im))
    p.write_bytes(b"hello, these bytes are no image at all")
    with pytest.raises(UnidentifiedImageError):
        Image.open(p)
    with pytest.raises(image.UnreadableImageError, match="cannot identify"):
        image.read_image_like_pil(str(p))
    # WebP, once queued, reads as PIL reads it (by content, named .png); a
    # RIFF WEBP file whose first chunk PIL does not know is unidentified
    bio = io.BytesIO()
    Image.new("RGB", (4, 3), (10, 20, 30)).save(bio, "WEBP")
    p.write_bytes(bio.getvalue())
    arr, mode, _ = image.read_image_like_pil(str(p))
    with Image.open(p) as im:
        assert mode == im.mode == "RGB"
        np.testing.assert_array_equal(arr, np.asarray(im))
    data = bio.getvalue()
    p.write_bytes(data[:12] + b"VP9 " + data[16:])
    with pytest.raises(image.UnreadableImageError, match="cannot identify"):
        image.read_image_like_pil(str(p))


def test_colmap_tiff_and_bmp_frames_match_jax(tmp_path):
    """A 2-frame COLMAP scene: an LZW TIFF frame and a BMP frame, both
    named .tif (PIL picks the decoder by content)."""
    root = write_colmap(str(tmp_path / "scene"), ["PINHOLE", "OPENCV"],
                        ext=".tif", seed=14)
    folder = os.path.join(root, "images")
    first, second = sorted(os.listdir(folder))
    rgb = np.asarray(Image.open(os.path.join(folder, first)))
    Image.fromarray(rgb).save(os.path.join(folder, first), "TIFF",
                              compression="tiff_lzw")
    rgb = np.asarray(Image.open(os.path.join(folder, second)))
    Image.fromarray(rgb).save(os.path.join(folder, second), "BMP")
    _assert_info_equal(jcolmap.read_colmap_scene(root),
                       tcolmap.read_colmap_scene(root))


@pytest.mark.parametrize("src,dst,c", [((800, 800), (400, 400), 3),
                                       ((30, 50), (48, 80), 1),
                                       ((64, 40), (32, 100), 4)])
def test_resize_bilinear_matches_jax(src, dst, c):
    img = np.random.default_rng(sum(src)).uniform(
        0, 1, (*src, c)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (*dst, c), "bilinear")
    got = resize_bilinear(torch.tensor(img), *dst)
    assert tuple(got.shape) == (*dst, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# each format Pillow writes here that PIL reads and the port does not
PIL_FORMATS = {"AVIF": "RGB", "EPS": "RGB"}
# ... and the ones the port reads as PIL does (CUR: written by hand)
READ_FORMATS = {"BLP": "P", "CUR": "RGB", "DDS": "RGB", "DIB": "RGB",
                "ICNS": "RGB", "ICO": "RGB", "IM": "RGB", "JPEG2000": "RGB",
                "MSP": "1", "PCX": "RGB", "PPM": "RGB", "QOI": "RGB",
                "SGI": "RGB", "SPIDER": "F", "TGA": "RGB", "XBM": "1"}


def _saved(tmp_path, fmt, mode):
    """A 16x16 frame of random colours saved by PIL as `fmt` (a cursor by
    hand: PIL writes none), named frame.png."""
    rng = np.random.default_rng(len(fmt))
    im = Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8))
    path = tmp_path / "frame.png"
    if fmt == "CUR":
        dib = ims.dib_frame(np.asarray(im), bits=24,
                            and_mask=rng.random((16, 16)) < 0.5)
        path.write_bytes(ims.write_ico([(dib, 16, 16, 24, 0)], cur=True))
        return path
    # some savers register the file's extension as their own (SPIDER's
    # does, process-wide): save to memory and restore the registry
    extensions = dict(Image.EXTENSION)
    bio = io.BytesIO()
    try:
        im.convert(mode).save(bio, fmt)
    finally:
        Image.EXTENSION.clear()
        Image.EXTENSION.update(extensions)
    path.write_bytes(bio.getvalue())
    return path


@pytest.mark.parametrize("fmt", sorted(PIL_FORMATS))
def test_pil_format_names_itself(tmp_path, fmt):
    """A file PIL identifies (by its plugins' own checks, in Image.OPEN's
    order) but the port does not read raises "<FORMAT> is not ported",
    whatever its name."""
    path = _saved(tmp_path, fmt, PIL_FORMATS[fmt])
    with Image.open(path) as pim:
        assert pim.format == fmt
    with pytest.raises(image.UnreadableImageError,
                       match=f"{fmt} is not ported"):
        image.read_image_like_pil(str(path))


@pytest.mark.parametrize("fmt", sorted(READ_FORMATS))
def test_pil_format_reads_as_pil(tmp_path, fmt):
    """A file of a format the port reads, whatever its name, gives PIL's
    array, mode, palette and convert("RGB")."""
    path = _saved(tmp_path, fmt, READ_FORMATS[fmt])
    with Image.open(path) as pim:
        assert pim.format == fmt
    assert fc.check_as_pil(str(path))


def test_plugins_in_pils_fresh_order():
    """The dispatcher's table is Pillow's plugin list in the order a fresh
    process tries it: Image.preinit's six, then the rest of Image.OPEN."""
    assert [n.upper() for n, _, _ in image._PLUGINS] == fc.fresh_order()


# files one plugin accepts by its prefix and whose header its _open then
# refuses, so that PIL tries the next plugin: what each comes to
FALL_THROUGH = {
    # an uncompressed Targa with an empty colour map starts as a cursor
    # with no entries: CUR refuses it, TGA reads it
    "targa_past_cur": (lambda: fc_bytes("tga", "pil_RGB_top"), "TGA"),
    "cursor_cut": (lambda: b"\0\0\2\0\1\0" + bytes(10), None),
    "icon_empty": (lambda: b"\0\0\1\0\0\0" + bytes(30), None),
    "ppm_zero_width": (lambda: b"P6\n0 4\n255\n" + bytes(30), None),
    "ppm_unknown_magic": (lambda: b"P6x\n1 1\n255\n" + bytes(3), None),
    "qoi_cut_header": (lambda: b"qoif\0\0\0\1\0\0\0\1", None),
    "sgi_cut_header": (lambda: b"\x01\xda\0\1\0\2\0\3", None),
    "pcx_empty_box": (lambda: b"\x0a\x05\x01\x08" + struct.pack(
        "<HHHH", 9, 0, 2, 2) + bytes(120), None),
    "dib_cut_masks": (lambda: struct.pack("<IiiHHI", 40, 2, 2, 1, 32, 3)
                      + bytes(20), None),
}


def fc_bytes(fmt, name):
    with open(os.path.join(DATA, fmt, name + "." + fmt), "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", sorted(FALL_THROUGH))
def test_failed_header_falls_through(tmp_path, case):
    """PIL moves on to the next plugin where an _open fails in its header
    (SyntaxError, IndexError, TypeError, struct.error, no size), and so
    does the port: a Targa that starts as an empty cursor reads as PIL
    reads it; the others end, as in PIL, unidentified."""
    make, fmt = FALL_THROUGH[case]
    path = tmp_path / "frame.png"
    path.write_bytes(make())
    if fmt is None:
        with pytest.raises(UnidentifiedImageError):
            Image.open(path, formats=fc.fresh_order())
        with pytest.raises(image.UnreadableImageError,
                           match="cannot identify"):
            image.read_image_like_pil(str(path))
    else:
        with Image.open(path, formats=fc.fresh_order()) as im:
            assert im.format == fmt
        assert fc.check_as_pil(str(path))
