"""PNG, JPEG, TIFF, GIF and WebP files whose header PIL's plugin refuses in
its _open (SyntaxError, EOFError, IndexError, KeyError, TypeError,
struct.error): PIL's Image.open hands the file to the next plugin and,
where none takes it, says "cannot identify image file"; the port's
content-sniffing reader does the same (the reader raises
image.NotThisFormat). A header PIL takes and data PIL then fails on raise
in both, but not as "cannot identify". Crafted headers, then seeded
damaged copies of committed fixtures, against PIL in a fresh process's
plugin order.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, UnidentifiedImageError

import fixture_checks as fc
from irgs_tpu_torch.utils import image

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _pil(im, fmt, **kw):
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _crafted():
    rng = np.random.default_rng(18)
    rgb = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    png = _pil(Image.fromarray(rgb), "PNG")
    jpg = _pil(Image.fromarray(rgb), "JPEG")
    gif = _pil(Image.fromarray(rgb).convert("P"), "GIF")
    tif = _pil(Image.fromarray(rgb), "TIFF")
    sig = b"\x89PNG\r\n\x1a\n"
    ihdr = struct.pack(">IIBBBBB", 7, 6, 8, 2, 0, 0, 0)
    idat = _png_chunk(b"IDAT", zlib.compress(bytes(7 * 6 * 3 + 6)))
    iend = _png_chunk(b"IEND", b"")
    sof = jpg.index(b"\xff\xc0")
    c = {
        "png_bad_ihdr_crc": png[:29] + bytes([png[29] ^ 1]) + png[30:],
        "png_chunk_type_not_word": png[:12] + b"IH-R" + png[16:],
        "png_cut_after_signature": png[:10],
        "png_ihdr_filter_method": sig + _png_chunk(
            b"IHDR", ihdr[:11] + b"\x01\x00") + idat + iend,
        "png_no_ihdr": sig + idat + iend,
        "png_grey_trns_short": sig + _png_chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 7, 6, 8, 0, 0, 0, 0)) + _png_chunk(b"tRNS", b"\x01")
        + _png_chunk(b"IDAT", zlib.compress(bytes(7 * 6 + 6))) + iend,
        "png_unknown_depth": sig + _png_chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 7, 6, 3, 2, 0, 0, 0)) + idat + iend,
        "png_chunk_payload_cut": png[:40],
        "jpeg_12_bit_sof": jpg[:sof + 4] + b"\x0c" + jpg[sof + 5:],
        "jpeg_two_layers": jpg[:sof + 9] + b"\x02" + jpg[sof + 10:],
        "jpeg_cut_before_scan": jpg[:sof + 12],
        "jpeg_unknown_marker": jpg[:2] + b"\xff\x01" + jpg[2:],
        "jpeg_sof_layers_cut": jpg[:sof + 2] + struct.pack(
            ">H", struct.unpack_from(">H", jpg, sof + 2)[0] - 1)
        + jpg[sof + 4:sof + 19] + jpg[sof + 20:],
        "jpeg_no_frame": jpg[:sof] + jpg[jpg.index(b"\xff\xda"):],
        "tiff_unknown_compression": _tiff_tag(tif, 259, 7777),
        "tiff_no_width": _tiff_tag(tif, 256, None),
        "tiff_unknown_pixel_mode": _tiff_tag(tif, 262, 9),
        "tiff_no_first_ifd": tif[:4] + bytes(4) + tif[8:],
        "tiff_palette_without_map": _tiff_tag(_pil(
            Image.fromarray(rgb).convert("P"), "TIFF"), 320, None),
        "tiff_raw_without_strips": _tiff_tag(tif, 273, None),
        "tiff_lzw_without_strips": _tiff_tag(_pil(
            Image.fromarray(rgb), "TIFF", compression="tiff_lzw"), 273, None),
        "gif_cut_in_header": gif[:11],
        "gif_cut_in_descriptor": gif[:gif.index(b",") + 5],
        "gif_no_frame": gif[:gif.index(b",")] + b";",
        "gif_short_control_extension": gif[:_gif_head(gif)]
        + b"!\xf9\x02\x01\x00\x00" + gif[_gif_head(gif):],
        "webp_bad_vp8": _pil(Image.fromarray(rgb), "WEBP")[:30] + bytes(20),
    }
    return c


def _gif_head(gif):
    """The bytes before a GIF's first block: header and global palette."""
    return 13 + (3 << ((gif[10] & 7) + 1) if gif[10] & 128 else 0)


def _tiff_tag(buf, tag, value):
    """A little-endian TIFF with `tag` set to a short `value` in place, or
    renamed to an unknown tag where `value` is None."""
    buf = bytearray(buf)
    (ifd,) = struct.unpack_from("<I", buf, 4)
    (n,) = struct.unpack_from("<H", buf, ifd)
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", buf, at)[0] == tag:
            if value is None:
                struct.pack_into("<H", buf, at, 65000)
            else:
                struct.pack_into("<HHIHH", buf, at, tag, 3, 1, value, 0)
            return bytes(buf)
    raise KeyError(tag)


CRAFTED = _crafted()


def _outcome(path):
    """("read" | "unidentified" | "error") of PIL and of the port."""
    try:
        fc.pil_fresh(path)
        pil = "read"
    except UnidentifiedImageError:
        pil = "unidentified"
    except Exception:
        pil = "error"
    try:
        image.read_image_like_pil(path)
        port = "read"
    except image.UnreadableImageError as e:
        port = ("unidentified" if "cannot identify" in str(e) else "error")
    except ValueError:
        port = "error"
    return pil, port


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_crafted_header_handed_on_as_pil(tmp_path, name):
    ext = {"png": ".png", "jpeg": ".jpg", "tiff": ".tif", "gif": ".gif",
           "webp": ".webp"}[name.split("_")[0]]
    path = tmp_path / f"x{ext}"
    path.write_bytes(CRAFTED[name])
    pil, port = _outcome(str(path))
    assert pil != "read", name
    assert port == pil, (name, pil, port)


SWEEP = [("png", ".png", "ct2_d8"), ("png", ".png", "ct3_d4"),
         ("jpeg", ".jpg", "prog_s420_q90_33x47"),
         ("jpeg", ".jpg", "grey_q90_17x9"), ("gif", ".gif", "global8"),
         ("gif", ".gif", "local2_interlaced"), ("tiff", ".tif", "palette2"),
         ("tiff", ".tif", "cmyk"), ("webp", ".webp", "alph_m0_f1")]


@pytest.mark.parametrize("fmt,ext,name", SWEEP,
                         ids=[s[2] for s in SWEEP])
def test_damaged_headers_identified_as_pil(tmp_path, fmt, ext, name):
    """Damaged copies (cuts and bit flips, half of them in the first 48
    bytes): PIL says "cannot identify" exactly where the port does."""
    with open(os.path.join(DATA, fmt, name + ext), "rb") as f:
        data = f.read()
    rng = np.random.default_rng([18, SWEEP.index((fmt, ext, name))])
    for i, d in enumerate(fc.damaged(data, rng, 24, head=48)):
        path = tmp_path / f"{i}{ext}"
        path.write_bytes(d)
        pil, port = _outcome(str(path))
        assert (pil == "unidentified") == (port == "unidentified"), (
            i, pil, port)


JPEG_REFUSED = sorted(os.path.basename(p)[:-4] for p in __import__(
    "glob").glob(os.path.join(DATA, "jpeg", "refused", "*.jpg")))
PNG_CRAFTED = sorted(n for n in CRAFTED if n.startswith("png_"))


@pytest.mark.parametrize("name", JPEG_REFUSED)
def test_refused_jpeg_raises_jpeg_error_by_path(name):
    """The JPEG reader's own entry point raises JpegError on every refused
    stream, a header PIL's _open refuses (a zero height: no size) as
    JpegHeaderError."""
    from irgs_tpu_torch.utils import jpeg
    with pytest.raises(jpeg.JpegError):
        jpeg.read_jpeg(os.path.join(DATA, "jpeg", "refused", name + ".jpg"))


@pytest.mark.parametrize("name", PNG_CRAFTED)
def test_refused_png_header_raises_png_error(tmp_path, name):
    from irgs_tpu_torch.utils import png
    path = tmp_path / "x.png"
    path.write_bytes(CRAFTED[name])
    with pytest.raises(png.PngError):
        png.read_png_like_pil(str(path))
