"""Write the TIFF fixtures of tests/data/tiff/ (with PIL, here only).

One small file per layout the port's reader (irgs_tpu_torch/utils/tiff.py)
takes: bilevel and grey at 1 to 32 bits (signed, unsigned, float), grey +
alpha, RGB(A) at 8 and 16 bits with each kind of extra sample, palettes at
1 to 8 bits, CMYK, CIELab; each compression (none, PackBits, LZW, Adobe
Deflate, Deflate) with predictors 1 and 2; strips and tiles, planar
configurations 1 and 2, both byte orders, fill order 2, BigTIFF, the eight
EXIF orientations; and files PIL's own TIFF writer makes. Beside each
``<name>.tif`` the ``<name>.npy`` PIL decodes from it and, in
``modes.json``, its PIL mode and palette, so a machine without PIL checks
the reader. ``refused/`` holds streams PIL refuses and streams PIL reads
that the port does not yet (``refused/refused.json`` says which).

    python tests/make_tiff_fixtures.py
"""

from __future__ import annotations

import io
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
    return out


def refused():
    """(name, bytes, why) of streams the port refuses: why None where PIL
    refuses them too, else what is not ported."""
    rng = np.random.default_rng(15)
    rgb = _samples(rng, 8, 3)
    raw = ims.write_tiff(rgb, photometric=2, bits=8)
    lzw = ims.write_tiff(rgb, photometric=2, bits=8, compression="lzw")
    bio = io.BytesIO()
    Image.fromarray(rgb.astype(np.uint8)).save(bio, "TIFF", compression="jpeg")
    ycbcr = ims.write_tiff(rgb, photometric=6, bits=8)
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
        ("jpeg", bio.getvalue(), "JPEG compression (7)"),
        ("ycbcr", ycbcr, None),
        ("rgb16_planar2_raw", ims.write_tiff(_samples(rng, 16, 3),
                                             photometric=2, bits=16,
                                             planar=2),
         "16-bit planes uncompressed"),
    ]


if __name__ == "__main__":
    ims.save_fixtures(OUT, variants(), refused(), ".tif")
    print(f"wrote {len(variants())} fixtures to {OUT}")
