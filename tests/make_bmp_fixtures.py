"""Write the BMP fixtures of tests/data/bmp/ (with PIL, here only).

One small file per layout the port's reader (irgs_tpu_torch/utils/bmp.py)
takes: core, info, V3, V4 and V5 headers; 1, 4 and 8 bits with a colour
palette or a grey ramp (which PIL reads as "1" or "L"), RLE8 and RLE4
(deltas, odd absolute runs), 16 bits 5-5-5 and 5-6-5, 24 bits, 32 bits
plain (read as RGB) and with each bitfield layout PIL takes; rows
bottom-up and top-down; and the files PIL's own BMP writer makes. Beside
each ``<name>.bmp`` the ``<name>.npy`` PIL decodes from it and, in
``modes.json``, its PIL mode and palette. ``refused/`` holds streams PIL
refuses (``refused/refused.json``).

    python tests/make_bmp_fixtures.py
"""

from __future__ import annotations

import io
import os
import struct

import numpy as np
from PIL import Image

import image_streams as ims

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "bmp")
H, W = 9, 13


def _raw_rle(w, h, bits, comp, data, pal):
    """A BMP around hand-written run-length data."""
    hdr = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, comp, len(data), 0,
                      0, len(pal), 0)
    p = b"".join(bytes([c[2], c[1], c[0], 0]) for c in pal)
    off = 14 + 40 + len(p)
    return (struct.pack("<2sIHHI", b"BM", off + len(data), 0, 0, off) + hdr
            + p + data)


def variants():
    rng = np.random.default_rng(14)
    out = []

    def add(name, arr, **kw):
        out.append((name, ims.write_bmp(arr, **kw)))

    for bits in (1, 4, 8):
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        ramp = np.repeat((np.array([0, 255]) if n == 2 else np.arange(n))
                         [:, None], 3, 1)
        idx = rng.integers(0, n, (H, W))
        for header in (12, 40, 56, 108, 124):
            add(f"pal{bits}_h{header}", idx, bits=bits, header=header,
                palette=pal)
        add(f"pal{bits}_topdown", idx, bits=bits, palette=pal, top_down=True)
        if bits != 4:                  # PIL refuses 4-bit grey (see refused)
            add(f"grey{bits}", idx, bits=bits, palette=ramp)
    idx8 = rng.integers(0, 256, (H, W))
    idx8[:, : W // 2] = idx8[:, :1]
    pal8 = rng.integers(0, 256, (256, 3))
    add("rle8", idx8, bits=8, palette=pal8, compression=1)
    add("rle8_colors_used", idx8 % 40, bits=8, palette=pal8[:40],
        compression=1, colors_used=40)
    idx4 = rng.integers(0, 16, (H, W))
    idx4[:, : W // 2] = idx4[:, :1]
    pal4 = rng.integers(0, 256, (16, 3))
    add("rle4", idx4, bits=4, palette=pal4, compression=2)
    pal16 = [tuple(int(v) for v in c) for c in pal4]
    out.append(("rle4_odd_absolute_delta", _raw_rle(
        6, 3, 4, 2, bytes([0, 3, 0x12, 0x30, 0, 2, 9, 9, 1, 1, 3, 0x22, 0, 0,
                           6, 0x45, 0, 1]), pal16)))
    out.append(("rle8_delta_eol", _raw_rle(
        5, 3, 8, 1, bytes([2, 1, 0, 2, 7, 7, 1, 0, 2, 5, 0, 0, 5, 3, 0, 0,
                           5, 4, 0, 1]),
        [tuple(int(v) for v in c) for c in pal8])))
    w16 = rng.integers(0, 65536, (H, W))
    add("rgb555", w16, bits=16)
    add("rgb565_bitfields", w16, bits=16, compression=3,
        masks=(0xF800, 0x7E0, 0x1F))
    add("rgb555_bitfields_v5", w16, bits=16, header=124, compression=3,
        masks=(0x7C00, 0x3E0, 0x1F))
    rgb = rng.integers(0, 256, (H, W, 3))
    add("rgb24", rgb, bits=24)
    add("rgb24_core", rgb, bits=24, header=12)
    add("rgb24_topdown_v4", rgb, bits=24, header=108, top_down=True)
    add("rgb24_bitfields", rgb, bits=24, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF))
    w32 = rng.integers(0, 1 << 32, (H, W), dtype=np.uint64)
    add("rgb32", w32, bits=32)
    for i, m in enumerate([(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                           (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                           (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                           (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                           (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                           (0xFF000000, 0xFF00, 0xFF, 0x0),
                           (0, 0, 0, 0)]):
        add(f"rgb32_bitfields{i}_v5", w32, bits=32, header=124,
            compression=3, masks=m)
    add("rgb32_bitfields_info", w32, bits=32, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF))
    img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        im = Image.fromarray(img[..., :3]).convert(mode) if mode != "RGBA" \
            else Image.fromarray(img, "RGBA")
        bio = io.BytesIO()
        im.save(bio, "BMP")
        out.append((f"pil_{mode}", bio.getvalue()))
    return out


def refused():
    rng = np.random.default_rng(15)
    rgb = ims.write_bmp(rng.integers(0, 256, (H, W, 3)), bits=24)
    ramp4 = np.repeat(np.arange(16)[:, None], 3, 1)
    pal = [(1, 2, 3)] * 256
    return [
        ("truncated", rgb[:len(rgb) - 20], None),
        ("grey4", ims.write_bmp(rng.integers(0, 16, (H, W)), bits=4,
                                palette=ramp4), None),
        ("bits2", ims.write_bmp(rng.integers(0, 4, (H, W)), bits=2,
                                palette=rng.integers(0, 256, (4, 3))), None),
        ("rle8_short", _raw_rle(4, 3, 8, 1, bytes([4, 1, 0, 0, 2, 2, 0, 1]),
                                pal), None),
        ("bitfields_odd_masks", ims.write_bmp(
            rng.integers(0, 1 << 32, (H, W), dtype=np.uint64), bits=32,
            header=124, compression=3, masks=(0xFF00, 0xFF, 0xFF0000, 0)),
         None),
        ("header_20", b"BM" + bytes(8) + struct.pack("<II", 34, 20)
         + bytes(40), None),
        ("jpeg_compression", ims.write_bmp(rng.integers(0, 256, (H, W, 3)),
                                           bits=24, compression=4), None),
    ]


if __name__ == "__main__":
    ims.save_fixtures(OUT, variants(), refused(), ".bmp")
    print(f"wrote {len(variants())} fixtures to {OUT}")
