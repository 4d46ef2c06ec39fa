"""Write the PNG fixtures of tests/data/png/ and the process_images
fixtures of tests/data/process_images/ (with PIL, here only).

tests/data/png/: one file per PNG image type (grey at 1, 2, 4, 8, 16 bits,
palette at 1, 2, 4, 8 bits, RGB, grey + alpha and RGBA at 8 and 16 bits),
each plain and Adam7-interlaced, and palette, grey and RGB files with a
tRNS chunk, every row filter
used in turn; beside each ``<name>.png`` the ``<name>.npy`` PIL decodes
from it, and in ``modes.json`` its PIL mode and palette. So a machine
without PIL checks the port's reader (irgs_tpu_torch/utils/png.py).

tests/data/process_images/: ``in/`` a few small images of several modes
(RGB JPEG with a comment, CMYK JPEG, palette PNG with tRNS, 16-bit grey,
1-bit, RGBA in a subfolder, and a vis grid), ``out/`` what the root
``process_images.py`` makes of them (``crop`` with CROP_ARGS, and
``split-grid`` of ``grid.png``).

    python tests/make_png_fixtures.py
"""

from __future__ import annotations

import io
import json
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
PNG_OUT = os.path.join(HERE, "data", "png")
PI_OUT = os.path.join(HERE, "data", "process_images")
CROP_ARGS = ["--downscale", "2", "--crop", "-2", "1", "3", "-2"]
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _filter_row(row: np.ndarray, prev: np.ndarray, bpp: int, f: int):
    x = row.astype(np.int32)
    up = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    if f == 0:
        pred = np.zeros_like(x)
    elif f == 1:
        pred = left
    elif f == 2:
        pred = up
    elif f == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, ul))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, stride] packed bytes."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.uint8)
    per = 8 // depth
    flat = samples.reshape(h, w * c)
    pad = np.zeros((h, -(-flat.shape[1] // per) * per), np.uint8)
    pad[:, :flat.shape[1]] = flat
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(pad.reshape(h, -1, per) << shifts,
                                axis=2).astype(np.uint8)


def raw_png(samples: np.ndarray, ctype: int, depth: int, interlace=0,
            palette=None, trns=None) -> bytes:
    """A PNG of the given samples [h, w, c] (values as stored), each row
    filtered with the next of the five filters."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    raw = bytearray()
    k = 0
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r in rows:
            f = k % 5
            raw += bytes([f]) + _filter_row(r, prev, bpp, f).tobytes()
            prev = r
            k += 1
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


def png_variants():
    rng = np.random.default_rng(12)
    w, h = 13, 11
    v = {}
    for ctype, depths in ((0, (1, 2, 4, 8, 16)), (3, (1, 2, 4, 8)),
                          (2, (8, 16)), (4, (8, 16)), (6, (8, 16))):
        for depth in depths:
            c = _CHANNELS[ctype]
            top = 1 << depth
            if ctype == 3:
                n = min(top, 5 if depth == 8 else top - 1 if top > 2 else 2)
                samples = rng.integers(0, n, (h, w, 1))
                palette = rng.integers(0, 256, (n, 3))
            else:
                samples = rng.integers(0, top, (h, w, c))
                palette = None
            samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
            for interlace in (0, 1):
                name = f"ct{ctype}_d{depth}" + ("_adam7" if interlace else "")
                v[name] = raw_png(samples, ctype, depth, interlace, palette)
    pal = rng.integers(0, 256, (6, 3))
    idx = rng.integers(0, 6, (h, w, 1)).astype(np.uint8)
    v["ct3_d8_trns"] = raw_png(idx, 3, 8, 0, pal, bytes([255, 0, 128]))
    v["ct3_d4_trns_simple_adam7"] = raw_png(idx, 3, 4, 1, pal,
                                            bytes([255, 255, 0]))
    # tRNS of grey and RGB images: a grey sample, or an (r, g, b) triple,
    # as 16-bit values (PIL keeps them in info as int and tuple)
    for name, ctype, depth, trns in (
            ("ct0_d1_trns", 0, 1, (1,)), ("ct0_d4_trns_adam7", 0, 4, (9,)),
            ("ct0_d8_trns", 0, 8, (7,)), ("ct0_d16_trns", 0, 16, (40000,)),
            ("ct2_d8_trns", 2, 8, (10, 20, 30)),
            ("ct2_d16_trns_adam7", 2, 16, (300, 65535, 0))):
        samples = rng.integers(0, 1 << depth, (h, w, _CHANNELS[ctype]))
        v[name] = raw_png(samples.astype(np.uint16 if depth == 16
                                         else np.uint8), ctype, depth,
                          name.endswith("adam7"), None,
                          struct.pack(f">{len(trns)}H", *trns))
    return v


def pil_info(im) -> dict:
    """Mode, palette and transparency of a PIL image, as JSON holds them
    (bytes and tuples as lists)."""
    t = im.info.get("transparency")
    info = {"mode": im.mode, "palette": None,
            "transparency": list(t) if isinstance(t, (bytes, tuple)) else t}
    if im.mode == "P":
        info["palette"] = np.asarray(im.getpalette(), int).reshape(
            -1, 3).tolist()
    return info


def write_png_fixtures(out: str = PNG_OUT) -> None:
    os.makedirs(out, exist_ok=True)
    modes = {}
    for name, data in png_variants().items():
        path = os.path.join(out, name + ".png")
        with open(path, "wb") as f:
            f.write(data)
        im = Image.open(io.BytesIO(data))
        np.save(os.path.join(out, name + ".npy"), np.asarray(im))
        modes[name] = pil_info(im)
        print(f"{name}: {len(data)} bytes, {im.mode}")
    with open(os.path.join(out, "modes.json"), "w") as f:
        json.dump(modes, f, indent=1, sort_keys=True)


def _pattern(w, h, seed):
    sys.path.insert(0, HERE)
    import make_jpeg_fixtures as fx
    return fx.pattern(w, h, seed=seed)


def write_process_images_fixtures(out: str = PI_OUT) -> None:
    src, dst = os.path.join(out, "in"), os.path.join(out, "out")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(src, "sub"))
    rgb = Image.fromarray(_pattern(45, 37, 20))
    rgb.info["comment"] = b"irgs_tpu fixture"
    rgb.save(os.path.join(src, "a_rgb.jpg"), comment=b"irgs_tpu fixture")
    Image.fromarray(_pattern(33, 29, 21)).convert("CMYK").save(
        os.path.join(src, "e_cmyk.JPEG"))
    p = Image.fromarray(_pattern(30, 26, 22)).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=12)
    p.save(os.path.join(src, "b_palette.png"), transparency=3)
    g16 = (np.arange(31 * 27).reshape(27, 31) * 97 % 65536).astype(np.uint16)
    Image.fromarray(g16).save(os.path.join(src, "c_grey16.png"))
    Image.fromarray(_pattern(29, 23, 23)[..., 0] > 128).save(
        os.path.join(src, "f_1bit.png"))
    rgba = np.concatenate([_pattern(26, 34, 24),
                           _pattern(26, 34, 25)[..., :1]], -1)
    Image.fromarray(rgba, "RGBA").save(os.path.join(src, "sub", "d_rgba.png"))
    grid = np.zeros((3 * 10 + 2 * 20, 44, 3), np.uint8)
    grid[10:30, 10:34] = _pattern(24, 20, 26)
    grid[40:60, 10:34] = _pattern(24, 20, 27) // 3
    Image.fromarray(grid).save(os.path.join(src, "grid.png"))
    root = os.path.dirname(HERE)
    script = os.path.join(root, "process_images.py")
    subprocess.run([sys.executable, script, "crop", src, dst, *CROP_ARGS],
                   check=True)
    shutil.copy(os.path.join(src, "grid.png"), os.path.join(out, "grid.png"))
    subprocess.run([sys.executable, script, "split-grid",
                    os.path.join(out, "grid.png")], check=True)
    os.remove(os.path.join(out, "grid.png"))
    for folder in (out, src, dst):
        for fn in sorted(os.listdir(folder)):
            p = os.path.join(folder, fn)
            if os.path.isfile(p):
                print(os.path.relpath(p, out), os.path.getsize(p), "bytes")


if __name__ == "__main__":
    write_png_fixtures()
    write_process_images_fixtures()
