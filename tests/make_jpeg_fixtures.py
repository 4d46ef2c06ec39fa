"""Write the JPEG fixtures of tests/data/jpeg/ with PIL.

Each ``<name>.jpg`` sits beside ``<name>.npy``, the array that
``np.asarray(PIL.Image.open(path))`` decodes from it, so that the port's
decoder (irgs_tpu_torch/utils/jpeg.py) is checked bit for bit where PIL is
not installed. The images are synthetic patterns made from a seed.

    python tests/make_jpeg_fixtures.py [--out tests/data/jpeg]

The variants PIL does not write (4:4:0 and 4:1:1 sampling, Adobe APP14
files, RGB component ids) are made by editing the markers of a file PIL
wrote: the entropy-coded data stays a valid stream, which PIL then decodes
as the new header says.
"""

from __future__ import annotations

import argparse
import io
import os
import struct

import numpy as np
from PIL import Image

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")


def pattern(w: int, h: int, seed: int = 0, noise: float = 0.3) -> np.ndarray:
    """uint8 [h, w, 3]: gradients, rings and a checker, plus some noise."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = 128 + 100 * np.sin(x / 23.0 + y / 41.0)
    g = 128 + 90 * np.cos(np.hypot(x - 0.45 * w, y - 0.5 * h) / 17.0)
    b = 128 + 110 * np.sin(x * y / 9000.0 + 0.3 * x)
    check = (((x // 64) + (y // 64)) % 2) * 40 - 20
    img = np.stack([r + check, g - check, b], -1)
    img = (1 - noise) * img + noise * rng.randint(0, 256, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(img: np.ndarray, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, "JPEG", **kw)
    return bio.getvalue()


def segments(data: bytes):
    """(marker, start, end) of every length-prefixed segment before SOS."""
    pos = 2
    while pos < len(data):
        m = data[pos + 1]
        (n,) = struct.unpack_from(">H", data, pos + 2)
        yield m, pos, pos + 2 + n
        if m == 0xDA:
            return
        pos += 2 + n


def set_sampling(data: bytes, hv: dict) -> bytes:
    """Rewrite the SOF's sampling byte of component index -> value."""
    out = bytearray(data)
    for m, start, _ in segments(data):
        if m in (0xC0, 0xC1):
            for i, v in hv.items():
                out[start + 4 + 6 + 3 * i + 1] = v
    return bytes(out)


def drop_jfif(data: bytes) -> bytes:
    for m, start, end in segments(data):
        if m == 0xE0:
            return data[:start] + data[end:]
    return data


def with_adobe(data: bytes, transform: int) -> bytes:
    """JFIF APP0 replaced by an Adobe APP14 with the given transform flag."""
    data = drop_jfif(data)
    app14 = (b"\xff\xee" + struct.pack(">H", 14) + b"Adobe"
             + struct.pack(">HHHB", 100, 0, 0, transform))
    return data[:2] + app14 + data[2:]


def with_ids(data: bytes, ids) -> bytes:
    """No JFIF marker, and the components renamed in SOF and SOS."""
    data = bytearray(drop_jfif(data))
    for m, start, _ in segments(bytes(data)):
        if m in (0xC0, 0xC1):
            for i, cid in enumerate(ids):
                data[start + 4 + 6 + 3 * i] = cid
        if m == 0xDA:
            for i, cid in enumerate(ids):
                data[start + 5 + 2 * i] = cid
    return bytes(data)


def variants():
    """name -> JPEG bytes: every variant the decoder handles."""
    img = pattern(33, 47, seed=1)
    v = {
        "s444_q95_17x9": encode(pattern(17, 9, seed=2), quality=95,
                                subsampling=0),
        "s422_q50_33x47": encode(img, quality=50, subsampling=1),
        "s420_q100_33x47": encode(img, quality=100, subsampling=2),
        "s420_q95_opt_1x1": encode(pattern(1, 1, seed=3), quality=95,
                                   subsampling=2, optimize=True),
        "s420_q95_opt_33x47": encode(img, quality=95, subsampling=2,
                                     optimize=True),
        "grey_q90_17x9": encode(pattern(17, 9, seed=4)[..., 0], quality=90),
        "restart_q90_33x47": encode(img, quality=90, subsampling=2,
                                    restart_marker_blocks=3),
        "dqt16_sof1_24x16": encode(pattern(24, 16, seed=5),
                                   qtables=[[300] * 64, [400] * 64]),
        # 4:2:2 relabelled h1v2 (29 x 43: both give 2 x 6 MCUs)
        "s440_q90_29x43": set_sampling(encode(pattern(29, 43, seed=6),
                                              quality=90, subsampling=1),
                                       {0: 0x12}),
        # 4:2:0 relabelled h4v1 (64 x 32: both give 8 MCUs): int_upsample
        "s411_q90_64x32": set_sampling(encode(pattern(64, 32, seed=7),
                                              quality=90, subsampling=2),
                                       {0: 0x41}),
        "adobe_rgb_q90_17x9": with_adobe(encode(pattern(17, 9, seed=8),
                                                quality=90, subsampling=0), 0),
        "adobe_ycc_q90_17x9": with_adobe(encode(pattern(17, 9, seed=9),
                                                quality=90, subsampling=2), 1),
        "ids_rgb_q90_17x9": with_ids(encode(pattern(17, 9, seed=10),
                                            quality=90, subsampling=0),
                                     (82, 71, 66)),
    }
    return v


def large() -> bytes:
    """Mip-NeRF 360's images_4 frame size, 4:2:0 at quality 95."""
    return encode(pattern(1297, 840, seed=11, noise=0.0), quality=95,
                  subsampling=2)


def write(out: str = OUT) -> None:
    os.makedirs(out, exist_ok=True)
    items = dict(variants())
    items["large_1297x840_q95"] = large()
    for name, data in items.items():
        with open(os.path.join(out, name + ".jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(out, name + ".npy"),
                np.asarray(Image.open(io.BytesIO(data))))
        print(f"{name}: {len(data)} bytes")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    write(ap.parse_args().out)
