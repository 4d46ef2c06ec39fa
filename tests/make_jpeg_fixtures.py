"""Write the JPEG fixtures of tests/data/jpeg/ with PIL.

Each ``<name>.jpg`` sits beside ``<name>.npy``, the array that
``np.asarray(PIL.Image.open(path))`` decodes from it, so that the port's
decoder (irgs_tpu_torch/utils/jpeg.py) is checked bit for bit where PIL is
not installed. The images are synthetic patterns made from a seed.

    python tests/make_jpeg_fixtures.py [--out tests/data/jpeg]

The variants PIL does not write (4:4:0 and 4:1:1 sampling, Adobe APP14
files, RGB component ids, YCCK) are made by editing the markers of a file
PIL wrote: the entropy-coded data stays a valid stream, which PIL then
decodes as the new header says. PIL writes the progressive, restart and
CMYK variants itself; an incomplete progressive file is one PIL wrote with
its last scans dropped (libjpeg-turbo then smooths its blocks). The
arithmetic-coded (SOF9, SOF10, with DAC) and lossless (SOF3) variants come
from the test-side encoders of tests/jpeg_streams.py; PIL's decode of them
is the array kept.

The two large re-saves of ``large_1297x840_q95`` (progressive, written by
PIL, and progressive arithmetic, re-encoded from its coefficients) carry
the same coefficients, so they decode to the same array and reuse its
``.npy`` (`ARRAY_OF`). PIL (Pillow 12.1) feeds libjpeg-turbo 64 KiB at a
time, and the arithmetic decoder cannot suspend when its data runs out, so
the arithmetic one has COM segments that start its scans past each 64 KiB
read; as written, without them, it is ``refused/arith_scan_past_64k_read``.

``refused/`` holds streams PIL refuses (`refused()`, `LARGE_REFUSED`): the
port raises on each as well.
"""

from __future__ import annotations

import argparse
import io
import os
import struct

import numpy as np
from PIL import Image

import jpeg_streams as js

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


def drop_scans(data: bytes, keep: int) -> bytes:
    """The stream with only its first `keep` scans, then EOI."""
    pos, seen = 2, 0
    while True:
        m = data[pos + 1]
        (n,) = struct.unpack_from(">H", data, pos + 2)
        if m == 0xDA:
            if seen == keep:
                return data[:pos] + b"\xff\xd9"
            seen += 1
            p = pos + 2 + n
            while not (data[p] == 0xFF and data[p + 1] != 0
                       and not 0xD0 <= data[p + 1] <= 0xD7):
                p += 1
            pos = p
        else:
            pos += 2 + n


def cmyk(img: np.ndarray, **kw) -> bytes:
    bio = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(bio, "JPEG", **kw)
    return bio.getvalue()


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    i = data.index(b"Adobe")
    return data[:i + 11] + bytes([transform]) + data[i + 12:]


def drop_adobe(data: bytes) -> bytes:
    for m, start, end in segments(data):
        if m == 0xEE:
            return data[:start] + data[end:]
    return data


def _arith_source(w=37, h=29, seed=12):
    """Coefficients of a PIL 4:2:0 file at quality 85."""
    return js.read_baseline(encode(pattern(w, h, seed=seed), quality=85,
                                   subsampling=2))


def arith(progressive, restart=0, dac=False, grey=False):
    coefs, samp, q, tq, size = _arith_source()
    if grey:
        coefs, samp, tq = coefs[:1], [(1, 1)], tq[:1]
        # one component at 1 x 1: its blocks as the frame's MCUs
    kw = dict(dc_l=(1, 2, 0, 0), dc_u=(4, 5, 1, 1), ac_k=(3, 9, 5, 5)) \
        if dac else {}
    return js.write_arith(coefs, samp, q[:len(set(tq))], tq, size,
                          progressive=progressive,
                          restart=restart, dac=dac, **kw)


def lossless(predictor, pt=0, restart_rows=0, grey=False):
    img = pattern(37, 29, seed=13)
    return js.write_lossless(img[..., 0] if grey else img, predictor, pt,
                             restart_rows)


def lossless_rgb(predictor, w=37, h=29, ids=(1, 2, 3), **kw):
    """A 3-component lossless frame with no JFIF or Adobe marker, which
    libjpeg-turbo takes as RGB whatever the component ids."""
    return js.write_lossless(pattern(w, h, seed=19), predictor, header=b"",
                             ids=list(ids), **kw)


def arith_fractional():
    """An arithmetic frame at 3 x 1 / 2 x 1 / 1 x 1: 3 is no multiple of 2,
    which libjpeg-turbo's upsampler refuses. The coefficients are
    _arith_source's, cut or padded to the new block grid."""
    coefs, _, q, tq, (w, h) = _arith_source()
    sampling = [(3, 1), (2, 1), (1, 1)]
    mx, my = -(-w // 24), -(-h // 8)
    out = []
    for (hs, vs), c in zip(sampling, coefs):
        a = np.zeros((my * vs, mx * hs, 64), np.int16)
        r, k = min(a.shape[0], c.shape[0]), min(a.shape[1], c.shape[1])
        a[:r, :k] = c[:r, :k]
        out.append(a)
    return js.write_arith(out, sampling, q[:len(set(tq))], tq, (w, h))


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
        # progressive Huffman (SOF2)
        "prog_s420_q90_33x47": encode(img, quality=90, subsampling=2,
                                      progressive=True),
        "prog_s444_q75_17x9": encode(pattern(17, 9, seed=14), quality=75,
                                     subsampling=0, progressive=True),
        "prog_grey_q90_33x47": encode(img[..., 1], quality=90,
                                      progressive=True),
        "prog_restart_q85_33x47": encode(img, quality=85, subsampling=1,
                                         progressive=True,
                                         restart_marker_blocks=2),
        # incomplete progressive: DC only (DC interpolation), and the last
        # refinement scans missing (AC estimates)
        "prog_dconly_61x45": drop_scans(encode(pattern(61, 45, seed=15),
                                               quality=75, progressive=True),
                                        1),
        "prog_partial_61x45": drop_scans(encode(pattern(61, 45, seed=15),
                                                quality=75, progressive=True),
                                         6),
        # four components: PIL's CMYK (Adobe, transform 0), YCCK, and
        # CMYK without an Adobe marker
        "cmyk_q75_17x9": cmyk(pattern(17, 9, seed=16)),
        "ycck_q75_17x9": set_adobe_transform(cmyk(pattern(17, 9, seed=17)),
                                             2),
        "cmyk_noadobe_q75_17x9": drop_adobe(cmyk(pattern(17, 9, seed=18))),
        # arithmetic coding (SOF9, SOF10), default and DAC conditioning
        "arith_seq_37x29": arith(False),
        "arith_seq_dac_restart_37x29": arith(False, restart=5, dac=True),
        "arith_prog_37x29": arith(True),
        "arith_prog_dac_restart_37x29": arith(True, restart=3, dac=True),
        "arith_prog_grey_37x29": arith(True, grey=True),
    }
    # lossless Huffman (SOF3): each predictor, point transforms, restarts
    for p in range(1, 8):
        v[f"lossless_p{p}_37x29"] = lossless(p, pt=p % 3,
                                             restart_rows=(0, 5)[p % 2],
                                             grey=p == 7)
    # three components, no marker: RGB in lossless mode whatever the ids
    v["lossless_ids123_37x29"] = lossless_rgb(1)
    v["lossless_ids012_37x29"] = lossless_rgb(4, ids=(0, 1, 2))
    v["lossless_ids597_restart_37x29"] = lossless_rgb(6, ids=(5, 9, 7),
                                                      restart_rows=5)
    # subsampled lossless (the first component at 2 x 1 or 2 x 2), even and
    # odd sizes, restarts; and one scan per component at 1 x 2 with a
    # restart every row (the predictor restarts once per iMCU row)
    v["lossless_s21_36x29"] = lossless_rgb(1, 36, sampling=[(2, 1), (1, 1),
                                                            (1, 1)])
    v["lossless_s22_36x29"] = lossless_rgb(1, 36, sampling=[(2, 2), (1, 1),
                                                            (1, 1)])
    v["lossless_s21_restart_37x29"] = lossless_rgb(
        5, sampling=[(2, 1), (1, 1), (1, 1)], restart_rows=3)
    v["lossless_s22_restart_37x29"] = lossless_rgb(
        7, pt=2, sampling=[(2, 2), (1, 1), (1, 1)], restart_rows=2)
    v["lossless_s12_scans_restart_37x29"] = lossless_rgb(
        2, sampling=[(1, 2), (1, 1), (1, 1)], restart=37, interleaved=False)
    return v


def refused():
    """name -> a stream PIL refuses to decode (and the port too)."""
    base = encode(pattern(16, 16), quality=90)
    i = base.index(b"\xff\xc0")
    return {
        "twelve_bit": base[:i + 4] + bytes([12]) + base[i + 5:],
        "dnl_height": base[:i + 5] + b"\x00\x00" + base[i + 7:],
        "sof5_hierarchical": base[:i + 1] + b"\xc5" + base[i + 2:],
        "sof11_arith_lossless": js.write_lossless(pattern(16, 16)[..., 0],
                                                  1, marker=0xCB),
        "two_components": with_two_components(base),
        "lossless_ycbcr": js.write_lossless(pattern(16, 16), 1,
                                            header=js.JFIF),
        "arith_fractional_sampling": arith_fractional(),
        # restart intervals of 7 and 16 MCUs on an 11-wide frame
        "lossless_restart_7": js.write_lossless(
            pattern(11, 9, seed=20)[..., 0], 1, restart=7),
        "lossless_restart_16": js.write_lossless(
            pattern(11, 9, seed=20)[..., 0], 1, restart=16),
    }


def with_two_components(data: bytes) -> bytes:
    out = bytearray(data)
    i = data.index(b"\xff\xc0")
    out[i + 9] = 2
    return bytes(out)


def large_variants():
    """The large frame re-saved progressive (PIL) and progressive
    arithmetic (from its coefficients): same coefficients, same array.
    -> (name -> stream PIL reads, name -> stream PIL refuses): the
    arithmetic scans as written run past PIL's 64 KiB reads, so the stream
    PIL reads has COM segments before its scans (`pad_scans_past_reads`)."""
    data = large()
    coefs, samp, q, tq, size = js.read_baseline(data)
    arith = js.write_arith(coefs, samp, q, tq, size, progressive=True)
    return {
        "large_1297x840_q95_progressive": encode(
            pattern(1297, 840, seed=11, noise=0.0), quality=95,
            subsampling=2, progressive=True),
        "large_1297x840_q95_arith": pad_scans_past_reads(arith),
    }, {"arith_scan_past_64k_read": arith}


def pad_scans_past_reads(data: bytes, block: int = 65536) -> bytes:
    """An arithmetic-coded stream with a COM segment before each scan whose
    data (up to the code of the marker after it) would hold a multiple of
    `block`: the scan then starts at that multiple. PIL feeds libjpeg-turbo
    the file in reads of `block` bytes, and its arithmetic decoder cannot
    suspend when a read ends inside a scan."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    bounds = sos + [len(data) - 2]                          # EOI last
    out = data[:sos[0]]
    for a, b in zip(bounds, bounds[1:]):
        (hdr,) = struct.unpack_from(">H", data, a + 2)
        first, last = len(out) + 2 + hdr, len(out) + b - a + 1
        m = -(-first // block) * block
        if m <= last:
            out += b"\xff\xfe" + struct.pack(">H", m - len(out) - 2)
            out += b"\0" * (m - len(out))
        out += data[a:b]
    return out + data[-2:]


# refused/ streams that large_variants() writes
LARGE_REFUSED = ("arith_scan_past_64k_read",)
# fixture -> the fixture whose .npy it decodes to
ARRAY_OF = {name: "large_1297x840_q95" for name in (
    "large_1297x840_q95_progressive", "large_1297x840_q95_arith")}


def large() -> bytes:
    """Mip-NeRF 360's images_4 frame size, 4:2:0 at quality 95."""
    return encode(pattern(1297, 840, seed=11, noise=0.0), quality=95,
                  subsampling=2)


def write(out: str = OUT) -> None:
    os.makedirs(os.path.join(out, "refused"), exist_ok=True)
    items = dict(variants())
    items["large_1297x840_q95"] = large()
    for name, data in items.items():
        with open(os.path.join(out, name + ".jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(out, name + ".npy"),
                np.asarray(Image.open(io.BytesIO(data))))
        print(f"{name}: {len(data)} bytes")
    want = np.asarray(Image.open(io.BytesIO(items["large_1297x840_q95"])))
    readable, refused_large = large_variants()
    for name, data in readable.items():         # PIL reads it: same array
        got = np.asarray(Image.open(io.BytesIO(data)))
        assert np.array_equal(got, want), name
        with open(os.path.join(out, name + ".jpg"), "wb") as f:
            f.write(data)
        print(f"{name}: {len(data)} bytes (array of {ARRAY_OF[name]})")
    for name, data in {**refused(), **refused_large}.items():
        try:
            np.asarray(Image.open(io.BytesIO(data)))
        except (OSError, SyntaxError, ValueError):
            pass
        else:
            raise AssertionError(f"PIL reads {name}")
        with open(os.path.join(out, "refused", name + ".jpg"), "wb") as f:
            f.write(data)
        print(f"refused/{name}: {len(data)} bytes")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    write(ap.parse_args().out)
