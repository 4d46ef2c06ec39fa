"""Test-side writers of the TIFF, BMP and GIF layouts PIL cannot write:
TIFF strips and tiles, planar configurations 1 and 2, both byte orders,
fill order 2, 1 to 32 bits per sample, the PackBits, LZW (MSB-first, early
change) and Deflate codecs with predictor 2; BMP core, info, V4 and V5
headers, 1 to 32 bits, RLE8, RLE4 and bitfields, rows either way up; GIF
frames at an offset, interlaced, with a local palette, a transparency
index, LZW (LSB-first) with or without a leading clear code and with a
deferred clear.

PIL decodes each file written, and its array is the oracle. Used by
tests/make_{tiff,bmp,gif}_fixtures.py and their tests; pure Python, so
the images stay small.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# codecs


def lzw_encode_tiff(data: bytes) -> bytes:
    """TIFF LZW: CLEAR first, codes MSB-first, 9 to 12 bits widened one
    code early, CLEAR again before the table fills, EOI last."""
    out = bytearray()
    acc, nacc = 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt == 4094:                       # libtiff: full, clear
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        else:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << nbits) - 1:
                nbits += 1
        w = bytes([b])
    if w:                                      # LZWPostEncode
        put(table[w])
        nxt += 1
        if nxt == 4094:
            put(256)
            nbits = 9
        elif nxt > (1 << nbits) - 1:
            nbits += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while (j + 1 < n and j - i < 127
               and not (j + 2 < n and data[j + 1] == data[j + 2])):
            j += 1
        out.append(j - i)
        out += data[i:j + 1]
        i = j + 1
    return bytes(out)


def lzw_encode_gif(idx: bytes, bits: int, clear_first=True,
                   defer_clear=False) -> bytes:
    """GIF LZW, codes LSB-first from bits + 1 to 12 bits. Without
    `defer_clear` a clear code is sent when the table fills; with it the
    table stays full and codes go on at 12 bits."""
    clear, end = 1 << bits, (1 << bits) + 1
    acc, nacc = 0, 0
    out = bytearray()
    size = bits + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}

    table, nxt = fresh(), end + 1
    if clear_first:
        put(clear)
    w = b""
    for b in idx:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        if nxt >= (1 << size) and size < 12:  # giflib's EGifCompressOutput
            size += 1
        if nxt < 4095 or (defer_clear and nxt < 4096):
            table[wc] = nxt
            nxt += 1
        elif not defer_clear:
            put(clear)
            table, nxt, size = fresh(), end + 1, bits + 1
        w = bytes([b])
    if w:
        put(table[w])
        if nxt >= (1 << size) and size < 12:
            size += 1
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _subblocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    return bytes(out) + b"\x00"


# ---------------------------------------------------------------------------
# TIFF

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 12: "d", 16: "Q"}
COMPRESSION = {"none": 1, "packbits": 32773, "lzw": 5, "adobe_deflate": 8,
               "deflate": 32946}


def _pack_bits_rows(vals: np.ndarray, bits: int) -> bytes:
    """[rows, n] sample values of `bits` < 8 -> rows packed MSB-first, each
    padded to a whole byte."""
    rows = []
    for r in vals:
        acc, nacc, out = 0, 0, bytearray()
        for v in r:
            acc = (acc << bits) | int(v)
            nacc += bits
            if nacc == 8:
                out.append(acc)
                acc, nacc = 0, 0
        if nacc:
            out.append(acc << (8 - nacc))
        rows.append(bytes(out))
    return b"".join(rows)


def _reverse_bits(b: bytes) -> bytes:
    lut = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return b.translate(lut)


def write_tiff(arr: np.ndarray, *, photometric: int, bits: int,
               sample_format: int = 1, extra_samples=(),
               compression: str = "none", predictor: int = 1,
               planar: int = 1, layout=("strips", None), order: str = "II",
               fill_order: int = 1, colormap=None, orientation=None,
               big: bool = False) -> bytes:
    """arr [H, W, S] of sample values (any integer or float dtype; 1 to 4
    bits as small integers) -> a one-page TIFF (a BigTIFF where `big`).
    layout ("strips", rows_per_strip or None for one strip) or ("tiles",
    tw, th)."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, spp = arr.shape
    e = "<" if order == "II" else ">"
    if bits >= 8:
        kind = {1: "u", 2: "i", 3: "f"}[sample_format]
        dt = np.dtype(f"{e}{kind}{bits // 8}")
    else:
        dt = None

    def block_bytes(block: np.ndarray) -> bytes:
        """[rows, cols, s] -> the block's bytes, predictor applied."""
        rows, cols, s = block.shape
        if predictor == 2:
            v = block.astype(np.int64) if dt is None or dt.kind != "f" else block
            d = v.copy()
            d[:, 1:] = v[:, 1:] - v[:, :-1]
            block = d
        if dt is None:
            flat = (np.asarray(block).astype(np.int64)
                    & ((1 << bits) - 1)).reshape(rows, cols * s)
            return _pack_bits_rows(flat, bits)
        if dt.kind == "f":
            return np.ascontiguousarray(block, dt).tobytes()
        mod = np.asarray(block).astype(np.int64) & ((1 << bits) - 1)
        return np.ascontiguousarray(mod.astype(dt.newbyteorder("=")
                                               .str.replace("i", "u")),
                                    dt.str.replace("i", "u")).tobytes()

    def compress(raw: bytes) -> bytes:
        if compression == "none":
            out = raw
        elif compression == "packbits":
            out = packbits_encode(raw)
        elif compression == "lzw":
            out = lzw_encode_tiff(raw)
        else:
            out = zlib.compress(raw, 6)
        return _reverse_bits(out) if fill_order == 2 else out

    planes = [arr] if planar == 1 else [arr[..., i:i + 1] for i in range(spp)]
    chunks = []
    if layout[0] == "strips":
        rps = layout[1] or h
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(compress(block_bytes(pl[y:y + rps])))
    else:
        tw, th = layout[1], layout[2]
        for pl in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                    part = pl[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(compress(block_bytes(t)))

    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
               259: (3, [COMPRESSION[compression]]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if orientation is not None:
        entries[274] = (3, [orientation])
    hsize = 16 if big else 8
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(hsize + len(body))
        body += c
        if len(body) % 2:
            body += b"\x00"
    counts = [len(c) for c in chunks]
    long_t = 16 if big else 4
    if layout[0] == "strips":
        entries[278] = (4, [layout[1] or h])
        entries[273] = (long_t, offsets)
        entries[279] = (long_t, counts)
    else:
        entries[322] = (4, [layout[1]])
        entries[323] = (4, [layout[2]])
        entries[324] = (long_t, offsets)
        entries[325] = (long_t, counts)
    ifd_at = hsize + len(body)
    tags = sorted(entries)
    cnt, off, ent, inline = ("Q", "Q", 20, 8) if big else ("H", "I", 12, 4)
    ifd = bytearray(struct.pack(e + cnt, len(tags)))
    extra = bytearray()
    extra_at = ifd_at + struct.calcsize(cnt) + ent * len(tags) + inline
    for t in tags:
        typ, vals = entries[t]
        data = struct.pack(e + _TYPES[typ] * len(vals), *vals)
        head = struct.pack(e + "HH" + ("Q" if big else "I"), t, typ, len(vals))
        if len(data) <= inline:
            ifd += head + data.ljust(inline, b"\0")
        else:
            ifd += head + struct.pack(e + off, extra_at + len(extra))
            extra += data
            if len(extra) % 2:
                extra += b"\0"
    ifd += struct.pack(e + off, 0)
    if big:
        header = order.encode() + struct.pack(e + "HHHQ", 43, 8, 0, ifd_at)
    else:
        header = order.encode() + struct.pack(e + "HI", 42, ifd_at)
    return bytes(header + body + ifd + extra)


# ---------------------------------------------------------------------------
# BMP


def _rle8(rows) -> bytes:
    out = bytearray()
    for r in rows:
        r = bytes(r)
        i = 0
        while i < len(r):
            j = i
            while j + 1 < len(r) and r[j + 1] == r[i] and j - i < 254:
                j += 1
            if j > i or len(r) - i < 3:
                n = j - i + 1
                out += bytes([n, r[i]])
                i = j + 1
                continue
            j = i
            while j + 1 < len(r) and j - i < 254 and r[j + 1] != r[j]:
                j += 1
            n = j - i + 1
            if n < 3:
                out += bytes([1, r[i]])
                i += 1
                continue
            out += bytes([0, n]) + r[i:i + n] + (b"\0" if n % 2 else b"")
            i += n
        out += b"\x00\x00"
    return bytes(out[:-2] + b"\x00\x01")


def _rle4(rows) -> bytes:
    """Encoded runs only (two alternating indices per run), then absolute
    runs of even length where the row changes often."""
    out = bytearray()
    for r in rows:
        r = [int(v) for v in r]
        i = 0
        while i < len(r):
            if i + 1 < len(r):
                a, b = r[i], r[i + 1]
                j = i + 2
                while j < len(r) and j - i < 255 and r[j] == (a if (j - i) % 2 == 0 else b):
                    j += 1
            else:
                a, b, j = r[i], 0, i + 1
            n = j - i
            if n >= 4 or len(r) - i <= 3:
                out += bytes([n, (a << 4) | b])
                i = j
            else:
                k = min(len(r) - i, 8) & ~1
                vals = r[i:i + k]
                packed = bytes((vals[t] << 4) | vals[t + 1] for t in range(0, k, 2))
                out += bytes([0, k]) + packed + (b"\0" if len(packed) % 2 else b"")
                i += k
        out += b"\x00\x00"
    return bytes(out[:-2] + b"\x00\x01")


def write_bmp(arr: np.ndarray, *, bits: int, header: int = 40,
              palette=None, compression: int = 0, masks=None,
              top_down: bool = False, colors_used: int = 0) -> bytes:
    """arr [H, W] of palette indices (bits <= 8) or [H, W, C] of 8-bit
    channels (24, 32 bits, BGR(A) order given by `masks` or the default),
    or [H, W] uint16 pixel words for 16 bits."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    rows = arr[::-1] if not top_down else arr
    if compression == 1:
        data = _rle8(rows)
    elif compression == 2:
        data = _rle4(rows)
    else:
        stride = ((w * bits + 31) >> 5) << 2
        out = bytearray()
        for r in rows:
            if bits < 8:
                b = _pack_bits_rows(np.asarray(r)[None], bits)
            elif bits == 16:
                b = np.asarray(r, "<u2").tobytes()
            elif bits == 24:
                b = np.asarray(r, np.uint8)[:, ::-1].tobytes()
            else:
                b = np.asarray(r, np.uint32).astype("<u4").tobytes() \
                    if r.ndim == 1 else np.asarray(r, np.uint8).tobytes()
            out += b.ljust(stride, b"\0")
        data = bytes(out)
    pal = b""
    if palette is not None:
        pad = 3 if header == 12 else 4
        pal = b"".join(bytes([c[2], c[1], c[0]] + [0] * (pad - 3))
                       for c in np.asarray(palette, np.uint8))
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = -h if top_down else h
        hdr = struct.pack("<IiiHHIIiiII", header, w, hh, 1, bits,
                          compression, len(data), 2835, 2835, colors_used, 0)
        if header >= 52 and masks is not None:
            hdr += struct.pack("<III", *masks[:3])
            if header >= 56:
                hdr += struct.pack("<I", masks[3] if len(masks) > 3 else 0)
        elif header >= 52:
            hdr += b"\0" * (12 if header == 52 else 16)
        hdr = hdr.ljust(header, b"\0")
    extra_masks = b""
    if header == 40 and compression == 3:
        extra_masks = struct.pack("<III", *masks[:3])
    offset = 14 + len(hdr) + len(extra_masks) + len(pal)
    head = struct.pack("<2sIHHI", b"BM", offset + len(data), 0, 0, offset)
    return head + hdr + extra_masks + pal + data


# ---------------------------------------------------------------------------
# GIF


def write_gif(idx: np.ndarray, *, screen=None, offset=(0, 0),
              global_palette=None, local_palette=None, transparency=None,
              interlace=False, bits=None, clear_first=True,
              defer_clear=False, comment=None, truncate=None,
              end_early=None) -> bytes:
    """One frame of palette indices idx [h, w]."""
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    sw, sh = screen or (w + offset[0], h + offset[1])

    def pal_bytes(p):
        p = np.asarray(p, np.uint8).reshape(-1, 3)
        n = max(1, int(np.ceil(np.log2(max(len(p), 2)))))
        full = np.zeros((1 << n, 3), np.uint8)
        full[:len(p)] = p
        return n, full.tobytes()

    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if global_palette is not None:
        n, gp = pal_bytes(global_palette)
        out += bytes([0x80 | 0x70 | (n - 1), 0, 0]) + gp
    else:
        out += bytes([0, 0, 0])
    if comment is not None:
        out += b"!\xfe" + _subblocks(comment)
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1]) + struct.pack("<H", 0) + bytes(
            [transparency, 0])
    flags = 0
    lp = b""
    if local_palette is not None:
        n, lp = pal_bytes(local_palette)
        flags |= 0x80 | (n - 1)
    if interlace:
        flags |= 0x40
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags) + lp
    if bits is None:
        bits = max(2, int(np.ceil(np.log2(int(idx.max()) + 1))) if idx.size else 2)
    rows = idx
    if interlace:
        order = (list(range(0, h, 8)) + list(range(4, h, 8))
                 + list(range(2, h, 4)) + list(range(1, h, 2)))
        rows = idx[order]
    stream = rows.tobytes()
    if end_early is not None:
        stream = stream[:end_early]
    data = lzw_encode_gif(stream, bits, clear_first, defer_clear)
    if truncate is not None:
        data = data[:truncate]
        out += bytes([bits]) + _subblocks(data)[:-1]
        return bytes(out)
    out += bytes([bits]) + _subblocks(data) + b";"
    return bytes(out)


# ---------------------------------------------------------------------------
# fixtures


def save_fixtures(out: str, files, refused, ext: str) -> None:
    """Write each (name, bytes) of `files` as ``out/<name><ext>`` beside
    the ``.npy`` PIL decodes from it and, in ``modes.json``, its PIL mode,
    palette and transparency; each (name, bytes, why) of `refused` under
    ``out/refused/``, with ``refused.json``: `why` None where PIL refuses
    the stream (checked), else what the port does not read yet (PIL reads
    it, checked). Needs PIL: run here, not on a machine without it."""
    import io
    import json
    import os
    import shutil

    from PIL import Image

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "refused"))
    modes = {}
    for name, data in files:
        path = os.path.join(out, name + ext)
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.asarray(im)
            pal = im.getpalette() if im.mode in ("P", "PA") else None
            modes[name] = {"mode": im.mode, "palette": pal,
                           "transparency": im.info.get("transparency")}
        np.save(os.path.join(out, name + ".npy"), arr)
    with open(os.path.join(out, "modes.json"), "w") as f:
        json.dump(modes, f, indent=0, sort_keys=True)
    notes = {}
    for name, data, why in refused:
        with open(os.path.join(out, "refused", name + ext), "wb") as f:
            f.write(data)
        try:
            with Image.open(io.BytesIO(data)) as im:
                np.asarray(im)
            pil_reads = True
        except Exception:
            pil_reads = False
        if pil_reads != (why is not None):
            raise AssertionError(f"{name}: PIL {'reads' if pil_reads else 'refuses'} it")
        notes[name] = why
    with open(os.path.join(out, "refused", "refused.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)
