"""Test-side writers of the TIFF, BMP, GIF, Targa, SGI, Netpbm, PCX and
ICO/CUR layouts PIL cannot write:
TIFF strips and tiles, planar configurations 1 and 2, both byte orders,
fill order 2, 1 to 32 bits per sample, the PackBits, LZW (MSB-first, early
change), Deflate, Zstandard (the system's libzstd) and LZMA (.xz, Python's
lzma) codecs with predictor 2, YCbCr data units at any subsampling, and
strips or tiles encoded elsewhere (JPEG) with extra tags; BMP core,
info, V4 and V5
headers, 1 to 32 bits, RLE8, RLE4 and bitfields, rows either way up; GIF
frames at an offset, interlaced, with a local palette, a transparency
index, LZW (LSB-first) with or without a leading clear code and with a
deferred clear; Targa 15/16-bit pixels and colour maps from any index,
run-length packets across rows; SGI run-length rows (8 and 16 bits,
shared rows); Netpbm in ASCII, at any maxval, and PFM; PCX at 1 bit in
2 or 4 planes with padded strides; icons mixing DIB and PNG frames, and
cursors; Photoshop files (raw or PackBits composites, colour-mode data,
image resources, a layer section) and DirectDraw Surface headers around
any pixel data, with a BC7 mode-6 block encoder.

PIL decodes each file written, and its array is the oracle. Used by
tests/make_{tiff,bmp,gif,small,texture}_fixtures.py, their tests and the
chip smoke's decode timings; pure Python and numpy, so the images stay
small where a writer loops in Python.
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


def lzw_encode_tiff_compat(data: bytes) -> bytes:
    """Old-style TIFF LZW (libtiff's LZWDecodeCompat reads it): CLEAR
    first, codes LSB-first, 9 to 12 bits widened one code late, CLEAR
    before the table fills, EOI last."""
    out = bytearray()
    acc, nacc = 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

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
        if nxt == 4093:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        else:
            table[wc] = nxt
            nxt += 1
            if nxt > (1 << nbits):
                nbits += 1
        w = bytes([b])
    if w:
        put(table[w])
        nxt += 1
        if nxt > (1 << nbits):
            nbits += 1
    put(257)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def thunderscan_encode(rows: np.ndarray) -> bytes:
    """4-bit grey rows [H, W] -> ThunderScan codes (libtiff's
    tif_thunder.c reads them): runs of the last pixel (never one that
    reaches the row's end, which libtiff does not write), three 2-bit
    deltas, two 3-bit deltas, else the raw value; each row starts from
    the last pixel 0."""
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        last, x, w = 0, 0, len(row)
        while x < w:
            run = 0
            while x + run < w - 1 and run < 63 and row[x + run] == last:
                run += 1
            if run >= 2:
                out.append(run)
                x += run
                continue
            d = [int(v) - int(p) for p, v in zip(
                [last] + list(row[x:x + 2]), row[x:x + 3])]
            if len(d) == 3 and all(-1 <= v <= 1 for v in d) and all(
                    0 <= v <= 15 for v in row[x:x + 3]):
                code = {0: 0, 1: 1, -1: 3}
                out.append(0x40 | code[d[0]] << 4 | code[d[1]] << 2
                           | code[d[2]])
                last, x = int(row[x + 2]), x + 3
                continue
            if len(d) >= 2 and all(-3 <= v <= 3 for v in d[:2]):
                code = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
                out.append(0x80 | code[d[0]] << 3 | code[d[1]])
                last, x = int(row[x + 1]), x + 2
                continue
            out.append(0xC0 | int(row[x]))
            last, x = int(row[x]), x + 1
    return bytes(out)


def fp_predict(block: np.ndarray) -> bytes:
    """Float rows [rows, cols, spp] -> libtiff's floating-point predictor
    3 (fpDiff): each row's samples split into byte planes, most
    significant first, then differenced byte by byte at a stride of spp."""
    rows, cols, spp = block.shape
    bps = block.dtype.itemsize
    out = bytearray()
    for r in block:
        be = np.ascontiguousarray(r.reshape(-1), r.dtype.newbyteorder(">"))
        planes = be.view(np.uint8).reshape(-1, bps).T.reshape(-1)
        d = planes.astype(np.int64).copy()
        d[spp:] = planes[spp:].astype(np.int64) - planes[:-spp]
        out += (d & 0xFF).astype(np.uint8).tobytes()
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

_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 7: "B", 12: "d", 16: "Q"}
COMPRESSION = {"none": 1, "packbits": 32773, "lzw": 5, "adobe_deflate": 8,
               "deflate": 32946, "ojpeg": 6, "jpeg": 7, "lzma": 34925,
               "zstd": 50000,
               "webp": 50001, "sgilog": 34676, "thunderscan": 32809}


def zstd_compress(raw: bytes, level: int = 3) -> bytes:
    """One Zstandard frame (the system's libzstd, through ctypes)."""
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress.restype = ctypes.c_size_t
    lib.ZSTD_compress.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_int]
    cap = lib.ZSTD_compressBound(ctypes.c_size_t(len(raw)))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(out, cap, raw, len(raw), level)
    assert n < cap, "ZSTD_compress failed"
    return out.raw[:n]


def xz_compress(raw: bytes, check: str = "none") -> bytes:
    """An .xz stream of LZMA2, with the given integrity check."""
    import lzma
    filters = [{"id": lzma.FILTER_LZMA2, "preset": 6}]
    return lzma.compress(raw, format=lzma.FORMAT_XZ, filters=filters,
                         check={"none": lzma.CHECK_NONE,
                                "crc32": lzma.CHECK_CRC32,
                                "crc64": lzma.CHECK_CRC64}[check])


def ycbcr_units(block: np.ndarray, sh: int, sv: int) -> bytes:
    """[rows, cols, 3] YCbCr samples -> libtiff's packed data units: per
    unit its sh x sv luma samples, then one Cb and one Cr (the unit's
    top-left chroma); partial units at the edges padded by repetition."""
    rows, cols, _ = block.shape
    ur, uc = -(-rows // sv), -(-cols // sh)
    full = np.pad(block, ((0, ur * sv - rows), (0, uc * sh - cols), (0, 0)),
                  mode="edge")
    y = full[..., 0].reshape(ur, sv, uc, sh).transpose(0, 2, 1, 3)
    out = np.concatenate([y.reshape(ur, uc, sv * sh),
                          full[::sv, ::sh, 1:]], -1)
    return np.ascontiguousarray(out, np.uint8).tobytes()


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
               big: bool = False, chunks=None, tags=None, units=None,
               xz_check: str = "none", raw_rowbytes=None) -> bytes:
    """arr [H, W, S] of sample values (any integer or float dtype; 1 to 4
    bits as small integers) -> a one-page TIFF (a BigTIFF where `big`).
    layout ("strips", rows_per_strip or None for one strip) or ("tiles",
    tw, th). `chunks`: the strips or tiles already encoded (arr then gives
    only the size); `tags`: more IFD entries {tag: (type, values)};
    `units` (sh, sv): YCbCr samples packed as data units (tag 530 set);
    `raw_rowbytes`: uncompressed rows of this many bytes (zero padded)."""
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
        if units is not None:
            return ycbcr_units(block, *units)
        if raw_rowbytes is not None:
            b = np.ascontiguousarray(block, np.uint8).reshape(rows, -1)
            return np.pad(b, ((0, 0), (0, raw_rowbytes - b.shape[1]))
                          ).tobytes()
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
        elif compression == "zstd":
            out = zstd_compress(raw)
        elif compression == "lzma":
            out = xz_compress(raw, check=xz_check)
        else:
            out = zlib.compress(raw, 6)
        return _reverse_bits(out) if fill_order == 2 else out

    planes = [arr] if planar == 1 else [arr[..., i:i + 1] for i in range(spp)]
    if chunks is not None:
        chunks = [_reverse_bits(c) if fill_order == 2 else c for c in chunks]
    elif layout[0] == "strips":
        chunks = []
        rps = layout[1] or h
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(compress(block_bytes(pl[y:y + rps])))
    else:
        chunks = []
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
    if units is not None:
        entries[530] = (3, list(units))
    entries.update(tags or {})
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
        vals = list(vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        data = struct.pack(e + _TYPES[typ][0] * len(vals), *vals)
        head = struct.pack(e + "HH" + ("Q" if big else "I"), t, typ, count)
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
# PIL's small formats: Targa, SGI, Netpbm, PCX, ICO/CUR


def _tga_rle(px: np.ndarray, h: int, w: int) -> bytes:
    """Targa RLE of [h * w, depth] pixel bytes: runs of two or more equal
    pixels as run packets, which never cross a row (PIL refuses those);
    literal packets run on across rows."""
    out = bytearray()
    seq = [bytes(p) for p in px]
    lit = []

    def flush():
        while lit:
            part = lit[:128]
            del lit[:128]
            out.append(len(part) - 1)
            out.extend(b"".join(part))

    i = 0
    while i < len(seq):
        j = i
        while j + 1 < len(seq) and seq[j + 1] == seq[i] and j + 1 - i < 128 \
                and (j + 1) // w == i // w:
            j += 1
        if j > i:
            flush()
            out.append(0x80 | (j - i))
            out.extend(seq[i])
            i = j + 1
        else:
            lit.append(seq[i])
            i += 1
    flush()
    return bytes(out)


def write_tga(arr: np.ndarray, *, itype: int, depth: int, cmap=None,
              cmap_depth: int = 24, cmap_start: int = 0, id_field=b"",
              top: bool = False, mirror: bool = False) -> bytes:
    """A Targa file: `arr` holds what each pixel stores, [H, W] indices,
    grey or 16-bit words (depth 16, types 2 and 10), [H, W] bool (depth 1),
    [H, W, 2] grey + alpha, [H, W, 3] RGB or [H, W, 4] RGBA. `cmap`:
    [n, 3] RGB, [n, 4] RGBA or [n] 16-bit entries of `cmap_depth` bits,
    from index `cmap_start`. Types 9-11 are run-length coded."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    rows = arr if top else arr[::-1]
    if mirror:
        rows = rows[:, ::-1]
    if depth == 1:
        data = _pack_bits_rows(np.asarray(rows, np.uint8), 1)
        px = None
    elif depth == 16 and itype & 7 == 2:
        px = np.asarray(rows, "<u2").reshape(-1, 1).view(np.uint8)
    elif rows.ndim == 3 and rows.shape[2] >= 3:
        order = [2, 1, 0, 3][:rows.shape[2]]
        px = np.asarray(rows, np.uint8)[..., order].reshape(h * w, -1)
    else:
        px = np.asarray(rows, np.uint8).reshape(h * w, -1)
    if px is not None:
        data = _tga_rle(px, h, w) if itype & 8 else px.tobytes()
    cm = b""
    n = 0
    if cmap is not None:
        c = np.asarray(cmap)
        n = len(c)
        if cmap_depth in (15, 16):
            cm = np.asarray(c, "<u2").tobytes()
        else:
            order = [2, 1, 0, 3][:c.shape[1]]
            cm = np.asarray(c, np.uint8)[:, order].tobytes()
    desc = (0x20 if top else 0) | (0x10 if mirror else 0) | (
        8 if depth == 32 or (depth == 16 and itype & 7 == 2) else 0)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), 1 if cmap is not None
                       else 0, itype, cmap_start, n,
                       cmap_depth if cmap is not None else 0, 0, 0, w, h,
                       depth, desc)
    return head + bytes(id_field) + cm + data


def _sgi_row(vals: np.ndarray, bpc: int) -> bytes:
    """One SGI RLE row (one channel): runs of equal values and copies, up
    to 127 each, then a zero count."""
    out = bytearray()

    def word(v):
        out.extend(struct.pack(">H", v) if bpc == 2 else bytes([v]))

    v = [int(x) for x in vals]
    i = 0
    while i < len(v):
        j = i
        while j + 1 < len(v) and v[j + 1] == v[i] and j + 1 - i < 127:
            j += 1
        if j - i >= 2:
            word(j - i + 1)
            word(v[i])
            i = j + 1
            continue
        k = i
        while k < len(v) and k - i < 127 and not (
                k + 2 < len(v) and v[k] == v[k + 1] == v[k + 2]):
            k += 1
        word(0x80 | (k - i))
        for x in v[i:k]:
            word(x)
        i = k
    word(0)
    return bytes(out)


def write_sgi(arr: np.ndarray, *, bpc: int = 1, rle: bool = True,
              dimension=None, share_rows: bool = True) -> bytes:
    """An SGI file of [H, W] or [H, W, Z] samples (uint8, or uint16 where
    bpc is 2), rows stored bottom-up, one plane per channel; RLE rows
    through offset and length tables (equal rows stored once where
    `share_rows`)."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    z = 1 if arr.ndim == 2 else arr.shape[2]
    planes = arr.reshape(h, w, z)[::-1]
    dim = dimension or (3 if z > 1 else 2)
    head = struct.pack(">HBBHHHHII4s80sI", 474, 1 if rle else 0, bpc, dim, w,
                       h, z, 0, 255 if bpc == 1 else 65535, b"",
                       b"irgs", 0).ljust(512, b"\0")
    dt = ">u2" if bpc == 2 else np.uint8
    if not rle:
        return head + b"".join(np.ascontiguousarray(
            planes[..., c], dt).tobytes() for c in range(z))
    starts, lengths, body, seen = [], [], bytearray(), {}
    table = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            row = _sgi_row(planes[y, :, c], bpc)
            if share_rows and row in seen:
                at = seen[row]
            else:
                at = table + len(body)
                body += row
                seen[row] = at
            starts.append(at)
            lengths.append(len(row))
    return (head + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lengths) + bytes(body))


def write_pnm_plain(arr: np.ndarray, magic: bytes, maxval: int = 255,
                    comment: bytes = b"", per_line: int = 7) -> bytes:
    """P1, P2 or P3 in ASCII: [H, W] bool (P1: True is white, written 0),
    [H, W] or [H, W, 3] samples up to maxval; a comment after the magic and
    between rows."""
    arr = np.asarray(arr)
    head = magic + b"\n" + (b"# " + comment + b"\n" if comment else b"")
    head += b"%d %d\n" % (arr.shape[1], arr.shape[0])
    if magic != b"P1":
        head += b"%d\n" % maxval
    vals = (~arr).astype(int) if magic == b"P1" else arr.astype(int)
    lines = []
    for r, row in enumerate(vals.reshape(arr.shape[0], -1)):
        tok = [str(v).encode() for v in row]
        for i in range(0, len(tok), per_line):
            lines.append(b" ".join(tok[i:i + per_line]))
        if comment and r == 0:
            lines.append(b"#" + comment)
    return head + b"\n".join(lines) + b"\n"


def write_pnm_raw(arr: np.ndarray, magic: bytes, maxval: int) -> bytes:
    """P5 or P6 at any maxval: one byte a sample up to 255, two big-endian
    bytes above."""
    arr = np.asarray(arr)
    head = b"%s\n%d %d\n%d\n" % (magic, arr.shape[1], arr.shape[0], maxval)
    return head + np.asarray(arr, ">u2" if maxval > 255 else np.uint8
                             ).tobytes()


def write_pfm(arr: np.ndarray, scale: float) -> bytes:
    """A grey PFM ("Pf"): rows bottom-up, little-endian floats where the
    scale is negative, big-endian where it is positive."""
    arr = np.asarray(arr, np.float32)
    head = b"Pf\n%d %d\n%r\n" % (arr.shape[1], arr.shape[0], scale)
    return head + np.asarray(arr[::-1], "<f4" if scale < 0 else ">f4"
                             ).tobytes()


def _pcx_rle(line: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(line):
        j = i
        while j + 1 < len(line) and line[j + 1] == line[i] and j + 1 - i < 62:
            j += 1
        n = j - i + 1
        if n > 1 or line[i] >= 0xC0:
            out += bytes([0xC0 | n, line[i]])
        else:
            out.append(line[i])
        i = j + 1
    return bytes(out)


def write_pcx(arr: np.ndarray, *, bits: int, planes: int, version: int = 5,
              palette=None, header_palette=None, stride=None,
              origin=(0, 0)) -> bytes:
    """A PCX file: [H, W] indices (1 bit in 1, 2 or 4 planes, or 8 bits),
    [H, W] bool (1 bit, 1 plane) or [H, W, 3] RGB (8 bits, 3 planes); each
    line's planes run-length coded together. `palette`: 256 RGB entries
    appended after a 12; `header_palette`: 16 RGB entries in the header;
    `stride`: the header's bytes a plane line (default: even)."""
    arr = np.asarray(arr)
    h, w = arr.shape[:2]
    least = (w * bits + 7) // 8
    given = stride if stride is not None else least + least % 2
    real = least if given == least else least + least % 2
    body = bytearray()
    for y in range(h):
        line = b""
        for p in range(planes):
            if bits == 1:
                v = arr[y] if planes == 1 else (arr[y] >> p) & 1
                b = _pack_bits_rows(np.asarray(v, np.uint8)[None], 1)
            elif arr.ndim == 3:
                b = np.asarray(arr[y, :, p], np.uint8).tobytes()
            else:
                b = np.asarray(arr[y], np.uint8).tobytes()
            line += b.ljust(real, b"\0")
        body += _pcx_rle(line)
    hp = (np.asarray(header_palette, np.uint8).tobytes()
          if header_palette is not None else b"").ljust(48, b"\0")
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH48sBBHH", 10, version, 1, bits, x0, y0,
                       x0 + w - 1, y0 + h - 1, 72, 72, hp, 0, planes, given,
                       1).ljust(128, b"\0")
    tail = b""
    if palette is not None:
        tail = b"\x0c" + np.asarray(palette, np.uint8).tobytes()
    return head + bytes(body) + tail


def dib_frame(arr: np.ndarray, *, bits: int, palette=None,
              and_mask=None) -> bytes:
    """An icon's DIB frame: the BITMAPINFOHEADER with the height doubled,
    the palette, the pixels (write_bmp's layouts) and the AND mask (1 bit,
    rows padded to 32 bits, bottom-up; `and_mask` [H, W] bool, True is
    transparent; none for 32 bits unless given)."""
    bmp = write_bmp(arr, bits=bits, palette=palette)[14:]
    h, w = np.asarray(arr).shape[:2]
    bmp = bmp[:8] + struct.pack("<i", 2 * h) + bmp[12:]
    if and_mask is None and bits == 32:
        return bmp
    m = np.zeros((h, w), bool) if and_mask is None else np.asarray(and_mask)
    wp = (w + 31) // 32 * 32
    padded = np.zeros((h, wp), np.uint8)
    padded[:, :w] = m
    return bmp + _pack_bits_rows(padded[::-1], 1)


def write_ico(frames, *, cur: bool = False, hotspot=(0, 0)) -> bytes:
    """An icon (or, with `cur`, a cursor) of `frames`: (payload bytes, w, h,
    bpp, colours) each, payload a PNG stream or a `dib_frame`; the
    directory gives w and h modulo 256 and, for a cursor, the hotspot in
    the planes and bpp fields."""
    head = struct.pack("<HHH", 0, 2 if cur else 1, len(frames))
    at = 6 + 16 * len(frames)
    dirs, body = b"", b""
    for payload, w, h, bpp, colors in frames:
        f1, f2 = hotspot if cur else (1, bpp)
        dirs += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, f1, f2,
                            len(payload), at + len(body))
        body += payload
    return head + dirs + body


# ---------------------------------------------------------------------------
# fixtures


def write_sun(w, h, depth, data, ftype=1, cmap=b"", ctype=None) -> bytes:
    """A Sun raster: the 32-byte header (big-endian magic, size, depth,
    data length, type, colour map type and length), the colour map
    (three planes) and `data` as given."""
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), ftype,
                       (1 if cmap else 0) if ctype is None else ctype,
                       len(cmap)) + cmap + data


def sun_rle(data: bytes) -> bytes:
    """Sun's byte RLE of `data` (runs of 3 and more, 0x80 escaped)."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        n = j - i
        if n >= 3 or data[i] == 0x80:
            if n == 1:
                out += b"\x80\x00"
            else:
                out += bytes([0x80, n - 1, data[i]])
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def save_fixtures(out: str, files, refused, ext: str) -> None:
    """Write each (name, bytes) of `files` as ``out/<name><ext>`` beside
    the ``.npy`` PIL decodes from it and, in ``modes.json``, its PIL mode,
    palette and transparency; each (name, bytes, why) of `refused` under
    ``out/refused/``, with ``refused.json``: `why` None where PIL refuses
    the stream (checked), else what the port does not read yet (PIL reads
    it, checked). Needs PIL: run here, not on a machine without it."""
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
            t = im.info.get("transparency")
            modes[name] = {"mode": im.mode, "palette": pal,
                           # an XPM's transparent key is bytes
                           "transparency": list(t) if isinstance(t, bytes)
                           else t}
        np.save(os.path.join(out, name + ".npy"), arr)
    with open(os.path.join(out, "modes.json"), "w") as f:
        json.dump(modes, f, indent=0, sort_keys=True)
    notes = {}
    for name, data, why in refused:
        path = os.path.join(out, "refused", name + ext)
        with open(path, "wb") as f:
            f.write(data)
        try:
            # by path, as the readers open files (a PCX file shorter than
            # its palette seeks before the start: refused from a file, read
            # from memory)
            with Image.open(path) as im:
                np.asarray(im)
            pil_reads = True
        except Exception:
            pil_reads = False
        if pil_reads != (why is not None):
            raise AssertionError(f"{name}: PIL {'reads' if pil_reads else 'refuses'} it")
        notes[name] = why
    with open(os.path.join(out, "refused", "refused.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


# ---------------------------------------------------------------------------
# Photoshop
def psd_layer_section(layers) -> bytes:
    """A layer and mask section's contents: each (top, left, planes [3 x
    [h, w] uint8], name) as a layer of R, G, B channels, raw, blend mode
    normal."""
    records, data = b"", b""
    for top, left, planes, name in layers:
        h, w = planes[0].shape
        records += struct.pack(">4iH", top, left, top + h, left + w,
                               len(planes))
        for k, plane in enumerate(planes):
            records += struct.pack(">hI", k, 2 + plane.size)
            data += struct.pack(">H", 0) + plane.tobytes()
        pname = bytes([len(name)]) + name
        pname += b"\0" * (-len(pname) % 4)
        extra = struct.pack(">II", 0, 0) + pname
        records += b"8BIMnorm" + bytes([255, 0, 0, 0])
        records += struct.pack(">I", len(extra)) + extra
    info = struct.pack(">h", len(layers)) + records + data
    info += b"\0" * (len(info) & 1)
    return struct.pack(">I", len(info)) + info + struct.pack(">I", 0)


def write_psd(planes, *, mode: int, bits: int = 8, compression: int = 1,
              channels=None, color_data: bytes = b"", resources=(),
              layers: bytes = b"", size=None) -> bytes:
    """A PSD file whose composite holds `planes` (each [h, rowbytes] uint8:
    rows of 8-bit samples, or of packed bits at depth 1), raw or PackBits
    (each row its own packets, the per-row byte counts first); `channels`
    overrides the header's channel count, `resources` are (id, data)
    image resources, `layers` the layer and mask section's contents."""
    h = planes[0].shape[0]
    w = size[0] if size else planes[0].shape[1] * (8 if bits == 1 else 1)
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels or len(planes), h,
                                 w, bits, mode)
    res = b""
    for rid, data in resources:
        res += b"8BIM" + struct.pack(">H", rid) + b"\0\0"
        res += struct.pack(">I", len(data)) + data + b"\0" * (len(data) & 1)
    out = head + struct.pack(">I", len(color_data)) + color_data
    out += struct.pack(">I", len(res)) + res
    out += struct.pack(">I", len(layers)) + layers
    if compression == 0:
        return out + struct.pack(">H", 0) + b"".join(p.tobytes()
                                                    for p in planes)
    rows = [packbits_encode(r.tobytes()) for p in planes for r in p]
    counts = b"".join(struct.pack(">H", len(r)) for r in rows)
    return out + struct.pack(">H", compression) + counts + b"".join(rows)


# ---------------------------------------------------------------------------
# DirectDraw Surface
def write_dds(w: int, h: int, data: bytes, *, pfflags: int = 0x4,
              fourcc: bytes = b"\0\0\0\0", bitcount: int = 0,
              masks=(0, 0, 0, 0), dxgi=None, header_size: int = 124) -> bytes:
    """A DDS file of `data` after its 124-byte header (and a DX10 header
    of DXGI format `dxgi`, with FourCC DX10)."""
    if dxgi is not None:
        fourcc = b"DX10"
    head = struct.pack("<7I", header_size, 0x1007, h, w, 0, 0, 0)
    head += b"\0" * 44 + struct.pack("<2I", 32, pfflags) + fourcc
    head += struct.pack("<5I", bitcount, *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return b"DDS " + head + data


def _field_bits(v: np.ndarray, n: int) -> np.ndarray:
    return ((v[:, None] >> np.arange(n)) & 1).astype(np.uint8)


def bc7_mode6_encode(rgba: np.ndarray) -> bytes:
    """[H, W, 4] uint8 (H, W multiples of 4) -> BC7 blocks, all mode 6:
    each block's per-channel minimum and maximum (even values: 7 bits and
    a p-bit of 0) as endpoints, 4-bit indices by projection on the line
    between them; row-major blocks."""
    h, w = rgba.shape[:2]
    blk = rgba.reshape(h // 4, 4, w // 4, 4, 4).transpose(0, 2, 1, 3, 4)
    blk = blk.reshape(-1, 16, 4).astype(np.int64)
    e0 = blk.min(1) >> 1
    e1 = blk.max(1) >> 1
    d = (e1 - e0) * 2
    t = ((blk - 2 * e0[:, None]) * d[:, None]).sum(-1)
    dd = np.maximum((d * d).sum(-1), 1)[:, None]
    idx = np.clip((t * 15 + dd // 2) // dd, 0, 15)
    swap = idx[:, 0] >= 8
    e0[swap], e1[swap] = e1[swap].copy(), e0[swap].copy()
    idx[swap] = 15 - idx[swap]
    n = len(blk)
    fields = [np.tile(np.array([0, 0, 0, 0, 0, 0, 1], np.uint8), (n, 1))]
    for c in range(4):
        fields += [_field_bits(e0[:, c], 7), _field_bits(e1[:, c], 7)]
    fields.append(np.zeros((n, 2), np.uint8))
    fields.append(_field_bits(idx[:, 0], 3))
    fields += [_field_bits(idx[:, k], 4) for k in range(1, 16)]
    bits = np.concatenate(fields, 1)
    return np.packbits(bits, axis=1, bitorder="little").tobytes()

