"""Write the JPEG 2000 fixtures of tests/data/jp2/ (here only: PIL and the
OpenJPEG 2.5 that Pillow ships).

Small JP2 files and raw J2K codestreams, each named with its extension:
PIL's save options (modes L, I;16, LA, RGB, RGBA, CMYK; irreversible;
quality layers; the five progression orders; tiles, tile and image
offsets; resolutions; code-block and precinct sizes; mct 0/1; signed;
PLT; no_jp2; comment; dpi), then what PIL cannot write, through Pillow's
libopenjp2 with ctypes (`encode`: every code-block style bit, SOP/EPH,
POC, ROI, subsampled components, tile-parts, TLM, 4- to 16-bit samples),
JP2 boxes edited in a PIL-written file (``colr`` sYCC, CMYK, ICC and
missing, ``pclr`` + ``cmap`` on L and LA, ``cdef``, ``res ``), packet
headers moved into PPT and PPM markers, and damaged copies (a cut stream,
a flipped packet byte, a bad marker length) that PIL still decodes.
Beside each the ``.npy`` PIL decodes from it and, in ``modes.json``, its
mode and palette; ``refused/`` holds streams PIL refuses.

``large/`` holds two 1297x840 frames the chip smoke times (5/3 lossless,
9/7 with quality layers) and the SHA-256 of PIL's arrays; ``colmap/`` a
COLMAP capture of the four views of tests/data/webp/colmap/ as a 5/3 JP2,
a 9/7 JP2 with 3 layers in RPCL order with 64x64 precincts, a 128x128-tiled
J2K with SOP/EPH and BYPASS|TERMALL code-blocks, and a 12-bit RGB JP2.

    python tests/make_jp2_fixtures.py [--no-capture]
"""

from __future__ import annotations

import ctypes
import glob
import io
import json
import os
import struct
import sys
import tempfile

import numpy as np
from PIL import Image

import image_streams as ims

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
OUT = os.path.join(DATA, "jp2")
H, W = 37, 45


# ---------------------------------------------------------------- encoder
_LIB = None
_PATH_LEN = 4096
_I = ctypes.c_int
_PRG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


class _Poc(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in (
        "resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
        "precno0", "precno1")]
        + [("prg1", _I), ("prg", _I), ("progorder", ctypes.c_char * 5),
           ("tile", ctypes.c_uint32)]
        + [(n, ctypes.c_int32) for n in ("tx0", "tx1", "ty0", "ty1")]
        + [(n, ctypes.c_uint32) for n in (
            "layS", "resS", "compS", "prcS", "layE", "resE", "compE",
            "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
            "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")])


class _Params(ctypes.Structure):
    """opj_cparameters_t of OpenJPEG 2.5."""
    _fields_ = [
        ("tile_size_on", _I), ("cp_tx0", _I), ("cp_ty0", _I),
        ("cp_tdx", _I), ("cp_tdy", _I), ("cp_disto_alloc", _I),
        ("cp_fixed_alloc", _I), ("cp_fixed_quality", _I),
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p),
        ("csty", _I), ("prog_order", _I), ("POC", _Poc * 32),
        ("numpocs", ctypes.c_uint32), ("tcp_numlayers", _I),
        ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", _I),
        ("cblockw_init", _I), ("cblockh_init", _I), ("mode", _I),
        ("irreversible", _I), ("roi_compno", _I), ("roi_shift", _I),
        ("res_spec", _I), ("prcw_init", _I * 33), ("prch_init", _I * 33),
        ("infile", ctypes.c_char * _PATH_LEN),
        ("outfile", ctypes.c_char * _PATH_LEN), ("index_on", _I),
        ("index", ctypes.c_char * _PATH_LEN), ("image_offset_x0", _I),
        ("image_offset_y0", _I), ("subsampling_dx", _I),
        ("subsampling_dy", _I), ("decod_format", _I), ("cod_format", _I),
        ("jpwl_epc_on", _I), ("jpwl_hprot_MH", _I),
        ("jpwl_hprot_TPH_tileno", _I * 16), ("jpwl_hprot_TPH", _I * 16),
        ("jpwl_pprot_tileno", _I * 16), ("jpwl_pprot_packno", _I * 16),
        ("jpwl_pprot", _I * 16), ("jpwl_sens_size", _I),
        ("jpwl_sens_addr", _I), ("jpwl_sens_range", _I),
        ("jpwl_sens_MH", _I), ("jpwl_sens_TPH_tileno", _I * 16),
        ("jpwl_sens_TPH", _I * 16), ("cp_cinema", _I),
        ("max_comp_size", _I), ("cp_rsiz", _I), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char),
        ("jpip_on", _I), ("mct_data", ctypes.c_void_p),
        ("max_cs_size", _I), ("rsiz", ctypes.c_uint16),
        ("_spare", ctypes.c_char * 4096)]


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_uint32) for n in (
        "dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
        "resno_decoded", "factor")]
        + [("data", ctypes.POINTER(ctypes.c_int32)),
           ("alpha", ctypes.c_uint16)])


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", _I),
                ("comps", ctypes.POINTER(_ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


def _lib():
    """Pillow's bundled libopenjp2 (loadable once PIL has loaded its
    dependencies)."""
    global _LIB
    if _LIB is None:
        import PIL
        libdir = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                              "pillow.libs")
        lib = ctypes.CDLL(glob.glob(os.path.join(libdir,
                                                 "libopenjp2-*.so*"))[0])
        vp = ctypes.c_void_p
        lib.opj_image_create.restype = ctypes.POINTER(_Image)
        lib.opj_create_compress.restype = vp
        lib.opj_stream_create_default_file_stream.restype = vp
        lib.opj_setup_encoder.argtypes = [vp, ctypes.POINTER(_Params),
                                          ctypes.POINTER(_Image)]
        lib.opj_start_compress.argtypes = [vp, ctypes.POINTER(_Image), vp]
        lib.opj_encode.argtypes = [vp, vp]
        lib.opj_end_compress.argtypes = [vp, vp]
        lib.opj_stream_destroy.argtypes = [vp]
        lib.opj_destroy_codec.argtypes = [vp]
        lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
        lib.opj_encoder_set_extra_options.argtypes = [
            vp, ctypes.POINTER(ctypes.c_char_p)]
        _LIB = lib
    return _LIB


def encode(comps, jp2=False, prec=8, sgnd=0, sub=None, offset=(0, 0),
           size=None, color_space=1, numres=3, layers=None, tile=None,
           tile_offset=None, cblk=None, mode=0, irreversible=0, csty=0,
           prog="LRCP", prec_sizes=None, roi=None, pocs=None, tp=None,
           mct=None, extra=()) -> bytes:
    """OpenJPEG's encoder on `comps` (2-D int arrays at each component's
    size; `sub` their (dx, dy); `size` the image's (w, h) on the reference
    grid past `offset`): a J2K codestream or a JP2 file."""
    lib = _lib()
    n = len(comps)
    sub = sub or [(1, 1)] * n
    precs = prec if isinstance(prec, (list, tuple)) else [prec] * n
    parm = (_CmptParm * n)()
    for i, a in enumerate(comps):
        parm[i].dx, parm[i].dy = sub[i]
        parm[i].h, parm[i].w = a.shape
        parm[i].x0 = -(-offset[0] // sub[i][0])
        parm[i].y0 = -(-offset[1] // sub[i][1])
        parm[i].prec = parm[i].bpp = precs[i]
        parm[i].sgnd = sgnd
    img = lib.opj_image_create(n, parm, color_space)
    im = img.contents
    if size is None:
        size = (comps[0].shape[1] * sub[0][0], comps[0].shape[0] * sub[0][1])
    im.x0, im.y0 = offset
    im.x1, im.y1 = offset[0] + size[0], offset[1] + size[1]
    for i, a in enumerate(comps):
        flat = np.ascontiguousarray(a, np.int32).ravel()
        ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
    p = _Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    layers = layers or [0]
    p.tcp_numlayers = len(layers)
    for i, r in enumerate(layers):
        p.tcp_rates[i] = r
    p.cp_disto_alloc = 1
    if tile:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tile
    if tile_offset:
        p.cp_tx0, p.cp_ty0 = tile_offset
    p.numresolution = numres
    if cblk:
        p.cblockw_init, p.cblockh_init = cblk
    p.mode, p.irreversible, p.csty = mode, irreversible, csty
    p.prog_order = _PRG[prog]
    if prec_sizes:
        p.res_spec = len(prec_sizes)
        p.csty |= 1
        for i, (a, b) in enumerate(prec_sizes):
            p.prcw_init[i], p.prch_init[i] = a, b
    if roi:
        p.roi_compno, p.roi_shift = roi
    for i, (t, r0, c0, l1, r1, c1, prg) in enumerate(pocs or []):
        q = p.POC[i]
        q.tile, q.resno0, q.compno0, q.layno1 = t, r0, c0, l1
        q.resno1, q.compno1, q.prg1 = r1, c1, _PRG[prg]
    p.numpocs = len(pocs or [])
    if tp:
        p.tp_on, p.tp_flag = 1, tp.encode()
    p.tcp_mct = (1 if n >= 3 else 0) if mct is None else mct
    codec = lib.opj_create_compress(2 if jp2 else 0)
    if not lib.opj_setup_encoder(codec, ctypes.byref(p), img):
        raise ValueError("opj_setup_encoder failed")
    if extra:
        opts = (ctypes.c_char_p * (len(extra) + 1))(
            *[e.encode() for e in extra], None)
        lib.opj_encoder_set_extra_options(codec, opts)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "out")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, img, stream)
              and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        if not ok:
            raise ValueError("OpenJPEG's encoder failed")
        with open(path, "rb") as f:
            return f.read()


# ---------------------------------------------------------------- helpers
def photo(h=H, w=W, seed=0, c=4):
    """Smooth colours with a little noise and a soft alpha."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0 + seed),
                    128 + 90 * np.cos(np.hypot(x - w / 3, y - h / 2) / 4.0),
                    128 + 110 * np.sin(x * y / 90.0 + seed),
                    255 - 3 * np.hypot(x - w / 2, y - h / 2)], -1)[..., :c]
    img += rng.normal(0, 4.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_save(arr, mode=None, **kw) -> bytes:
    im = Image.fromarray(np.asarray(arr))
    if mode is not None:
        im = im.convert(mode)
    bio = io.BytesIO()
    im.save(bio, "JPEG2000", **kw)
    return bio.getvalue()


def boxes(buf: bytes):
    """A JP2 file's top-level boxes: [(type, body)]."""
    out, pos = [], 0
    while pos < len(buf):
        n, t = struct.unpack_from(">I4s", buf, pos)
        n = n or len(buf) - pos
        out.append((t, buf[pos + 8:pos + n]))
        pos += n
    return out


def join_boxes(items) -> bytes:
    return b"".join(struct.pack(">I4s", 8 + len(b), t) + b for t, b in items)


def edit_jp2h(buf: bytes, edit) -> bytes:
    """The JP2 file with its jp2h children replaced by edit(children)."""
    out = []
    for t, body in boxes(buf):
        if t == b"jp2h":
            body = join_boxes(edit(boxes(body)))
        out.append((t, body))
    return join_boxes(out)


def colr(enumcs=None, icc=None):
    if icc is not None:
        return (b"colr", b"\x02\x00\x00" + icc)
    return (b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def set_colr(buf, item):
    return edit_jp2h(buf, lambda ch: [item if t == b"colr" else (t, b)
                                      for t, b in ch])


def add_boxes(buf, items, drop=()):
    return edit_jp2h(buf, lambda ch: [(t, b) for t, b in ch
                                      if t not in drop] + list(items))


def pclr(entries, depths=None):
    entries = np.asarray(entries)
    ne, nc = entries.shape
    depths = depths or [8] * nc
    body = struct.pack(">HB", ne, nc) + bytes(d - 1 for d in depths)
    for row in entries:
        for v, d in zip(row, depths):
            body += int(v).to_bytes((d + 7) // 8, "big")
    return (b"pclr", body)


def cmap(items):
    return (b"cmap", b"".join(struct.pack(">HBB", *m) for m in items))


def cdef(items):
    return (b"cdef", struct.pack(">H", len(items)) + b"".join(
        struct.pack(">HHH", *m) for m in items))


def codestream_of(buf: bytes) -> bytes:
    return buf if buf[:2] == b"\xff\x4f" else dict(boxes(buf))[b"jp2c"]


def packets_to_ppt(cs: bytes, main: bool = False) -> bytes:
    """A codestream written with SOP and EPH (one tile-part per tile) with
    its packet headers moved into PPT markers (PPM with `main`): each
    packet's header, EPH included, leaves the body, which keeps its SOP."""
    pos = cs.index(b"\xff\x90")
    head, parts, ppm = cs[:pos], [], []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        part = cs[pos:pos + psot]
        sod = part.index(b"\xff\x93")
        tph, data = part[12:sod], part[sod + 2:]
        hdrs, bodies, i = bytearray(), bytearray(), 0
        while i < len(data):
            assert data[i:i + 2] == b"\xff\x91"
            eph = data.index(b"\xff\x92", i + 6) + 2
            nxt = data.find(b"\xff\x91", eph)
            nxt = len(data) if nxt < 0 else nxt
            hdrs += data[i + 6:eph]
            bodies += data[i:i + 6] + data[eph:nxt]
            i = nxt
        if main:
            ppm.append(bytes(hdrs))
            new_tph = tph
        else:
            new_tph = tph + b"\xff\x61" + struct.pack(
                ">HB", 3 + len(hdrs), 0) + bytes(hdrs)
        body = new_tph + b"\xff\x93" + bytes(bodies)
        parts.append(b"\xff\x90" + struct.pack(">HHIBB", 10, *struct.unpack_from(
            ">H", part, 4), 12 + len(body), part[10], part[11]) + body)
        pos += psot
    tail = cs[pos:]
    if main:
        ippm = b"".join(struct.pack(">I", len(h)) + h for h in ppm)
        head += b"\xff\x60" + struct.pack(">HB", 3 + len(ippm), 0) + ippm
    return head + b"".join(parts) + tail


def sop_positions(cs: bytes):
    out, i = [], cs.find(b"\xff\x91")
    while i >= 0:
        out.append(i)
        i = cs.find(b"\xff\x91", i + 2)
    return out


# ---------------------------------------------------------------- fixtures
def variants():
    """(file name, bytes) of every fixture PIL decodes."""
    rgba = photo(seed=1)
    rgb = np.ascontiguousarray(rgba[..., :3])
    grey = np.ascontiguousarray(rgba[..., 0])
    out = []

    def add(name, data):
        out.append((name, data))

    # PIL's save options
    add("rgb_53.jp2", pil_save(rgb))
    add("rgb_97.jp2", pil_save(rgb, irreversible=True))
    add("rgb_53_layers.jp2", pil_save(rgb, quality_mode="rates",
                                      quality_layers=[40, 12, 3]))
    add("rgb_97_layers.jp2", pil_save(rgb, irreversible=True,
                                      quality_layers=[60, 20, 5]))
    add("rgb_97_dB.jp2", pil_save(rgb, irreversible=True,
                                  quality_mode="dB",
                                  quality_layers=[25, 35]))
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        add(f"prog_{prog.lower()}.jp2", pil_save(
            rgb, progression=prog, quality_layers=[20, 5],
            precinct_size=(16, 16), codeblock_size=(4, 4),
            num_resolutions=4))
    add("tiles_offsets.jp2", pil_save(rgb, tile_size=(16, 12),
                                      tile_offset=(3, 2), offset=(7, 5)))
    add("tiles_97_layers.j2k", pil_save(rgb, tile_size=(20, 20),
                                        irreversible=True,
                                        quality_layers=[30, 6],
                                        no_jp2=True))
    # odd tile and image origins: the wavelets' odd phases, and a tile one
    # sample wide at an odd x (the 5/3's lone high-pass sample)
    wide = photo(35, 49, 7, 3)
    add("edge_1px_tile_53.jp2", pil_save(wide, offset=(1, 1),
                                         tile_offset=(1, 1),
                                         tile_size=(16, 16)))
    add("odd_tiles_53.jp2", pil_save(wide, offset=(7, 9),
                                     tile_offset=(6, 8), tile_size=(7, 5),
                                     num_resolutions=3))
    add("odd_tiles_97.jp2", pil_save(wide, offset=(5, 3),
                                     tile_offset=(4, 2), tile_size=(13, 11),
                                     irreversible=True, num_resolutions=3))
    add("odd_tiles_97_layers.jp2", pil_save(
        wide, offset=(3, 5), tile_offset=(2, 4), tile_size=(15, 9),
        irreversible=True, quality_layers=[10, 3], num_resolutions=3))
    add("tiles_2x2.jp2", pil_save(wide, tile_size=(2, 2), num_resolutions=1))
    add("numres_1.jp2", pil_save(rgb, num_resolutions=1))
    add("numres_2_97.jp2", pil_save(rgb, num_resolutions=2,
                                    irreversible=True))
    add("numres_6_53.jp2", pil_save(photo(64, 64, 2, 3), num_resolutions=6))
    add("cblk_4x64.jp2", pil_save(rgb, codeblock_size=(4, 64)))
    add("precinct_8.jp2", pil_save(rgb, precinct_size=(8, 8),
                                   codeblock_size=(4, 4), num_resolutions=3,
                                   quality_layers=[12, 3]))
    add("mct0.jp2", pil_save(rgb, mct=0))
    add("mct0_97.jp2", pil_save(rgb, mct=0, irreversible=True))
    add("signed.jp2", pil_save(rgb, signed=True))
    add("signed_97_L.j2k", pil_save(grey, signed=True, irreversible=True,
                                    no_jp2=True))
    add("plt.jp2", pil_save(rgb, plt=True, tile_size=(24, 24)))
    add("L.jp2", pil_save(grey))
    add("L.j2k", pil_save(grey, no_jp2=True))
    add("L_97_layers.j2k", pil_save(grey, irreversible=True,
                                    quality_layers=[30, 8], no_jp2=True))
    add("LA.jp2", pil_save(rgba[..., [0, 3]].copy()))
    add("RGBA.jp2", pil_save(rgba))
    add("RGBA_97.j2k", pil_save(rgba, irreversible=True, no_jp2=True))
    add("CMYK.jp2", pil_save(rgba, "CMYK"))
    i16 = (photo(seed=3, c=1)[..., 0].astype(np.int32) * 257
           + np.arange(W)[None, :] % 7).astype(np.uint16)
    add("I16.jp2", pil_save(Image.fromarray(i16.astype(np.int32), "I")
                            .convert("I;16")))
    add("I16_97.j2k", pil_save(Image.fromarray(i16.astype(np.int32), "I")
                               .convert("I;16"), irreversible=True,
                               no_jp2=True))
    add("comment.j2k", pil_save(rgb, comment=b"irgs jpeg 2000 test",
                                no_jp2=True))
    add("comment.jp2", pil_save(rgb, comment="a JP2 comment"))
    add("dpi.jp2", pil_save(rgb, dpi=(72, 300)))

    # OpenJPEG's encoder: what PIL cannot write
    c3 = [rgb[..., k].astype(np.int32) for k in range(3)]
    for bit, tag in ((1, "bypass"), (2, "reset"), (4, "termall"), (8, "vsc"),
                     (16, "pterm"), (32, "segsym")):
        add(f"cblk_{tag}.j2k", encode(c3, mode=bit, layers=[20, 5, 1]))
    add("cblk_all.j2k", encode(c3, mode=63, layers=[30, 8, 2],
                               cblk=(16, 16)))
    add("cblk_bypass_97.j2k", encode(c3, mode=1, irreversible=1,
                                     layers=[40, 10, 3]))
    add("cblk_bypass_termall_vsc.jp2", encode(c3, jp2=True, mode=13,
                                              layers=[10, 2]))
    add("sop_eph.j2k", encode(c3, csty=6, layers=[10, 3]))
    add("sop_eph_tiles.j2k", encode(c3, csty=6, layers=[12, 3],
                                    tile=(16, 16)))
    add("poc.j2k", encode(c3, layers=[8, 2], pocs=[
        (1, 0, 0, 2, 2, 3, "RLCP"), (1, 2, 0, 2, 3, 3, "CPRL")]))
    add("poc_tiles.j2k", encode(c3, layers=[8, 2], tile=(24, 24), pocs=[
        (1, 0, 0, 2, 2, 3, "RLCP"), (1, 2, 0, 2, 3, 3, "CPRL"),
        (2, 0, 0, 2, 3, 3, "LRCP")]))
    add("roi_53.j2k", encode(c3, roi=(0, 7)))
    add("roi_97.j2k", encode(c3, roi=(1, 5), irreversible=1,
                             layers=[10, 3]))
    add("tileparts_r.j2k", encode(c3, tile=(24, 16), tp="R", prog="RPCL",
                                  layers=[10, 2], extra=("TLM=YES",)))
    add("tileparts_c.j2k", encode(c3, tile=(32, 32), tp="C", prog="CPRL",
                                  extra=("TLM=YES", "PLT=YES")))
    add("tileparts_l.jp2", encode(c3, jp2=True, tp="L", layers=[20, 6, 2],
                                  tile=(30, 20)))
    sub420 = photo(40, 48, 4, 3)
    add("sub_420.j2k", encode(
        [sub420[..., 0], sub420[::2, ::2, 1], sub420[::2, ::2, 2]],
        sub=[(1, 1), (2, 2), (2, 2)], mct=0))
    sub_odd = photo(37, 45, 5, 3)
    add("sub_422_odd.j2k", encode(
        [sub_odd[..., 0], sub_odd[:, ::2, 1], sub_odd[:, ::2, 2]],
        sub=[(1, 1), (2, 1), (2, 1)], mct=0, tile=(16, 16)))
    add("sub_444_422_c2.j2k", encode(
        [sub_odd[..., 0], sub_odd[..., 1], sub_odd[:, ::2, 2]],
        sub=[(1, 1), (1, 1), (2, 1)], mct=0))
    add("sub_all_2x2.j2k", encode([sub420[::2, ::2, k] for k in range(3)],
                                  sub=[(2, 2)] * 3, mct=0))
    add("sub_420_srgb.jp2", encode(
        [sub420[..., 0], sub420[::2, ::2, 1], sub420[::2, ::2, 2]],
        sub=[(1, 1), (2, 2), (2, 2)], mct=0, jp2=True))
    rng = np.random.default_rng(9)
    c12 = [(c.astype(np.int32) << 4) | rng.integers(0, 16, c.shape)
           for c in c3]
    c12[0][0, :4] = [4095, 4088, 4087, 8]
    add("rgb_12bit.jp2", encode(c12, jp2=True, prec=12))
    add("rgb_12bit_97.j2k", encode(c12, prec=12, irreversible=1,
                                   layers=[20, 5]))
    add("rgb_16bit.j2k", encode([c.astype(np.int32) * 257 for c in c3],
                                prec=16))
    add("grey_12bit.j2k", encode([c12[0]], prec=12))
    add("grey_4bit.j2k", encode([c3[0] >> 4], prec=4))
    add("grey_1bit.j2k", encode([c3[0] >> 7], prec=1))
    add("signed_12bit_rgb.j2k", encode([c - 2048 for c in c12], prec=12,
                                       sgnd=1))
    add("mixed_depth.j2k", encode([c12[0], c3[1], c3[2] >> 2],
                                  prec=[12, 8, 6], mct=0))

    # JP2 boxes edited
    base = pil_save(rgb, mct=0)
    add("colr_sycc.jp2", set_colr(base, colr(18)))
    add("colr_sycc_rgba.jp2", set_colr(pil_save(rgba, mct=0), colr(18)))
    add("colr_cmyk_on_rgba.jp2", set_colr(pil_save(rgba), colr(12)))
    add("colr_two_boxes.jp2", add_boxes(base, [colr(17)]))
    add("colr_icc.jp2", set_colr(base, colr(icc=bytes(128))))
    add("colr_cielab.jp2", set_colr(base, (b"colr", struct.pack(
        ">BBBI7I", 1, 0, 0, 14, 100, 0, 255, 128, 255, 96, 0x443530))))
    add("colr_missing.jp2", edit_jp2h(base, lambda ch: [
        (t, b) for t, b in ch if t != b"colr"]))
    add("colr_missing_420.jp2", edit_jp2h(encode(
        [sub420[..., 0], sub420[::2, ::2, 1], sub420[::2, ::2, 2]],
        sub=[(1, 1), (2, 2), (2, 2)], mct=0, jp2=True), lambda ch: [
        (t, b) for t, b in ch if t != b"colr"]))
    add("colr_method3.jp2", add_boxes(set_colr(base, (b"colr", bytes(
        [3, 0, 0]) + bytes(4))), [colr(16)]))
    pal = np.stack([np.arange(16) * 17, 255 - np.arange(16) * 16,
                    (np.arange(16) * 53) % 256], -1)
    idx = (grey >> 4).astype(np.uint8)
    pl = pil_save(idx)
    add("pclr_L.jp2", set_colr(add_boxes(pl, [pclr(pal), cmap(
        [(0, 1, 0), (0, 1, 1), (0, 1, 2)])]), colr(16)))
    add("pclr_dup_colours.jp2", set_colr(add_boxes(pl, [pclr(np.concatenate(
        [pal[:8], pal[:8]])), cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])]),
        colr(16)))
    add("pclr_rgba.jp2", set_colr(add_boxes(pl, [pclr(np.concatenate(
        [pal, np.full((16, 1), 255)], 1)), cmap(
            [(0, 1, 0), (0, 1, 1), (0, 1, 2), (0, 1, 3)])]), colr(16)))
    add("pclr_no_cmap.jp2", set_colr(add_boxes(pl, [pclr(pal)]), colr(16)))
    pla = pil_save(np.stack([idx, rgba[..., 3]], -1))
    add("pclr_LA.jp2", set_colr(add_boxes(pla, [pclr(pal), cmap(
        [(0, 1, 0), (0, 1, 1), (0, 1, 2), (1, 0, 0)])]), colr(16)))
    prgba = pil_save(rgba)
    add("cdef_alpha.jp2", add_boxes(prgba, [cdef(
        [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])], drop=(b"cdef",)))
    add("cdef_swap.jp2", add_boxes(prgba, [cdef(
        [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 2, 0)])], drop=(b"cdef",)))
    add("cdef_premultiplied.jp2", add_boxes(prgba, [cdef(
        [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)])], drop=(b"cdef",)))
    add("colr_sycc_12bit.jp2", set_colr(encode(c12, jp2=True, prec=12,
                                               mct=0), colr(18)))
    add("res_box.jp2", add_boxes(base, [(b"res ", join_boxes([
        (b"resc", struct.pack(">HHHHBB", 3937, 100, 7874, 100, 0, 0)),
        (b"resd", struct.pack(">HHHHBB", 1, 1, 1, 1, 0, 0))]))]))
    add("bpcc.jp2", add_boxes(base, [(b"bpcc", b"\x07\x07\x07")]))
    add("xml_uuid_boxes.jp2", join_boxes(
        boxes(base)[:3] + [(b"xml ", b"<a/>"), (b"uuid", bytes(20))]
        + boxes(base)[3:]))

    # packet headers in PPT and PPM
    se = encode(c3, csty=6, layers=[10, 3], tile=(24, 24))
    add("ppt.j2k", packets_to_ppt(se))
    add("ppm.j2k", packets_to_ppt(se, main=True))

    # damaged streams PIL still decodes
    for name, data in out[:]:
        if name in ("rgb_53.jp2", "rgb_97_layers.jp2", "sop_eph.j2k",
                    "cblk_all.j2k"):
            cs = codestream_of(data)
            at = data.index(cs) + len(cs) // 2
            d = bytearray(data)
            d[at] ^= 0x21
            add("corrupt_flip_" + name, bytes(d))
    add("corrupt_junk_after_eoc.jp2", pil_save(rgb) + b"\x00junk")
    return out


def refused():
    """(file name, bytes, None) of streams PIL refuses."""
    rgb = np.ascontiguousarray(photo(seed=1)[..., :3])
    c3 = [rgb[..., k].astype(np.int32) for k in range(3)]
    out = []
    for name, data in (("rgb_53.jp2", pil_save(rgb)),
                       ("sop_eph.j2k", encode(c3, csty=6, layers=[10, 3])),
                       ("tiles.j2k", pil_save(rgb, tile_size=(16, 16),
                                              no_jp2=True))):
        cs = codestream_of(data)
        start = data.index(cs)
        sot = start + cs.index(b"\xff\x90")
        out.append(("cut_in_data_" + name, data[:sot + (len(data) - sot)
                                                // 2], None))
        out.append(("cut_in_header_" + name, data[:start + 60], None))
        d = bytearray(data)
        d[start + 5] += 3               # SIZ's length
        out.append(("bad_siz_length_" + name, bytes(d), None))
        cod = start + cs.index(b"\xff\x52")
        d = bytearray(data)
        d[cod + 3] += 3                 # COD's length
        out.append(("bad_cod_length_" + name, bytes(d), None))
        d = bytearray(data)
        d[sot + 9] ^= 0x10              # Psot past the end
        out.append(("bad_psot_" + name, bytes(d), None))
    rgba = photo(seed=1)
    out.append(("colr_cmyk_on_rgb.jp2", set_colr(pil_save(rgb), colr(12)),
                None))
    out.append(("colr_eycc.jp2", set_colr(pil_save(rgb), colr(24)), None))
    out.append(("ihdr_size_mismatch.jp2", edit_jp2h(pil_save(rgb), lambda ch: [
        (t, struct.pack(">II", H + 1, W) + b[8:]) if t == b"ihdr" else (t, b)
        for t, b in ch]), None))
    out.append(("no_jp2h.jp2", join_boxes([
        (t, b) for t, b in boxes(pil_save(rgb)) if t != b"jp2h"]), None))
    out.append(("five_components.j2k", encode(
        c3 + [c3[0], c3[1]], mct=0), None))
    out.append(("sub_rgb_mct.j2k", _sub_mct(c3), None))
    out.append(("sub_grey_2x2.j2k", encode([c3[0][::2, ::2]], sub=[(2, 2)],
                                           size=(W, H)), None))
    out.append(("colr_grey_on_rgb.jp2", set_colr(pil_save(rgb, mct=0),
                                                 colr(17)), None))
    idx = (c3[0] >> 4).astype(np.uint8)
    pal = np.stack([np.arange(16) * 17, 255 - np.arange(16) * 16,
                    (np.arange(16) * 53) % 256], -1)
    out.append(("pclr_16bit.jp2", set_colr(add_boxes(pil_save(idx), [
        pclr(pal * 257, [16] * 3), cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])]),
        colr(16)), None))
    out.append(("no_eoc.j2k", encode(c3)[:-2], None))
    out.append(("two_cdef.jp2", add_boxes(pil_save(rgba), [cdef(
        [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])]), None))
    return out


def _sub_mct(c3) -> bytes:
    """A 4:2:0 stream whose COD asks for the colour transform: OpenJPEG
    refuses to transform components of different sizes."""
    cs = bytearray(encode([c3[0], c3[1][::2, ::2], c3[2][::2, ::2]],
                          sub=[(1, 1), (2, 2), (2, 2)], mct=0))
    cod = cs.index(b"\xff\x52")
    cs[cod + 8] = 1
    return bytes(cs)


# ---------------------------------------------------------------- large
LARGE = (("large_53.jp2", "5/3 lossless, 6 resolutions"),
         ("large_97_layers.jp2", "9/7, 3 quality layers"))


def large_frames():
    import make_webp_fixtures as mw
    frame = mw.photo(840, 1297, 5, noise=0.0, scale=16.0)
    return [("large_53.jp2", pil_save(frame)),
            ("large_97_layers.jp2", pil_save(frame, irreversible=True,
                                             quality_layers=[40, 15, 6]))]


def save_large(out: str) -> None:
    import hashlib
    os.makedirs(out, exist_ok=True)
    notes = {}
    for name, data in large_frames():
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        with Image.open(path) as im:
            arr = np.asarray(im)
            notes[name] = {"mode": im.mode, "shape": list(arr.shape),
                           "sha256": hashlib.sha256(
                               np.ascontiguousarray(arr).tobytes())
                           .hexdigest()}
    with open(os.path.join(out, "large.json"), "w") as f:
        json.dump(notes, f, indent=0, sort_keys=True)


# ---------------------------------------------------------------- capture
CAPTURE_FRAMES = (("view_000.jp2", "53_lossless"),
                  ("view_001.jp2", "97_layers_rpcl_prec64"),
                  ("view_002.j2k", "tiles128_sop_eph_bypass_termall"),
                  ("view_003.jp2", "rgb_12bit"))


def capture_frame(rgb: np.ndarray, kind: str) -> bytes:
    c3 = [rgb[..., k].astype(np.int32) for k in range(3)]
    if kind == "53_lossless":
        return pil_save(rgb)
    if kind == "97_layers_rpcl_prec64":
        return pil_save(rgb, irreversible=True, quality_layers=[30, 10, 3],
                        progression="RPCL", precinct_size=(64, 64))
    if kind == "tiles128_sop_eph_bypass_termall":
        return encode(c3, numres=5, tile=(128, 128), csty=6, mode=1 | 4)
    return encode([(c << 4) | (c >> 4) for c in c3], jp2=True, prec=12,
                  numres=5)


def write_colmap_capture(root: str) -> None:
    import shutil
    sys.path.insert(0, os.path.dirname(HERE))
    from irgs_tpu_torch.scene import colmap

    src = os.path.join(DATA, "webp", "colmap")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "sparse", "0"))
    for f in ("cameras.bin", "points3D.bin"):
        shutil.copy(os.path.join(src, "sparse", "0", f),
                    os.path.join(root, "sparse", "0", f))
    images = colmap.read_images_bin(os.path.join(src, "sparse", "0",
                                                 "images.bin"))
    with open(os.path.join(root, "sparse", "0", "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for (iid, im), (name, kind) in zip(sorted(images.items()),
                                           CAPTURE_FRAMES):
            with Image.open(os.path.join(src, "images", im["name"])) as pim:
                rgb = np.asarray(pim.convert("RGB"))
            with open(os.path.join(root, "images", name), "wb") as fh:
                fh.write(capture_frame(rgb, kind))
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im["qvec"]))
            f.write(struct.pack("<ddd", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


if __name__ == "__main__":
    ims.save_fixtures(OUT, variants(), refused(), "")
    print(f"wrote {len(variants())} JPEG 2000 fixtures")
    save_large(os.path.join(OUT, "large"))
    if "--no-capture" not in sys.argv:
        write_colmap_capture(os.path.join(OUT, "colmap"))
