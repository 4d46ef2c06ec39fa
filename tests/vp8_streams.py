"""Test-side VP8 key-frame rewriting for tests/make_webp_fixtures.py: the
layouts the available encoders do not write (libwebp's encoder ignores its
``partitions`` option and never writes loop-filter deltas).

`rewrite` parses a key frame (RFC 6386: the frame header, partition 0's
header and per-macroblock modes, every macroblock's tokens) with a boolean
decoder that logs each (probability, bit) it reads, then encodes the logs
again with the boolean encoder of RFC 6386 section 7.3: the token data of
macroblock row y into partition y mod n, and, where asked, the loop-filter
header with mode and reference deltas in place of use_lf_delta = 0. The
probability tables are read from the decoder's source
(irgs_tpu_torch/csrc/webp_decode.cpp), whose tables equal RFC 6386's."""

from __future__ import annotations

import os
import re
import struct

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "irgs_tpu_torch", "csrc", "webp_decode.cpp")


def _table(name: str, shape) -> np.ndarray:
    with open(_SRC) as f:
        src = f.read()
    body = re.search(name + r"[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)]).reshape(
        shape)


class _Reader:
    """RFC 6386's boolean decoder, logging (prob, bit)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1] if len(data) > 1 else 0
        self.range, self.bit_count, self.log = 255, 0, []

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big_split = split << 8
        if self.value >= big_split:
            b = 1
            self.range -= split
            self.value -= big_split
        else:
            b = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        self.log.append((prob, b))
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v


def encode(log) -> bytes:
    """RFC 6386 section 7.3's boolean encoder over (prob, bit) pairs."""
    out = bytearray()
    rng, bottom, bit_count = 255, 0, 24

    def add_one():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for prob, b in log:
        split = 1 + (((rng - 1) * prob) >> 8)
        if b:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                add_one()
            bottom = (bottom << 1) & 0xFFFFFFFF
            bit_count -= 1
            if not bit_count:
                out.append(bottom >> 24)
                bottom &= (1 << 24) - 1
                bit_count = 8
    c, v = bit_count, bottom
    if v & (1 << (32 - c)):
        add_one()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append(v >> 24)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def _bit128(value: int, n: int):
    return [(128, (value >> (n - 1 - i)) & 1) for i in range(n)]


def _signed(value: int, n: int):
    return _bit128(abs(value), n) + [(128, int(value < 0))]


def rewrite(frame: bytes, n_parts: int = 1, lf_deltas=None) -> bytes:
    """A VP8 key frame with its tokens in `n_parts` partitions and, with
    `lf_deltas` = (ref[4], mode[4]), those loop-filter deltas."""
    probs0 = _table("kCoeffProbs0", (4, 8, 3, 11))
    upd = _table("kCoeffUpdateProbs", (4, 8, 3, 11))
    bmode = _table("kBModeProbs", (10, 10, 9))
    # RFC 6386 section 11.2's bmode_tree, modes in the RFC's order
    tree = [0, 2, -1, 4, -2, 6, 8, 12, -3, 10, -5, -6, -4, 14, -7, 16, -8, -9]
    bands = _table("kBands", (17,))
    cats = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
            [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]
    tag = frame[0] | (frame[1] << 8) | (frame[2] << 16)
    assert not tag & 1, "a key frame"
    p0_len = tag >> 5
    w, h = (struct.unpack_from("<H", frame, 6)[0] & 0x3FFF,
            struct.unpack_from("<H", frame, 8)[0] & 0x3FFF)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    br = _Reader(frame[10:10 + p0_len])
    br.literal(2)                                    # colour space, clamp
    if br.bit(128):                                  # segmentation
        update_map = br.bit(128)
        if br.bit(128):
            br.bit(128)
            for _ in range(4):
                if br.bit(128):
                    br.literal(8)
            for _ in range(4):
                if br.bit(128):
                    br.literal(7)
        seg_probs = [br.literal(8) if br.bit(128) else 255
                     for _ in range(3)] if update_map else None
    else:
        seg_probs = None
    br.literal(1 + 6 + 3)                            # type, level, sharpness
    lf_at = len(br.log)
    if br.bit(128) and br.bit(128):                  # deltas present
        for _ in range(8):
            if br.bit(128):
                br.literal(7)
        assert lf_deltas is None, "the frame has loop-filter deltas already"
    parts_at = len(br.log)
    old_parts = 1 << br.literal(2)
    assert old_parts == 1, "one token partition in"
    br.literal(7)
    for _ in range(5):
        if br.bit(128):
            br.literal(5)
    br.bit(128)                                      # refresh_entropy_probs
    probas = probs0.copy()
    for idx in np.ndindex(4, 8, 3, 11):
        if br.bit(int(upd[idx])):
            probas[idx] = br.literal(8)
    use_skip = br.bit(128)
    skip_p = br.literal(8) if use_skip else 0
    # partition 0's modes: per macroblock (is_i4x4, skip)
    mbs = []
    intra_t = [0] * (4 * mb_w)
    for _ in range(mb_h):
        intra_l = [0] * 4
        row = []
        for mx in range(mb_w):
            if seg_probs:
                if not br.bit(seg_probs[0]):
                    br.bit(seg_probs[1])
                else:
                    br.bit(seg_probs[2])
            skip = br.bit(skip_p) if use_skip else 0
            i4 = not br.bit(145)
            top = intra_t[4 * mx:4 * mx + 4]
            if not i4:
                ymode = ((1 if br.bit(128) else 3) if br.bit(156) else
                         (2 if br.bit(163) else 0))
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    ymode = intra_l[y]
                    for x in range(4):
                        prob = bmode[top[x]][ymode]
                        i = 0
                        while True:
                            i = int(tree[i + br.bit(int(prob[i >> 1]))])
                            if i <= 0:
                                break
                        ymode = -i
                        top[x] = ymode
                    intra_l[y] = ymode
            intra_t[4 * mx:4 * mx + 4] = top
            if br.bit(142) and br.bit(114):
                br.bit(183)
            row.append((i4, skip))
        mbs.append(row)
    log0 = br.log
    # tokens, logged per macroblock row
    tr = _Reader(frame[10 + p0_len:])
    rows = []

    def coeffs(t, ctx, n):
        p = probas[t][bands[n]][ctx]
        while n < 16:
            if not tr.bit(int(p[0])):
                return n
            while not tr.bit(int(p[1])):
                n += 1
                p = probas[t][bands[n]][0]
                if n == 16:
                    return 16
            p_ctx = probas[t][bands[n + 1]]
            if not tr.bit(int(p[2])):
                p = p_ctx[1]
            else:
                if not tr.bit(int(p[3])):
                    if tr.bit(int(p[4])):
                        tr.bit(int(p[5]))
                elif not tr.bit(int(p[6])):
                    if not tr.bit(int(p[7])):
                        tr.bit(159)
                    else:
                        tr.bit(165)
                        tr.bit(145)
                else:
                    b1 = tr.bit(int(p[8]))
                    b0 = tr.bit(int(p[9 + b1]))
                    for pr in cats[2 * b1 + b0]:
                        tr.bit(pr)
                p = p_ctx[2]
            tr.bit(128)                              # sign
            n += 1
        return 16

    top_nz = [[0] * 9 for _ in range(mb_w)]          # 4 y, 2 u, 2 v, dc
    for row in mbs:
        start = len(tr.log)
        left = [0] * 9
        for mx, (i4, skip) in enumerate(row):
            top = top_nz[mx]
            if skip:
                for k in range(8):
                    top[k] = left[k] = 0
                if not i4:
                    top[8] = left[8] = 0
                continue
            first = 0
            if not i4:
                nz = coeffs(1, top[8] + left[8], 0)
                top[8] = left[8] = int(nz > 0)
                first = 1
            t = 0 if not i4 else 3
            for y in range(4):
                for x in range(4):
                    nz = coeffs(t, top[x] + left[y], first)
                    top[x] = left[y] = int(nz > first)
            for c in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = coeffs(2, top[c + x] + left[c + y], 0)
                        top[c + x] = left[c + y] = int(nz > 0)
        rows.append(tr.log[start:])
    # re-encode
    log0 = list(log0)
    log0[parts_at:parts_at + 2] = _bit128(n_parts.bit_length() - 1, 2)
    if lf_deltas is not None:
        ref, mode = lf_deltas
        add = [(128, 1), (128, 1)]
        for d in list(ref) + list(mode):
            add += [(128, 1)] + _signed(d, 6)
        assert log0[lf_at] == (128, 0)
        log0[lf_at:lf_at + 1] = add
    p0 = encode(log0)
    parts = [encode([e for y, r in enumerate(rows) if y % n_parts == k
                     for e in r]) for k in range(n_parts)]
    tag = (tag & 0x1F) | (len(p0) << 5)
    sizes = b"".join(struct.pack("<I", len(p))[:3] for p in parts[:-1])
    return bytes([tag & 255, (tag >> 8) & 255, tag >> 16]) + frame[3:10] + \
        p0 + sizes + b"".join(parts)
