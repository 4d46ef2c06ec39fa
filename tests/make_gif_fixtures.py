"""Write the GIF fixtures of tests/data/gif/ (with PIL, here only).

One small file per case of the port's reader (irgs_tpu_torch/utils/gif.py):
palettes of 2 to 256 entries, global or local, a grey-ramp palette (PIL
reads "L"), no palette at all, interlaced frames, a frame at an offset on
a larger screen with a transparency index (the canvas filled with it), a
frame reaching past the screen, LZW without a leading clear code and with
a deferred clear, comment and application extensions, an animated file
(the first frame is read), and the files PIL's own GIF writer makes.
Beside each ``<name>.gif`` the ``<name>.npy`` PIL decodes from it and, in
``modes.json``, its PIL mode, palette and transparency. ``refused/`` holds
streams PIL refuses (``refused/refused.json``).

    python tests/make_gif_fixtures.py
"""

from __future__ import annotations

import io
import os

import numpy as np
from PIL import Image

import image_streams as ims

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "gif")
H, W = 21, 26


def variants():
    rng = np.random.default_rng(14)
    out = []

    def add(name, idx, **kw):
        out.append((name, ims.write_gif(idx, **kw)))

    for bits in (1, 2, 4, 8):
        n = 1 << bits
        pal = rng.integers(0, 256, (n, 3))
        idx = rng.integers(0, n, (H, W))
        idx[: H // 2] = idx[: H // 2] // 2     # repeats for longer codes
        add(f"global{bits}", idx, global_palette=pal)
        add(f"local{bits}_interlaced", idx, local_palette=pal,
            global_palette=rng.integers(0, 256, (4, 3)), interlace=True)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (H, W))
    add("grey_ramp", idx, global_palette=np.repeat(
        np.arange(16)[:, None], 3, 1))
    add("local_grey_ramp", idx, global_palette=pal,
        local_palette=np.repeat(np.arange(16)[:, None], 3, 1))
    add("no_palette", idx)
    add("offset_transparent", idx, global_palette=pal, transparency=5,
        offset=(3, 4), screen=(W + 7, H + 6))
    add("past_screen", idx, global_palette=pal, offset=(5, 2),
        screen=(W - 4, H - 3))
    add("no_clear_code", idx, global_palette=pal, clear_first=False)
    add("interlaced_3_rows", idx[:3], global_palette=pal, interlace=True)
    add("comment", idx, global_palette=pal, comment=b"made for a test")
    big = rng.integers(0, 256, (90, 100))
    big[:50] //= 64
    pal256 = rng.integers(0, 256, (256, 3))
    add("deferred_clear", big, global_palette=pal256, defer_clear=True)
    add("table_full_clear", big, global_palette=pal256)
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    for mode in ("P", "L", "RGB"):
        im = Image.fromarray(img).convert(mode)
        for inter in (False, True):
            bio = io.BytesIO()
            im.save(bio, "GIF", interlace=inter)
            out.append((f"pil_{mode}{'_interlaced' if inter else ''}",
                        bio.getvalue()))
    frames = [Image.fromarray(img).convert("P"),
              Image.fromarray(img[::-1]).convert("P")]
    bio = io.BytesIO()
    frames[0].save(bio, "GIF", save_all=True, append_images=frames[1:],
                   duration=50, loop=0, transparency=3)
    out.append(("animated", bio.getvalue()))
    return out


def refused():
    rng = np.random.default_rng(15)
    idx = rng.integers(0, 16, (H, W))
    pal = rng.integers(0, 256, (16, 3))
    return [
        ("truncated", ims.write_gif(idx, global_palette=pal, truncate=40),
         None),
        ("end_code_early", ims.write_gif(idx, global_palette=pal,
                                         end_early=100), None),
        ("no_image", b"GIF89a" + bytes([4, 0, 4, 0, 0, 0, 0]) + b";", None),
        ("not_gif", b"GIF90a" + bytes(20), None),
    ]


if __name__ == "__main__":
    ims.save_fixtures(OUT, variants(), refused(), ".gif")
    print(f"wrote {len(variants())} fixtures to {OUT}")
