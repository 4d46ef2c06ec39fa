"""Image munging for paper figures and relit outputs (≙ process_images.py,
with the port's PNG/JPEG codecs and PIL-exact Lanczos in place of PIL).

    python -m irgs_tpu_torch.process_images split-grid 020000_env.png \
        --rows 2 --padding 10
    python -m irgs_tpu_torch.process_images crop <in_dir> <out_dir> \
        --downscale 4 --crop 115 25 85 35

split-grid reads the grid as ``convert("RGB")`` does, cuts `rows` panels
between `padding`-pixel borders, max-normalises every panel after the
first (``--normalize`` is always on, as in the root script), and writes
``<image>_panel<r>.png``. crop walks `in_dir` (os.walk, files sorted per
folder), opens each file named .png, .jpg or .jpeg by its content, as PIL
does, downscales it by an integer factor with PIL's LANCZOS
(NEAREST for palette and 1-bit images), crops as ``Image.crop`` does (zeros
past the edge) and saves it flat into `out_dir` under its own name: PNG in
its own mode (palette and transparency kept; modes I and I;16B as 16-bit
grey, I clipped to 0..65535), JPEG as PIL's default save writes it. A mode
the format cannot hold (F, PA, LAB; I and I;16 as JPEG) stops the walk at
that file with PIL's OSError, after the files before it were written. No
device is touched.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .utils import image, jpeg_encode, png
from .utils.resize import resize_lanczos_like_pil


def split_grid(args):
    img = image.read_rgb_like_pil(args.image).astype(np.float32) / 255.0
    h_total, w = img.shape[:2]
    pad = args.padding
    h_each = (h_total - (args.rows + 1) * pad) // args.rows
    base = os.path.splitext(args.image)[0]
    for r in range(args.rows):
        top = pad + r * (h_each + pad)
        panel = img[top:top + h_each, pad:w - pad]
        if args.normalize and r > 0:
            panel = panel / max(panel.max(), 1e-8)
        out = f"{base}_panel{r}.png"
        save_like_pil(out, (np.clip(panel, 0, 1) * 255).astype(np.uint8),
                      "RGB")
        print("wrote", out)


def crop_like_pil(arr: np.ndarray, box) -> np.ndarray:
    """``np.asarray(im.crop(box))``: box (left, top, right, bottom), zeros
    where it reaches past the image."""
    left, top, right, bottom = (int(v) for v in box)
    if right < left:
        raise ValueError("Coordinate 'right' is less than 'left'")
    if bottom < top:
        raise ValueError("Coordinate 'lower' is less than 'upper'")
    h, w = arr.shape[:2]
    out = np.zeros((bottom - top, right - left) + arr.shape[2:], arr.dtype)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = arr[y0:y1, x0:x1]
    return out


# of the modes the readers return, those PIL's PNG and JPEG plugins save
# (PngImagePlugin._OUTMODES, JpegImagePlugin.RAWMODE)
_WRITES = {".png": {"1", "L", "LA", "P", "RGB", "RGBA", "I", "I;16", "I;16B"},
           ".jpg": {"1", "L", "RGB", "CMYK"}}
_WRITES[".jpeg"] = _WRITES[".jpg"]


def writable(path: str, mode: str) -> bool:
    """Whether ``im.save(path)`` writes an image of `mode` (else OSError)."""
    return mode in _WRITES.get(os.path.splitext(path)[1].lower(), ())


def save_like_pil(path: str, arr: np.ndarray, mode: str,
                  info: dict | None = None) -> None:
    """``im.save(path)`` by the path's extension: PNG or JPEG. A mode the
    format cannot hold raises PIL's OSError("cannot write mode M as PNG"),
    and leaves the path as Image.save does: removed where the save
    created it, empty where it was there before (PIL opens the file for
    writing before its plugin refuses the mode)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in _WRITES:
        raise NotImplementedError(f"{path}: only PNG and JPEG are written")
    existed = os.path.exists(path)
    try:
        if not writable(path, mode):
            raise OSError(f"cannot write mode {mode} as "
                          f"{'PNG' if ext == '.png' else 'JPEG'}")
        if ext == ".png":
            png.write_png_like_pil(path, arr, mode, info)
        else:
            jpeg_encode.write_jpeg(path, arr, mode, info)
    except Exception:
        if existed:
            open(path, "wb").close()
        elif os.path.exists(path):
            os.remove(path)
        raise


def crop(args):
    left, top, right, bottom = args.crop
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for root, _, files in os.walk(args.in_dir):
        for fn in sorted(files):
            if not fn.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            arr, mode, info = image.open_like_pil(os.path.join(root, fn))
            out = os.path.join(args.out_dir, fn)
            h, w = arr.shape[:2]
            if args.downscale > 1:
                w, h = w // args.downscale, h // args.downscale
                # PIL resizes every mode it reads; where the save below
                # refuses the mode, the resized values are never read
                arr = (resize_lanczos_like_pil(arr, mode, (w, h))
                       if writable(out, mode) else
                       np.zeros((h, w) + arr.shape[2:], arr.dtype))
            arr = crop_like_pil(arr, (left, top, w - right, h - bottom))
            save_like_pil(out, arr, mode, info)
            n += 1
    print(f"processed {n} images -> {args.out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.process_images")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("split-grid")
    g.add_argument("image")
    g.add_argument("--rows", type=int, default=2)
    g.add_argument("--padding", type=int, default=10)
    g.add_argument("--normalize", action="store_true", default=True)
    g.set_defaults(fn=split_grid)
    c = sub.add_parser("crop")
    c.add_argument("in_dir")
    c.add_argument("out_dir")
    c.add_argument("--downscale", type=int, default=1)
    c.add_argument("--crop", type=int, nargs=4, default=(0, 0, 0, 0),
                   metavar=("LEFT", "TOP", "RIGHT", "BOTTOM"))
    c.set_defaults(fn=crop)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
