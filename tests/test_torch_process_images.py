"""``python -m irgs_tpu_torch.process_images`` against the root
process_images.py: on a folder of images of several modes (and the
committed fixtures of tests/data/process_images/, made by
tests/make_png_fixtures.py), `crop` and `split-grid` write files that PIL
decodes to the same arrays, modes, palettes, transparency and ICC
profiles, and that equal the root script's byte for byte."""

import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import make_jpeg_fixtures as fx
import make_png_fixtures as mk
from irgs_tpu_torch import process_images as PI

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "process_images")


def _decoded(path):
    im = Image.open(path)
    return (np.asarray(im), im.mode,
            im.getpalette() if im.mode == "P" else None,
            im.info.get("transparency"), im.info.get("icc_profile"))


def _same(a, b):
    da, db = _decoded(a), _decoded(b)
    assert da[1:] == db[1:], (a, da[1:], db[1:])
    np.testing.assert_array_equal(da[0], db[0], err_msg=a)
    assert open(a, "rb").read() == open(b, "rb").read(), a


def _root(*args):
    subprocess.run([sys.executable, os.path.join(ROOT, "process_images.py"),
                    *args], check=True, capture_output=True)


def _inputs(folder):
    """A folder of images of several modes, one in a subfolder."""
    os.makedirs(os.path.join(folder, "deep"))
    Image.fromarray(fx.pattern(50, 41, seed=1)).save(
        os.path.join(folder, "rgb.jpg"), comment=b"note")
    Image.fromarray(fx.pattern(37, 29, seed=2)[..., 0]).save(
        os.path.join(folder, "grey.jpeg"))
    with open(os.path.join(folder, "prog.jpg"), "wb") as f:
        f.write(fx.encode(fx.pattern(35, 27, seed=3), quality=90,
                          progressive=True))
    Image.fromarray(fx.pattern(33, 26, seed=4)).convert("CMYK").save(
        os.path.join(folder, "cmyk.jpg"))
    Image.fromarray(fx.pattern(44, 30, seed=5)).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=3).save(
        os.path.join(folder, "pal.png"), transparency=1)
    Image.fromarray(fx.pattern(31, 23, seed=6), "RGB").convert("LA").save(
        os.path.join(folder, "deep", "la.png"), icc_profile=b"an ICC profile")
    with open(os.path.join(folder, "deep", "inter.png"), "wb") as f:
        f.write(mk.png_variants()["ct2_d16_adam7"])
    Image.fromarray(fx.pattern(12, 10, seed=7)).save(
        os.path.join(folder, "skip.bmp"))


@pytest.mark.parametrize("args", [
    ["--downscale", "3", "--crop", "1", "0", "1", "1"],
    ["--crop", "-3", "-2", "-1", "5"],
], ids=["down3", "pad_past_edges"])
def test_crop_equals_root_script(tmp_path, args):
    src = str(tmp_path / "in")
    _inputs(src)
    _root("crop", src, str(tmp_path / "root"), *args)
    PI.main(["crop", src, str(tmp_path / "port"), *args])
    names = sorted(os.listdir(tmp_path / "root"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 7 and "skip.bmp" not in names
    for n in names:
        _same(str(tmp_path / "root" / n), str(tmp_path / "port" / n))


def test_split_grid_equals_root_script(tmp_path):
    grid = np.zeros((4 * 6 + 3 * 14, 30, 3), np.uint8)
    for r in range(3):
        grid[6 + r * 20:20 + r * 20, 6:24] = fx.pattern(18, 14, seed=r) // (
            r + 1)
    for who in ("root", "port"):
        os.makedirs(tmp_path / who)
        Image.fromarray(grid).save(str(tmp_path / who / "g.png"))
    _root("split-grid", str(tmp_path / "root" / "g.png"), "--rows", "3",
          "--padding", "6")
    PI.main(["split-grid", str(tmp_path / "port" / "g.png"), "--rows", "3",
             "--padding", "6"])
    for r in range(3):
        _same(str(tmp_path / "root" / f"g_panel{r}.png"),
              str(tmp_path / "port" / f"g_panel{r}.png"))


def test_committed_fixtures(tmp_path):
    """What the smoke checks without PIL: the port's outputs on the
    committed inputs decode (here with PIL) as the root script's committed
    outputs do."""
    PI.main(["crop", os.path.join(DATA, "in"), str(tmp_path / "out"),
             *mk.CROP_ARGS])
    names = sorted(os.listdir(os.path.join(DATA, "out")))
    assert names == sorted(os.listdir(tmp_path / "out"))
    for n in names:
        _same(os.path.join(DATA, "out", n), str(tmp_path / "out" / n))
    shutil.copy(os.path.join(DATA, "in", "grid.png"), tmp_path / "grid.png")
    PI.main(["split-grid", str(tmp_path / "grid.png")])
    for r in range(2):
        _same(os.path.join(DATA, f"grid_panel{r}.png"),
              str(tmp_path / f"grid_panel{r}.png"))


@pytest.mark.parametrize("args", [["--crop", "1", "1", "1", "1"],
                                  ["--downscale", "2", "--crop", "1", "0",
                                   "0", "1"]], ids=["crop", "down2"])
def test_crop_keeps_trns_byte_for_byte(tmp_path, args):
    """Grey and RGB PNGs with a tRNS chunk: PIL keeps their transparency
    through the Lanczos downscale and the crop, and so does the port; the
    files are the root script's byte for byte."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(
        src / "rgb.png", transparency=(10, 20, 30))
    Image.fromarray(rng.integers(0, 255, (8, 8), dtype=np.uint8)).save(
        src / "grey.png", transparency=7)
    _root("crop", str(src), str(tmp_path / "root"), *args)
    PI.main(["crop", str(src), str(tmp_path / "port"), *args])
    for n, t in (("rgb.png", (10, 20, 30)), ("grey.png", 7)):
        assert Image.open(tmp_path / "root" / n).info["transparency"] == t
        assert (open(tmp_path / "port" / n, "rb").read()
                == open(tmp_path / "root" / n, "rb").read()), n


def test_crop_box_raises_as_pil():
    with pytest.raises(ValueError, match="right"):
        PI.crop_like_pil(np.zeros((4, 4), np.uint8), (3, 0, 1, 2))


def _odd_mode_files():
    """name -> bytes of a 40x30 file PIL opens in mode I, I;16B, F, PA or
    LAB: P5 and P2 at maxval 65535 (I), a PFM (F), TIFFs as PIL saves
    them."""
    rng = np.random.default_rng(18)
    v = rng.integers(0, 65536, (30, 40))
    v[0, :4] = (0, 65535, 1, 65534)
    files = {
        "p5_I": b"P5\n40 30\n65535\n" + v.astype(">u2").tobytes(),
        "p2_I": b"P2\n40 30\n65535\n" + " ".join(map(str, v.ravel())).encode(),
    }
    out = {}
    for name, im in (
            ("pfm_F", Image.fromarray(rng.random((30, 40)).astype(np.float32),
                                      "F")),
            ("tif_I", Image.fromarray(
                rng.integers(-3000, 70000, (30, 40)).astype(np.int32), "I")),
            ("tif_I16B", Image.frombytes("I;16B", (40, 30),
                                         v.astype(">u2").tobytes())),
            ("tif_F", Image.fromarray((rng.random((30, 40)) * 300).astype(
                np.float32), "F")),
            ("tif_PA", Image.frombytes("PA", (40, 30), rng.integers(
                0, 256, (30, 40, 2), dtype=np.uint8).tobytes())),
            ("tif_LAB", Image.frombytes("LAB", (40, 30), rng.integers(
                0, 256, (30, 40, 3), dtype=np.uint8).tobytes()))):
        buf = io.BytesIO()
        if name == "tif_PA":
            im.putpalette(list(range(256)) * 3)
        im.save(buf, "PPM" if name.startswith("pfm") else "TIFF")
        out[name] = buf.getvalue()
    files.update(out)
    return files


@pytest.mark.parametrize("name,ext", [
    ("p5_I", ".png"), ("p2_I", ".png"), ("tif_I", ".png"),
    ("tif_I16B", ".png"), ("p5_I", ".jpg"), ("tif_I16B", ".jpeg"),
    ("pfm_F", ".png"), ("tif_F", ".png"), ("tif_PA", ".png"),
    ("tif_LAB", ".png"), ("tif_LAB", ".jpg")])
def test_crop_modes_I_F_PA_LAB_as_root_script(tmp_path, name, ext):
    """`crop --downscale 4` over a folder whose middle file opens in mode
    I, I;16B, F, PA or LAB: the files the root script writes (16-bit grey
    PNGs, I clipped to 0..65535) are written byte for byte, and where PIL
    cannot save the mode, both stop at that file with the same OSError,
    after the file before it and with no file left for it."""
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(1)
    for n in ("a.png", "c.png"):
        Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)
                        ).save(src / n)
    (src / f"b{ext}").write_bytes(_odd_mode_files()[name])
    args = ["--downscale", "4", "--crop", "1", "0", "0", "1"]
    root = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "process_images.py"),
                           "crop", str(src), str(tmp_path / "root"), *args],
                          capture_output=True, text=True)
    err = None
    try:
        PI.main(["crop", str(src), str(tmp_path / "port"), *args])
    except OSError as e:
        err = e
    names = sorted(os.listdir(tmp_path / "root"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    if root.returncode:
        assert err is not None and f"OSError: {err}" in root.stderr, (
            err, root.stderr[-300:])
        assert names == ["a.png"]
    else:
        assert err is None and names == ["a.png", f"b{ext}", "c.png"]
    for n in names:
        _same(str(tmp_path / "root" / n), str(tmp_path / "port" / n))


@pytest.mark.parametrize("mode", ["I", "I_extremes", "I;16B", "PA", "LAB"])
@pytest.mark.parametrize("sizes", [(40, 30, 10, 7), (13, 9, 30, 20),
                                   (57, 31, 9, 31)])
def test_lanczos_modes_I_PA_LAB_as_pil(mode, sizes):
    """PIL's LANCZOS of modes I (double sums rounded to int32, INT_MIN past
    its range), I;16B (the samples' bytes read little-endian), PA and LAB
    (a and b signed)."""
    from irgs_tpu_torch.utils.resize import resize_lanczos_like_pil
    W, H, w, h = sizes
    rng = np.random.default_rng(W * h)
    if mode.startswith("I") and mode != "I;16B":
        arr = rng.integers(-3000, 70000, (H, W)).astype(np.int32)
        if mode == "I_extremes":
            arr = rng.integers(-2 ** 31, 2 ** 31, (H, W)).astype(np.int32)
            arr[:, ::3] = 2 ** 31 - 1
        im = Image.fromarray(arr, "I")
        mode = "I"
    else:
        arr = (rng.integers(0, 65536, (H, W)).astype(">u2") if mode == "I;16B"
               else rng.integers(0, 256, (H, W, len(mode)), dtype=np.uint8))
        im = Image.frombytes(mode, (W, H), arr.tobytes())
    ref = np.asarray(im.resize((w, h), Image.LANCZOS))
    got = resize_lanczos_like_pil(arr, mode, (w, h))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
