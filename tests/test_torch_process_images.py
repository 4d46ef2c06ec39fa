"""``python -m irgs_tpu_torch.process_images`` against the root
process_images.py: on a folder of images of several modes (and the
committed fixtures of tests/data/process_images/, made by
tests/make_png_fixtures.py), `crop` and `split-grid` write files that PIL
decodes to the same arrays, modes, palettes, transparency and ICC
profiles, and that equal the root script's byte for byte."""

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
