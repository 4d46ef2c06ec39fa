"""The port's WebP reader (irgs_tpu_torch/utils/webp.py) against PIL, bit for
bit: every committed fixture of tests/data/webp/ (array, mode and info, as
tests/make_webp_fixtures.py recorded them, and as PIL reads them now, with
``convert("RGB")``), every refused stream raising WebpError, the fixture
set against the generator, the three 1297x840 frames, lossy frames of
every width and height from 1 to 17, the JAX package's ``_load_image_any``
and COLMAP reader on a handful of the files (also under .png and .jpg
names), ``load_scene`` of the committed COLMAP capture, and
``process_images crop`` of a WebP named .png against the root script."""

import glob
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import fixture_checks as fc
import make_webp_fixtures as mk
from irgs_tpu.scene import colmap as jcolmap
from irgs_tpu.scene import datasets as jds
from irgs_tpu_torch import process_images as PI
from irgs_tpu_torch.scene import colmap as tcolmap
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.utils import image, webp
from test_torch_colmap import _assert_info_equal

FMT, EXT = "webp", ".webp"
NAMES = sorted(fc.modes(FMT))
LARGE = os.path.join(fc.DATA, FMT, "large")
CAPTURE = os.path.join(fc.DATA, FMT, "colmap")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fixture_set_is_complete():
    names = sorted(os.path.basename(p)[:-len(EXT)]
                   for p in glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    assert names == NAMES == sorted(n for n, _ in mk.variants())
    assert sorted(fc.refused(FMT)) == sorted(n for n, _, _ in mk.refused())
    with open(os.path.join(LARGE, "large.json")) as f:
        assert sorted(json.load(f)) == sorted(n for n, _ in
                                              mk.large_frames())
    assert sorted(os.listdir(os.path.join(CAPTURE, "images"))) == sorted(
        n for n, _ in mk.CAPTURE_SAVES)


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil(name):
    fc.check_fixture(FMT, EXT, name, webp.read_webp_like_pil)
    _, _, info = webp.read_webp_like_pil(os.path.join(fc.DATA, FMT,
                                                      name + EXT))
    assert mk.json_info(info) == fc.modes(FMT)[name]["info"]


@pytest.mark.parametrize("name", NAMES)
def test_fixture_equals_pil_now(name):
    fc.check_fixture_against_pil(FMT, EXT, name)
    path = os.path.join(fc.DATA, FMT, name + EXT)
    with Image.open(path) as im:
        im.load()                       # the frame's timestamp and duration
        assert webp.read_webp_like_pil(path)[2] == im.info


@pytest.mark.parametrize("name", sorted(fc.refused(FMT)))
def test_refused_stream_raises(name):
    path = os.path.join(fc.DATA, FMT, "refused", name + EXT)
    with pytest.raises(webp.WebpError):
        webp.read_webp_like_pil(path)
    with pytest.raises(Exception):
        with Image.open(path) as im:
            np.asarray(im)


def test_unknown_riff_webp_is_unidentified(tmp_path):
    path = str(tmp_path / "x.webp")
    with open(path, "wb") as f:
        f.write(mk.riff(mk.chunk(b"ABCD", bytes(16))))
    with pytest.raises(image.UnreadableImageError):
        image.read_image_like_pil(path)
    with pytest.raises(Exception):
        Image.open(path)


@pytest.mark.parametrize("name", ["large_lossless", "large_lossy_q90",
                                  "large_lossy_alpha_q90"])
def test_large_frame_equals_pil(name):
    path = os.path.join(LARGE, name + EXT)
    with open(os.path.join(LARGE, "large.json")) as f:
        want = json.load(f)[name]
    arr, mode, _ = image.read_image_like_pil(path)
    assert (mode, list(arr.shape)) == (want["mode"], want["shape"])
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))
    assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]


@pytest.mark.parametrize("width", range(1, 18))
def test_every_small_size_equals_pil(width):
    """Lossy frames (with alpha and without) of this width and every height
    1-17: the fancy upsampler's first and last rows and odd sizes."""
    for height in range(1, 18):
        rgba = mk.photo(height, width, seed=width * 17 + height, alpha=True)
        for data in (mk.pil_webp(rgba, "RGBA", quality=70),
                     mk.pil_webp(rgba[..., :3], quality=95, method=1)):
            arr, mode, _ = webp.decode_webp(data)
            with Image.open(io.BytesIO(data)) as im:
                assert mode == im.mode
                np.testing.assert_array_equal(arr, np.asarray(im))


def _mutations(kind: str, rng):
    """Streams made from the fixtures by `kind` of damage: random bytes of
    the file, the first bytes of a VP8 frame's partitions, bytes of a VP8L
    or ALPH payload, or an image chunk cut short with its sizes kept
    consistent."""
    files = sorted(glob.glob(os.path.join(fc.DATA, FMT, "*" + EXT)))
    while True:
        data = open(files[rng.integers(len(files))], "rb").read()
        chunks = mk.chunks_of(data)
        tags = [t for t, _ in chunks]
        if kind == "bytes":
            out = bytearray(data)
            for _ in range(rng.integers(1, 4)):
                out[rng.integers(12, len(out))] ^= 1 << rng.integers(8)
            yield bytes(out)
            continue
        tag = {"vp8_partitions": b"VP8 ", "vp8l_payload": b"VP8L",
               "alph_payload": b"ALPH", "cut": tags[0]}[kind]
        if tag not in tags or b"ANMF" in tags:
            continue
        i = tags.index(tag)
        payload = bytearray(chunks[i][1])
        if kind == "cut":
            payload = payload[:len(payload) - rng.integers(1, 40)]
        elif kind == "vp8_partitions":
            p0 = (payload[0] | (payload[1] << 8) | (payload[2] << 16)) >> 5
            j = (10, 10 + p0)[rng.integers(2)] + rng.integers(3)
            if j < len(payload):
                payload[j] = rng.integers(256)
        else:
            for _ in range(rng.integers(1, 4)):
                payload[rng.integers(len(payload))] = rng.integers(256)
        chunks[i] = (tag, bytes(payload))
        yield mk.riff(*[mk.chunk(t, q) for t, q in chunks])


@pytest.mark.parametrize("kind", ["bytes", "vp8_partitions", "vp8l_payload",
                                  "alph_payload", "cut"])
def test_damaged_streams_as_pil(kind):
    """150 damaged streams per kind: each refused where PIL refuses it, else
    decoded to PIL's array and mode (libwebp's end-of-data rules, its
    64-bit boolean decoder and 16-bit transform on corrupt data)."""
    rng = np.random.default_rng(["bytes", "vp8_partitions", "vp8l_payload",
                                 "alph_payload", "cut"].index(kind))
    gen = _mutations(kind, rng)
    decoded = 0
    for _ in range(150):
        data = next(gen)
        try:
            with Image.open(io.BytesIO(data)) as im:
                want, want_mode = np.asarray(im), im.mode
        except Exception:
            with pytest.raises(webp.WebpError):
                webp.decode_webp(data)
            continue
        arr, mode, _ = webp.decode_webp(data)
        assert mode == want_mode
        np.testing.assert_array_equal(arr, want)
        decoded += 1
    assert 0 < decoded < 150


READ_CASES = ["lossless_rgba", "lossy_q90_m6", "lossy_rgba_q80",
              "alph_m1_f3", "animated_offset_first_frame",
              "lossless_from_L"]


@pytest.mark.parametrize("ext", [EXT, ".png", ".jpg"])
@pytest.mark.parametrize("name", READ_CASES)
def test_readers_match_jax(tmp_path, name, ext):
    """_load_image_any (Blender-style frames) and the COLMAP reader's
    convert("RGB") of the JAX package against the port's, also for WebP
    content under another extension."""
    path = str(tmp_path / ("frame" + ext))
    shutil.copy(os.path.join(fc.DATA, FMT, name + EXT), path)
    want = jds._load_image_any(path)
    got = tds._load_image_any(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    want_rgb = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(tcolmap._read_rgb(path), want_rgb)


def test_load_scene_capture_matches_jax():
    j = jds.load_scene(CAPTURE, eval_split=False)
    t = tds.load_scene(CAPTURE, eval_split=False)
    assert len(t.train_cameras) == 4 and len(t.points) == 4096
    assert t.train_cameras[0].image.shape == (400, 400, 3)
    _assert_info_equal(j, t)
    jc = jcolmap.read_colmap_scene(CAPTURE)
    tc = tcolmap.read_colmap_scene(CAPTURE)
    _assert_info_equal(jc, tc)


def test_process_images_crop_webp_named_png(tmp_path):
    """A WebP with alpha and one with an ICC profile, named .png: the root
    script (PIL opens by content, saves PNG) and the port write the same
    bytes."""
    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(os.path.join(fc.DATA, FMT, "lossy_rgba_q80.webp"),
                src / "rgba.png")
    shutil.copy(os.path.join(fc.DATA, FMT, "vp8x_metadata.webp"),
                src / "meta.png")
    args = ["--downscale", "2", "--crop", "1", "2", "0", "1"]
    subprocess.run([sys.executable, os.path.join(ROOT, "process_images.py"),
                    "crop", str(src), str(tmp_path / "root"), *args],
                   check=True, capture_output=True)
    PI.main(["crop", str(src), str(tmp_path / "port"), *args])
    for name in ("rgba.png", "meta.png"):
        root_bytes = (tmp_path / "root" / name).read_bytes()
        assert root_bytes[:8] == b"\x89PNG\r\n\x1a\n"
        assert (tmp_path / "port" / name).read_bytes() == root_bytes
