"""The port's file I/O against the JAX package's (and against PIL where the
JAX package reads and writes images through PIL): PLY, EXR and PNG codecs,
and the Gaussian PLY with its three envmap sidecars, both ways."""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from irgs_tpu.scene import gaussians as jgs
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.utils import exr as jexr
from irgs_tpu.utils import ply as jply
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.utils import exr as texr
from irgs_tpu_torch.utils import ply as tply
from irgs_tpu_torch.utils import png


def _vertex(rng, n=37):
    dt = np.dtype([("x", "f4"), ("y", "f4"), ("red", "u1"), ("id", "i4"),
                   ("w", "f8")])
    v = np.zeros(n, dt)
    v["x"], v["y"] = rng.standard_normal((2, n))
    v["red"] = rng.integers(0, 256, n)
    v["id"] = rng.integers(-2 ** 31, 2 ** 31 - 1, n)
    v["w"] = rng.standard_normal(n)
    return v


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ply_roundtrip_both_ways(tmp_path, writer):
    rng = np.random.default_rng(0)
    v = _vertex(rng)
    faces = rng.integers(0, len(v), (11, 3))
    path = str(tmp_path / "a.ply")
    write, read = ((jply.write_ply, tply.read_ply) if writer == "jax"
                   else (tply.write_ply, jply.read_ply))
    write(path, v, faces=faces, comments=("test",))
    got = read(path)
    assert got["vertex"].data.tobytes() == v.tobytes()
    assert got["vertex"].data.dtype.names == v.dtype.names
    np.testing.assert_array_equal(got["face"].lists["vertex_indices"], faces)
    fields = {"a": rng.standard_normal(5), "b": rng.standard_normal((5, 1))}
    assert (tply.structured_from_dict(fields).tobytes()
            == jply.structured_from_dict(fields).tobytes())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exr_roundtrip_both_ways(tmp_path, writer):
    rng = np.random.default_rng(1)
    rgb = np.exp(3 * rng.standard_normal((19, 23, 3))).astype(np.float32)
    rgb[0, 0] = [0.0, -1.5, 1e30]
    path = str(tmp_path / "a.exr")
    write, read = ((jexr.write_exr, texr.read_exr_rgb) if writer == "jax"
                   else (texr.write_exr, jexr.read_exr_rgb))
    write(path, rgb)
    got = read(path)
    assert got.dtype == np.float32
    assert got.tobytes() == rgb.tobytes()
    assert texr.read_exr(path)["channels"]["G"].tobytes() == \
        jexr.read_exr(path)["channels"]["G"].tobytes()


def _raw_png(path, samples, color_type, bits=16, interlace=0):
    """A PNG of `samples` ([H, W, C] uint) with filter 0 on every row,
    written here (PIL writes no 16-bit colour PNGs)."""
    h, w = samples.shape[:2]
    dt = ">u2" if bits == 16 else "u1"
    raw = b"".join(b"\x00" + samples[r].astype(dt).tobytes() for r in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits,
                                             color_type, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_png_decode_matches_pil_on_pil_files(tmp_path, mode):
    """Files PIL writes (its adaptive filters use all five row filters
    across these images): the port's decode is PIL's, bit for bit."""
    rng = np.random.default_rng(2)
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    hi = 65536 if mode == "I;16" else 256
    smooth = np.cumsum(rng.integers(0, 3, (29, 31, c)), axis=1)
    arr = ((smooth * 7 + rng.integers(0, 5, (29, 31, c))) % hi).astype(
        np.uint16 if mode == "I;16" else np.uint8)
    arr = arr[..., 0] if c == 1 else arr
    path = str(tmp_path / "a.png")
    Image.fromarray(arr).save(path)
    want = np.asarray(Image.open(path))
    assert Image.open(path).mode == mode
    got = png.read_png_like_pil(path)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read_png(path), arr)


@pytest.mark.parametrize("color_type,c", [(0, 1), (4, 2), (2, 3), (6, 4)])
def test_png_16bit_decode_matches_pil(tmp_path, color_type, c):
    """16-bit files of every colour type: read_png gives the samples as
    stored, read_png_like_pil what PIL makes of them (high bytes, grey + alpha
    widened to RGBA, grey kept at 16 bits)."""
    rng = np.random.default_rng(3)
    samples = rng.integers(0, 65536, (9, 13, c)).astype(np.uint16)
    path = str(tmp_path / "a.png")
    _raw_png(path, samples, color_type)
    stored = png.read_png(path)
    np.testing.assert_array_equal(stored, samples[..., 0] if c == 1 else samples)
    want = np.asarray(Image.open(path))
    got = png.read_png_like_pil(path)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_encoder_filters_decode_in_pil(tmp_path, filter_type, c):
    rng = np.random.default_rng(4 + c)
    img = rng.integers(0, 256, (17, 21, c)).astype(np.uint8)
    img[4:9] = 250          # runs and wrap-around at the top of the range
    img = img[..., 0] if c == 1 else img
    path = str(tmp_path / "a.png")
    png.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    """Palette files are now read as PIL reads them (the indices, mode P and
    the palette); a file whose data does not fit its interlaced header, an
    image type PNG does not define and a corrupt chunk raise, in PIL too."""
    pal = str(tmp_path / "p.png")
    Image.fromarray(np.arange(16, dtype=np.uint8).reshape(4, 4) * 9,
                    "L").convert("P").save(pal)
    arr, mode, info = png.read_png_like_pil(pal)
    assert mode == Image.open(pal).mode == "P"
    np.testing.assert_array_equal(arr, np.asarray(Image.open(pal)))
    np.testing.assert_array_equal(
        info["palette"].reshape(-1),
        np.asarray(Image.open(pal).getpalette()))
    inter = str(tmp_path / "i.png")
    _raw_png(inter, np.zeros((4, 4, 3), np.uint8), 2, bits=8, interlace=1)
    with pytest.raises(png.PngError, match="interlaced"):
        png.read_png(inter)
    with pytest.raises(OSError):
        np.asarray(Image.open(inter))
    odd = str(tmp_path / "o.png")
    _raw_png(odd, np.zeros((4, 2, 3), np.uint8), 2, bits=4)
    with pytest.raises(png.PngError, match="not a PNG image type"):
        png.read_png(odd)
    with pytest.raises(OSError):
        Image.open(odd)
    bad = str(tmp_path / "b.png")
    _raw_png(bad, np.zeros((4, 4, 3), np.uint8), 2, bits=8)
    data = bytearray(open(bad, "rb").read())
    data[40] ^= 0xFF                      # inside IDAT: the CRC fails
    open(bad, "wb").write(bytes(data))
    with pytest.raises(png.PngError, match="corrupt"):
        png.read_png(bad)


# ---------------------------------------------------------------------------
# Gaussian PLY + envmap sidecars
# ---------------------------------------------------------------------------

SIDECARS = {"npy": "_env.npy", "map": "1.map", "exr": "1.exr"}


def _keep_only(path, sidecar):
    for k, suffix in SIDECARS.items():
        if k != sidecar:
            os.remove(path.replace(".ply", suffix))


def _jax_fields(params):
    return {f: np.asarray(getattr(params, f)) for f in tgs.PARAM_FIELDS}


def _torch_fields(params):
    return {f: getattr(params, f).detach().numpy() for f in tgs.PARAM_FIELDS}


def _assert_fields_equal(got, want, env_rtol=0.0):
    for f in tgs.PARAM_FIELDS:
        if f == "env" and env_rtol:
            # exp and log of the .exr sidecar round differently in XLA and
            # torch: a few ulps apart
            np.testing.assert_allclose(got[f], want[f], rtol=env_rtol,
                                       atol=1e-6, err_msg=f)
        else:
            assert got[f].dtype == want[f].dtype, f
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.fixture(scope="module")
def jax_scene():
    params, aux = jtoy.make_sphere_scene(n_surface=200, n_capacity=256,
                                         env_resolution=16)
    rng = np.random.default_rng(5)
    # distinct values in every field (the toy scene repeats them)
    import dataclasses
    params = dataclasses.replace(
        params, **{f: jnp.asarray(np.asarray(getattr(params, f))
                                  + 0.1 * rng.standard_normal(
                                      getattr(params, f).shape).astype(np.float32))
                   for f in ("base_color", "metallic", "features_rest", "env")})
    return params, aux


@pytest.mark.parametrize("sidecar", ["npy", "map", "exr"])
def test_gaussian_ply_from_jax_loads_in_port(tmp_path, jax_scene, sidecar):
    params, aux = jax_scene
    path = str(tmp_path / "point_cloud.ply")
    jgs.save_ply(path, params, aux, env_activation="exp")
    _keep_only(path, sidecar)
    jp, ja = jgs.load_ply(path, 300, 3, env_activation="exp")
    tp, ta = tgs.load_ply(path, 300, 3, env_activation="exp", device="cpu")
    _assert_fields_equal(_torch_fields(tp), _jax_fields(jp),
                         env_rtol=1e-6 if sidecar == "exr" else 0.0)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))
    assert ta.active_sh_degree == int(ja.active_sh_degree) == 3
    assert int(ta.alive.sum()) == 200


@pytest.mark.parametrize("sidecar", ["npy", "map", "exr"])
def test_gaussian_ply_from_port_loads_in_jax(tmp_path, jax_scene, sidecar):
    jparams, jaux = jax_scene
    tp, ta = tgs.params_from_numpy(_jax_fields(jparams), np.asarray(jaux.alive),
                                   "cpu")
    path = str(tmp_path / "point_cloud.ply")
    tgs.save_ply(path, tp, ta, env_activation="exp")
    _keep_only(path, sidecar)
    jp, ja = jgs.load_ply(path, 256, 3, env_activation="exp")
    lp, la = tgs.load_ply(path, 256, 3, env_activation="exp", device="cpu")
    want = _torch_fields(lp)
    _assert_fields_equal(_jax_fields(jp), want,
                         env_rtol=1e-6 if sidecar == "exr" else 0.0)
    np.testing.assert_array_equal(np.asarray(ja.alive), la.alive.numpy())
    # what was saved comes back: the alive rows, and the raw env
    saved = _torch_fields(tp)
    alive = ta.alive.numpy()
    for f in tgs.PARAM_FIELDS:
        if f != "env":
            np.testing.assert_array_equal(want[f][alive], saved[f][alive], f)
    if sidecar != "exr":
        np.testing.assert_array_equal(want["env"], saved["env"])
    # the .map sidecar is the reference's torch format, loadable without
    # unpickling code
    if sidecar == "map":
        blob = torch.load(path.replace(".ply", "1.map"), weights_only=True)
        assert blob["activation"] == "exp"
        np.testing.assert_array_equal(blob["state_dict"]["base"].numpy(),
                                      want["env"])


def test_gaussian_ply_sidecar_activation_checks(tmp_path, jax_scene):
    params, aux = jax_scene
    path = str(tmp_path / "point_cloud.ply")
    jgs.save_ply(path, params, aux, env_activation="exp")
    _keep_only(path, "map")
    with pytest.raises(ValueError, match="activation"):
        tgs.load_ply(path, 256, 3, env_activation="softplus", device="cpu")
    os.remove(path.replace(".ply", "1.map"))
    tp, _ = tgs.load_ply(path, 256, 3, device="cpu")
    assert tp.env.shape == (64, 128, 3) and not bool(tp.env.any())
    with pytest.raises(ValueError, match="capacity"):
        tgs.load_ply(path, 100, 3, device="cpu")


def test_vis_pngs_match_jax(tmp_path):
    """The training visualisations: the AOV grid is the JAX package's
    (imageio-written) image bit for bit; the envmap snapshot goes through
    each package's sRGB curve, whose pow rounds apart by an ulp, so a
    byte may land one level off."""
    from irgs_tpu.utils import vis as jvis
    from irgs_tpu_torch.utils import vis as tvis
    rng = np.random.default_rng(6)
    panels = {"render": rng.uniform(-0.1, 1.1, (12, 10, 3)),
              "rend_alpha": rng.uniform(size=(12, 10, 1)),
              "surf_depth": rng.uniform(2, 5, (12, 10, 1)),
              "rend_normal": rng.standard_normal((12, 10, 3)),
              "odd_size": rng.uniform(size=(4, 4, 3))}
    panels = {k: v.astype(np.float32) for k, v in panels.items()}
    jvis.save_aov_grid(str(tmp_path / "j" / "grid.png"), panels)
    tvis.save_aov_grid(str(tmp_path / "t" / "grid.png"),
                       {k: torch.tensor(v) for k, v in panels.items()})
    want = np.asarray(Image.open(tmp_path / "j" / "grid.png"))
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "t" / "grid.png")),
                                  want)
    env = np.exp(rng.standard_normal((8, 16, 3))).astype(np.float32)
    jvis.save_envmap_png(str(tmp_path / "j" / "env.png"), env)
    tvis.save_envmap_png(str(tmp_path / "t" / "env.png"), torch.tensor(env))
    a = png.read_png(str(tmp_path / "t" / "env.png")).astype(int)
    b = np.asarray(Image.open(tmp_path / "j" / "env.png")).astype(int)
    assert a.shape == b.shape == (8, 16, 3) and np.abs(a - b).max() <= 1
