"""The port's analytic dataset tool (irgs_tpu_torch/tools/make_dataset.py)
against the JAX tool (tools/make_dataset.py, loaded by path) on tiny
inputs: the analytic intersection, occlusion and materials, the envmaps,
the spiral cameras and their transforms, the radiosity textures and one 16²
frame at a few samples with JAX's light draws fed in; and a folder the port
writes loads the same through both packages' load_scene."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.scene import datasets as jds
from irgs_tpu.scene import envlight as jenv
from irgs_tpu_torch.scene import datasets as tds
from irgs_tpu_torch.scene import envlight as tenv
from irgs_tpu_torch.tools import make_dataset as tmd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmd():
    spec = importlib.util.spec_from_file_location(
        "_jax_make_dataset", os.path.join(ROOT, "tools", "make_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rays(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.normal(size=(n, 3)) * [1.5, 0.6, 1.5] + [0.0, 1.2, 0.0]
    tgt = rng.normal(size=(n, 3)) * 0.8
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def test_intersect_occluded_materials_match_jax(jmd):
    ro, rd = _rays()
    jt, jo, jp, jn = jmd.intersect(jnp.asarray(ro), jnp.asarray(rd))
    tt, to, tp, tn = tmd.intersect(torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert 0.2 < (to.numpy() == 1).mean() and (to.numpy() == 2).mean() > 0.2
    hit = np.asarray(jo) > 0
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-5, atol=1e-5)
    assert np.isinf(tt.numpy()[~hit]).all()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_array_equal(
        tmd.occluded(torch.from_numpy(ro), torch.from_numpy(rd)).numpy(),
        np.asarray(jmd.occluded(jnp.asarray(ro), jnp.asarray(rd))))
    jb, jr = jmd.materials(jp, jo)
    tb, tr = tmd.materials(torch.tensor(np.asarray(jp)),
                           torch.tensor(np.asarray(jo)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)


def test_envs_match_jax(jmd):
    j, t = jmd.make_envs(16), tmd.make_envs(16)
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])


@pytest.mark.parametrize("split", ["train", "test"])
def test_spiral_cameras_and_transforms_match_jax(jmd, split, tmp_path):
    kw = (dict(seed=0) if split == "train"
          else dict(seed=1, elev=(12.0, 50.0), name_offset=1000))
    jc, jw = jmd.spiral_cameras(5, 24, 16, 0.8, **kw)
    tc, tw = tmd.spiral_cameras(5, 24, 16, 0.8, **kw)
    for a, b in zip(jw, tw):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jc, tc):
        assert (a.image_name, a.width, a.height) == (b.image_name, b.width,
                                                     b.height)
        jp, tp = a.params(), b.params("cpu")
        for name in jp._fields:
            np.testing.assert_allclose(np.asarray(getattr(tp, name)),
                                       np.asarray(getattr(jp, name)),
                                       atol=1e-6, err_msg=name)
    off = kw.get("name_offset", 0)
    jmd.write_transforms(str(tmp_path / "j.json"), 0.8, jw, split, off)
    tmd.write_transforms(str(tmp_path / "t.json"), 0.8, tw, split, off)
    assert json.load(open(tmp_path / "j.json")) == \
        json.load(open(tmp_path / "t.json"))


def _jax_draws_fn(env_pdf_j):
    """draws_fn giving the port JAX's draws: the texel indices that
    irgs_tpu's sample_light_dirs draws with key PRNGKey(0) per pixel id."""
    logits = jnp.log(jnp.maximum(env_pdf_j.reshape(-1), 1e-30))
    key = jax.random.PRNGKey(0)

    def draws_fn(env_pdf, pixel_ids, n):
        pids = jnp.asarray(pixel_ids.numpy(), jnp.int32)
        keys = jax.vmap(lambda p: jax.random.fold_in(key, p))(pids)
        idx = jax.vmap(lambda k: jax.random.categorical(
            k, logits, shape=(n,)))(keys)
        return tenv.LightDraws(torch.tensor(np.asarray(idx),
                                            dtype=torch.int64), None)
    return draws_fn


# texel centres off the sphere's stripe edges (sin 8φ = 0 at an 8-wide
# grid's centres, where the albedo flips on the last bit)
GRID = (8, (5, 10))
RAD_SPP = (16, 8)


@pytest.fixture(scope="module")
def radiosity(jmd):
    env = jmd.make_envs(8)["gt_env"]
    jmd.GRID_G, jmd.GRID_S = GRID
    j_lin = jnp.asarray(env)
    j_pdf = jenv.build_pdf(j_lin, activation="none")
    jg, js = jmd.build_radiosity(j_lin, j_pdf, RAD_SPP)
    t_lin = torch.from_numpy(env)
    t_pdf = tenv.build_pdf(t_lin, activation="none")
    tg, ts = tmd.build_radiosity(t_lin, t_pdf, RAD_SPP, GRID[0], GRID[1],
                                 draws_fn=_jax_draws_fn(j_pdf))
    return dict(env=env, j_lin=j_lin, j_pdf=j_pdf, t_lin=t_lin, t_pdf=t_pdf,
                jg=np.asarray(jg), js=np.asarray(js), tg=tg, ts=ts)


@pytest.mark.parametrize("which", ["ground", "sphere"])
def test_radiosity_matches_jax(radiosity, which):
    j = radiosity["jg" if which == "ground" else "js"]
    t = radiosity["tg" if which == "ground" else "ts"].numpy()
    assert t.shape == j.shape and np.isfinite(t).all() and t.max() > 0
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


def test_radiosity_lookup_matches_jax(jmd, radiosity):
    ro, rd = _rays(seed=3)
    _, jo, jp, _ = jmd.intersect(jnp.asarray(ro), jnp.asarray(rd))
    jl = jmd.radiosity_lookup(jp, jo, jnp.asarray(radiosity["jg"]),
                              jnp.asarray(radiosity["js"]))
    tl = tmd.radiosity_lookup(torch.tensor(np.asarray(jp)),
                              torch.tensor(np.asarray(jo)),
                              torch.from_numpy(radiosity["jg"]),
                              torch.from_numpy(radiosity["js"]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("ss", [1, 2])
def test_frame_matches_jax(jmd, radiosity, ss):
    """One 16² frame at 16 + 8 samples from the same radiosity textures and
    JAX's light draws: colour, alpha, albedo and roughness."""
    jmd.GRID_G, jmd.GRID_S = GRID
    W = H = 16
    jc, _ = jmd.spiral_cameras(1, W, H, 0.8, seed=1, elev=(20.0, 30.0))
    tc, _ = tmd.spiral_cameras(1, W, H, 0.8, seed=1, elev=(20.0, 30.0))
    rg, rs = radiosity["jg"], radiosity["js"]
    jr = jmd.make_frame_renderer(radiosity["j_lin"], radiosity["j_pdf"],
                                 jnp.asarray(rg), jnp.asarray(rs), W, H,
                                 (16, 8), 64)
    tr = tmd.make_frame_renderer(radiosity["t_lin"], radiosity["t_pdf"],
                                 torch.from_numpy(rg), torch.from_numpy(rs),
                                 W, H, (16, 8), 64,
                                 draws_fn=_jax_draws_fn(radiosity["j_pdf"]))
    jout = jr(jc[0].params(), ss=ss)
    tout = tr(tc[0].params("cpu"), ss=ss)
    names = ("rgb", "alpha", "albedo", "roughness")
    for name, a, b in zip(names, jout, tout):
        assert b.shape == a.shape, name
        if name != "rgb":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    # a secondary ray's nearest radiosity texel and its silhouette hits flip
    # on the last bit of the hit point: the few pixels where one of a
    # pixel's 24 samples took the other texel differ by that one sample
    err = np.abs(tout[0] - jout[0]).max(-1)
    assert (err > 1e-4).mean() <= 0.05, (err > 1e-4).mean()
    assert err.max() < 0.05, err.max()
    assert 0.1 < jout[1].mean() < 1.0
    close = err <= 1e-4
    np.testing.assert_array_equal(tmd.srgb_rgba(tout[0], tout[1])[close],
                                  tmd.srgb_rgba(jout[0], jout[1])[close])


def test_written_folder_loads_the_same(tmp_path):
    out = tmp_path / "ds"
    tmd.main(["--out", str(out), "--img", "16", "--n_train", "3",
              "--n_test", "2", "--spp", "8", "8", "--ss", "1", "--env_res",
              "8", "--grid", "8", "4", "--rad_spp", "8", "8", "--points",
              "50", "--device", "cpu"])
    for sub in ("train", "test", "albedo", "roughness", "sunset", "sun"):
        assert os.listdir(out / sub)
    meta = json.load(open(out / "dataset_meta.json"))
    assert meta["n_train"] == 3 and meta["relight_envs"] == ["sunset", "sun"]
    for white in (False, True):
        j = jds.load_scene(str(out), white, eval_split=True)
        t = tds.load_scene(str(out), white, eval_split=True)
        assert len(t.train_cameras) == 3 and len(t.test_cameras) == 2
        for jc, tc in zip(j.train_cameras + j.test_cameras,
                          t.train_cameras + t.test_cameras):
            np.testing.assert_array_equal(tc.image, jc.image)
            np.testing.assert_array_equal(tc.mask, jc.mask)
            np.testing.assert_array_equal(tc.full_proj, jc.full_proj)
        np.testing.assert_array_equal(t.points, j.points)
        np.testing.assert_array_equal(t.colors, j.colors)
        assert t.points.shape == (50, 3)
    from irgs_tpu.utils import exr as jexr
    np.testing.assert_array_equal(jexr.read_exr_rgb(str(out / "sun.exr")),
                                  tmd.make_envs(8)["sun"])
