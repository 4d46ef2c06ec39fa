"""The port's NVS eval frame (irgs_tpu_torch.render.eval.render_ir_eval) and
image metrics against the JAX package's, on the same scene: the toy sphere
(512 surfels), 32x32, 16 diffuse and 0 light samples, and a small eval
tracer with the eval switches on (`adaptive`, `select_topk`,
`pallas_gather`, the JAX package's Pallas gather run in interpret mode).

Tolerance of the frame: rtol 2e-4 / atol 2e-5 per element, as the JAX
package's own compact-vs-full eval test, except for a share of outliers.
The two packages draw the sample directions through different matrix
products (XLA's einsum, torch.bmm), which round a few directions an ulp
apart; the tracer's discrete tests (alpha_min, the transmittance cut, the
hit-cell dedup) can then take or drop a hit on such a ray. On identical
rays the traces agree to 5e-5 (tests/test_torch_tracer.py). A flipped hit
moves one of a pixel's S samples, so an outlier is bounded by 1/S, and at
most 1% of the elements of an AOV may be outliers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irgs_tpu.ops.gather_pallas as gp
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.render import eval as jev
from irgs_tpu.scene import toy
from irgs_tpu_torch.eval import metrics as tm
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.render import eval as tev
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy
from test_torch_mis import one_torch_thread  # noqa: F401

IMG, SPP = 32, 16
TRACER = dict(grid_res=16, pair_capacity=2 ** 15, max_cells=8, max_hits=24,
              select_tiles=4, retrace_select_tiles=8, tile=32,
              tiled_direct=True, hit_budget=8, retrace_hit_budget=12,
              max_crossings=12, retrace_max_crossings=16,
              retrace_max_cells=12, retrace_max_hits=48, n_segments=4,
              retrace_frac=0.5, retrace_decay=0.5, adaptive=True,
              select_topk=True, pallas_gather=8)
RTOL, ATOL = 2e-4, 2e-5
MAX_OUTLIER_SHARE = 0.01
AOVS = ("render", "render_env", "render_sh", "diffuse", "specular",
        "env_only", "base_color", "base_color_linear", "roughness",
        "rend_alpha", "rend_normal", "surf_normal", "surf_depth", "rend_dist",
        "visibility", "light", "light_indirect", "light_direct")


def _ecfg(mod, tcfg):
    # 2^14 point samples per chunk: 1024 pixels, so the full frame and the
    # compact one are one chunk each (the compact one padded), as at the
    # default chunk, with a quarter of the padding rays to trace
    return mod.EvalConfig(img_w=IMG, img_h=IMG, active_sh_degree=3,
                          diffuse_sample_num=SPP, light_sample_num=0,
                          dup_capacity=2 ** 14, chunk_point_samples=2 ** 14,
                          tracer=tcfg)


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames, compact and full: {(pkg, compact): AOVs}."""
    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    tp, ta = tgs.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS},
        np.asarray(ja.alive), "cpu")
    jcam = toy.make_ring_cameras(1, width=IMG, height_px=IMG)[0].params()
    tcam = ttoy.make_ring_cameras(1, width=IMG, height_px=IMG)[0].params("cpu")
    jcfg = _ecfg(jev, gt.TracerConfig(**TRACER))
    tcfg = _ecfg(tev, tgt.TracerConfig(**TRACER))
    jgrid = gt.build_grid_from_gaussians(jp, ja, jcfg.tracer)
    tgrid = tgt.build_grid_from_gaussians(tp, ta, tcfg.tracer)
    orig = gp.gather_rows
    gp.gather_rows = lambda t, i, **kw: orig(t, i, interpret=True)
    try:
        out, stats = {}, {}
        for compact in (True, False):
            jo = jev.render_ir_eval(jp, ja, jgrid, jcam, jcfg,
                                    compact_fg=compact)
            out["jax", compact] = {k: np.asarray(v) for k, v in jo.items()}
            stats[compact] = {}
            to = tev.render_ir_eval(tp, ta, tgrid, tcam, tcfg,
                                    compact_fg=compact,
                                    stats_out=stats[compact])
            out["torch", compact] = {k: v.numpy() for k, v in to.items()}
    finally:
        gp.gather_rows = orig
    return out, stats


def _outliers(a, b):
    d = np.abs(a - b)
    bad = d > ATOL + RTOL * np.abs(b)
    return float(bad.mean()), float(d.max())


@pytest.mark.parametrize("compact", [True, False])
def test_eval_frame_matches_jax(frames, compact):
    out, stats = frames
    j, t = out["jax", compact], out["torch", compact]
    assert set(t) == set(j) == set(AOVS)
    assert float(j["rend_alpha"].max()) > 0.5 and j["rend_alpha"].min() == 0.0
    assert float(j["visibility"].max()) < 1.0   # the rays hit the sphere
    for k in AOVS:
        assert t[k].shape == j[k].shape and np.isfinite(t[k]).all(), k
        share, worst = _outliers(t[k], j[k])
        assert share <= MAX_OUTLIER_SHARE, (k, share)
        assert worst <= 1.0 / SPP, (k, worst)
    st = stats[compact]
    assert st["raster_overflow"] == 0
    assert st["shaded_pixels"] == (int((j["rend_alpha"] > 0).sum()) if compact
                                   else IMG * IMG)
    pc = _ecfg(tev, tgt.TracerConfig()).pixel_chunk
    assert st["traced_rays"] == -(-st["shaded_pixels"] // pc) * pc * SPP


@pytest.mark.parametrize("aov", ["render", "diffuse", "specular",
                                 "visibility", "light", "render_env",
                                 "light_indirect"])
def test_compact_frame_matches_full_frame(frames, aov):
    """The port's foreground-compacted frame against its own all-pixels
    frame, at the JAX package's tolerance for the same check."""
    out, _ = frames
    np.testing.assert_allclose(out["torch", True][aov],
                               out["torch", False][aov], rtol=RTOL, atol=ATOL)


def test_render_ir_eval_rejects_mesh():
    """A mesh whose size does not divide the sample count is refused before
    any work (tests/test_torch_parallel.py runs the sharded frames)."""
    from irgs_tpu_torch.parallel import Mesh
    cfg = tev.EvalConfig(img_w=8, img_h=8, diffuse_sample_num=16,
                         light_sample_num=0)
    with pytest.raises(ValueError, match="mesh size 3"):
        tev.render_ir_eval(None, None, None, None, cfg,
                           mesh=Mesh(rank=0, size=3))


def test_pixel_chunk_matches_jax():
    for d, l, c in [(256, 0, 2 ** 20), (512, 256, 2 ** 20), (16, 0, 2 ** 20),
                    (8, 0, 2 ** 10), (3000, 0, 2 ** 20)]:
        jc = jev.EvalConfig(img_w=8, img_h=8, diffuse_sample_num=d,
                            light_sample_num=l, chunk_point_samples=c)
        tc = tev.EvalConfig(img_w=8, img_h=8, diffuse_sample_num=d,
                            light_sample_num=l, chunk_point_samples=c)
        assert tc.pixel_chunk == jc.pixel_chunk
    j = dataclasses.asdict(jev.EvalConfig(img_w=8, img_h=8))
    t = dataclasses.asdict(tev.EvalConfig(img_w=8, img_h=8))
    assert j == t


# ---------------------------------------------------------------------------
# metrics

def _images(seed=0, hw=48):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=(hw, hw, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal((hw, hw, 3)), 0, 1).astype(
        np.float32)
    return a, b


@pytest.mark.parametrize("name", ["psnr", "ssim"])
def test_psnr_ssim_match_jax(name):
    from irgs_tpu.eval import metrics as jm
    a, b = _images()
    want = float(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tm, name)(torch.tensor(a), torch.tensor(b)))
    assert got == pytest.approx(want, rel=1e-5)


def _vgg_weights(with_lin=True):
    """Synthetic VGG16 (and lpips linear) weights in the npz layout."""
    rng = np.random.default_rng(0)
    w, in_c, ci = {}, 3, 0
    for a in tm._VGG_ARCH:
        if a == "M":
            continue
        w[f"conv{ci}_w"] = (0.05 * rng.standard_normal((a, in_c, 3, 3))
                            ).astype(np.float32)
        w[f"conv{ci}_b"] = (0.05 * rng.standard_normal(a)).astype(np.float32)
        in_c, ci = a, ci + 1
    if with_lin:
        for i, c in enumerate((64, 128, 256, 512, 512)):
            w[f"lin{i}_w"] = rng.uniform(size=c).astype(np.float32)
    return w


@pytest.mark.parametrize("with_lin", [True, False])
def test_lpips_matches_jax(with_lin):
    from irgs_tpu.eval import metrics as jm
    w = _vgg_weights(with_lin)
    a, b = _images(1, 32)
    want = jm.lpips_fn(a, b, weights=w)
    got = tm.lpips_fn(torch.tensor(a), torch.tensor(b), weights=w)
    assert got == pytest.approx(want, rel=2e-4)
    assert abs(tm.lpips_fn(torch.tensor(a), torch.tensor(a), weights=w)) < 1e-9


def test_lpips_weight_probe(tmp_path, monkeypatch):
    """The probe order: IRGS_TPU_VGG16_NPZ, then torchvision's VGG16
    checkpoint under TORCH_HOME; None (and lpips_fn None) without either."""
    monkeypatch.delenv("IRGS_TPU_VGG16_NPZ", raising=False)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    monkeypatch.setattr(tm, "_warned_no_weights", True)   # keep stderr quiet
    a, b = _images(2, 16)
    assert tm.load_vgg16_weights() is None
    assert tm.lpips_fn(torch.tensor(a), torch.tensor(b)) is None

    w = _vgg_weights(with_lin=False)
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    sd = {}
    for ci, idx in enumerate(conv_idx):
        sd[f"features.{idx}.weight"] = torch.tensor(w[f"conv{ci}_w"])
        sd[f"features.{idx}.bias"] = torch.tensor(w[f"conv{ci}_b"])
    ckpt = tmp_path / "torch_home" / "hub" / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(sd, ckpt / "vgg16-397923af.pth")
    got = tm.load_vgg16_weights()
    assert sorted(got) == sorted(w)
    np.testing.assert_array_equal(got["conv12_w"], w["conv12_w"])

    npz = tmp_path / "w.npz"
    np.savez(npz, **_vgg_weights(with_lin=True))
    monkeypatch.setenv("IRGS_TPU_VGG16_NPZ", str(npz))
    assert "lin4_w" in tm.load_vgg16_weights()
