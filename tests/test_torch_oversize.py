"""The port's exact oversize merge (irgs_tpu_torch.ops.grid_tracer with
`oversize_cap` > 0) against the JAX package's, as tests/test_a_oversize.py
holds the JAX one: on its floor scene (a disk spanning the scene over small
surfels) and on a small make_shadow_scene (a ground disk of wide surfels
under a sphere). Inputs are made once, in JAX, and handed to both as numpy
arrays, so that the comparison is the tracer's alone."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.utils import math3d
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import toy as ttoy

from test_a_oversize import _floor_scene
from test_torch_mis import one_torch_thread  # noqa: F401

FIELDS = ("means3d", "opacity", "ru", "rv", "normals", "shs", "features")
# the floor scene's configs of test_oversize_merge_exact: one pass with wide
# budgets, and segmented re-trace with tight ones
FLOOR_CFG = dict(grid_res=8, pair_capacity=2 ** 15, max_cells=48,
                 max_hits=192, hit_budget=192, span_cap=6, oversize_cap=8,
                 select_tiles=48, tile=8, tiled_direct=True)
FLOOR_SEG = dict(FLOOR_CFG, max_cells=8, max_hits=16, hit_budget=8,
                 select_tiles=4, n_segments=4, retrace_frac=1.0,
                 max_crossings=12)
SHADOW_CFG = dict(grid_res=16, pair_capacity=2 ** 16, max_cells=8,
                  max_hits=24, hit_budget=16, max_crossings=12, span_cap=6,
                  select_tiles=8, tile=32, tiled_direct=True, n_segments=4,
                  retrace_frac=0.5, oversize_cap=64)


def _floor_rays():
    """test_oversize_merge_exact's rays: straight down onto the floor and
    oblique ones that graze it through many cells."""
    xs = jnp.linspace(-1.8, 1.8, 8)
    ox, oy = jnp.meshgrid(xs, xs, indexing="ij")
    ro = jnp.stack([ox.reshape(-1), oy.reshape(-1), jnp.full(64, 2.0)], -1)
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (64, 1))
    ro2 = jnp.tile(jnp.asarray([[2.5, 0.3, 1.5]]), (64, 1))
    rd2 = math3d.safe_normalize(jnp.stack(
        [-1.0 - 0.3 * jax.random.uniform(jax.random.PRNGKey(3), (64,)),
         -0.2 * jax.random.uniform(jax.random.PRNGKey(4), (64,)),
         -0.9 + 0.4 * jax.random.uniform(jax.random.PRNGKey(5), (64,))], -1))
    return (np.asarray(jnp.concatenate([ro, ro2]), np.float32),
            np.asarray(jnp.concatenate([rd, rd2]), np.float32))


def _shadow_inputs(seed=1):
    params, aux = jtoy.make_shadow_scene(n_ground=200, n_sphere=300,
                                         n_capacity=512, env_resolution=16)
    s = params.get_scaling()
    Rm = math3d.quat_to_rotmat(params.rotation)
    inputs = gt.TraceInputs(
        means3d=params.xyz,
        opacity=jnp.where(aux.alive, params.get_opacity()[:, 0], 0.0),
        ru=Rm[:, :, 0] / s[:, 0:1], rv=Rm[:, :, 1] / s[:, 1:2],
        normals=params.world_normals(cam_pos=jnp.asarray([3.0, 0.8, 0.0])),
        shs=params.get_features(),
        features=jnp.concatenate([params.get_base_color(),
                                  params.get_roughness()], -1))
    # rays from a ring of eye points at the ground and the sphere. Two hits
    # whose depths lie within an ulp of each other blend in either order
    # under different rounding (XLA's fused kernels, torch's), which moves a
    # ray's colour by up to a1·a2·|c1 - c2|; the rays of seeds 0 and 4 meet
    # such a pair (6e-4 and 4e-3, ROADMAP.md C), those of seed 1 do not
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, 256)
    ro = np.stack([3 * np.cos(ang), 0.8 + 0.5 * rng.uniform(size=256),
                   3 * np.sin(ang)], -1)
    target = np.asarray(params.xyz)[rng.integers(0, 500, 256)]
    rd = target - ro + 0.05 * rng.standard_normal((256, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return inputs, s, aux.alive, ro.astype(np.float32), rd.astype(np.float32)


def _setup(inputs, scales, alive, ro, rd, cfg):
    jcfg, tcfg = gt.TracerConfig(**cfg), tgt.TracerConfig(**cfg)
    arrs = {k: np.asarray(getattr(inputs, k), np.float32) for k in FIELDS}
    alive = np.asarray(alive)
    radius = np.asarray(gt.bounding_radius(jnp.asarray(arrs["opacity"]),
                                           jnp.asarray(scales), jcfg.alpha_min))
    kw = dict(grid_res=cfg["grid_res"], pair_capacity=cfg["pair_capacity"],
              span_cap=cfg["span_cap"], oversize_cap=cfg["oversize_cap"])
    j_in = gt.TraceInputs(**{k: jnp.asarray(v) for k, v in arrs.items()})
    t_in = tgt.TraceInputs(**{k: torch.tensor(v) for k, v in arrs.items()})
    j_grid = gt.build_grid(j_in.means3d, jnp.asarray(radius),
                           jnp.asarray(alive), normals=j_in.normals, **kw)
    t_grid = tgt.build_grid(t_in.means3d, torch.tensor(radius),
                            torch.tensor(alive), normals=t_in.normals, **kw)
    return dict(arrs=arrs, alive=alive, j_in=j_in, t_in=t_in, j_grid=j_grid,
                t_grid=t_grid, jcfg=jcfg, tcfg=tcfg, ro=ro, rd=rd)


@pytest.fixture(scope="module")
def floor():
    inputs, scales = _floor_scene()
    ro, rd = _floor_rays()
    return _setup(inputs, scales, np.ones(inputs.means3d.shape[0], bool),
                  ro, rd, FLOOR_CFG)


@pytest.fixture(scope="module")
def shadow():
    return _setup(*_shadow_inputs(), SHADOW_CFG)


def test_shadow_scene_matches_jax():
    """make_shadow_scene: the fields built in numpy are JAX's bit for bit;
    those through an activation's inverse (torch against XLA) within an
    ulp or two."""
    jp, ja = jtoy.make_shadow_scene(n_ground=200, n_sphere=300,
                                    n_capacity=512, env_resolution=16)
    tp, ta = ttoy.make_shadow_scene(n_ground=200, n_sphere=300,
                                    n_capacity=512, env_resolution=16,
                                    device="cpu")
    for f in tgs.PARAM_FIELDS:
        want, got = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        if f in ("xyz", "metallic", "features_dc", "features_rest",
                 "scaling", "env"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))


@pytest.mark.parametrize("scene", ["floor", "shadow"])
def test_build_grid_oversize_equal(scene, request):
    s = request.getfixturevalue(scene)
    j, t = s["j_grid"], s["t_grid"]
    ids = np.asarray(j.oversize_ids)
    assert (ids >= 0).sum() > 0
    np.testing.assert_array_equal(t.oversize_ids.numpy(), ids)
    assert int(t.oversize) == int(j.oversize)
    assert int(t.overflow) == int(j.overflow) == 0
    for name in ("sorted_gauss", "sorted_cell", "cell_meta", "coarse_occ"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(t.bb_min.numpy(), np.asarray(j.bb_min),
                               rtol=1e-6)
    if scene == "floor":
        # the floor (last id) left the grid for the oversize list
        n = s["alive"].shape[0]
        assert (n - 1) in ids and int(t.oversize) == 0
        n_pairs = int(tgt.unpack_cell_meta(t.cell_meta)[1].sum())
        assert not bool((t.sorted_gauss[:n_pairs] == n - 1).any())
    else:
        # more ground surfels than the cap: the rest stay truncated
        assert int(t.oversize) > 0 and (ids >= 0).all()


def _cfgs(s, cfg):
    """The JAX and port TracerConfigs of `cfg`, or the scene's own."""
    if cfg is None:
        return s["jcfg"], s["tcfg"]
    return gt.TracerConfig(**cfg), tgt.TracerConfig(**cfg)


@pytest.mark.parametrize("scene,fn,cfg", [("floor", "trace", None),
                                          ("floor", "trace_segments", FLOOR_SEG),
                                          ("shadow", "trace", None),
                                          ("shadow", "trace_segments", None)])
def test_merged_trace_matches_jax(scene, fn, cfg, request):
    """Values, and gradients of a random linear functional with respect to
    every TraceInputs field and the rays (the JAX side jitted); the
    oversize Gaussians get theirs through the merged blend."""
    s = request.getfixturevalue(scene)
    jcfg, tcfg = _cfgs(s, cfg)
    rng = np.random.default_rng(3)
    r, f = s["ro"].shape[0], s["arrs"]["features"].shape[1]
    cot = [rng.standard_normal(sh).astype(np.float32)
           for sh in [(r, 3), (r, 3), (r, f), (r,), (r,), (r,)]]

    def j_fn(inp, o, d):
        return getattr(gt, fn)(o, d, s["j_grid"], inp, cfg=jcfg, sh_deg=3)

    jo, j_vjp = jax.vjp(jax.jit(j_fn), s["j_in"], jnp.asarray(s["ro"]),
                        jnp.asarray(s["rd"]))
    jg = j_vjp(gt.TraceOut(*[jnp.asarray(c) for c in cot]))
    leaves = [torch.tensor(s["arrs"][k], requires_grad=True) for k in FIELDS]
    o_t = torch.tensor(s["ro"], requires_grad=True)
    d_t = torch.tensor(s["rd"], requires_grad=True)
    to = getattr(tgt, fn)(o_t, d_t, s["t_grid"], tgt.TraceInputs(*leaves),
                          cfg=tcfg, sh_deg=3)
    assert float(jnp.max(jo.alpha)) > 0.5
    for name in jo._fields:
        np.testing.assert_allclose(getattr(to, name).detach().numpy(),
                                   np.asarray(getattr(jo, name)), atol=1e-5,
                                   err_msg=name)
    loss = sum((a * torch.tensor(b)).sum() for a, b in zip(to, cot))
    tg = torch.autograd.grad(loss, leaves + [o_t, d_t])
    pairs = list(zip(FIELDS, jg[0], tg[:7])) + [("rays_o", jg[1], tg[7]),
                                                ("rays_d", jg[2], tg[8])]
    for name, a, b in pairs:
        a = np.asarray(a)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)
    ov = s["t_grid"].oversize_ids
    assert float(tg[1][ov[ov >= 0]].abs().max()) > 0.0


@pytest.mark.parametrize("fn,cfg,atol", [("trace", FLOOR_CFG, 3e-5),
                                         ("trace_segments", FLOOR_SEG, 2e-3)])
def test_merged_trace_equals_reference(floor, fn, cfg, atol):
    """The exactness of test_oversize_merge_exact: the floor out of the
    grid, merged into every blend, the oracle's result; across segmented
    re-trace rounds the oversize windows partition the rays (no double
    blend, no loss)."""
    s = floor
    tcfg = tgt.TracerConfig(**cfg)
    ro, rd = torch.tensor(s["ro"]), torch.tensor(s["rd"])
    ref = tgt.trace_reference(ro, rd, s["t_in"], torch.tensor(s["alive"]),
                              sh_deg=3, transmittance_min=tcfg.transmittance_min)
    with torch.no_grad():
        out = getattr(tgt, fn)(ro, rd, s["t_grid"], s["t_in"], cfg=tcfg,
                               sh_deg=3)
    assert float(ref.alpha[:64].min()) > 0.3   # the rays straight down
    np.testing.assert_allclose(out.alpha.numpy(), ref.alpha.detach().numpy(),
                               atol=atol)
    np.testing.assert_allclose(out.color.numpy(), ref.color.detach().numpy(),
                               atol=atol)
    if fn == "trace":
        np.testing.assert_allclose(out.depth.numpy(),
                                   ref.depth.detach().numpy(), atol=1e-4)
