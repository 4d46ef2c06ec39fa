"""The port's grid tracer (irgs_tpu_torch.ops.grid_tracer) against the JAX
package's, on the same inputs (made with numpy from a seed), at a small
tiled training config: grid 12, 4 tiles x 32 candidates, tiled_direct,
4 segments; with and without the eval switches (`select_topk`, the
`adaptive` capacity ladder) and at eval-like re-trace budgets."""

import dataclasses


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu_torch.ops import grid_tracer as tgt
from test_torch_mis import one_torch_thread  # noqa: F401

CFG = dict(grid_res=12, pair_capacity=2 ** 15, max_cells=8, max_hits=24,
           hit_budget=16, max_crossings=10, span_cap=6, select_tiles=4,
           tile=32, tiled_direct=True, n_segments=4, retrace_frac=0.25)
JCFG = gt.TracerConfig(**CFG)
TCFG = tgt.TracerConfig(**CFG)
# the eval budgets' shape at this size: wider re-trace rounds whose capacity
# decays (TracerConfig.from_pipe(..., eval=True))
EVAL_RETRACE = dict(retrace_frac=0.5, retrace_decay=0.5,
                    retrace_select_tiles=8, retrace_hit_budget=24,
                    retrace_max_cells=12, retrace_max_hits=48,
                    retrace_max_crossings=16)
FIELDS = ("means3d", "opacity", "ru", "rv", "normals", "shs", "features")


def make_inputs(seed=0, n=96, s=4, r=256):
    """Surfels on a jittered unit sphere (dense enough that rays hit many
    of them and the re-trace rounds run), plus rays shot inward."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    nrm = d / np.linalg.norm(d, axis=-1, keepdims=True)
    means = nrm * (1.0 + 0.15 * rng.standard_normal((n, 1)))
    tu = np.cross(nrm, rng.standard_normal((n, 3)))
    tu /= np.linalg.norm(tu, axis=-1, keepdims=True)
    tv = np.cross(nrm, tu)
    scales = np.exp(rng.uniform(-2.0, -1.2, (n, 2)))
    opac = 1.0 / (1.0 + np.exp(-(rng.standard_normal(n) + 1.5)))
    arrs = dict(means3d=means, opacity=opac, ru=tu / scales[:, :1],
                rv=tv / scales[:, 1:], normals=nrm,
                shs=0.3 * rng.standard_normal((n, 16, 3)),
                features=rng.uniform(size=(n, s)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    dirs = rng.standard_normal((r, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ro = (-2.5 * dirs).astype(np.float32)
    rd = dirs + 0.1 * rng.standard_normal((r, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return arrs, scales.astype(np.float32), ro, rd


@pytest.fixture(scope="module")
def setup():
    arrs, scales, ro, rd = make_inputs()
    alive = np.ones(arrs["means3d"].shape[0], bool)
    j_in = gt.TraceInputs(**{k: jnp.asarray(arrs[k]) for k in FIELDS})
    t_in = tgt.TraceInputs(**{k: torch.tensor(arrs[k]) for k in FIELDS})
    radius = gt.bounding_radius(j_in.opacity, jnp.asarray(scales), JCFG.alpha_min)
    j_grid = gt.build_grid(j_in.means3d, radius, jnp.asarray(alive),
                           grid_res=JCFG.grid_res,
                           pair_capacity=JCFG.pair_capacity,
                           span_cap=JCFG.span_cap, normals=j_in.normals)
    t_grid = tgt.build_grid(t_in.means3d, torch.tensor(np.asarray(radius)),
                            torch.tensor(alive), grid_res=TCFG.grid_res,
                            pair_capacity=TCFG.pair_capacity,
                            span_cap=TCFG.span_cap, normals=t_in.normals)
    return arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd


def test_build_grid_csr_equal(setup):
    *_, j_grid, t_grid, _, _ = setup
    assert int(j_grid.overflow) == 0 and int(t_grid.overflow) == 0
    for name in ("sorted_gauss", "sorted_cell", "cell_meta", "coarse_occ"):
        np.testing.assert_array_equal(np.asarray(getattr(j_grid, name)),
                                      getattr(t_grid, name).numpy(),
                                      err_msg=name)
    np.testing.assert_allclose(np.asarray(j_grid.bb_min), t_grid.bb_min.numpy(),
                               rtol=1e-6)
    assert int(j_grid.oversize) == int(t_grid.oversize)


def _cfgs(**over):
    return (dataclasses.replace(JCFG, **over),
            dataclasses.replace(TCFG, **over))


def _hits(j_grid, t_grid, j_in, t_in, ro, rd, jcfg=JCFG, tcfg=TCFG):
    jc = gt.collect_cells(jnp.asarray(ro), jnp.asarray(rd), j_grid, jcfg)
    jh = gt.select_hits(jnp.asarray(ro), jnp.asarray(rd), j_grid.sorted_gauss,
                        jc, gt._pack_geom(j_in), jcfg, False, grid=j_grid)
    tc = tgt.collect_cells(torch.tensor(ro), torch.tensor(rd), t_grid, tcfg)
    th = tgt.select_hits(torch.tensor(ro), torch.tensor(rd), t_grid, tc,
                         tgt._pack_geom(t_in), tcfg, False)
    return jh, th


@pytest.mark.parametrize("select_topk", [False, True])
def test_selected_hits_match_exactly(setup, select_topk):
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jh, th = _hits(j_grid, t_grid, j_in, t_in, ro, rd,
                   *_cfgs(select_topk=select_topk))
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(valid, th.valid.numpy())
    assert valid.sum() > 200
    np.testing.assert_array_equal(np.where(valid, np.asarray(jh.gs), -1),
                                  np.where(valid, th.gs.numpy(), -1))
    np.testing.assert_array_equal(np.asarray(jh.more), th.more.numpy())
    assert np.asarray(jh.more).any()   # the re-trace rounds have work
    np.testing.assert_array_equal(np.asarray(jh.cand_skip), th.cand_skip.numpy())
    np.testing.assert_allclose(np.asarray(jh.t_last), th.t_last.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jh.t_cell), th.t_cell.numpy(), rtol=1e-6)


@pytest.mark.parametrize("select_topk", [False, True])
@pytest.mark.parametrize("fn", ["trace", "trace_segments"])
def test_trace_matches_jax(setup, fn, select_topk):
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(select_topk=select_topk)
    jo = getattr(gt, fn)(jnp.asarray(ro), jnp.asarray(rd), j_grid, j_in,
                         cfg=jcfg, sh_deg=3)
    to = getattr(tgt, fn)(torch.tensor(ro), torch.tensor(rd), t_grid, t_in,
                          cfg=tcfg, sh_deg=3)
    assert float(jnp.max(jo.alpha)) > 0.5
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).detach().numpy(),
                                   atol=1e-5, err_msg=name)


def test_adaptive_trace_segments_matches_jax_and_full_capacity(
        setup, monkeypatch):
    """The `adaptive` capacity ladder at the eval re-trace budgets (with
    select_topk): the port's (one host read of the need count per round)
    against the JAX package's lax.switch, and against the port's own
    full-capacity rounds, which it must equal bit for bit. 2048 rays at a
    re-trace fraction of 2 (clipped to the ray count, then halved by the
    decay) make two rounds of capacity 2048, so that the ladder has two
    rungs to choose from."""
    arrs, alive, j_in, t_in, j_grid, t_grid, _, _ = setup
    _, _, ro, rd = make_inputs(r=2048)
    jcfg, tcfg = _cfgs(adaptive=True, select_topk=True,
                       **dict(EVAL_RETRACE, retrace_frac=2.0, n_segments=3))
    picks = []
    orig = tgt.ladder_capacity
    monkeypatch.setattr(tgt, "ladder_capacity",
                        lambda c, n: picks.append((c, orig(c, n))) or orig(c, n))
    jo = gt.trace_segments(jnp.asarray(ro), jnp.asarray(rd), j_grid, j_in,
                           cfg=jcfg, sh_deg=3)
    with torch.no_grad():
        to = tgt.trace_segments(torch.tensor(ro), torch.tensor(rd), t_grid,
                                t_in, cfg=tcfg, sh_deg=3)
        tf = tgt.trace_segments(torch.tensor(ro), torch.tensor(rd), t_grid,
                                t_in, cfg=dataclasses.replace(tcfg,
                                                              adaptive=False),
                                sh_deg=3)
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).numpy(), atol=1e-5,
                                   err_msg=name)
        assert torch.equal(getattr(to, name), getattr(tf, name)), name
    assert any(rung < cap for cap, rung in picks), picks


def test_trace_forward_only_is_trace_without_graph(setup):
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    leaves = tgt.TraceInputs(*[x.clone().requires_grad_(True) for x in t_in])
    want = tgt.trace(torch.tensor(ro), torch.tensor(rd), t_grid, leaves,
                     cfg=TCFG, sh_deg=3)
    got = tgt.trace_forward_only(torch.tensor(ro), torch.tensor(rd), t_grid,
                                 leaves, cfg=TCFG, sh_deg=3)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name).detach())
        assert not getattr(got, name).requires_grad, name


def test_ladder_capacity_rungs():
    """The smallest of {max(1024, c/16), max(1024, c/4), c} that holds the
    need count, as the reference's lax.switch picks it."""
    assert tgt.ladder_capacity(65536, 1) == 4096
    assert tgt.ladder_capacity(65536, 4096) == 4096
    assert tgt.ladder_capacity(65536, 4097) == 16384
    assert tgt.ladder_capacity(65536, 16385) == 65536
    assert tgt.ladder_capacity(65536, 10 ** 6) == 65536
    assert tgt.ladder_capacity(2048, 5) == 1024
    assert tgt.ladder_capacity(512, 5) == 512


def test_eval_from_pipe_matches_jax():
    """TracerConfig.from_pipe(..., eval=True): the same budgets as the JAX
    package's (every option they can switch on is ported:
    tests/test_torch_tracer_options.py)."""
    from irgs_tpu.config import Config as JConfig
    from irgs_tpu_torch.config import Config as TConfig
    for ev in (False, True):
        j = gt.TracerConfig.from_pipe(JConfig().pipe, eval=ev)
        t = tgt.TracerConfig.from_pipe(TConfig().pipe, eval=ev)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_trace_reference_matches_jax(setup):
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jo = gt.trace_reference(jnp.asarray(ro), jnp.asarray(rd), j_in,
                            jnp.asarray(alive), sh_deg=3)
    to = tgt.trace_reference(torch.tensor(ro), torch.tensor(rd), t_in,
                             torch.tensor(alive), sh_deg=3)
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).numpy(), atol=1e-5,
                                   err_msg=name)


def test_trace_segments_gradients_match_jax(setup):
    """Gradients of a random linear functional of the segmented trace with
    respect to every TraceInputs field and the rays."""
    import jax
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    rng = np.random.default_rng(3)
    r, s = ro.shape[0], arrs["features"].shape[1]
    cot = [rng.standard_normal(sh).astype(np.float32)
           for sh in [(r, 3), (r, 3), (r, s), (r,), (r,), (r,)]]

    def j_loss(inp, o, d):
        out = gt.trace_segments(o, d, j_grid, inp, cfg=JCFG, sh_deg=3)
        return sum(jnp.vdot(a, jnp.asarray(b)) for a, b in zip(out, cot))

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(j_in, jnp.asarray(ro), jnp.asarray(rd))
    leaves = [torch.tensor(arrs[k], requires_grad=True) for k in FIELDS]
    o_t = torch.tensor(ro, requires_grad=True)
    d_t = torch.tensor(rd, requires_grad=True)
    out = tgt.trace_segments(o_t, d_t, t_grid, tgt.TraceInputs(*leaves),
                             cfg=TCFG, sh_deg=3)
    loss = sum((a * torch.tensor(b)).sum() for a, b in zip(out, cot))
    tg = torch.autograd.grad(loss, leaves + [o_t, d_t])
    pairs = list(zip(FIELDS, jg[0], tg[:7])) + [("rays_o", jg[1], tg[7]),
                                                ("rays_d", jg[2], tg[8])]
    for name, a, b in pairs:
        a = np.asarray(a)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)


def test_chunked_trace_fn_matches_jax():
    """make_trace_fn's chunked path (coherence sort, grouped select, per-chunk
    blends, re-trace rounds on the padded arrays, truncation stats) against
    the JAX one, with a small ray_chunk so that 2000 rays take it."""
    from irgs_tpu.render import ir as jir
    from irgs_tpu.scene import toy
    from irgs_tpu_torch.render import ir as tir
    from irgs_tpu_torch.scene import gaussians as tgs

    jp, ja = toy.make_sphere_scene(n_surface=512, n_capacity=1024,
                                   env_resolution=16)
    tp, ta = tgs.params_from_numpy(
        {f: np.asarray(getattr(jp, f)) for f in tgs.PARAM_FIELDS},
        np.asarray(ja.alive), "cpu")
    rng = np.random.default_rng(5)
    n = rng.standard_normal((2000, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = n + 0.8 * rng.standard_normal((2000, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = (1.02 * n).astype(np.float32)
    rd = d.astype(np.float32)
    cam_pos = np.array([3.0, 0.8, 0.0], np.float32)
    j_stats, t_stats = {}, {}
    jo = jir.make_trace_fn(jp, ja, gt.build_grid_from_gaussians(jp, ja, JCFG),
                           JCFG, jnp.asarray(cam_pos), 3, ray_chunk=512,
                           stats_out=j_stats)(jnp.asarray(ro), jnp.asarray(rd))
    to = tir.make_trace_fn(tp, ta, tgt.build_grid_from_gaussians(tp, ta, TCFG),
                           TCFG, torch.tensor(cam_pos), 3, ray_chunk=512,
                           stats_out=t_stats)(torch.tensor(ro), torch.tensor(rd))
    assert float(j_stats["trace_trunc_frac"]) > 0.0
    for k in ("trace_trunc_frac", "trace_more_frac"):
        assert float(t_stats[k]) == pytest.approx(float(j_stats[k]), abs=1e-6), k
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).detach().numpy(),
                                   atol=1e-5, err_msg=name)


def test_pair_table_overflow_matches_jax(setup):
    """A pair table too small for the scene (ROADMAP.md C3, shared with the
    JAX package): the port drops the same pairs and counts the same
    grid_overflow, and traces the same colours and alphas with them
    dropped (within the trace tests' 1e-5)."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    cap = 256
    scales = make_inputs()[1]
    rad = gt.bounding_radius(j_in.opacity, jnp.asarray(scales), JCFG.alpha_min)
    kw = dict(grid_res=JCFG.grid_res, pair_capacity=cap,
              span_cap=JCFG.span_cap)
    jg = gt.build_grid(j_in.means3d, rad, jnp.asarray(alive),
                       normals=j_in.normals, **kw)
    tg = tgt.build_grid(t_in.means3d, torch.tensor(np.asarray(rad)),
                        torch.tensor(alive), normals=t_in.normals, **kw)
    assert int(jg.overflow) > 0
    assert int(tg.overflow) == int(jg.overflow)
    for name in ("sorted_gauss", "sorted_cell", "cell_meta", "coarse_occ"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy(), err_msg=name)
    jcfg, tcfg = _cfgs(pair_capacity=cap)
    jo = gt.trace(jnp.asarray(ro), jnp.asarray(rd), jg, j_in, cfg=jcfg,
                  sh_deg=3)
    to = tgt.trace(torch.tensor(ro), torch.tensor(rd), tg, t_in, cfg=tcfg,
                   sh_deg=3)
    full = gt.trace(jnp.asarray(ro), jnp.asarray(rd), j_grid, j_in, cfg=JCFG,
                    sh_deg=3)
    # the dropped pairs change what the rays see
    assert float(jnp.abs(jo.alpha - full.alpha).max()) > 1e-3
    for name in ("color", "alpha"):
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).detach().numpy(),
                                   atol=1e-5, err_msg=name)
