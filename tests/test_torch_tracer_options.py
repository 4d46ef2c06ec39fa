"""The tracer options of the port (irgs_tpu_torch.ops.grid_tracer) against
the JAX package's, on the same inputs made with numpy from a seed: the
packed cell collection, the per-candidate select (single- and two-tier, the
default `TracerConfig`), the bf16 pair table, iterative-deepening re-trace
(`retrace_while`) and `first_hit`; `make_trace_fn`'s chunked path with the
per-candidate select; and the port's trace at the per-candidate default
against its own brute-force oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu_torch.ops import grid_tracer as tgt

BASE = dict(grid_res=12, pair_capacity=2 ** 15, max_cells=8, max_hits=24,
            hit_budget=16, max_crossings=10, span_cap=6, n_segments=4,
            retrace_frac=0.25)
# the options, each on the base config
VARIANTS = {
    "candidates": dict(),
    "two_tier": dict(prefilter_width=96),
    "packed_tiled": dict(select_tiles=4, tile=32, tiled_direct=False),
    "bf16": dict(select_tiles=4, tile=32, tiled_direct=True, table_bf16=True),
}
FIELDS = ("means3d", "opacity", "ru", "rv", "normals", "shs", "features")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _grids(arrs, scales, grid_res, span_cap, pair_capacity, normals=True):
    alive = np.ones(arrs["means3d"].shape[0], bool)
    j_in = gt.TraceInputs(**{k: jnp.asarray(arrs[k]) for k in FIELDS})
    t_in = tgt.TraceInputs(**{k: torch.tensor(arrs[k]) for k in FIELDS})
    radius = gt.bounding_radius(j_in.opacity, jnp.asarray(scales), 1.0 / 255.0)
    j_grid = gt.build_grid(j_in.means3d, radius, jnp.asarray(alive),
                           grid_res=grid_res, pair_capacity=pair_capacity,
                           span_cap=span_cap,
                           normals=j_in.normals if normals else None)
    t_grid = tgt.build_grid(t_in.means3d, torch.tensor(np.asarray(radius)),
                            torch.tensor(alive), grid_res=grid_res,
                            pair_capacity=pair_capacity, span_cap=span_cap,
                            normals=t_in.normals if normals else None)
    return alive, j_in, t_in, j_grid, t_grid


@pytest.fixture(scope="module")
def setup():
    arrs, scales, ro, rd = make_inputs()
    alive, j_in, t_in, j_grid, t_grid = _grids(arrs, scales, 12, 6, 2 ** 15)
    return arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd


def _cfgs(**over):
    kw = dict(BASE, **over)
    return gt.TracerConfig(**kw), tgt.TracerConfig(**kw)


def _assert_hits_equal(jh, th):
    """Exact on valid, the ids where valid, more and cand_skip; rtol 1e-6 on
    the restart depths."""
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(valid, th.valid.numpy())
    np.testing.assert_array_equal(np.where(valid, np.asarray(jh.gs), -1),
                                  np.where(valid, th.gs.numpy(), -1))
    np.testing.assert_array_equal(np.asarray(jh.more), th.more.numpy())
    np.testing.assert_array_equal(np.asarray(jh.cand_skip),
                                  th.cand_skip.numpy())
    np.testing.assert_allclose(np.asarray(jh.t_last), th.t_last.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jh.t_cell), th.t_cell.numpy(),
                               rtol=1e-6)
    return valid


@pytest.mark.parametrize("select_tiles", [0, 4])
def test_packed_collect_cells_matches_jax(setup, select_tiles):
    """The packed branch: the first max_cells non-empty segments in
    traversal order, for the per-candidate select and for the tiled one
    with tiled_direct off."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(select_tiles=select_tiles, tile=32, tiled_direct=False)
    jc = gt.collect_cells(jnp.asarray(ro), jnp.asarray(rd), j_grid, jcfg)
    tc = tgt.collect_cells(torch.tensor(ro), torch.tensor(rd), t_grid, tcfg)
    assert tc.starts.shape == (ro.shape[0], BASE["max_cells"])
    assert np.asarray(jc.truncated).any() and np.asarray(jc.resume).any()
    for name in ("starts", "counts", "truncated"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy(), err_msg=name)
    for name in ("tin", "tout", "resume"):
        np.testing.assert_allclose(np.asarray(getattr(jc, name)),
                                   getattr(tc, name).numpy(), rtol=1e-6,
                                   err_msg=name)


def test_packed_collect_cells_pads_empty_slots(setup):
    """max_cells above the segment count: the extra slots stay empty."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(max_cells=40, max_crossings=4)
    jc = gt.collect_cells(jnp.asarray(ro), jnp.asarray(rd), j_grid, jcfg)
    tc = tgt.collect_cells(torch.tensor(ro), torch.tensor(rd), t_grid, tcfg)
    assert tc.counts.shape[1] == 40 and int(tc.counts[:, 13:].abs().sum()) == 0
    for name in jc._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      getattr(tc, name).numpy(), err_msg=name)


@pytest.mark.parametrize("retrace", [False, True])
@pytest.mark.parametrize("back_culling", [False, True])
@pytest.mark.parametrize("variant", ["candidates", "two_tier"])
def test_candidate_select_matches_jax(setup, variant, back_culling, retrace):
    """The per-candidate select, single-tier (max_hits 24) and two-tier
    (prefilter 96), on a first pass and on a re-trace round's restart
    (t_start, cand_skip and the collection restart of JAX's first pass)."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jro, jrd, tro, trd = (jnp.asarray(ro), jnp.asarray(rd), torch.tensor(ro),
                          torch.tensor(rd))
    jgeom, tgeom = gt._pack_geom(j_in), tgt._pack_geom(t_in)
    jc = gt.collect_cells(jro, jrd, j_grid, jcfg)
    jh = gt.select_hits(jro, jrd, j_grid.sorted_gauss, jc, jgeom, jcfg,
                        back_culling, grid=j_grid)
    kw_j = kw_t = {}
    t_collect = None
    if retrace:
        t_acc = np.asarray(jh.t_last) * (1.0 + 1e-5) + 1e-6
        t_collect = np.maximum(np.asarray(jh.t_cell), 0.0)
        skip = np.asarray(jh.cand_skip)
        # single-tier, some rays resume inside a partial cell
        assert skip.any() or variant == "two_tier"
        kw_j = dict(t_start=jnp.asarray(t_acc), cand_skip=jnp.asarray(skip))
        kw_t = dict(t_start=torch.tensor(t_acc),
                    cand_skip=torch.tensor(skip).long())
        jc = gt.collect_cells(jro, jrd, j_grid, jcfg,
                              t_start=jnp.asarray(t_collect))
        jh = gt.select_hits(jro, jrd, j_grid.sorted_gauss, jc, jgeom, jcfg,
                            back_culling, grid=j_grid, **kw_j)
    tc = tgt.collect_cells(tro, trd, t_grid, tcfg,
                           t_start=None if t_collect is None
                           else torch.tensor(t_collect))
    th = tgt.select_hits(tro, trd, t_grid, tc, tgeom, tcfg, back_culling,
                         **kw_t)
    valid = _assert_hits_equal(jh, th)
    # culled, the second segment of the two-tier select finds no back face
    assert valid.sum() > 100 or (retrace and back_culling)
    assert np.asarray(jh.more).any()


def _coplanar(n=6):
    """n coplanar unit disks at z = 0 covering the origin, distinct alphas
    and colours (tests/test_tracer.py:299-309)."""
    return dict(
        means3d=np.zeros((n, 3), np.float32),
        opacity=np.linspace(0.2, 0.9, n).astype(np.float32),
        ru=np.tile(np.float32([[8.0, 0, 0]]), (n, 1)),
        rv=np.tile(np.float32([[0, 8.0, 0]]), (n, 1)),
        normals=np.tile(np.float32([[0.0, 0, 1.0]]), (n, 1)),
        shs=(np.arange(n, dtype=np.float32)[:, None, None]
             * np.ones((n, 16, 3), np.float32) * 0.05),
        features=np.zeros((n, 0), np.float32))


@pytest.mark.parametrize("max_hits", [16, 24])
def test_candidate_select_coplanar_tie_order(max_hits):
    """Exact depth ties of coplanar surfels with a hit budget (4) below the
    tie (6): the same survivors in the same order as JAX on the CPU, and the
    same blend. The reference's depth sort is one key with no promise of
    stability; at these shapes XLA's CPU sort gives the slot order, which is
    the port's second key (see test_xla_cpu_sort_ties_beyond_16)."""
    arrs = _coplanar()
    n = arrs["means3d"].shape[0]
    kw = dict(grid_res=8, pair_capacity=2 ** 12, max_cells=8, span_cap=8,
              max_hits=max_hits, hit_budget=4)
    jcfg, tcfg = gt.TracerConfig(**kw), tgt.TracerConfig(**kw)
    alive, j_in, t_in, j_grid, t_grid = _grids(
        arrs, np.full((n, 2), 1 / 8.0, np.float32), 8, 8, 2 ** 12)
    ro = np.float32([[0.0, 0.0, -2.0], [0.01, 0.02, -2.0]])
    rd = np.float32([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    jc = gt.collect_cells(jnp.asarray(ro), jnp.asarray(rd), j_grid, jcfg)
    jh = gt.select_hits(jnp.asarray(ro), jnp.asarray(rd), j_grid.sorted_gauss,
                        jc, gt._pack_geom(j_in), jcfg, False, grid=j_grid)
    tc = tgt.collect_cells(torch.tensor(ro), torch.tensor(rd), t_grid, tcfg)
    th = tgt.select_hits(torch.tensor(ro), torch.tensor(rd), t_grid, tc,
                         tgt._pack_geom(t_in), tcfg, False)
    _assert_hits_equal(jh, th)
    np.testing.assert_array_equal(th.gs.numpy(), [[0, 1, 2, 3]] * 2)
    jo = gt.trace(jnp.asarray(ro), jnp.asarray(rd), j_grid, j_in, cfg=jcfg,
                  sh_deg=0)
    to = tgt.trace(torch.tensor(ro), torch.tensor(rd), t_grid, t_in,
                   cfg=tcfg, sh_deg=0)
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_xla_cpu_sort_ties_beyond_16():
    """What the reference's unstable one-key lax.sort gives on the CPU:
    equal keys stay in index order up to 16 elements (an insertion sort),
    and not above (introsort's partitions move them). The port's depth sort
    keeps the index order at every width."""
    rng = np.random.default_rng(0)
    for width, stable in ((16, True), (24, False)):
        keys = rng.choice(np.float32([1.0, 2.0, 1e16]), size=(64, width))
        idx = np.broadcast_to(np.arange(width, dtype=np.int32), keys.shape)
        _, got = jax.lax.sort((jnp.asarray(keys), jnp.asarray(idx)),
                              num_keys=1, is_stable=False)
        want = np.argsort(keys, axis=-1, kind="stable")
        assert np.array_equal(np.asarray(got), want) == stable, width


def _cotangent(r, s):
    rng = np.random.default_rng(3)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in [(r, 3), (r, 3), (r, s), (r,), (r,), (r,)]]


@pytest.fixture(scope="module")
def jax_segments(setup):
    """JAX's segmented trace per variant, forward and the gradients of a
    random linear functional (one jax.vjp serves both tests)."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    cache = {}

    def get(variant):
        if variant not in cache:
            jcfg, _ = _cfgs(**VARIANTS[variant])
            out, vjp = jax.vjp(
                lambda inp, o, d: gt.trace_segments(o, d, j_grid, inp,
                                                    cfg=jcfg, sh_deg=3),
                j_in, jnp.asarray(ro), jnp.asarray(rd))
            cot = _cotangent(ro.shape[0], arrs["features"].shape[1])
            cache[variant] = out, vjp(type(out)(*map(jnp.asarray, cot)))
        return cache[variant]
    return get


@pytest.mark.parametrize("fn", ["trace", "trace_segments"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trace_matches_jax(setup, jax_segments, variant, fn):
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    if fn == "trace":
        jo = gt.trace(jnp.asarray(ro), jnp.asarray(rd), j_grid, j_in,
                      cfg=jcfg, sh_deg=3)
    else:
        jo = jax_segments(variant)[0]
    to = getattr(tgt, fn)(torch.tensor(ro), torch.tensor(rd), t_grid, t_in,
                          cfg=tcfg, sh_deg=3)
    assert float(jnp.max(jo.alpha)) > 0.5
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).detach().numpy(),
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_trace_segments_gradients_match_jax(setup, jax_segments, variant):
    """Gradients of a random linear functional of the segmented trace with
    respect to every TraceInputs field and the rays, 1e-4·max|g|."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    _, tcfg = _cfgs(**VARIANTS[variant])
    jg = jax_segments(variant)[1]
    leaves = [torch.tensor(arrs[k], requires_grad=True) for k in FIELDS]
    o_t = torch.tensor(ro, requires_grad=True)
    d_t = torch.tensor(rd, requires_grad=True)
    out = tgt.trace_segments(o_t, d_t, t_grid, tgt.TraceInputs(*leaves),
                             cfg=tcfg, sh_deg=3)
    cot = _cotangent(ro.shape[0], arrs["features"].shape[1])
    loss = sum((a * torch.tensor(b)).sum() for a, b in zip(out, cot))
    tg = torch.autograd.grad(loss, leaves + [o_t, d_t])
    pairs = (list(zip(FIELDS, jg[0], tg[:7]))
             + [("rays_o", jg[1], tg[7]), ("rays_d", jg[2], tg[8])])
    for name, a, b in pairs:
        a = np.asarray(a)
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b.numpy(), a, atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=name)


def oracle_inputs(seed=1, n=48, s=4, r=64):
    """tests/test_tracer.py's scene drawn with numpy: surfels uniform in the
    cube [-1, 1]^3, log-scales in [-3, -1.8], random orientations; rays
    shot inward from a sphere of radius 2.5."""
    from irgs_tpu_torch.utils.math3d import quat_to_rotmat
    rng = np.random.default_rng(seed)
    scales = np.exp(rng.uniform(-3.0, -1.8, (n, 2))).astype(np.float32)
    q = rng.standard_normal((n, 4))
    rot = quat_to_rotmat(torch.tensor(q / np.linalg.norm(q, axis=-1,
                                                         keepdims=True),
                                      dtype=torch.float32)).numpy()
    arrs = dict(means3d=rng.uniform(-1.0, 1.0, (n, 3)),
                opacity=1.0 / (1.0 + np.exp(-(rng.standard_normal(n) + 1.0))),
                ru=rot[:, :, 0] / scales[:, 0:1], rv=rot[:, :, 1] / scales[:, 1:2],
                normals=rot[:, :, 2], shs=0.3 * rng.standard_normal((n, 16, 3)),
                features=rng.uniform(size=(n, s)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    d = rng.standard_normal((r, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rd = d + 0.03 * rng.standard_normal((r, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return arrs, scales, (-2.5 * d).astype(np.float32), rd.astype(np.float32)


def test_default_config_matches_brute_force():
    """The port's trace at the per-candidate default against its own
    brute-force oracle, forward and gradients, at the tolerances and
    budgets of tests/test_tracer.py:70-123 (sphere insertion, 48 cells and
    192 candidates a segment). One ray of this scene meets 205 candidates,
    more than a segment holds, so the trace is segmented (re-trace rounds at
    full capacity, as tests/test_tracer.py:358-375)."""
    arrs, scales, ro, rd = oracle_inputs()
    _, _, t_in, _, t_grid = _grids(arrs, scales, 16, 8, 2 ** 15, normals=False)
    assert int(t_grid.oversize) == 0 and int(t_grid.overflow) == 0
    cfg = tgt.TracerConfig(grid_res=16, pair_capacity=2 ** 15, max_cells=48,
                           max_hits=192, hit_budget=192, span_cap=8,
                           n_segments=4, retrace_frac=1.0)
    assert cfg.select_tiles == 0 and cfg.prefilter_width == 0
    first = tgt.select_hits(torch.tensor(ro), torch.tensor(rd), t_grid,
                            tgt.collect_cells(torch.tensor(ro),
                                              torch.tensor(rd), t_grid, cfg),
                            tgt._pack_geom(t_in), cfg, False)
    assert first.more.any()
    alive = torch.ones(arrs["means3d"].shape[0], dtype=torch.bool)
    leaves = [torch.tensor(arrs[k], requires_grad=True) for k in FIELDS]
    o_t = torch.tensor(ro, requires_grad=True)
    d_t = torch.tensor(rd, requires_grad=True)
    inp = tgt.TraceInputs(*leaves)
    out = tgt.trace_segments(o_t, d_t, t_grid, inp, cfg=cfg, sh_deg=3)
    ref = tgt.trace_reference(o_t, d_t, inp, alive, sh_deg=3,
                              transmittance_min=cfg.transmittance_min)
    assert float(ref.alpha.detach().max()) > 0.5
    for name, atol in (("alpha", 3e-5), ("color", 3e-5), ("normal", 3e-5),
                       ("feature", 3e-5), ("depth", 1e-4)):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   getattr(ref, name).detach().numpy(),
                                   atol=atol, err_msg=name)
    rng = np.random.default_rng(5)
    cot = [torch.tensor(rng.standard_normal(x.shape).astype(np.float32))
           for x in out[:5]]
    grads = [torch.autograd.grad(sum((a * c).sum() for a, c in zip(o[:5], cot)),
                                 leaves + [o_t, d_t], retain_graph=True)
             for o in (out, ref)]
    for name, a, b in zip(list(FIELDS) + ["rays_o", "rays_d"], *grads):
        scale = max(float(b.abs().max()), 1e-6)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4 * scale,
                                   rtol=2e-3, err_msg=name)


def test_bf16_table_bits_match_jax(setup):
    """The bf16 pair table bit for bit (as uint16): the cell-relative
    means, the round to nearest even, the cell id's two halves. The JAX
    table's rows carry lane padding to a multiple of 128, dropped here."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    for tile in (16, 32):
        jt = gt._pair_tab_from_geom(j_grid, gt._pack_geom(j_in), tile,
                                    bf16=True)
        tt = tgt._pair_tab_from_geom(t_grid, tgt._pack_geom(t_in), tile,
                                     bf16=True)
        assert tt.dtype == torch.bfloat16 and tt.shape[1] == 12 * tile
        want = np.asarray(jt)[:, :12 * tile].view(np.uint16)
        got = tt.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def count_tail_rounds(monkeypatch):
    """How many tail rounds (_retrace_body calls at the tail capacity) the
    port's iterative re-trace ran."""
    calls = []
    orig = tgt._retrace_body
    monkeypatch.setattr(tgt, "_retrace_body", lambda *a, **k: (
        calls.append(a[9]), orig(*a, **k))[1])
    return calls


def test_retrace_while_matches_jax(setup, count_tail_rounds):
    """Iterative deepening at n_segments 8, retrace_bulk 1: the segmented
    trace, forward only (under no_grad in the port, as the reference's
    while_loop is forward only), against JAX's; the tail ran."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(retrace_while=True, n_segments=8, retrace_bulk=1,
                       retrace_frac=0.25, retrace_tail_frac=0.02)
    jo = gt.trace_segments(jnp.asarray(ro), jnp.asarray(rd), j_grid, j_in,
                           cfg=jcfg, sh_deg=3)
    with torch.no_grad():
        to = tgt.trace_segments(torch.tensor(ro), torch.tensor(rd), t_grid,
                                t_in, cfg=tcfg, sh_deg=3)
    tail_cap = int(ro.shape[0] * 0.02)
    assert tail_cap in count_tail_rounds, count_tail_rounds
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).numpy(), atol=1e-5,
                                   err_msg=name)


def test_retrace_while_refuses_autograd(setup):
    """Under autograd with inputs that require grad the iterative schedule
    raises, as JAX's reverse-mode derivative of its while_loop does."""
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs(retrace_while=True, n_segments=8, retrace_bulk=1)
    # traced under jit: the refusal comes at trace time, with no op run
    with pytest.raises(ValueError, match="while_loop"):
        jax.jit(jax.grad(lambda o: gt.trace_segments(
            o, jnp.asarray(rd), j_grid, j_in, cfg=jcfg,
            sh_deg=3).alpha.sum()))(jnp.asarray(ro))
    o_t = torch.tensor(ro, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        tgt.trace_segments(o_t, torch.tensor(rd), t_grid, t_in, cfg=tcfg,
                           sh_deg=3)


def test_chunked_trace_fn_candidates_matches_jax():
    """make_trace_fn's chunked path (coherence sort, grouped select, per-chunk
    blends, re-trace rounds, truncation stats) with the per-candidate select,
    against the JAX one, with a small ray_chunk so that 2000 rays take it."""
    from irgs_tpu.render import ir as jir
    from irgs_tpu.scene import toy
    from irgs_tpu_torch.render import ir as tir
    from irgs_tpu_torch.scene import gaussians as tgs

    jcfg, tcfg = _cfgs(prefilter_width=48)
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
    jo = jir.make_trace_fn(jp, ja, gt.build_grid_from_gaussians(jp, ja, jcfg),
                           jcfg, jnp.asarray(cam_pos), 3, ray_chunk=512,
                           stats_out=j_stats)(jnp.asarray(ro), jnp.asarray(rd))
    with torch.no_grad():
        to = tir.make_trace_fn(tp, ta,
                               tgt.build_grid_from_gaussians(tp, ta, tcfg),
                               tcfg, torch.tensor(cam_pos), 3, ray_chunk=512,
                               stats_out=t_stats)(torch.tensor(ro),
                                                  torch.tensor(rd))
    assert float(j_stats["trace_trunc_frac"]) > 0.0
    for k in ("trace_trunc_frac", "trace_more_frac"):
        assert float(t_stats[k]) == pytest.approx(float(j_stats[k]), abs=1e-6), k
    for name in jo._fields:
        np.testing.assert_allclose(np.asarray(getattr(jo, name)),
                                   getattr(to, name).numpy(), atol=1e-5,
                                   err_msg=name)


def test_first_hit_matches_jax(setup):
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    jcfg, tcfg = _cfgs()
    jh = np.asarray(gt.first_hit(jnp.asarray(ro), jnp.asarray(rd), j_grid,
                                 j_in, cfg=jcfg))
    th = tgt.first_hit(torch.tensor(ro), torch.tensor(rd), t_grid, t_in,
                       cfg=tcfg)
    assert th.dtype == torch.bool and jh.any() and not jh.all()
    np.testing.assert_array_equal(th.numpy(), jh)


@pytest.mark.parametrize("eval_", [False, True])
def test_from_pipe_with_every_option_traces(setup, eval_):
    """TracerConfig.from_pipe with every option switched on: the
    per-candidate select with the two-tier prefilter for training; the
    packed collection, the bf16 table and iterative deepening for eval: the
    same config as the JAX package's; it builds and traces (shrunk to the
    test grid)."""
    from irgs_tpu.config import Config as JConfig
    from irgs_tpu_torch.config import Config as TConfig
    arrs, alive, j_in, t_in, j_grid, t_grid, ro, rd = setup
    over = dict(tracer_select_tiles=0, tracer_prefilter_width=96,
                tracer_max_hits=24, tracer_table_bf16=True,
                tracer_tiled_direct=False, tracer_table_bf16_eval=True,
                tracer_retrace_while_eval=True, tracer_retrace_bulk_eval=1,
                tracer_retrace_select_tiles_eval=0,
                tracer_retrace_prefilter_width_eval=128,
                tracer_retrace_max_hits_eval=48)
    cfgs = []
    for Config, mod in ((JConfig, gt), (TConfig, tgt)):
        pipe = Config().pipe
        for k, v in over.items():
            setattr(pipe, k, v)
        cfg = mod.TracerConfig.from_pipe(pipe, eval=eval_)
        cfgs.append(dataclasses.replace(cfg, grid_res=12, span_cap=6,
                                        pair_capacity=2 ** 15, tile=32,
                                        max_crossings=10))
    jcfg, tcfg = cfgs
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.retrace_while, tcfg.table_bf16) == (eval_, True)
    with torch.no_grad():
        to = tgt.trace_segments(torch.tensor(ro), torch.tensor(rd), t_grid,
                                t_in, cfg=tcfg, sh_deg=3)
    assert float(to.alpha.max()) > 0.5
    for name in to._fields:
        assert torch.isfinite(getattr(to, name)).all(), name
