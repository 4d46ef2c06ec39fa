"""The port's row gather (irgs_tpu_torch.ops.gather_rows) and the tiled
select that uses it, against the JAX package's Pallas row gather run in
interpret mode, on the same inputs (made with numpy from a seed). The
gather is a copy and is held bit for bit; so are the select's hits, and its
restart depths to 1e-6. On the CPU the port's gather takes its plain
version; the kernel is held against that version on the card in
tests/test_torch_kernels.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irgs_tpu.ops.gather_pallas as gp
from irgs_tpu.ops import grid_tracer as gt
from irgs_tpu.scene import toy
from irgs_tpu_torch.ops import gather_rows as tgr
from irgs_tpu_torch.ops import grid_tracer as tgt
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.utils import math3d as tm3


# the shapes of tests/test_gather_pallas.py (M = 3T + 7), its small batch
# (M < block_rows), and the two probe kernels of tools/_prof_collect_parts.py
@pytest.mark.parametrize("T,W,M", [(513, 224, 3 * 513 + 7),
                                   (64, 896, 3 * 64 + 7),
                                   (2048, 56, 3 * 2048 + 7),
                                   (10, 4, 5), (1024, 128, 128),
                                   (110592, 1, 1024)])
def test_gather_rows_matches_pallas_interpret(T, W, M):
    rng = np.random.default_rng(T + W)
    tab = rng.standard_normal((T, W)).astype(np.float32)
    idx = rng.integers(0, T, M)
    want = gp.gather_rows(jnp.asarray(tab), jnp.asarray(idx, jnp.int32),
                          interpret=True)
    tgr.reset_launches()
    got = tgr.gather_rows(torch.tensor(tab), torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tgr.LAUNCHES["gather_rows"] == 0    # CPU tensors: plain version


@pytest.fixture(scope="module")
def scene():
    """The scene of test_gather_pallas.py's tiled-select case."""
    params, aux = toy.make_sphere_scene(n_surface=2000, n_capacity=2048,
                                        env_resolution=16)
    tp, ta = tgs.params_from_numpy(
        {f: np.asarray(getattr(params, f)) for f in tgs.PARAM_FIELDS},
        np.asarray(aux.alive), "cpu")
    rng = np.random.default_rng(0)
    ro = (np.asarray(params.xyz)[rng.integers(0, 2000, 64)] * 1.5
          ).astype(np.float32)
    rd = rng.standard_normal((64, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return params, aux, tp, ta, ro, rd


def _inputs_jax(params, aux, n_cap):
    from irgs_tpu.utils import math3d
    s = params.get_scaling()
    Rm = math3d.quat_to_rotmat(params.rotation)
    return gt.TraceInputs(
        means3d=params.xyz,
        opacity=jnp.where(aux.alive, params.get_opacity()[:, 0], 0.0),
        ru=Rm[:, :, 0] / s[:, 0:1], rv=Rm[:, :, 1] / s[:, 1:2],
        normals=params.world_normals(cam_pos=jnp.zeros(3)),
        shs=params.get_features(), features=jnp.zeros((n_cap, 0)))


def _inputs_torch(params, aux, n_cap):
    s = params.get_scaling()
    Rm = tm3.quat_to_rotmat(params.rotation)
    return tgt.TraceInputs(
        means3d=params.xyz,
        opacity=torch.where(aux.alive, params.get_opacity()[:, 0],
                            torch.zeros(n_cap)),
        ru=Rm[:, :, 0] / s[:, 0:1], rv=Rm[:, :, 1] / s[:, 1:2],
        normals=params.world_normals(cam_pos=torch.zeros(3)),
        shs=params.get_features(), features=torch.zeros((n_cap, 0)))


@pytest.mark.parametrize("select_topk", [False, True])
def test_tiled_select_pallas_gather_matches_jax(scene, monkeypatch,
                                                select_topk):
    """select_hits_tiled with pallas_gather=8: the JAX package's through its
    Pallas gather (interpret mode), the port's through gather_rows; the
    selected hits are equal (the restart depths to 1e-6)."""
    params, aux, tp, ta, ro, rd = scene
    fields = dict(grid_res=16, pair_capacity=2 ** 15, max_cells=8,
                  select_tiles=8, tile=16, hit_budget=8, max_crossings=12,
                  tiled_direct=True, pallas_gather=8, select_topk=select_topk)
    jcfg, tcfg = gt.TracerConfig(**fields), tgt.TracerConfig(**fields)
    orig = gp.gather_rows
    monkeypatch.setattr(gp, "gather_rows",
                        lambda t, i, **kw: orig(t, i, interpret=True))
    jgrid = gt.build_grid_from_gaussians(params, aux, jcfg)
    j_in = _inputs_jax(params, aux, 2048)
    jtab = gt.pack_pair_table(jgrid, j_in, jcfg.tile)
    jc = gt.collect_cells(jnp.asarray(ro), jnp.asarray(rd), jgrid, jcfg)
    jh = gt.select_hits_tiled(jnp.asarray(ro), jnp.asarray(rd), jgrid, jc,
                              jtab, jcfg, False)

    with torch.no_grad():
        tgrid = tgt.build_grid_from_gaussians(tp, ta, tcfg)
        t_in = _inputs_torch(tp, ta, 2048)
        ttab = tgt._pair_tab_from_geom(tgrid, tgt._pack_geom(t_in), tcfg.tile)
        tc = tgt.collect_cells(torch.tensor(ro), torch.tensor(rd), tgrid, tcfg)
        th = tgt.select_hits_tiled(torch.tensor(ro), torch.tensor(rd), tgrid,
                                   tc, ttab, tcfg, False)
    valid = np.asarray(jh.valid)
    assert valid.sum() >= 16
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    np.testing.assert_array_equal(np.where(valid, th.gs.numpy(), -1),
                                  np.where(valid, np.asarray(jh.gs), -1))
    np.testing.assert_array_equal(th.more.numpy(), np.asarray(jh.more))
    # the restart depths come out of the hit math on ru, rv that are ulps
    # apart (see the table test): as in test_torch_tracer.py
    np.testing.assert_allclose(th.t_last.numpy(), np.asarray(jh.t_last),
                               rtol=1e-6)
    np.testing.assert_allclose(th.t_cell.numpy(), np.asarray(jh.t_cell),
                               rtol=1e-6)
    np.testing.assert_array_equal(th.cand_skip.numpy(),
                                  np.asarray(jh.cand_skip))


def test_pair_table_rows_hold_the_reference_table(scene):
    """The port's [T, 11·tile] table holds the reference's tile rows (which
    pad each row to 128 lanes): the same 11 components, the cell ids as
    their raw bits."""
    params, aux, tp, ta, ro, rd = scene
    cfg_f = dict(grid_res=16, pair_capacity=2 ** 15, tile=16)
    jcfg, tcfg = gt.TracerConfig(**cfg_f), tgt.TracerConfig(**cfg_f)
    jgrid = gt.build_grid_from_gaussians(params, aux, jcfg)
    jtab = np.asarray(gt.pack_pair_table(jgrid, _inputs_jax(params, aux, 2048),
                                         16))
    with torch.no_grad():
        tgrid = tgt.build_grid_from_gaussians(tp, ta, tcfg)
        ttab = tgt._pair_tab_from_geom(
            tgrid, tgt._pack_geom(_inputs_torch(tp, ta, 2048)), 16).numpy()
    assert ttab.shape == (jtab.shape[0], 11 * 16)
    np.testing.assert_array_equal(ttab[:, 10 * 16:].view(np.int32),
                                  jtab[:, 10 * 16:11 * 16].view(np.int32))
    # ru, rv come from each package's own quaternion math: ulps apart
    np.testing.assert_allclose(ttab[:, :10 * 16], jtab[:, :10 * 16],
                               rtol=1e-5, atol=1e-5)


def test_gather_switch_keeps_values(scene):
    """pallas_gather is the JAX package's switch only: the port's select
    gives the same hits whatever its value."""
    _, _, tp, ta, ro, rd = scene
    cfg = tgt.TracerConfig(grid_res=16, pair_capacity=2 ** 15, max_cells=8,
                           select_tiles=8, tile=16, hit_budget=8,
                           max_crossings=12, tiled_direct=True)
    with torch.no_grad():
        grid = tgt.build_grid_from_gaussians(tp, ta, cfg)
        geom = tgt._pack_geom(_inputs_torch(tp, ta, 2048))
        tab = tgt._pair_tab_from_geom(grid, geom, cfg.tile)
        cells = tgt.collect_cells(torch.tensor(ro), torch.tensor(rd), grid, cfg)
        a = tgt.select_hits_tiled(torch.tensor(ro), torch.tensor(rd), grid,
                                  cells, tab, cfg, False)
        b = tgt.select_hits_tiled(torch.tensor(ro), torch.tensor(rd), grid,
                                  cells, tab,
                                  dataclasses.replace(cfg, pallas_gather=8),
                                  False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
