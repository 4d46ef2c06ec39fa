"""The port's densification, stage-1 reset ops and optimizer surgery
against the JAX package's (mirrors tests/test_train.py:113,326), on a
512-slot scene with 256 alive Gaussians and Adam moments from one update of
random gradients, mapped from optax's multi_transform state onto torch's
Adam (`optax_to_torch`).

densify_and_prune gets JAX's split draws (jax.random.normal of the split
keys): alive masks, every parameter and every Adam moment row equal (the
split positions through a 3x3 rotation product, and the children's log
scales, whose log rounds apart by an ulp between XLA and torch, within
1e-6); the step counts kept. add_densification_stats equal (the gradient norm within rtol
1e-6). The reset ops within rtol 1e-6 / atol 1e-7 (the sigmoid and its
inverse's log round apart by an ulp or two between XLA and torch; u·0.8 -
0.4 may fuse into one rounding in XLA), with JAX's uniforms fed to
dist_color and reset_base_color.
zero_moments zeroes exactly the groups the JAX surgery zeroes.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.config import stage1_config as jstage1_config
from irgs_tpu.scene import ref_gaussians as jrgs
from irgs_tpu.scene import toy as jtoy
from irgs_tpu.scene.gaussians import GaussianAux as JAux
from irgs_tpu.train import densify as jD
from irgs_tpu.train import stage1_full as js1
from irgs_tpu_torch.config import stage1_config
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.scene import ref_gaussians as trgs
from irgs_tpu_torch.train import densify as tD
from irgs_tpu_torch.train.optim import RefOptimizer

N = 512
MAX_NEW = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _adam_leaves(state):
    """The (count, mu, nu) of optax's Adam inside one group's state, or
    None for a group without (set_to_zero)."""
    for leaf in jax.tree.leaves(state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf.count, leaf.mu, leaf.nu
    return None


def optax_to_torch(opt_state) -> dict:
    """optax multi_transform inner Adam states -> {group: {exp_avg,
    exp_avg_sq, step}}, the state_dict layout of the port's optimizers."""
    out = {}
    for name, st in opt_state.inner_states.items():
        adam = _adam_leaves(st)
        if adam is not None:
            count, mu, nu = adam   # params-shaped, the group's field set
            out[name] = {"exp_avg": torch.tensor(np.asarray(getattr(mu, name))),
                         "exp_avg_sq": torch.tensor(
                             np.asarray(getattr(nu, name))),
                         "step": torch.tensor(float(count))}
    return out


def _scene():
    jp, ja = jtoy.make_sphere_scene(n_surface=256, n_capacity=N,
                                    env_resolution=16)
    rng = np.random.default_rng(11)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
    rp = jrgs.RefGaussianParams(
        xyz=jp.xyz, base_color=f32(rng.standard_normal((N, 3))),
        metallic=f32(rng.standard_normal((N, 1)) - 2.0),
        roughness=f32(rng.standard_normal((N, 1)) - 2.0),
        features_dc=jp.features_dc,
        features_rest=f32(0.05 * rng.standard_normal((N, 15, 3))),
        indirect_dc=f32(0.3 * rng.standard_normal((N, 1, 3))),
        indirect_rest=f32(0.05 * rng.standard_normal((N, 15, 3))),
        # scales either side of percent_dense·extent = 0.03: both clones
        # and splits
        scaling=f32(np.log(rng.uniform(0.005, 0.2, (N, 2)))),
        rotation=jp.rotation,
        opacity=f32(rng.standard_normal((N, 1))),
        env1=f32(rng.standard_normal((6, 8, 8, 3))),
        env2=f32(rng.standard_normal((6, 8, 8, 3))))
    optimizer = js1.make_ref_optimizer(jstage1_config().opt)
    opt_state = optimizer.init(rp)
    grads = jax.tree.map(
        lambda x: f32(rng.standard_normal(x.shape)), rp)
    _, opt_state = optimizer.update(grads, opt_state, rp)
    aux = JAux(alive=ja.alive,
               max_radii2d=f32(rng.uniform(0, 40, N)),
               xyz_gradient_accum=f32(rng.uniform(0, 2e-3, N)),
               denom=f32(rng.integers(1, 5, N)),
               active_sh_degree=jnp.int32(0))
    return rp, aux, opt_state


def _port(rp, aux, opt_state):
    fields = {f: np.asarray(getattr(rp, f)) for f in trgs.REF_FIELDS}
    tp, ta = tgs.params_from_numpy(fields, np.asarray(aux.alive), "cpu",
                                   cls=trgs.RefGaussianParams)
    ta = tgs.GaussianAux(ta.alive, 0,
                         torch.tensor(np.asarray(aux.max_radii2d)),
                         torch.tensor(np.asarray(aux.xyz_gradient_accum)),
                         torch.tensor(np.asarray(aux.denom)))
    opt = RefOptimizer(tp, stage1_config().opt)
    opt.load_state_dict(optax_to_torch(opt_state))
    return tp, ta, opt


def _assert_params(tp, jp, tol_fields=(), tol=1e-6):
    for f in trgs.REF_FIELDS:
        got, want = getattr(tp, f).detach().numpy(), np.asarray(getattr(jp, f))
        if tol_fields == "all":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=f)
        elif f in tol_fields:
            np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


def _assert_moments(opt, opt_state):
    want = optax_to_torch(opt_state)
    got = opt.state_dict()
    assert sorted(got) == sorted(want)
    for g in want:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got[g][k].cpu().float(), want[g][k].float()), \
                (g, k)


@pytest.mark.parametrize("max_screen_size", [0, 20])
def test_densify_and_prune_matches_jax(max_screen_size):
    rp, aux, opt_state = _scene()
    key = jax.random.PRNGKey(2)
    kw = dict(grad_threshold=2e-4, min_opacity=0.2, extent=3.0,
              max_screen_size=max_screen_size, percent_dense=0.01,
              max_new=MAX_NEW)
    jp2, ja2, jo2, jstats = jD.densify_and_prune(rp, aux, opt_state, key,
                                                 **kw)
    # JAX's split draws: one key split per child
    draws, k = [], key
    for _ in range(2):
        k, k1 = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(k1, (MAX_NEW, 3))))
    tp, ta, opt = _port(rp, aux, opt_state)
    ta2, tstats = tD.densify_and_prune(tp, ta, opt, **kw,
                                       split_normals=torch.tensor(
                                           np.stack(draws)))
    assert int(jstats["n_cloned"]) > 0 and int(jstats["n_split"]) > 0
    for k_ in ("n_alive", "n_cloned", "n_split"):
        assert tstats[k_] == int(jstats[k_]), k_
    np.testing.assert_array_equal(ta2.alive.numpy(), np.asarray(ja2.alive))
    _assert_params(tp, jp2, tol_fields=("xyz", "scaling"))
    _assert_moments(opt, jo2)
    for name in ("max_radii2d", "xyz_gradient_accum", "denom"):
        assert float(getattr(ta2, name).abs().sum()) == 0.0


def test_add_densification_stats_matches_jax():
    rp, aux, _ = _scene()
    rng = np.random.default_rng(3)
    g = rng.standard_normal((N, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 30, N).astype(np.int32)
    radii[::3] = 0
    ja2 = jD.add_densification_stats(aux, jnp.asarray(g), jnp.asarray(radii))
    _, ta, _ = _port(rp, aux, _scene()[2])
    tD.add_densification_stats(ta, torch.tensor(g), torch.tensor(radii))
    np.testing.assert_array_equal(ta.max_radii2d.numpy(),
                                  np.asarray(ja2.max_radii2d))
    np.testing.assert_array_equal(ta.denom.numpy(), np.asarray(ja2.denom))
    np.testing.assert_allclose(ta.xyz_gradient_accum.numpy(),
                               np.asarray(ja2.xyz_gradient_accum), rtol=1e-6)


def test_reset_ops_match_jax():
    rp, aux, _ = _scene()
    tp, _, _ = _port(rp, aux, _scene()[2])
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    u_dc = np.asarray(jax.random.uniform(k1, rp.features_dc.shape))
    u_bc = np.asarray(jax.random.uniform(k2, rp.base_color.shape))

    jp = jrgs.reset_opacity0(rp, aux.alive)
    trgs.reset_opacity0(tp, None)
    jp = jrgs.reset_metallic(jp, 0.3)
    trgs.reset_metallic(tp, 0.3)
    _assert_params(tp, jp, tol_fields="all")
    jp = jrgs.reset_opacity1(jp)
    trgs.reset_opacity1(tp)
    jp = jrgs.dist_color(jp, k1, metallic_thr=0.4)
    trgs.dist_color(tp, torch.tensor(u_dc), metallic_thr=0.4)
    jp = jrgs.reset_scale(jp, 0.2, 1.5, 0.3)
    trgs.reset_scale(tp, 0.2, 1.5, 0.3)
    _assert_params(tp, jp, tol_fields="all")
    # dist_color and reset_scale changed some Gaussians and kept others
    moved = np.abs(np.asarray(jp.features_dc) - np.asarray(rp.features_dc))
    assert 0 < (moved.max(axis=(1, 2)) > 0).sum() < N
    jp = jrgs.reset_base_color(jp, k2)
    trgs.reset_base_color(tp, torch.tensor(u_bc))
    jp = jrgs.reset_metallic_full(jp, 0.01)
    trgs.reset_metallic_full(tp, 0.01)
    jp = jrgs.reset_roughness(jp, 0.1)
    trgs.reset_roughness(tp, 0.1)
    jp = jrgs.reset_features_rest(jp)
    trgs.reset_features_rest(tp)
    _assert_params(tp, jp, tol_fields="all")


def test_zero_moments_matches_jax_surgery():
    rp, aux, opt_state = _scene()
    tp, _, opt = _port(rp, aux, opt_state)
    names = ("opacity", "metallic", "features_dc")
    jo = jrgs.zero_adam_moments(opt_state, names, N)
    opt.zero_moments(names)
    _assert_moments(opt, jo)
    for name in names:
        assert float(opt.moments(name)[1].abs().max()) == 0.0
    assert float(opt.moments("scaling")[1].abs().max()) > 0.0


def test_reset_opacity_matches_jax():
    rp, aux, opt_state = _scene()
    tp, _, opt = _port(rp, aux, opt_state)
    jp, jo = jD.reset_opacity(rp, opt_state, N, max_opacity=0.05)
    tD.reset_opacity(tp, opt, max_opacity=0.05)
    _assert_params(tp, jp, tol_fields="all")
    _assert_moments(opt, jo)
