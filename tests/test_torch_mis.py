"""The port's light sampling (scene/envlight.py) and the MIS branch of
render/ir.py:rendering_equation against the JAX package's, with JAX's own
draws fed in; and the port's sampler (an inverse CDF on hash uniforms) on
its own: a chi-square test against the pdf, zero-pdf texels never drawn, a
pixel's draws independent of its batch slot.

Inputs come from numpy seeds. Tolerances: directions and pdfs rtol 1e-5 /
atol 1e-6 (float32 trig of the same expressions); the shaded outputs of the
rendering equation rtol 1e-4 / atol 1e-6 (sums of S samples).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.render import ir as jir
from irgs_tpu.scene import envlight as jenv
from irgs_tpu_torch.render import ir as tir
from irgs_tpu_torch.scene import envlight as tenv
from irgs_tpu_torch.utils import rng as trng

DIR_TOL = dict(rtol=1e-5, atol=1e-6)
SHADE_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors while the
    module runs: the test runner's parallel workers otherwise each spin a
    thread per core over ops of a few thousand elements."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_light_draws(jpdf, sample_num, key=None, pixel_ids=None, batch=None,
                    training=False):
    """JAX's texel indices [B, S] and jitter [B, S, 2] (or None), drawn as
    irgs_tpu.scene.envlight.sample_light_dirs draws them (:134-155)."""
    logits = jnp.log(jnp.maximum(jpdf.reshape(-1), 1e-30))
    key = jax.random.PRNGKey(0) if key is None else key
    jit = None
    if pixel_ids is not None:
        pids = jnp.asarray(pixel_ids, jnp.int32)
        keys = jax.vmap(lambda p: jax.random.fold_in(key, p))(pids)
        idx = jax.vmap(lambda k: jax.random.categorical(
            k, logits, shape=(sample_num,)))(keys)
        if training:
            jk = jax.vmap(lambda p: jax.random.fold_in(key, p + (1 << 24)))(pids)
            jit = jax.vmap(lambda k: jax.random.uniform(k, (sample_num, 2)))(jk)
    else:
        idx = jax.random.categorical(key, logits, shape=(batch * sample_num,))
        idx = idx.reshape(batch, sample_num)
        if training:
            k1, k2 = jax.random.split(jax.random.fold_in(key, 1))
            jit = jnp.stack([jax.random.uniform(k1, (batch * sample_num,)),
                             jax.random.uniform(k2, (batch * sample_num,))],
                            -1).reshape(batch, sample_num, 2)
    return tenv.LightDraws(
        torch.tensor(np.asarray(idx), dtype=torch.int64),
        None if jit is None else torch.tensor(np.asarray(jit)))


def _env(seed=0, h=16, w=32):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.0, (h, w, 3)).astype(np.float32)


def _dirs(seed, n):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


TRANSFORM = np.array([[0, -1, 0], [0, 0, 1], [-1, 0, 0]], np.float32)


@pytest.mark.parametrize("transform", [False, True])
def test_light_pdf_matches_jax(transform):
    env = _env(1)
    tf = TRANSFORM if transform else None
    jpdf = jenv.build_pdf(jnp.asarray(env))
    tpdf = tenv.build_pdf(torch.tensor(env))
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), **DIR_TOL)
    dirs = _dirs(2, 4 * 64).reshape(4, 64, 3)
    want = jenv.light_pdf(jpdf, jnp.asarray(dirs),
                          transform=None if tf is None else jnp.asarray(tf))
    got = tenv.light_pdf(torch.tensor(np.asarray(jpdf)), torch.tensor(dirs),
                         transform=None if tf is None else torch.tensor(tf))
    assert got.shape == (4, 64, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DIR_TOL)


def test_texel_dirs_match_jax():
    rng = np.random.default_rng(3)
    gx = rng.uniform(-1, 1, 500).astype(np.float32)
    gy = rng.uniform(0, 1, 500).astype(np.float32)
    np.testing.assert_allclose(
        tenv._texel_to_dir(torch.tensor(gx), torch.tensor(gy)).numpy(),
        np.asarray(jenv._texel_to_dir(jnp.asarray(gx), jnp.asarray(gy))),
        **DIR_TOL)
    np.testing.assert_allclose(tenv.env_image_dirs(8, 16).numpy(),
                               np.asarray(jenv.env_image_dirs(8, 16)), **DIR_TOL)


def test_init_direct_light_shape_and_range():
    g = torch.Generator().manual_seed(0)
    env = tenv.init_direct_light(g, max_res=16, init_value=0.5)
    j = jenv.init_direct_light(jax.random.PRNGKey(0), 16, 0.5)
    assert env.shape == j.shape == (16, 32, 3)
    assert float(env.min()) >= 0.0 and float(env.max()) <= 0.5


@pytest.mark.parametrize("mode", ["pixel_ids", "pixel_ids_train", "batch_train"])
def test_sample_light_dirs_with_jax_draws(mode):
    """JAX's texel indices and jitter into the port's sample_light_dirs give
    JAX's directions and pdfs."""
    env = _env(4)
    tf = jnp.asarray(TRANSFORM)
    jpdf = jenv.build_pdf(jnp.asarray(env))
    key = jax.random.PRNGKey(7)
    training = mode != "pixel_ids"
    pids = np.array([5, 17, 3, 900, 42], np.int32)
    if mode == "batch_train":
        want = jenv.sample_light_dirs(key, jpdf, 5, 16, True, transform=tf)
        draws = jax_light_draws(jpdf, 16, key, batch=5, training=True)
    else:
        want = jenv.sample_light_dirs(key, jpdf, 5, 16, training, transform=tf,
                                      pixel_ids=jnp.asarray(pids))
        draws = jax_light_draws(jpdf, 16, key, pixel_ids=pids,
                                training=training)
    dirs, prob = tenv.sample_light_dirs(torch.tensor(np.asarray(jpdf)), draws,
                                        transform=torch.tensor(TRANSFORM))
    np.testing.assert_allclose(dirs.numpy(), np.asarray(want[0]), **DIR_TOL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want[1]), **DIR_TOL)


class _Trace(NamedTuple):
    alpha: object
    color: object
    normal: object
    feature: object


def synthetic_trace(xp, sigmoid, rays_o, rays_d):
    """A smooth stand-in for the tracer, written once for both packages:
    opacity, radiance, normal and premultiplied materials of the ray's hit
    as functions of the ray."""
    a = sigmoid(3.0 * (rays_d[..., 0] - 0.5 * rays_d[..., 2]) + rays_o[..., 1])
    alpha = 0.9 * a
    color = 0.5 + 0.5 * xp.sin(3.0 * rays_d + rays_o)
    n = rays_d + 0.3
    normal = n / xp.sqrt(xp.sum(n * n, -1, keepdims=True))
    base = 0.2 + 0.6 * sigmoid(2.0 * rays_d)
    rough = 0.1 + 0.8 * sigmoid(rays_o[..., :1] - rays_d[..., 1:2])
    mats = xp.concatenate([base, rough], -1) if xp is jnp else \
        torch.cat([base, rough], -1)
    return _Trace(alpha, color, normal, mats * alpha[..., None])


def jax_trace(o, d):
    return synthetic_trace(jnp, jax.nn.sigmoid, o, d)


def torch_trace(o, d):
    return synthetic_trace(torch, torch.sigmoid, o, d)


def shading_inputs(seed, b):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(size=s).astype(np.float32)
    normals = _dirs(seed + 1, b)
    views = _dirs(seed + 2, b)
    return dict(base=0.1 + 0.8 * f(b, 3), rough=0.1 + 0.8 * f(b, 1),
                normal=normals, pos=f(b, 3) - 0.5,
                wo=np.where(np.sum(views * normals, -1, keepdims=True) < 0,
                            -views, views).astype(np.float32))


@pytest.mark.parametrize("training", [False, True])
def test_mis_rendering_equation_matches_jax(training):
    """The MIS branch (16 + 8 samples, env_transform) with JAX's draws:
    at eval keyed by pixel id with PRNGKey(0), in training from
    split(key) into the hemisphere rotation and the batch draws."""
    b, s_d, s_l = 24, 16, 8
    x = shading_inputs(5, b)
    env = _env(6)
    jpdf = jenv.build_pdf(jnp.asarray(env))
    key = jax.random.PRNGKey(11) if training else None
    pids = np.arange(100, 100 + b, dtype=np.int32)
    jcfg = jir.ShadeConfig(diffuse_sample_num=s_d, light_sample_num=s_l,
                           training=training)
    tcfg = tir.ShadeConfig(diffuse_sample_num=s_d, light_sample_num=s_l,
                           training=training)
    J = {k: jnp.asarray(v) for k, v in x.items()}
    want = jir.rendering_equation(
        J["base"], J["rough"], J["normal"], J["pos"], J["wo"], jnp.asarray(env),
        jpdf, jax_trace, jcfg, key=key, env_transform=jnp.asarray(TRANSFORM),
        pixel_ids=None if training else jnp.asarray(pids))
    theta_u = None
    if training:
        kd, kl = jax.random.split(key)
        theta_u = torch.tensor(np.asarray(jax.random.uniform(kd, (b, 1))))
        draws = jax_light_draws(jpdf, s_l, kl, batch=b, training=True)
    else:
        draws = jax_light_draws(jpdf, s_l, pixel_ids=pids)
    T = {k: torch.tensor(v) for k, v in x.items()}
    got = tir.rendering_equation(
        T["base"], T["rough"], T["normal"], T["pos"], T["wo"], torch.tensor(env),
        torch.tensor(np.asarray(jpdf)), torch_trace, tcfg, theta_u=theta_u,
        env_transform=torch.tensor(TRANSFORM), pixel_ids=torch.tensor(pids),
        light_draws=draws)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **SHADE_TOL)


def test_mis_rendering_equation_draws_itself():
    """Without injected draws the branch keys the sampler by pixel id: the
    result equals the one given draw_light's draws explicitly."""
    b = 12
    x = {k: torch.tensor(v) for k, v in shading_inputs(8, b).items()}
    env = torch.tensor(_env(9))
    pdf = tenv.build_pdf(env)
    cfg = tir.ShadeConfig(diffuse_sample_num=8, light_sample_num=8,
                          training=False)
    pids = torch.arange(40, 40 + b)
    args = (x["base"], x["rough"], x["normal"], x["pos"], x["wo"], env, pdf,
            torch_trace, cfg)
    a = tir.rendering_equation(*args, pixel_ids=pids)
    b_ = tir.rendering_equation(*args, pixel_ids=pids,
                                light_draws=tenv.draw_light(pdf, pids, 8))
    for k in a:
        assert torch.equal(a[k], b_[k]), k


# ---------------------------------------------------------------------------
# the port's sampler on its own

def test_hash_is_a_pure_function_of_its_key():
    ids = torch.tensor([[0], [1], [2 ** 24 + 5]])
    s = torch.arange(4)[None]
    w = trng.hash_words(3, ids, s, 0)
    assert w.dtype == torch.int64 and int(w.min()) >= 0 and int(w.max()) < 2 ** 32
    assert torch.equal(w, trng.hash_words(3, ids, s, 0))
    assert not torch.equal(w, trng.hash_words(4, ids, s, 0))
    assert not torch.equal(w, trng.hash_words(3, ids, s, 1))
    u = trng.uniform53(0, torch.arange(1 << 16)[:, None], torch.arange(4)[None], 0)
    assert u.dtype == torch.float64 and 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.003


def test_sampler_chi_square_against_pdf():
    """2^20 draws from the pdf of a 32x64 blob env (max-radiance x sin θ):
    the texel counts pass a chi-square test against n·pdf at |z| < 4."""
    from irgs_tpu_torch.scene.toy import make_blob_env
    pdf = tenv.build_pdf(torch.tensor(make_blob_env(32, 64)))
    draws = tenv.draw_light(pdf, 1 << 12, 256, seed=1)
    assert draws.idx.shape == (1 << 12, 256) and draws.jitter is None
    assert abs(trng.chi_square_z(draws.idx, pdf)[0]) < 4.0


def test_sampler_never_draws_zero_pdf_texels():
    env = np.full((16, 32, 3), 0.5, np.float32)
    env[:, 10:20] = -1.0            # activation "none": max(0) -> pdf 0
    pdf = tenv.build_pdf(torch.tensor(env), activation="none")
    assert float(pdf.reshape(16, 32)[:, 10:20].abs().max()) == 0.0
    draws = tenv.draw_light(pdf, 4096, 64, seed=5, training=True)
    col = draws.idx % 32
    assert not bool(((col >= 10) & (col < 20)).any())
    assert float(draws.jitter.min()) >= 0.0 and float(draws.jitter.max()) < 1.0
    # an all-zero pdf draws uniformly, as JAX's equal logits do
    flat = tenv.draw_light(torch.zeros(8, 16), 2048, 64, seed=0)
    counts = np.bincount(flat.idx.reshape(-1).numpy(), minlength=128)
    assert counts.min() > 0.7 * counts.mean()


def test_sampler_draws_depend_on_pixel_id_not_slot():
    pdf = tenv.build_pdf(torch.tensor(_env(10)))
    ids = torch.tensor([7, 3, 1000, 42, 3])
    a = tenv.draw_light(pdf, ids, 32, seed=9, training=True)
    perm = torch.tensor([4, 2, 0, 3, 1])
    b = tenv.draw_light(pdf, ids[perm], 32, seed=9, training=True)
    assert torch.equal(a.idx[perm], b.idx)
    assert torch.equal(a.jitter[perm], b.jitter)
    assert torch.equal(a.idx[1], a.idx[4])           # same id, same draws
    one = tenv.draw_light(pdf, ids[2:3], 32, seed=9, training=True)
    assert torch.equal(one.idx[0], a.idx[2])
    other = tenv.draw_light(pdf, ids, 32, seed=10, training=True)
    assert not torch.equal(other.idx, a.idx)
