"""The port's render/relight.py against the JAX package's: the prefiltered
environment, its three queries, the diffuse-trace cache and
`rendering_equation_relight` with JAX's light draws fed in (a synthetic
tracer written once for both packages, tests/test_torch_mis.py); then the
port on its own grid tracer: the cached path equal to the uncached one bit
for bit (as tests/test_train.py holds the JAX package's), and a second
envmap on the same cache.

Tolerances: the environment and its queries rtol 1e-4 / atol 1e-5 (sums
over Hammersley samples and texels, as tests/test_torch_cubemap.py); the
shaded outputs rtol 1e-4 / atol 1e-6 (means over S samples).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.render import ir as jir
from irgs_tpu.render import relight as jrl
from irgs_tpu.scene import cubemap as jcm
from irgs_tpu_torch.render import ir as tir
from irgs_tpu_torch.render import relight as trl
from irgs_tpu_torch.scene import cubemap as tcm
from test_torch_mis import (TRANSFORM, _dirs, jax_light_draws, jax_trace,  # noqa: F401
                            one_torch_thread, shading_inputs, torch_trace)

ENV_TOL = dict(rtol=1e-4, atol=1e-5)
SHADE_TOL = dict(rtol=1e-4, atol=1e-6)


def _hdr(seed=0, h=16, w=32):
    rng = np.random.default_rng(seed)
    hdr = np.exp(rng.normal(0.0, 1.0, (h, w, 3))).astype(np.float32)
    hdr[2:4, 5:8] *= 30.0                               # a sun
    return hdr


@pytest.fixture(scope="module")
def envs():
    hdr = _hdr()
    jenv_ = jrl.build_relight_env(jnp.asarray(hdr), jnp.asarray(TRANSFORM),
                                  max_res=32, min_res=8)
    tenv_ = trl.build_relight_env(torch.tensor(hdr), torch.tensor(TRANSFORM),
                                  max_res=32, min_res=8)
    # the JAX environment's own arrays in torch, so that the shading tests
    # see only the shading's differences
    tj = trl.RelightEnv(
        base=torch.tensor(np.asarray(jenv_.base)),
        pdf=torch.tensor(np.asarray(jenv_.pdf)),
        specular_mips=tuple(torch.tensor(np.asarray(m))
                            for m in jenv_.specular_mips),
        diffuse=torch.tensor(np.asarray(jenv_.diffuse)),
        transform=torch.tensor(TRANSFORM), activation="none")
    return dict(j=jenv_, t=tenv_, tj=tj,
                lut_j=jcm.compute_fg_lut(16, 64),
                lut_t=tcm.compute_fg_lut(16, 64))


def test_build_relight_env_matches_jax(envs):
    j, t = envs["j"], envs["t"]
    assert t.activation == j.activation == "none"
    assert len(t.specular_mips) == len(j.specular_mips) == 3
    for a, b in zip(t.specular_mips, j.specular_mips):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ENV_TOL)
    np.testing.assert_allclose(t.diffuse.numpy(), np.asarray(j.diffuse),
                               **ENV_TOL)
    np.testing.assert_allclose(t.pdf.numpy(), np.asarray(j.pdf), **ENV_TOL)


@pytest.mark.parametrize("mode", ["pure_env", "diffuse", "specular"])
def test_env_query_matches_jax(envs, mode):
    d = _dirs(3, 600).reshape(20, 30, 3)
    rough = np.random.default_rng(4).uniform(0, 1, (20, 30, 1)).astype(np.float32)
    want = jrl.env_query(envs["j"], jnp.asarray(d), mode,
                         roughness=jnp.asarray(rough))
    got = trl.env_query(envs["tj"], torch.tensor(d), mode,
                        roughness=torch.tensor(rough))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ENV_TOL)


def test_trace_diffuse_cache_matches_jax():
    b = 16
    x = shading_inputs(20, b)
    cfg_j = jir.ShadeConfig(diffuse_sample_num=8, training=False)
    cfg_t = tir.ShadeConfig(diffuse_sample_num=8, training=False)
    want = jrl.trace_diffuse_cache(jnp.asarray(x["normal"]),
                                   jnp.asarray(x["pos"]), jax_trace, cfg_j)
    got = trl.trace_diffuse_cache(torch.tensor(x["normal"]),
                                  torch.tensor(x["pos"]), torch_trace, cfg_t)
    for f in trl.DiffuseTraceCache._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f,
                                   **SHADE_TOL)


@pytest.mark.parametrize("case", ["eval", "eval_cached", "eval_no_light",
                                  "train", "wo_indirect"])
def test_rendering_equation_relight_matches_jax(envs, case):
    """16 + 8 samples (8 + 0 for eval_no_light), the draws JAX makes: at
    eval keyed by pixel id with PRNGKey(0); in training from split(key)."""
    b = 24
    s_l = 0 if case == "eval_no_light" else 8
    training = case == "train"
    x = shading_inputs(21, b)
    cfg_j = jir.ShadeConfig(diffuse_sample_num=16, light_sample_num=s_l,
                            training=training)
    cfg_t = tir.ShadeConfig(diffuse_sample_num=16, light_sample_num=s_l,
                            training=training)
    pids = np.arange(300, 300 + b, dtype=np.int32)
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.tensor(v) for k, v in x.items()}
    key = jax.random.PRNGKey(5) if training else None
    kw_j = dict(key=key, pixel_ids=None if training else jnp.asarray(pids),
                wo_indirect_relight=case == "wo_indirect")
    kw_t = dict(pixel_ids=torch.tensor(pids),
                wo_indirect_relight=case == "wo_indirect")
    if case == "eval_cached":
        kw_j["diffuse_cache"] = jrl.trace_diffuse_cache(
            J["normal"], J["pos"], jax_trace, cfg_j)
        kw_t["diffuse_cache"] = trl.trace_diffuse_cache(
            T["normal"], T["pos"], torch_trace, cfg_t)
    if training:
        kd, kl = jax.random.split(key)
        kw_t["theta_u"] = torch.tensor(np.asarray(jax.random.uniform(kd, (b, 1))))
        kw_t["light_draws"] = jax_light_draws(envs["j"].pdf, s_l, kl, batch=b,
                                              training=True)
    elif s_l:
        kw_t["light_draws"] = jax_light_draws(envs["j"].pdf, s_l,
                                              pixel_ids=pids)
    want = jrl.rendering_equation_relight(
        J["base"], J["rough"], J["normal"], J["pos"], J["wo"], envs["j"],
        jax_trace, cfg_j, envs["lut_j"], **kw_j)
    got = trl.rendering_equation_relight(
        T["base"], T["rough"], T["normal"], T["pos"], T["wo"], envs["tj"],
        torch_trace, cfg_t, torch.tensor(np.asarray(envs["lut_j"])), **kw_t)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **SHADE_TOL)


def test_relight_cache_is_the_uncached_path_on_the_grid_tracer(envs):
    """On the port's grid tracer (the toy sphere, 512 surfels) the cached
    path equals the uncached one bit for bit, and a second envmap on the
    same cache stays finite (≙ tests/test_train.py:178-215)."""
    from irgs_tpu_torch.ops import grid_tracer as tgt
    from irgs_tpu_torch.scene import toy
    params, aux = toy.make_sphere_scene(512, n_capacity=1024,
                                        env_resolution=16, device="cpu")
    # one segment, as that test's tracer: the re-trace rounds' capacity is a
    # share of the batch, so with them a ray's hits depend on its batch
    tracer = tgt.TracerConfig(grid_res=12, pair_capacity=2 ** 13,
                              max_cells=8, max_hits=24, select_tiles=4,
                              tile=32, tiled_direct=True)
    grid = tgt.build_grid_from_gaussians(params, aux, tracer)
    tf = tir.make_trace_fn(params, aux, grid, tracer, torch.zeros(3), 3,
                           with_materials=True)
    b = 64
    normals = params.xyz[:b].detach() / params.xyz[:b].detach().norm(
        dim=-1, keepdim=True)
    pts = params.xyz[:b].detach()
    cfg = tir.ShadeConfig(diffuse_sample_num=8, light_sample_num=4,
                          training=False)
    args = (torch.full((b, 3), 0.5), torch.full((b, 1), 0.5), normals, pts,
            normals)
    pids = torch.arange(b)
    with torch.no_grad():
        out = trl.rendering_equation_relight(*args, envs["t"], tf, cfg,
                                             envs["lut_t"], pixel_ids=pids)
        cache = trl.trace_diffuse_cache(normals, pts, tf, cfg)
        out_c = trl.rendering_equation_relight(*args, envs["t"], tf, cfg,
                                               envs["lut_t"], pixel_ids=pids,
                                               diffuse_cache=cache)
        env2 = trl.build_relight_env(envs["t"].base * 0.3 + 0.1, max_res=16,
                                     min_res=8)
        out2 = trl.rendering_equation_relight(*args, env2, tf, cfg,
                                              envs["lut_t"], pixel_ids=pids,
                                              diffuse_cache=cache)
    for k in out:
        assert torch.isfinite(out[k]).all(), k
        assert torch.equal(out_c[k], out[k]), k
        assert torch.isfinite(out2[k]).all(), k
    assert float(out["light_direct"].mean()) > 0
    assert float(out["visibility"].min()) < 1.0        # the sphere occludes
    assert not math.isclose(float(out2["diffuse"].mean()),
                            float(out["diffuse"].mean()))
