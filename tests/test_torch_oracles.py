"""The JAX package's small analytic oracles, held against the port: the MC
white furnace of tests/test_envlight.py:59-69 through the port's
fibonacci_sphere_sampling, and the cubemap prefilters of
tests/test_golden.py:298-346 against the reference CUDA kernels' formulas
re-derived in numpy (renderutils c_src/cubemap.cu DiffuseCubemapFwdKernel
:110-139, SpecularCubemapFwdKernel :248-300), with the same bounds."""

import numpy as np
import pytest
import torch

from irgs_tpu_torch.render.sampling import fibonacci_sphere_sampling
from irgs_tpu_torch.scene import cubemap as cm


def test_mc_white_furnace():
    """Uniform radiance 1: mean(L·area·cosθ/π) over 4096 hemisphere samples
    is 1.030, the bias of the reference's z clamp at sin(10°)
    (graphics_utils.py:27), reproduced exactly."""
    normals = torch.tensor([[0.0, 0.0, 1.0]])
    dirs, areas = fibonacci_sphere_sampling(normals, 4096)
    cos = torch.clamp(torch.sum(dirs * normals[:, None], -1, keepdim=True),
                      min=0.0)
    est = float(torch.mean(1.0 * areas * cos / np.pi))
    assert abs(est - 1.030) < 0.005, est


def _smooth_cube(res, seed=0):
    """A smooth positive envmap: a low-order function of direction."""
    rng = np.random.RandomState(seed)
    dirs = cm._face_dirs(res).numpy()                    # [6, R, R, 3]
    a = rng.uniform(0.2, 1.0, (3, 3))
    val = np.stack([np.maximum(dirs @ a[c], 0.05) for c in range(3)], axis=-1)
    return torch.tensor(val, dtype=torch.float32)


def _texels(res):
    return (cm._face_dirs(res).numpy().reshape(-1, 3),
            cm._texel_solid_angles(res).numpy().reshape(-1))


def test_diffuse_cubemap_matches_cuda_formula():
    res = 16
    cube = _smooth_cube(res)
    dirs, area = _texels(res)
    L = cube.numpy().reshape(-1, 3)
    # out(N) = Σ L·clip(N·ω, 0, .999)·A/π
    cos = np.clip(dirs @ dirs.T, 0.0, 0.999)
    oracle = (cos * area[None]) @ L / np.pi
    ours = cm.diffuse_cubemap(cube).numpy().reshape(-1, 3)
    rel = np.abs(ours - oracle) / np.abs(oracle).mean()
    assert rel.max() < 5e-3, f"diffuse prefilter rel err {rel.max()}"


@pytest.mark.parametrize("roughness", [0.4, 0.8])
def test_specular_cubemap_matches_cuda_formula(roughness):
    res = 16
    cube = _smooth_cube(res, seed=1)
    dirs, area = _texels(res)
    L = cube.numpy().reshape(-1, 3)
    # w = max(L·VNR, 0)·ndfGGX(α², VNR·H)·A/4, out = Σ L·w / Σ w; the
    # cutoff is ignored (its bound keeps 99 % of the NDF energy)
    alpha_sqr = roughness ** 4
    h = dirs[None] + dirs[:, None]                       # [out, src, 3]
    h /= np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    vnr_h = np.clip((dirs[:, None] * h).sum(-1), 0.0, 1.0)
    d = (vnr_h * alpha_sqr - vnr_h) * vnr_h + 1.0
    ndf = alpha_sqr / (d * d * np.pi)
    w = np.maximum(dirs @ dirs.T, 0.0) * ndf * area[None] / 4.0
    oracle = (w @ L) / np.maximum(w.sum(-1, keepdims=True), 1e-12)
    ours = cm.specular_cubemap(cube, roughness, samples=2048).numpy()
    rel = np.abs(ours.reshape(-1, 3) - oracle) / np.abs(oracle).mean()
    # the port's is the Hammersley split-sum estimator of the same
    # integral: it agrees up to MC error and the NDF lobe's texelization
    assert rel.mean() < 0.02, f"specular prefilter mean rel err {rel.mean()}"
    assert rel.max() < 0.10, f"specular prefilter max rel err {rel.max()}"
