"""The port's RayBank (irgs_tpu_torch/scene/raybank.py) against the JAX
package's on the ring cameras of a small scene: the bank's rays and
colours, and the batches drawn from the same RandomState, equal JAX's."""

import numpy as np
import pytest

from irgs_tpu.scene import cameras as jcams
from irgs_tpu.scene import raybank as jrb
from irgs_tpu.scene import toy
from irgs_tpu_torch.scene import cameras as tcams
from irgs_tpu_torch.scene import raybank as trb


def _cams(mod, n=3, res=(20, 12), k=False):
    rng = np.random.RandomState(0)
    out = []
    for i, ring in enumerate(toy.make_ring_cameras(n, width=res[0],
                                                   height_px=res[1])):
        K = None
        if k:
            f = res[0] / (2 * np.tan(ring.fovx / 2))
            K = np.array([[f, 0, res[0] / 2 + 3], [0, f, res[1] / 2 - 2],
                          [0, 0, 1]], np.float32)
        img = rng.uniform(size=(res[1], res[0], 3)).astype(np.float32)
        out.append(mod.Camera(i, ring.R, ring.T, fovx=ring.fovx,
                              fovy=ring.fovy, image=img, K=K))
    return out


@pytest.mark.parametrize("k", [False, True], ids=["fov", "K"])
def test_bank_matches_jax(k):
    j = jrb.RayBank(_cams(jcams, k=k), batch_size=64)
    t = trb.RayBank(_cams(tcams, k=k), batch_size=64, device="cpu")
    assert len(t) == len(j) == 3 * 20 * 12
    np.testing.assert_array_equal(t.rays_o, j.rays_o)
    np.testing.assert_allclose(t.rays_d, j.rays_d, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.rays_rgb, j.rays_rgb)


@pytest.mark.parametrize("seed", [None, 7])
def test_batches_match_jax(seed):
    j = jrb.RayBank(_cams(jcams), batch_size=100)
    t = trb.RayBank(_cams(tcams), batch_size=100, device="cpu")
    for _ in range(3):
        jr = None if seed is None else np.random.RandomState(seed)
        tr = None if seed is None else np.random.RandomState(seed)
        jb, tb = j.get_batch_rays(jr), t.get_batch_rays(tr)
        for a, b in zip(jb, tb):
            assert tuple(b.shape) == (100, 3) and b.device.type == "cpu"
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=0)
