"""The port's initialisation from a point cloud against the JAX package's:
the brute-force kNN (ops/knn.py) within rtol 1e-5 plus an absolute
knn_atol = 4·eps·max|p|² (the expansion |a|² + |b|² - 2a·b cancels to the
distance, so its rounding is absolute in |a|², and XLA fuses the chunk's
expression in its own order: 1.3e-6 at most on the randn cloud below,
where max|p|² ≈ 17), the ctypes loader of the unchanged
native/irgs_native.cpp (the Morton-window kNN, bit for bit with the JAX
loader's, from the same source) and create_from_pcd below and above 50k
points, where the native search takes over. Mirrors tests/test_native.py.

create_from_pcd is compared exactly, field by field, except for the four
fields that hold one constant each (base colour, metallic, roughness,
opacity: the inverse sigmoid of an init value, whose log rounds apart by an
ulp between XLA and torch), held to 1 ulp; below 50k points the JAX kNN is
passed to both, so that the scales compare exactly too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from irgs_tpu.ops import knn as jknn
from irgs_tpu.scene import gaussians as jgs
from irgs_tpu.utils import native as jnative
from irgs_tpu_torch.ops import knn as tknn
from irgs_tpu_torch.scene import gaussians as tgs
from irgs_tpu_torch.utils import native as tnative

CONST_FIELDS = ("base_color", "metallic", "roughness", "opacity")


def knn_atol(pts):
    return 4 * np.finfo(np.float32).eps * float((pts ** 2).sum(-1).max())


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mean_knn_dist2_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.randn(3000, 3).astype(np.float32)
    pts[7] = pts[3]                       # a duplicate: distance 0 counts
    want = np.asarray(jknn.mean_knn_dist2(jnp.asarray(pts)))
    got = tknn.mean_knn_dist2(torch.tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=knn_atol(pts))
    assert got.shape == (3000,) and (got >= 0).all()


def test_native_knn_is_the_jax_loaders():
    if not jnative.available():
        pytest.skip("g++ toolchain unavailable")
    rng = np.random.RandomState(0)
    pts = rng.randn(2000, 3).astype(np.float32)
    want = jnative.mean_knn_dist2_native(pts, k=3, window=64)
    got = tnative.mean_knn_dist2_native(pts, k=3, window=64)
    np.testing.assert_array_equal(got, want)
    lib = tnative.build()
    assert lib.parent == tnative.BUILD_DIR and lib.name.endswith(".so")


def _assert_init_equal(tp, ta, jp, ja):
    for f in tgs.PARAM_FIELDS:
        got, want = getattr(tp, f).numpy(), np.asarray(getattr(jp, f))
        if f in CONST_FIELDS:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(ta.alive.numpy(), np.asarray(ja.alive))


def test_create_from_pcd_below_50k_matches_jax():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (3000, 3)).astype(np.float32)
    knn = np.asarray(jknn.mean_knn_dist2(jnp.asarray(pts)))
    jp, ja = jgs.create_from_pcd(pts, cols, 4096, env_resolution=16,
                                 knn_dist2=knn)
    tp, ta = tgs.create_from_pcd(pts, cols, 4096, env_resolution=16,
                                 knn_dist2=knn, device="cpu")
    _assert_init_equal(tp, ta, jp, ja)
    # and with the port's own kNN: the scales within the kNN's tolerance
    tp2, _ = tgs.create_from_pcd(pts, cols, 4096, env_resolution=16,
                                 device="cpu")
    np.testing.assert_allclose(np.exp(2 * tp2.scaling.numpy())[:3000],
                               np.exp(2 * np.asarray(jp.scaling))[:3000],
                               rtol=1e-5, atol=knn_atol(pts))
    assert ta.n_alive == 3000 and float(ta.denom.abs().sum()) == 0.0


def test_create_from_pcd_above_50k_takes_native_knn():
    if not jnative.available():
        pytest.skip("g++ toolchain unavailable")
    rng = np.random.RandomState(2)
    pts = rng.rand(60_000, 3).astype(np.float32)
    cols = np.full((60_000, 3), 0.5, np.float32)
    jp, ja = jgs.create_from_pcd(pts, cols, n_capacity=65536,
                                 env_resolution=16)
    tp, ta = tgs.create_from_pcd(pts, cols, n_capacity=65536,
                                 env_resolution=16, device="cpu")
    _assert_init_equal(tp, ta, jp, ja)
    assert ta.n_alive == 60_000


def test_create_from_pcd_refuses_overfull_capacity():
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match="capacity 8"):
        tgs.create_from_pcd(pts, pts + 0.5, 8, device="cpu")
