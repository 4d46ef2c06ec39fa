"""The port's hand-written CUDA kernels against their plain PyTorch version.

This file imports no JAX, so that it also runs on a machine with a CUDA card
and no JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels.py

The kernel cases carry the `cuda` marker and skip where there is no card;
the rasterizer on the card is held against the same call on the CPU (which
takes the plain blend), on the 48-surfel, 32x32, S = 4 scene of
tests/test_torch_raster.py; the row gather is held bit for bit against
``table[idx]``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from irgs_tpu_torch.ops import gather_rows as gr
from irgs_tpu_torch.ops import raster_blend as rb
from irgs_tpu_torch.ops import surfel_raster as sr
from irgs_tpu_torch.scene.cameras import Camera

W = H = 32
DUP = 2 ** 12
S = 4
FWD_TOL = dict(atol=5e-5, rtol=1e-4)
GRAD_REL = 5e-4  # x max|g|, as the JAX parity tests
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_scene(seed=5, n=48, s=S):
    rng = np.random.default_rng(seed)
    arrs = (rng.uniform(-1.0, 1.0, (n, 3)),
            np.exp(rng.uniform(-3.0, -1.5, (n, 2))),
            rng.standard_normal((n, 4)),
            1.0 / (1.0 + np.exp(-(rng.standard_normal((n, 1)) + 1.0))),
            0.3 * rng.standard_normal((n, 16, 3)),
            rng.uniform(size=(n, s)))
    return tuple(torch.tensor(a.astype(np.float32)) for a in arrs)


def camera_params(dev):
    cam = Camera(0, np.eye(3), np.array([0.0, 0.0, 4.0]), fovx=0.8, fovy=0.8,
                 width=W, height=H)
    return cam.params(dev)


def slab(dev):
    means, scales, quats, opac, shs, feats = (x.to(dev) for x in make_scene())
    with torch.no_grad():
        prep = sr.preprocess(means, scales, quats, opac, shs,
                             camera_params(dev), W, H, 2)
        binning = sr.bin_and_sort(prep, 2, 2, DUP)
        return sr.build_slab(prep, binning, feats, 2, 4, DUP)


@pytest.fixture
def cuda_device():
    """The kernels run on the card only: skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the blend kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_blend_kernels_match_plain(cuda_device):
    splat, starts, counts = slab(cuda_device)
    rb.reset_launches()
    out_k = rb.blend_fwd_cuda(splat, starts, counts, 2, 4, S)
    out_p = rb.blend_tiles_plain(splat, starts, counts, 2, 4, S)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert float(out_k[..., rb.n_attr(S) + 2].max()) > 0.2
    cot = torch.randn(out_k.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    cot[..., rb.c_out(S) - 2] = 0.0   # med_ord is an index
    d_k = rb.blend_bwd_cuda(splat, starts, counts, out_k, cot, 2, 4, S)
    d_k2 = rb.blend_bwd_cuda(splat, starts, counts, out_k, cot, 2, 4, S)
    assert torch.equal(d_k, d_k2)   # fixed-order reduction, no atomics
    sp = splat.clone().requires_grad_(True)
    (d_p,) = torch.autograd.grad(
        rb.blend_tiles_plain(sp, starts, counts, 2, 4, S), sp, cot)
    torch.testing.assert_close(d_k, d_p, rtol=0,
                               atol=GRAD_REL * float(d_p.abs().max()))
    assert rb.LAUNCHES == {"blend_fwd": 1, "blend_bwd": 2}


@pytest.mark.cuda
def test_rasterize_on_card_matches_cpu(cuda_device):
    """The whole rasterizer through BlendTiles on the card, values and the
    gradients of all six inputs, against the CPU path."""
    bg = torch.tensor([0.2, 0.1, 0.4])
    outs, grads = {}, {}
    for dev in ("cpu", cuda_device):
        leaves = [x.to(dev).requires_grad_(True) for x in make_scene()]
        out = sr.rasterize(*leaves, None, camera_params(dev), bg.to(dev),
                           img_w=W, img_h=H, active_sh_degree=2,
                           dup_capacity=DUP)
        loss = (out.color.sum() + out.feature.mean() + out.normal.mean()
                + 0.1 * out.distortion.mean() + 0.01 * out.depth.mean()
                + 0.01 * out.depth_median.mean())
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        outs[str(dev)] = out
    dev = str(cuda_device)
    for name in ("color", "feature", "alpha", "depth", "depth2",
                 "depth_median", "normal", "distortion"):
        torch.testing.assert_close(getattr(outs[dev], name).detach().cpu(),
                                   getattr(outs["cpu"], name).detach(),
                                   **FWD_TOL)
    for g_k, g_p in zip(grads[dev], grads["cpu"]):
        torch.testing.assert_close(g_k, g_p, rtol=0,
                                   atol=GRAD_REL * float(g_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(513, 224), (64, 896), (2048, 56),
                                   (1000, 1), (1000, 3), (300, 6), (77, 352)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_kernel_matches_plain(cuda_device, shape, dtype):
    """Every width class of the kernel: 16-byte rows (W % 4 == 0), word
    rows (W = 1, 3, 6), narrow and wide; out-of-order and repeated indices.
    A copy, so bit for bit."""
    T, W = shape
    g = torch.Generator(cuda_device).manual_seed(W)
    tab = torch.randn((T, W), device=cuda_device, generator=g)
    if dtype == torch.int32:
        tab = tab.view(torch.int32)
    idx = torch.randint(0, T, (3 * T + 7,), device=cuda_device, generator=g)
    gr.reset_launches()
    out = gr.gather_rows(tab, idx)
    assert out.dtype == dtype and out.shape == (idx.shape[0], W)
    assert torch.equal(out.view(torch.int32), tab[idx].view(torch.int32))
    assert gr.LAUNCHES["gather_rows"] == 1
    # an offset view: a table that is not 16-byte aligned takes word copies
    sub = tab.reshape(-1)[1:1 + (T - 1) * W].reshape(T - 1, W)
    assert torch.equal(gr.gather_rows(sub, idx % (T - 1)), sub[idx % (T - 1)])


@pytest.mark.cuda
def test_gather_kernel_rejects_bad_inputs(cuda_device):
    tab = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(ValueError, match="int64"):
        gr.gather_rows(tab, torch.zeros(3, dtype=torch.int32,
                                        device=cuda_device))
    with pytest.raises(ValueError, match="float32 or int32"):
        gr.gather_rows(tab.double(), torch.zeros(3, dtype=torch.long,
                                                 device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        gr.gather_rows(tab.T, torch.zeros(3, dtype=torch.long,
                                          device=cuda_device))


def test_gather_rows_cpu_takes_plain():
    tab = torch.arange(40.0).reshape(10, 4)
    idx = torch.tensor([3, 3, 9, 0, 7])
    gr.reset_launches()
    assert torch.equal(gr.gather_rows(tab, idx), tab[idx])
    assert gr.LAUNCHES["gather_rows"] == 0


def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX or the JAX
    package (whose __init__ imports JAX and sets its global config)."""
    code = (
        "import pkgutil, importlib, sys, irgs_tpu_torch\n"
        "for m in pkgutil.walk_packages(irgs_tpu_torch.__path__, "
        "'irgs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'irgs_tpu' or m.startswith('irgs_tpu.')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: without a device argument the entry points
    run on the card, and raise where there is none."""
    from irgs_tpu_torch.scene import toy
    cam = toy.make_ring_cameras(2, width=16, height_px=16)[0]
    make = lambda: toy.make_sphere_scene(64, n_capacity=128, env_resolution=8)
    if torch.cuda.is_available():
        assert make()[0].xyz.device.type == "cuda"
        assert cam.params().w2c.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cam.params()
    params, aux = toy.make_sphere_scene(64, n_capacity=128, env_resolution=8,
                                        device="cpu")
    assert params.xyz.device.type == "cpu" and aux.alive.device.type == "cpu"


def test_eval_entry_points_default_to_cuda():
    """eval_setup runs on the card unless asked for the CPU, and
    render_ir_eval renders on the device of the scene it is given."""
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.render.eval import render_ir_eval
    tiny = dict(n_surface=64, n_capacity=128, img=16, diffuse=4, light=0,
                pallas_gather=8, tracer=dict(grid_res=8, pair_capacity=2 ** 12),
                dup_capacity=2 ** 12)
    if torch.cuda.is_available():
        params, aux, grid, cam, ecfg = workload.eval_setup(**tiny)
        assert params.xyz.device.type == "cuda"
        out = render_ir_eval(params, aux, grid, cam, ecfg)
        assert out["render"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            workload.eval_setup(**tiny)
    params, aux, grid, cam, ecfg = workload.eval_setup(**tiny, device="cpu")
    out = render_ir_eval(params, aux, grid, cam, ecfg)
    assert out["render"].device.type == "cpu" and out["render"].shape == (16, 16, 3)
    assert len(out) == 18


def test_package_turns_tf32_off():
    import irgs_tpu_torch  # noqa: F401
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
