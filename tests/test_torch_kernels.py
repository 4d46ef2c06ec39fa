"""The port's hand-written CUDA kernels against their plain PyTorch version.

This file imports no JAX, so that it also runs on a machine with a CUDA card
and no JAX:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels.py

The kernel cases carry the `cuda` marker and skip where there is no card.
The blend kernels are held against the plain version on the 48-surfel,
32x32 scene of tests/test_torch_raster.py at S = 0, 4 and 8, on a tile that
blends several chunks and stops mid-slab while the other tiles are empty,
and on a scene where whole warps have no live pair; the rasterizer on the
card against the same call on the CPU (which takes the plain blend); the
row gather bit for bit against ``table[idx]``. The CPU cases check what the
card cases rely on: the scenes' shapes, the backward's closed-form total
and the tile order.
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


def make_box_scene(seed, n, box, log_scale, opacity_logit, s=S):
    """n surfels with centres uniform in box ((x0, x1), (y0, y1), (z0, z1)),
    scales exp(U(log_scale)) and opacities sigmoid(N(opacity_logit, 1))."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(lo, hi, n) for lo, hi in box], -1)
    arrs = (means, np.exp(rng.uniform(*log_scale, (n, 2))),
            rng.standard_normal((n, 4)),
            1.0 / (1.0 + np.exp(-(rng.standard_normal((n, 1))
                                  + opacity_logit))),
            0.3 * rng.standard_normal((n, 16, 3)),
            rng.uniform(size=(n, s)))
    return tuple(torch.tensor(a.astype(np.float32)) for a in arrs)


# The blend cases (name -> scene, and whether to keep tile 0 alone):
#   base       the 48-surfel scene: one chunk per tile, no tile saturates;
#   cover      3000 opaque surfels over the whole frame: every tile blends
#              5-6 of its 11-12 chunks and stops mid-slab;
#   skew       `cover` with every tile but tile 0 emptied: one heavy tile,
#              its neighbours without work (as the bench slab's heaviest
#              tile, which is the kernels' critical path);
#   dead_warps 200 small surfels in a band across the top rows of tiles 0
#              and 1: half of each tile's warps have no live pair.
BLEND_SCENES = {
    "base": (lambda s: make_scene(s=s), False),
    "cover": (lambda s: make_box_scene(
        1, 3000, ((-2.2, 2.2), (-2.2, 2.2), (-0.5, 0.5)), (-1.6, -0.9), 0.5,
        s), False),
    "skew": (lambda s: make_box_scene(
        1, 3000, ((-2.2, 2.2), (-2.2, 2.2), (-0.5, 0.5)), (-1.6, -0.9), 0.5,
        s), True),
    "dead_warps": (lambda s: make_box_scene(
        3, 200, ((-1.5, 1.5), (-1.5, -1.2), (-0.3, 0.3)), (-3.0, -2.6), 2.0,
        s), False),
}
BLEND_DUP = 2 ** 14


def camera_params(dev):
    cam = Camera(0, np.eye(3), np.array([0.0, 0.0, 4.0]), fovx=0.8, fovy=0.8,
                 width=W, height=H)
    return cam.params(dev)


def slab(dev, scene=None, dup=DUP):
    means, scales, quats, opac, shs, feats = (
        x.to(dev) for x in (make_scene() if scene is None else scene))
    with torch.no_grad():
        prep = sr.preprocess(means, scales, quats, opac, shs,
                             camera_params(dev), W, H, 2)
        binning = sr.bin_and_sort(prep, 2, 2, dup)
        assert int(binning.overflow) == 0
        return sr.build_slab(prep, binning, feats, 2, 4, dup)


def blend_case(name, s, dev):
    """(splat, starts, counts) of a BLEND_SCENES case with S = s."""
    make, tile0_only = BLEND_SCENES[name]
    splat, starts, counts = slab(dev, make(s), BLEND_DUP)
    if tile0_only:
        counts = torch.where(torch.arange(4, device=dev) == 0, counts,
                             torch.zeros_like(counts))
    return splat, starts, counts


@pytest.fixture
def cuda_device():
    """The kernels run on the card only: skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the blend kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["base-S0", "base-S4", "base-S8", "cover-S4",
                                  "skew-S4", "dead_warps-S4"])
def test_blend_kernels_match_plain(cuda_device, case):
    name, s = case.split("-S")
    s = int(s)
    splat, starts, counts = blend_case(name, s, cuda_device)
    rb.reset_launches()
    out_k = rb.blend_fwd_cuda(splat, starts, counts, 2, 4, s)
    out_p = rb.blend_tiles_plain(splat, starts, counts, 2, 4, s)
    torch.testing.assert_close(out_k, out_p, **FWD_TOL)
    assert float(out_k[..., rb.n_attr(s) + 2].max()) > 0.2
    cot = torch.randn(out_k.shape, device=cuda_device,
                      generator=torch.Generator(cuda_device).manual_seed(0))
    cot[..., rb.c_out(s) - 2] = 0.0   # med_ord is an index
    d_k = rb.blend_bwd_cuda(splat, starts, counts, out_k, cot, 2, 4, s)
    d_k2 = rb.blend_bwd_cuda(splat, starts, counts, out_k, cot, 2, 4, s)
    assert torch.equal(d_k, d_k2)   # fixed-order reduction, no atomics
    sp = splat.clone().requires_grad_(True)
    (d_p,) = torch.autograd.grad(
        rb.blend_tiles_plain(sp, starts, counts, 2, 4, s), sp, cot)
    torch.testing.assert_close(d_k, d_p, rtol=0,
                               atol=GRAD_REL * float(d_p.abs().max()))
    assert rb.LAUNCHES == {"blend_fwd": 1, "blend_bwd": 2}


def _live_warps(splat, starts, chunks, tile):
    """[8] bool: which of the tile's 8 warps (two pixel rows each) have a
    pixel x splat pair with alpha > 0 in the chunks it blends."""
    n = int(chunks[tile]) * rb.K
    cols = starts[tile].long() + torch.arange(n)
    i = torch.arange(rb.TILE_PIX)
    px = ((tile % 2) * 16 + i % 16).float()[None, :, None]
    py = ((tile // 2) * 16 + i // 16).float()[None, :, None]
    alpha = rb.alpha_depth(splat[:, cols][None], px, py)[0][0]
    return (alpha > 0).reshape(8, 32, n).any(-1).any(-1)


def test_blend_scenes_have_their_shape():
    """What the card cases rely on, on the CPU: `cover` tiles stop mid-slab
    after at least 3 chunks, `skew` leaves one such tile with work, and
    `dead_warps` has tiles with work where whole warps have no live pair."""
    for name in ("cover", "skew"):
        splat, starts, counts = blend_case(name, S, "cpu")
        _, chunks = rb.blend_tiles_plain(splat, starts, counts, 2, 4, S,
                                         return_chunks=True)
        busy = chunks > 0
        stopped = chunks[busy] < counts[busy] // rb.K
        assert bool(((chunks[busy] >= 3) & stopped).all())
        assert int(busy.sum()) == (1 if name == "skew" else 4)
    splat, starts, counts = blend_case("dead_warps", S, "cpu")
    _, chunks = rb.blend_tiles_plain(splat, starts, counts, 2, 4, S,
                                     return_chunks=True)
    tiles = [t for t in range(4) if int(chunks[t]) > 0]
    assert tiles
    for t in tiles:
        live = _live_warps(splat, starts, chunks, t)
        assert 0 < int(live.sum()) < 8


def _s_tot_replay(splat, starts, counts, out, cot, S):
    """Σ_k w_k·dL/dw_k per pixel, replayed from the geometry over each
    tile's chunks up to where the forward stopped (the quantity the Pallas
    backward's first pass forms)."""
    NA = rb.n_attr(S)
    _, chunks = rb.blend_tiles_plain(splat, starts, counts, 2, 4, S,
                                     return_chunks=True)
    res = torch.zeros(out.shape[:2])
    i = torch.arange(rb.TILE_PIX)
    for t in range(out.shape[0]):
        n = int(chunks[t]) * rb.K
        if n == 0:
            continue
        sl = splat[:, starts[t].long() + torch.arange(n)]
        px = ((t % 2) * 16 + i % 16).float()[None, :, None]
        py = ((t // 2) * 16 + i // 16).float()[None, :, None]
        alpha, depth, m = (x[0] for x in rb.alpha_depth(sl[None], px, py))
        lg = torch.log1p(-alpha)
        T_in = torch.exp(torch.cumsum(lg, -1) - lg)
        w = torch.where(T_in * (1.0 - alpha) >= rb.T_DONE, alpha * T_in,
                        torch.zeros_like(alpha))
        g, o = cot[t], out[t]
        A, M1, M2 = (o[:, NA + j, None] for j in (2, 3, 4))
        gc = lambda j: g[:, NA + j, None]
        dLdw = (g[:, :NA] @ sl[12:12 + NA] + gc(0) * depth
                + gc(1) * depth * depth + gc(2) + gc(3) * m + gc(4) * m * m
                + gc(5) * (m * m * A + M2 - 2.0 * m * M1))
        res[t] = (w * dLdw).sum(-1)
    return res


@pytest.mark.parametrize("name", ["base", "cover"])
def test_s_tot_closed_form_matches_replay(name):
    """The backward kernel's closed-form Σ w·dL/dw against its replay.
    Tolerance 1e-5 x max|S|: both are fp32 sums of the same terms in
    different orders."""
    splat, starts, counts = blend_case(name, S, "cpu")
    out = rb.blend_tiles_plain(splat, starts, counts, 2, 4, S)
    rng = np.random.default_rng(11)
    cot = torch.tensor(rng.standard_normal(tuple(out.shape)),
                       dtype=torch.float32)
    closed = rb.s_tot_closed(out, cot, S)
    replay = _s_tot_replay(splat, starts, counts, out, cot, S)
    assert float(replay.abs().max()) > 1.0
    torch.testing.assert_close(closed, replay, rtol=0,
                               atol=1e-5 * float(replay.abs().max()))


def test_tile_order_heaviest_first():
    counts = torch.tensor([128, 0, 384, 128, 384, 256], dtype=torch.int32)
    order = rb.tile_order(counts)
    assert order.dtype == torch.int64
    assert order.tolist() == [2, 4, 5, 0, 3, 1]


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
def test_light_sampler_card_equals_cpu(cuda_device):
    """The light sampler's hash uniforms and integer CDF draw the same texels
    and jitter on the card as on the CPU, from the same pdf."""
    from irgs_tpu_torch.scene import envlight
    from irgs_tpu_torch.scene.toy import make_blob_env
    pdf = envlight.build_pdf(torch.tensor(make_blob_env(64, 128)))
    ids = torch.arange(0, 3 * 4096, 3)
    cpu = envlight.draw_light(pdf, ids, 256, seed=3, training=True)
    card = envlight.draw_light(pdf.to(cuda_device), ids.to(cuda_device), 256,
                               seed=3, training=True)
    assert torch.equal(card.idx.cpu(), cpu.idx)
    assert torch.equal(card.jitter.cpu(), cpu.jitter)


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
    package (whose __init__ imports JAX and sets its global config), nor
    cv2, PIL or imageio, which the card's machine lacks."""
    code = (
        "import pkgutil, importlib, sys, irgs_tpu_torch\n"
        "for m in pkgutil.walk_packages(irgs_tpu_torch.__path__, "
        "'irgs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'irgs_tpu', 'cv2', 'PIL', 'imageio')]\n"
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


@pytest.mark.parametrize("cli", ["render", "eval.material", "eval.relighting"])
def test_eval_clis_default_to_cuda(cli):
    """The three eval CLIs take --device cuda unless given --device cpu: with
    no card they raise before they read anything."""
    import importlib
    mod = importlib.import_module(
        "irgs_tpu_torch.render.__main__" if cli == "render"
        else f"irgs_tpu_torch.{cli}")
    argv = ["-m", "no_such_run"]
    if cli == "eval.relighting":
        argv += ["--envmaps", "no_such_env.hdr"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)


def test_eval_entry_points_default_to_cuda():
    """eval_setup runs on the card unless asked for the CPU, and
    render_ir_eval renders on the device of the scene it is given."""
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.render.eval import render_ir_eval
    tiny = dict(n_surface=64, n_capacity=128, img=16, diffuse=4, light=0,
                tracer=dict(grid_res=8, pair_capacity=2 ** 12),
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
