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
and the tile order. The deterministic scatter-add's levels (the plain
version) are held against index_add_ on the CPU in float64; on the card the
kernel against the plain version bit for bit, with no host sync and
n_levels(M) launches a call.
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
                                  "skew-S4", "dead_warps-S4", "base-S11",
                                  "base-S18", "cover-S11", "cover-S18"])
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
@pytest.mark.parametrize("tile", [1, 16, 32])
def test_gather_kernel_bf16_table_rows(cuda_device, tile):
    """The tiled select's bf16 pair table (12·tile bf16 a row) goes through
    the kernel viewed as 6·tile int32 words (ops/grid_tracer._table_rows):
    the 16-byte path at tile 16 and 32, word copies at tile 1; bit for bit
    against table[idx], one launch."""
    from irgs_tpu_torch.ops.grid_tracer import _table_rows
    T = 777
    g = torch.Generator(cuda_device).manual_seed(tile)
    tab = torch.randn((T, 12 * tile), device=cuda_device,
                      generator=g).to(torch.bfloat16)
    idx = torch.randint(0, T, (3 * T + 7,), device=cuda_device, generator=g)
    gr.reset_launches()
    out = _table_rows(tab, idx)
    assert out.dtype == torch.bfloat16 and out.shape == (idx.shape[0], 12 * tile)
    assert torch.equal(out.view(torch.int16), tab[idx].view(torch.int16))
    assert gr.LAUNCHES["gather_rows"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 4, 6, 128, 192, 352])
@pytest.mark.parametrize("M", [1, 5, 31, 33, 1000, 70_001])
def test_gather_kernel_branches(cuda_device, W, M):
    """The kernel at rows of one word, of a width that is no multiple of 4
    words (word copies), of 16-byte multiples (the bf16 table's 192 words,
    352), at row counts below, at and past one warp's 32-row chunk and past
    a grid's worth of chunks; indices at 0 and T - 1, and out of range
    (clamped to [0, T), as the TPU gather clamps); f32, int32 and
    bf16-as-int32 tables, and a table viewed at a row offset (not 16-byte
    aligned); the same bits on two runs."""
    T = 777
    g = torch.Generator(cuda_device).manual_seed(W * 7919 + M)
    idx = torch.randint(0, T, (M,), device=cuda_device, generator=g)
    idx[0] = T - 1
    if M > 4:
        idx[1], idx[2], idx[3] = 0, -5, T + 11
    want_idx = idx.clamp(0, T - 1)
    base = torch.randn((T + 1, W), device=cuda_device, generator=g)
    tables = {"f32": base[:T], "int32": base[:T].view(torch.int32),
              "bf16": base[:T].to(torch.bfloat16).view(torch.int32)
              if W % 2 == 0 else base[:T].view(torch.int32),
              "offset": base.reshape(-1)[1:1 + T * W].reshape(T, W)}
    for name, tab in tables.items():
        gr.reset_launches()
        out = gr.gather_rows_cuda(tab, idx)
        again = gr.gather_rows_cuda(tab, idx)
        torch.cuda.synchronize()
        assert out.dtype == tab.dtype and out.shape == (M, tab.shape[1])
        want = tab[want_idx].view(torch.int32)
        assert torch.equal(out.view(torch.int32), want), name
        assert torch.equal(again.view(torch.int32), want), name
        assert gr.LAUNCHES["gather_rows"] == 2


@pytest.mark.cuda
def test_gather_kernel_on_a_side_stream(cuda_device):
    """The kernel launches on the current stream: under a side stream the
    result is ready once that stream has run."""
    tab = torch.arange(40.0, device=cuda_device).reshape(10, 4)
    idx = torch.tensor([9, 0, 3], device=cuda_device)
    s = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(s):
        out = gr.gather_rows(tab, idx)
    s.synchronize()
    assert torch.equal(out, tab[idx])


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


def test_blend_widths_outside_the_set_raise():
    """Stage 1's widths 11 and 18 join 0-8; any other width raises before
    a launch (no quiet fall-back to the plain version), as does a CPU
    tensor handed to the kernel's wrapper."""
    splat, starts, counts = slab("cpu")
    assert rb.SUPPORTED_S == (0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 18)
    for s_bad in (9, 12, 19):
        with pytest.raises(ValueError, match="built for"):
            rb.blend_fwd_cuda(splat, starts, counts, 2, 4, s_bad)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rb.blend_fwd_cuda(splat, starts, counts, 2, 4, S)


@pytest.mark.parametrize("s", [11, 18])
def test_blend_slab_takes_stage1_widths(s):
    """build_slab pads the splat table to slab_width(S) at the wide widths
    and the plain blend fills S feature channels."""
    splat, starts, counts = slab("cpu", make_scene(s=s))
    assert splat.shape[0] == rb.slab_width(s) >= 12 + rb.n_attr(s)
    out = rb.blend_tiles(splat, starts, counts, 2, 4, s)
    assert out.shape == (4, rb.TILE_PIX, rb.c_out(s))
    assert float(out[..., 3:3 + s].abs().max()) > 0


def _scatter_case(dev, seed=0):
    """Gradient rows for a gather with runs of every length: most indices a
    few times, one a hundred thousand times (the slab's padding)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.cat([torch.randint(0, 500, (5000,), generator=g),
                     torch.full((100_000,), 7)])
    idx = idx[torch.randperm(idx.shape[0], generator=g)]
    grad = torch.randn((idx.shape[0], 24), generator=g)
    return grad.to(dev), idx.to(dev)


def test_scatter_add_rows_cpu_is_index_add():
    from irgs_tpu_torch.ops import segment_sum as ss
    grad, idx = _scatter_case("cpu")
    ss.reset_launches()
    want = torch.zeros(600, 24).index_add_(0, idx, grad)
    assert torch.equal(ss.scatter_add_rows(grad, idx, 600), want)
    assert ss.LAUNCHES["segment_sum"] == 0
    # the card's algorithm, with the kernel's plain version, in float64
    got = ss.scatter_sorted(grad.double(), idx, 600, ss.segment_sum_plain)
    want = torch.zeros(600, 24, dtype=torch.float64).index_add_(
        0, idx, grad.double())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-10)


@pytest.mark.cuda
def test_scatter_add_rows_on_card(cuda_device):
    """The sorted segment sums: the same bits twice, bit for bit with the
    plain version of the kernel, and within 1e-5·max of the exact sums
    (index_add_ in float64; float32 index_add_'s own atomic rounding of the
    100,000-row run spreads over about that bound from run to run)."""
    from irgs_tpu_torch.ops import segment_sum as ss
    grad, idx = _scatter_case(cuda_device)
    ss.reset_launches()
    a = ss.scatter_add_rows(grad, idx, 600)
    b = ss.scatter_add_rows(grad, idx, 600)
    assert ss.LAUNCHES["segment_sum"] >= 2
    assert torch.equal(a, b)
    assert torch.equal(a, ss.scatter_sorted(grad, idx, 600,
                                            ss.segment_sum_plain))
    ref = torch.zeros(600, 24, dtype=torch.float64,
                      device=cuda_device).index_add_(0, idx, grad.double())
    torch.testing.assert_close(a.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def _scatter_rows_case(name):
    """(grad, idx [M], n_rows) of a named case, grad [M, W] float64 or a list
    of column blocks [M, w] side by side; every case leaves rows that no
    index names."""
    from irgs_tpu_torch.ops.segment_sum import TILE
    rng = np.random.default_rng(7)
    if name == "empty":
        idx, n, w = np.zeros(0, np.int64), 10, 24
    elif name == "w1":
        idx, n, w = rng.integers(0, 40, 1000), 50, 1
    elif name == "w24-tile-edges":
        # runs of exactly TILE rows, so that each ends on a tile's edge
        idx, n, w = np.repeat(np.arange(0, 12, 2), TILE), 13, 24
    elif name.startswith("blocks"):
        # column blocks read in place: blend_hits' seven tables (65 wide),
        # or blocks of widths that take 16-byte loads; a run of 3·TILE + 5
        # crosses tile edges
        idx = np.concatenate([rng.integers(0, 300, 4000),
                              np.full(3 * TILE + 5, 11)])
        idx, n = rng.permutation(idx), 320
        widths = (3, 1, 3, 3, 3, 48, 4) if name == "blocks65" else (4, 8, 52)
        return ([torch.tensor(rng.standard_normal((idx.shape[0], w)))
                 for w in widths], torch.tensor(idx), n)
    else:                          # "one-index": TILE² copies of one index
        idx, n, w = np.full(TILE * TILE, 7), 20, 24
    grad = rng.standard_normal((idx.shape[0], w))
    return torch.tensor(grad), torch.tensor(idx), n


SCATTER_CASES = ["empty", "w1", "w24-tile-edges", "blocks65", "blocks64",
                 "one-index"]


def _side_by_side(grad):
    return grad if torch.is_tensor(grad) else torch.cat(grad, 1)


@pytest.mark.parametrize("name", SCATTER_CASES)
def test_scatter_sorted_plain_matches_index_add(name):
    """The kernel's algorithm with its plain version (the reduce-by-key
    levels over tiles and carry slots) against index_add_ in float64, with
    one call of the level function per level of n_levels(M)."""
    from irgs_tpu_torch.ops import segment_sum as ss
    grad, idx, n = _scatter_rows_case(name)
    calls = []

    def level(*a):
        calls.append(a[2].shape[0])
        return ss.segment_sum_plain(*a)
    got = ss.scatter_sorted(grad, idx, n, level)
    rows = _side_by_side(grad)
    want = torch.zeros(n, rows.shape[1], dtype=torch.float64).index_add_(
        0, idx, rows)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.equal(ss.scatter_add_rows(grad, idx, n), want)
    assert len(calls) == ss.n_levels(idx.numel())
    if name == "one-index":
        assert len(calls) >= 3
    if name != "empty":
        assert float(got[n - 1].abs().max()) == 0.0   # a row no index names


def test_gather_rows_many_matches_one_gather_each():
    """gather_rows_many: the same forward as one index_select per table, and
    on the CPU (index_add_) the same gradient bits as one gather each."""
    from irgs_tpu_torch.utils.math3d import gather_rows, gather_rows_many
    rng = np.random.default_rng(3)
    tabs = [torch.tensor(rng.standard_normal(s).astype(np.float32),
                         requires_grad=r)
            for s, r in (((30, 3), True), ((30,), True), ((30, 16, 3), True),
                         ((30, 2), False), ((30, 0), True))]
    idx = torch.tensor(rng.integers(0, 25, (7, 5)))
    many = gather_rows_many(tabs, idx)
    ups = [torch.tensor(rng.standard_normal(o.shape).astype(np.float32))
           for o in many]
    g_many = torch.autograd.grad(sum((o * u).sum() for o, u in zip(many, ups)),
                                 [t for t in tabs if t.requires_grad])
    one = [gather_rows(t, idx) for t in tabs]
    g_one = torch.autograd.grad(sum((o * u).sum() for o, u in zip(one, ups)),
                                [t for t in tabs if t.requires_grad])
    for a, b, t in zip(many, one, tabs):
        assert torch.equal(a, b) and torch.equal(a, t[idx])
    for a, b in zip(g_many, g_one):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCATTER_CASES)
def test_scatter_add_rows_levels_on_card(cuda_device, name):
    """On the card, in float32: no host sync (sync debug mode "error"),
    n_levels(M) launches a call, the same bits twice, the plain version's
    bits, and column blocks read in place give the bits of their
    concatenation."""
    from irgs_tpu_torch.ops import segment_sum as ss
    grad, idx, n = _scatter_rows_case(name)
    idx = idx.to(cuda_device)
    grad = (grad.float().to(cuda_device) if torch.is_tensor(grad)
            else [g.float().to(cuda_device) for g in grad])
    torch.cuda.synchronize()
    ss.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = ss.scatter_add_rows(grad, idx, n)
        b = ss.scatter_add_rows(grad, idx, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ss.LAUNCHES["segment_sum"] == 2 * ss.n_levels(idx.numel())
    assert torch.equal(a, b)
    assert torch.equal(a, ss.scatter_sorted(grad, idx, n,
                                            ss.segment_sum_plain))
    assert torch.equal(a, ss.scatter_add_rows(_side_by_side(grad), idx, n))


def _bitwise_twice(make_loss, tensors):
    runs = []
    for _ in range(2):
        for t in tensors.values():
            t.grad = None
        make_loss().backward()
        runs.append({k: None if t.grad is None else t.grad.clone()
                     for k, t in tensors.items()})
    return [k for k in tensors if (runs[0][k] is None) != (runs[1][k] is None)
            or (runs[0][k] is not None
                and not torch.equal(runs[0][k], runs[1][k]))]


STAGE2_SMALL_TRACER = dict(grid_res=12, pair_capacity=2 ** 14, max_cells=8,
                           max_hits=24, hit_budget=16, max_crossings=10,
                           select_tiles=4, tile=32, tiled_direct=True,
                           n_segments=4, retrace_frac=0.25)


@pytest.mark.cuda
def test_stage2_gradients_are_deterministic_on_card(cuda_device):
    """Two backward passes of the test-scale stage-2 step from the same
    inputs give the same gradient bits (ROADMAP C2)."""
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.train import stage2 as s2
    state, grid, cams, st = workload.stage2_setup(
        512, 1024, 64, 8, 8 * 128, 2 ** 14, cuda_device, STAGE2_SMALL_TRACER)
    draws = s2.draw_stage2(torch.Generator().manual_seed(0), st,
                           "cpu").to(cuda_device)
    gt_img = torch.full((64, 64, 3), 0.4, device=cuda_device)
    cam = cams[0].params(cuda_device)
    differ = _bitwise_twice(lambda: s2.stage2_forward_loss(
        state.params, state.aux, grid, cam, gt_img, None, draws, 1001,
        st)[0], state.params.tensors())
    assert not differ, differ


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["initial", "volume", "surfel",
                                   "volume_indirect", "surfel_indirect"])
def test_stage1_gradients_are_deterministic_on_card(cuda_device, phase):
    """Two backward passes of the test-scale stage-1 step (STAGE1_SMALL)
    from the same inputs give the same gradient bits, the screen-space
    offset's (which feeds densification) included."""
    from irgs_tpu_torch import workload
    from irgs_tpu_torch.config import stage1_config
    from irgs_tpu_torch.scene import cubemap as cm
    from irgs_tpu_torch.scene import gaussians as G
    from irgs_tpu_torch.scene import toy
    from irgs_tpu_torch.scene.ref_gaussians import RefGaussianParams
    from irgs_tpu_torch.train import stage1_full as s1
    w = workload.STAGE1_SMALL
    fields, alive = workload.stage1_small_fields(w["n_surface"],
                                                 w["n_capacity"], w["env_res"])
    params, aux = G.params_from_numpy(fields, alive, cuda_device,
                                      cls=RefGaussianParams)
    state = s1.init_state(params, aux, stage1_config().opt)
    cams = toy.make_ring_cameras(w["n_cams"], width=w["img"],
                                 height_px=w["img"])
    vol = None
    if phase.endswith("indirect"):
        vol = s1.reconstruct_tsdf(params, aux, cams, img_w=w["img"],
                                  img_h=w["img"], active_sh_degree=3,
                                  mesh_res=32, dup_capacity=w["dup"])
    st = s1.Stage1FullStatic(img_w=w["img"], img_h=w["img"],
                             active_sh_degree=3, white_background=False,
                             phase=phase.split("_")[0],
                             use_indirect=vol is not None,
                             dup_capacity=w["dup"])
    lut = cm.compute_fg_lut(res=32, samples=64, device=cuda_device)
    gt = torch.full((w["img"], w["img"], 3), 0.4, device=cuda_device)
    m2d = torch.zeros((params.n_capacity, 2), device=cuda_device,
                      requires_grad=True)
    cam = cams[0].params(cuda_device)
    differ = _bitwise_twice(lambda: s1.stage1_forward_loss(
        params, aux, cam, gt, None, lut, vol, 10, st, means2d_offset=m2d)[0],
        {**params.tensors(), "means2d": m2d})
    assert not differ, differ


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
    # and cuDNN's convolutions (SSIM) take deterministic algorithms
    assert torch.backends.cudnn.deterministic
