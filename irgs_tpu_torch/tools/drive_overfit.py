"""Overfit drive of the rasterizer: render -> L1 -> grad -> Adam
(≙ tools/drive_overfit.py, the canonical drive of the verify notes).

    python -m irgs_tpu_torch.tools.drive_overfit [--device cuda]
        [--steps 200] [--seed 0]

The JAX script's scene and schedule: 2048 random surfels (means uniform in
[-1, 1]^3, log-scales -2.5, normal quaternions, opacity logits 0, SH
coefficients normal * 0.2, four uniform features), a 128 x 128 camera at
(0, 0, 4) with fov 0.9, dup capacity 2^17, black background, a smooth
gradient target, Adam at 5e-3 on means, scales, quaternions, opacities and
SH. The weights are drawn from `--seed` with torch's generator (the JAX
script's are jax.random draws, which the port does not reproduce). Prints
L1, PSNR and the dropped-splat count at steps 0, 50, 100 and the last,
then ms/step over 50 more steps, then the two probes: a 2^10 dup capacity
reports its overflow with a finite image, and an all-dead mask renders the
background. Expected: PSNR from ~7 dB to above 45 dB, overflow 0.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def make_scene(n: int, seed: int, device):
    import torch
    g = torch.Generator().manual_seed(seed)
    params = dict(
        means=torch.rand((n, 3), generator=g) * 2 - 1,
        scales=torch.full((n, 2), -2.5),
        quats=torch.randn((n, 4), generator=g),
        opac=torch.zeros((n, 1)),
        shs=torch.randn((n, 16, 3), generator=g) * 0.2,
    )
    feats = torch.rand((n, 4), generator=g)
    return ({k: v.to(device).requires_grad_(True) for k, v in params.items()},
            feats.to(device))


def main(argv=None, res: int = 128, n: int = 2048, timing_steps: int = 50):
    """`res`, `n` and `timing_steps` shrink the drive for a test. Returns
    a dict of what it printed."""
    import torch

    from .. import resolve_device
    from ..ops.surfel_raster import rasterize
    from ..scene.cameras import Camera
    from .common import card_line, sync

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.drive_overfit",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)

    params, feats = make_scene(n, args.seed, dev)
    cam = Camera(0, np.eye(3), np.array([0.0, 0.0, 4.0]), 0.9, 0.9,
                 image=None, width=res, height=res).params(dev)
    bg = torch.zeros(3, device=dev)
    off = torch.zeros((n, 2), device=dev)
    kw = dict(img_w=res, img_h=res, active_sh_degree=3, dup_capacity=2 ** 17)
    lin = torch.linspace(0, 1, res, device=dev)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    tgt = torch.stack([xx, yy, 0.5 * (xx + yy)], -1)

    def render(p, **extra):
        return rasterize(p["means"], torch.exp(p["scales"]), p["quats"],
                         torch.sigmoid(p["opac"])[:, 0], p["shs"], feats,
                         off, cam, bg, **{**kw, **extra})

    opt = torch.optim.Adam(list(params.values()), lr=5e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        out = render(params)
        loss = (out.color - tgt).abs().mean()
        loss.backward()
        opt.step()
        return loss, out

    rows = []
    t0 = time.time()
    for i in range(args.steps + 1):
        loss, out = step()
        if i in (0, 50, 100, args.steps):
            mse = float(((out.color.detach() - tgt) ** 2).mean())
            row = dict(iter=i, l1=float(loss.detach()),
                       psnr=float(-10 * np.log10(mse)),
                       overflow=int(out.overflow))
            rows.append(row)
            print(f"iter {i:4d}  L1 {row['l1']:.4f}  PSNR {row['psnr']:.2f} "
                  f"dB  overflow {row['overflow']}", flush=True)
    sync(dev)
    print(f"wall: {time.time() - t0:.1f}s (incl. warm-up); per-step after "
          "warmup:", flush=True)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(timing_steps):
        step()
    sync(dev)
    ms = (time.perf_counter() - t0) / max(timing_steps, 1) * 1000
    print(f"  {ms:.1f} ms/step @{res}x{res}, n={n} on {dev}", flush=True)

    with torch.no_grad():
        small = render(params, dup_capacity=2 ** 10)
        dropped = int(small.overflow)
        finite = bool(torch.isfinite(small.color).all())
        print(f"probe overflow (tiny capacity): {dropped} dropped dups; "
              f"color finite: {finite}", flush=True)
        red = torch.tensor([1.0, 0.0, 0.0], device=dev)
        dead = rasterize(params["means"], torch.exp(params["scales"]),
                         params["quats"], torch.sigmoid(params["opac"])[:, 0],
                         params["shs"], feats, off, cam, red,
                         alive=torch.zeros(n, dtype=torch.bool, device=dev),
                         **kw)
        dead_err = float((dead.color - red).abs().max())
        print(f"probe dead-mask: max|color - bg| = {dead_err}", flush=True)
    result = dict(rows=rows, ms_per_step=ms, probe_overflow=dropped,
                  probe_finite=finite, probe_dead_err=dead_err)
    print(json.dumps({"drive_overfit": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
