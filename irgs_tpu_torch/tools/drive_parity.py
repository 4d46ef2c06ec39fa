"""Eval-path parity against the brute-force oracle trace
(≙ tools/drive_parity.py).

    python -m irgs_tpu_torch.tools.drive_parity [--img 64] [--spp 512 256]
        [--views 2] [--train N] [--subsample N] [--ply <ply>] [--device cuda]

The shadow scene (scene/toy.py make_shadow_scene: a checker ground, a sphere
and a sharp sun, so hard Monte-Carlo shadows and interreflection) is
rendered at the eval sample counts twice: through the production path (the
grid tracer at the eval budgets of `TracerConfig.from_pipe(pipe,
eval=True)`) and through the brute-force trace (grid_tracer.trace_reference
against every surfel). Sampling is deterministic (training off, the light
samples keyed by pixel id), so the difference of the two images is the
tracer's bias alone; the PSNR between them is printed per view, and last
`{"parity_psnr": {...}}`. `--train N` then runs the material-recovery
drive: N stage-2 steps from reset materials and envmap against ground
truth rendered through the oracle, and the recovered views through the
production path against it (`{"recovery_psnr": [...]}`).

Every flag of the JAX tool is kept, plus `--device` (default cuda; without
a card the run raises). `--cache DIR` keeps each image as a .npy file and
reads it back on a rerun; the default is no cache.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

ORACLE_CHUNK = 8192


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.drive_parity",
        description=__doc__.splitlines()[0])
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--spp", type=int, nargs=2, default=(512, 256))
    ap.add_argument("--train", type=int, default=0)
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--eval_segments", type=int, default=0,
                    help="override tracer_n_segments_eval")
    ap.add_argument("--eval_kb", type=int, default=0,
                    help="override tracer_hit_budget_eval")
    ap.add_argument("--eval_frac", type=float, default=0.0)
    ap.add_argument("--eval_rh", type=int, default=0,
                    help="override retrace_max_hits (wide-round candidate "
                         "cap)")
    ap.add_argument("--eval_rcr", type=int, default=-1,
                    help="override retrace_max_crossings (-1 keeps config)")
    ap.add_argument("--eval_while", type=int, default=-1,
                    help="override retrace_while (0/1; -1 keeps config)")
    ap.add_argument("--eval_decay", type=float, default=0.0,
                    help="override retrace_decay (0 keeps config)")
    ap.add_argument("--subsample", type=int, default=0,
                    help="compare on N random foreground pixels instead of "
                         "the full frame (the O(R*N) oracle is intractable "
                         "at 400^2 full-frame)")
    ap.add_argument("--ply", default="",
                    help="load a trained scene from this PLY instead of the "
                         "analytic shadow scene")
    ap.add_argument("--bf16", type=int, default=-1,
                    help="override tracer table_bf16 for the eval path "
                         "(0/1; -1 keeps config)")
    ap.add_argument("--cache", default="",
                    help="directory for resumable per-image results "
                         "(default: none)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    return ap


def eval_tracer_from_args(args, pipe):
    """The eval tracer of `pipe` with the flags' overrides."""
    from ..ops import grid_tracer as gt
    t = gt.TracerConfig.from_pipe(pipe, eval=True)
    over = {}
    if args.eval_segments:
        over["n_segments"] = args.eval_segments
    if args.eval_frac:
        over["retrace_frac"] = args.eval_frac
    if args.eval_kb:
        over["retrace_hit_budget"] = args.eval_kb
    if args.eval_rh:
        over["retrace_max_hits"] = args.eval_rh
    if args.eval_rcr >= 0:
        over["retrace_max_crossings"] = args.eval_rcr
    if args.eval_while >= 0:
        over["retrace_while"] = bool(args.eval_while)
    if args.eval_decay:
        over["retrace_decay"] = args.eval_decay
    if args.bf16 >= 0:
        over["table_bf16"] = bool(args.bf16)
    return dataclasses.replace(t, **over)


def gbuffer(params, aux, cam, img: int):
    """The frame's shading inputs [P, C] and alpha [H, W, 1]."""
    from ..ops import surfel_raster as sr
    from ..render import ir
    dev = params.xyz.device
    feats = torch.cat([params.get_base_color(), params.get_roughness()], -1)
    raster = sr.rasterize(
        params.xyz, params.get_scaling(), params.rotation,
        params.get_opacity()[:, 0], params.get_features(), feats, None, cam,
        torch.zeros(3, device=dev), img_w=img, img_h=img, active_sh_degree=3,
        dup_capacity=2 ** 19, alive=aux.alive)
    maps = ir.derive_geometry_maps(raster, cam, img, img)
    flat = lambda x: x.reshape(-1, x.shape[-1])
    return ((flat(raster.feature[..., :3]), flat(raster.feature[..., 3:4]),
             flat(maps["normal_map"]), flat(maps["points"]),
             -flat(maps["rays_d"])), maps["alpha"])


def shade(px, pixel_ids, cam_pos, params, aux, grid, tracer, sd: int,
          sl: int, mode: str, draws_fn=None):
    """Linear radiance of the pixels `px` (gbuffer's tuple, sliced) through
    the production trace (mode "prod") or the oracle (mode "oracle").
    `draws_fn(env_pdf, pixel_ids, n)` -> envlight.LightDraws replaces the
    pixel-keyed light draws (a test feeds the JAX package's)."""
    from ..render import ir
    from ..scene import envlight
    from .common import oracle_trace
    if mode == "oracle":
        inputs = ir.trace_inputs(params, aux, cam_pos)
        tmin = tracer.transmittance_min

        def trace_fn(ro, rd):
            return oracle_trace(inputs, aux.alive, ro, rd, tmin, ORACLE_CHUNK)
    else:
        trace_fn = ir.make_trace_fn(params, aux, grid, tracer, cam_pos, 3)
    cfg = ir.ShadeConfig(diffuse_sample_num=sd, light_sample_num=sl,
                         training=False)
    pdf = envlight.build_pdf(params.env)
    draws = (draws_fn(pdf, pixel_ids, sl) if draws_fn is not None and sl
             else None)
    re = ir.rendering_equation(*px, params.env, pdf, trace_fn, cfg,
                               pixel_ids=pixel_ids, light_draws=draws)
    return re["diffuse"] + re["specular"]


@torch.no_grad()
def render_blocks(cam, params, aux, grid, tracer, img: int, sd: int, sl: int,
                  mode: str, n_blocks: int = 8, draws_fn=None):
    """The sRGB frame [H, W, 3], shaded in `n_blocks` blocks of pixels."""
    from ..utils.math3d import rgb_to_srgb
    px, alpha = gbuffer(params, aux, cam, img)
    npx = img * img
    bs = -(-npx // n_blocks)
    ids = torch.arange(npx, device=alpha.device)
    outs = [shade(tuple(x[a:a + bs] for x in px), ids[a:a + bs], cam.cam_pos,
                  params, aux, grid, tracer, sd, sl, mode, draws_fn)
            for a in range(0, npx, bs)]
    out = rgb_to_srgb(torch.cat(outs)).reshape(img, img, 3)
    return torch.clamp(out * alpha, 0.0, 1.0)


def _cached(cache, tag, fn, dev):
    """fn() (a tensor), or with a `cache` directory the array it saved there
    under `tag` on an earlier run."""
    path = os.path.join(cache, tag + ".npy") if cache else ""
    if path and os.path.exists(path):
        print(f"{tag}: cached", flush=True)
        return torch.as_tensor(np.load(path), device=dev)
    out = fn()
    if path:
        np.save(path, out.cpu().numpy())
    return out


def _tag(t, ply):
    r = t.retrace_cfg()
    return (f"nf_sg{t.n_segments}kb{t.hit_budget}rkb{r.hit_budget}"
            f"rh{r.max_hits}rcr{r.max_crossings}f{t.retrace_frac}"
            f"d{t.retrace_decay}w{int(t.retrace_while)}b{int(t.table_bf16)}"
            + ("ply" if ply else ""))


@torch.no_grad()
def subset_compare(vi, cam, params, aux, grid, tracer, img, sd, sl, n,
                   cache="", tag="", draws_fn=None):
    """Budgeted tracer against the oracle on n deterministic foreground
    pixels of the frame -> (PSNR, mean |d|)."""
    from ..train.losses import psnr
    from ..utils.math3d import rgb_to_srgb
    px, alpha = gbuffer(params, aux, cam, img)
    fg = np.flatnonzero(alpha[..., 0].reshape(-1).cpu().numpy() > 0.5)
    rng = np.random.default_rng(17 + vi)
    n = min(n, fg.size)
    sel = torch.as_tensor(np.sort(rng.choice(fg, size=n, replace=False)),
                          device=alpha.device)
    sub = tuple(x[sel] for x in px)
    dev = alpha.device
    t0 = time.perf_counter()
    out_p = _cached(
        cache, f"sub_prod_v{vi}_i{img}_n{n}_s{sd}_{sl}_{tag}",
        lambda: shade(sub, sel, cam.cam_pos, params, aux, grid, tracer, sd,
                      sl, "prod", draws_fn), dev)
    tp = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_o = _cached(
        cache, f"sub_oracle_v{vi}_i{img}_n{n}_s{sd}_{sl}",
        lambda: shade(sub, sel, cam.cam_pos, params, aux, grid, tracer, sd,
                      sl, "oracle", draws_fn), dev)
    to = time.perf_counter() - t0
    a = torch.clamp(rgb_to_srgb(out_p), 0.0, 1.0)
    b = torch.clamp(rgb_to_srgb(out_o), 0.0, 1.0)
    p, mad = float(psnr(a, b)), float((a - b).abs().mean())
    print(f"view {vi}: SUBSET({n} fg px) eval vs oracle PSNR {p:.2f} dB, "
          f"mean|d| {mad:.6f} (prod {tp:.0f}s, oracle {to:.0f}s)", flush=True)
    return p, mad


def recovery_drive(params, aux, cams, eval_tracer, img, iters, dev,
                   cache="", log=print, render_spp=(128, 64), spp=64,
                   n_pixels=2048, draws_fn=None, step_draws=None):
    """Stage-2 recovery against oracle-rendered ground truth: bias of the
    production pipeline would cap the PSNR it can reach -> the recovered
    views' PSNR against that truth. `render_spp` (the GT's and the final
    frames' samples), `spp` and `n_pixels` (a step's diffuse samples and
    shaded pixels) shrink it for a test, which may also feed the JAX
    tool's draws: `draws_fn` as in shade, `step_draws(it, st)` -> the
    Stage2Draws of step `it`."""
    from ..config import Config
    from ..ops import grid_tracer as gt
    from ..scene.gaussians import inverse_base_color_activation
    from ..train import stage2 as s2
    from ..train.losses import psnr

    cfg = Config()
    cfg.pipe.diffuse_sample_num = spp
    cfg.opt.trace_num_rays = spp * n_pixels
    cfg.opt.iterations = iters
    st = dataclasses.replace(s2.from_configs(cfg, img_w=img, img_h=img),
                             dup_capacity=2 ** 19)
    gts = []
    for vi in range(4):
        cp = cams[vi].params(dev)
        gts.append(_cached(
            cache, f"gt_v{vi}_i{img}",
            lambda: render_blocks(cp, params, aux, None, eval_tracer, img,
                                  *render_spp, "oracle",
                                  draws_fn=draws_fn), dev))
        log(f"GT view {vi} ready")
    # materials and envmap reset, geometry kept
    with torch.no_grad():
        p0 = dataclasses.replace(params, **{
            k: v.detach().clone() for k, v in params.tensors().items()})
        p0.base_color.fill_(float(inverse_base_color_activation(
            torch.tensor(0.5))))
        p0.roughness.zero_()
        p0.env.fill_(float(np.log(np.float32(1.5))))
    state = s2.init_state(p0, aux, cfg.opt)
    tgrid = gt.build_grid_from_gaussians(state.params, aux, st.tracer)
    gen = torch.Generator(dev).manual_seed(0)
    for it in range(1, iters + 1):
        vi = it % 4
        draws = (step_draws(it, st) if step_draws is not None
                 else s2.draw_stage2(gen, st, dev))
        state, m = s2.stage2_step(state, tgrid, cams[vi].params(dev), gts[vi],
                                  None, draws, st=st)
        if it % 40 == 0 or it == 1:
            log(f"iter {it}: loss {float(m['loss']):.4f} ray_psnr "
                f"{float(m.get('ray_psnr', m.get('psnr', 0.0))):.2f}")
    egrid = gt.build_grid_from_gaussians(state.params, aux, eval_tracer)
    fin = []
    for vi in range(4):
        img_f = render_blocks(cams[vi].params(dev), state.params, aux, egrid,
                              eval_tracer, img, *render_spp, "prod",
                              draws_fn=draws_fn)
        fin.append(float(psnr(img_f, gts[vi])))
        log(f"recovered view {vi}: PSNR vs oracle GT {fin[-1]:.2f} dB")
    return fin


def main(argv=None, scene=None, recovery_kw=None):
    """`scene`, a (params, aux) pair, replaces the shadow scene, and
    `recovery_kw` is passed on to recovery_drive (a test passes a small
    scene and shrinks the drive)."""
    from .. import resolve_device
    from ..config import Config
    from ..ops import grid_tracer as gt
    from ..scene import toy
    from ..train.losses import psnr
    from .common import card_line

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    if args.cache:
        os.makedirs(args.cache, exist_ok=True)
    img, (sd, sl) = args.img, args.spp
    if args.ply:
        from ..scene import gaussians as G
        params, aux = G.load_ply(args.ply, 2 ** 17, device=dev)
        print(f"loaded {int(aux.n_alive)} trained gaussians from "
              f"{args.ply}", flush=True)
    elif scene is not None:
        params, aux = scene
    else:
        params, aux = toy.make_shadow_scene(device=dev)
    cams = toy.make_ring_cameras(max(args.views, 4), radius=3.4, height=1.6,
                                 width=img, height_px=img)
    tracer = eval_tracer_from_args(args, Config().pipe)
    tag = _tag(tracer, args.ply)
    grid = gt.build_grid_from_gaussians(params, aux, tracer)
    if int(grid.overflow) != 0:
        raise RuntimeError(f"the eval grid drops {int(grid.overflow)} pairs")

    results = {}
    t0 = time.perf_counter()
    for vi in range(args.views):
        cam = cams[vi].params(dev)
        if args.subsample:
            results[f"view{vi}_psnr"] = subset_compare(
                vi, cam, params, aux, grid, tracer, img, sd, sl,
                args.subsample, args.cache, tag)[0]
            continue
        img_prod = _cached(
            args.cache, f"prod_v{vi}_i{img}_s{sd}_{sl}_{tag}",
            lambda: render_blocks(cam, params, aux, grid, tracer, img, sd, sl,
                                  "prod"), dev)
        t1 = time.perf_counter()
        img_orc = _cached(
            args.cache, f"oracle_v{vi}_i{img}_s{sd}_{sl}",
            lambda: render_blocks(cam, params, aux, grid, tracer, img, sd, sl,
                                  "oracle"), dev)
        p = float(psnr(img_prod, img_orc))
        mad = float((img_prod - img_orc).abs().mean())
        print(f"view {vi}: eval-path vs oracle PSNR {p:.2f} dB, mean|d| "
              f"{mad:.5f} (prod {t1 - t0:.0f}s, oracle "
              f"{time.perf_counter() - t1:.0f}s)", flush=True)
        results[f"view{vi}_psnr"] = p
        t0 = time.perf_counter()
    print(json.dumps({"parity_psnr": results}), flush=True)

    if args.train:
        fin = recovery_drive(params, aux, cams, tracer, img, args.train, dev,
                             args.cache,
                             log=lambda s: print(s, flush=True),
                             **(recovery_kw or {}))
        print(json.dumps({"recovery_psnr": fin}), flush=True)
    return results


if __name__ == "__main__":
    main()
