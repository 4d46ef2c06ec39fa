"""Relighting evaluation CLI, ≙ eval_relighting.py.

    python -m irgs_tpu_torch.eval.relighting -m <model_dir> --envmaps a.hdr b.exr
    ... --device cpu                                    (the plain path)

For every GT envmap (Radiance .hdr or EXR, lat-long) it builds a
`RelightEnv` (cube mips, diffuse map, texel pdf, the dataset's world
rotation), renders each view under every envmap with
`rendering_equation_relight` (the albedo scale of `albedo_scale.json`
applied; the hemisphere half traced once per view and shared by the
envmaps) and writes `relight/<env>/<view>.png` and `relighting_results.json`:
PSNR/SSIM/LPIPS per envmap against the relit GT (`<source>/$MAP_NAME/` or
`<source>/<env stem>/<view>.png`, as `*_pbr`), or, where none is found,
against the training-illumination frame (as `*_trainlight`), and the `*_pbr`
averages. LPIPS is null without VGG weights. `--device` defaults to cuda and
raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.eval.relighting",
        description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--envmaps", nargs="+", required=True,
                        help="paths to GT HDR/EXR lat-long envmaps")
    parser.add_argument("--albedo_rescale", type=int, default=2)
    parser.add_argument("--diffuse_sample_num", type=int, default=512)
    parser.add_argument("--light_sample_num", type=int, default=256)
    parser.add_argument("--max_images", type=int, default=-1)
    parser.add_argument("--split", choices=("test", "train"), default="test",
                        help="'train' relights the training frames")
    parser.add_argument("--save_env_composite", action="store_true",
                        help="also save the render composited over the "
                             "envmap background")
    parser.add_argument("--no_metrics", action="store_true",
                        help="skip PSNR/SSIM (relit train frames have no GT)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                             "PyTorch path)")
    return parser


def pixel_chunk(diffuse_sample_num: int, light_sample_num: int) -> int:
    """Pixels per shade call: 2^20 samples' worth, at least 128 (1365 at the
    default 512 + 256; not a power of two, and the chunks' composition
    decides the re-trace rounds)."""
    return max(2 ** 20 // (diffuse_sample_num + light_sample_num), 128)


def relight_gbuffer(params, aux, cam, base_scale, w: int, h: int,
                    sh_degree: int):
    """The view's G-buffer with the base colour rescaled -> (raster, maps)."""
    import torch
    from ..ops import surfel_raster as sr
    from ..render import ir
    feats = torch.cat([params.get_base_color() * base_scale[None],
                       params.get_roughness()], -1)
    raster = sr.rasterize(
        params.xyz, params.get_scaling(), params.rotation,
        params.get_opacity()[:, 0], params.get_features(), feats, None, cam,
        torch.zeros(3, device=params.xyz.device), img_w=w, img_h=h,
        active_sh_degree=sh_degree, alive=aux.alive)
    return raster, ir.derive_geometry_maps(raster, cam, w, h)


def relight_view(params, aux, grid, cam, envs, tracer_cfg, shade_cfg, fg_lut,
                 base_scale, w: int, h: int, sh_degree: int,
                 wo_indirect_relight: bool = False):
    """One view under every envmap of `envs`: the foreground pixels in
    chunks of `pixel_chunk`, each chunk's hemisphere half traced once
    (`trace_diffuse_cache`) and shaded under each envmap with its own light
    samples, keyed by pixel id. -> ([sRGB image [H, W, 3] per env], alpha
    [H, W, 1], {"fg_pixels", "chunks", "pixel_chunk"})."""
    import torch
    from ..render import ir, relight
    from ..utils.math3d import rgb_to_srgb

    with torch.no_grad():
        raster, maps = relight_gbuffer(params, aux, cam, base_scale, w, h,
                                       sh_degree)
        alpha = maps["alpha"]
        dev = alpha.device
        flat = lambda x: x.reshape(-1, x.shape[-1])
        n_px = w * h
        px = dict(base=flat(raster.feature[..., :3]),
                  rough=flat(raster.feature[..., 3:4]),
                  normal=flat(maps["normal_map"]), points=flat(maps["points"]),
                  wo=-flat(maps["rays_d"]),
                  pid=torch.arange(n_px, dtype=torch.int32, device=dev)[:, None])
        fg = torch.nonzero(alpha[..., 0].reshape(-1) > 0).reshape(-1)
        if fg.numel() == 0:
            fg = torch.zeros(1, dtype=torch.long, device=dev)
        n_fg = fg.numel()
        pc = pixel_chunk(shade_cfg.diffuse_sample_num,
                         shade_cfg.light_sample_num)
        n_chunks = -(-n_fg // pc)
        idx = torch.zeros(n_chunks * pc, dtype=torch.long, device=dev)
        idx[:n_fg] = fg
        px = {k: v[idx] for k, v in px.items()}
        trace_fn = ir.make_trace_fn(params, aux, grid, tracer_cfg, cam.cam_pos,
                                    sh_degree, with_materials=True)
        outs = [[] for _ in envs]
        for c in range(n_chunks):
            px_c = {k: v[c * pc:(c + 1) * pc] for k, v in px.items()}
            # the envmap-independent half, shared by every envmap
            cache_c = relight.trace_diffuse_cache(px_c["normal"],
                                                  px_c["points"], trace_fn,
                                                  shade_cfg)
            for e, env in enumerate(envs):
                re_c = relight.rendering_equation_relight(
                    px_c["base"], px_c["rough"], px_c["normal"],
                    px_c["points"], px_c["wo"], env, trace_fn, shade_cfg,
                    fg_lut, wo_indirect_relight=wo_indirect_relight,
                    pixel_ids=px_c["pid"][:, 0], diffuse_cache=cache_c)
                outs[e].append(re_c["diffuse"] + re_c["specular"])
        imgs = []
        for e in range(len(envs)):
            acc = torch.cat(outs[e])[:n_fg]
            buf = torch.zeros((n_px, 3), dtype=torch.float32, device=dev)
            buf[fg] = acc
            imgs.append(rgb_to_srgb(buf.reshape(h, w, 3)) * alpha)
    return imgs, alpha, {"fg_pixels": n_fg, "chunks": n_chunks,
                         "pixel_chunk": pc}


def main(argv=None):
    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import load_config
    from ..eval import metrics as M
    from ..ops import grid_tracer as gt
    from ..render import ir, relight
    from ..scene import cubemap as cm
    from ..scene.datasets import (LIGHT_ROTATE_TRANSFORM, _load_image_any,
                                  load_scene)
    from ..utils.image import resize_bilinear
    from ..utils.math3d import rgb_to_srgb
    from .common import load_trained, write_png8

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.model_path)
    params, aux, _ = load_trained(args.model_path, args.iteration, cfg, dev)

    scale_path = os.path.join(args.model_path, "albedo_scale.json")
    base_scale = torch.ones(3, device=dev)
    if os.path.exists(scale_path):
        with open(scale_path) as f:
            base_scale = torch.tensor(json.load(f)[str(args.albedo_rescale)],
                                      dtype=torch.float32, device=dev)

    info = load_scene(cfg.model.source_path, cfg.model.white_background, True,
                      resolution=cfg.model.resolution)
    cams = (info.train_cameras if args.split == "train"
            else info.test_cameras or info.train_cameras)
    if args.max_images > 0:
        cams = cams[:args.max_images]
    transform = (torch.tensor(LIGHT_ROTATE_TRANSFORM, device=dev)
                 if info.light_rotate else None)
    h, w = cams[0].height, cams[0].width

    tracer_cfg = gt.TracerConfig.from_pipe(cfg.pipe, eval=True)
    grid = gt.build_grid_from_gaussians(params, aux, tracer_cfg)
    fg_lut = cm.compute_fg_lut(device=dev)
    shade_cfg = ir.ShadeConfig(
        diffuse_sample_num=args.diffuse_sample_num,
        light_sample_num=args.light_sample_num,
        light_t_min=cfg.pipe.light_t_min, training=False)

    def per_env_gt(name, cam):
        """The relit GT of this envmap and view, (rgb·mask, mask) at the
        render resolution: `<source>/$MAP_NAME/<view>.png`, then
        `<source>/<env stem>/<view>.png`; (None, None) when neither exists."""
        for sub in (os.environ.get("MAP_NAME", ""), name):
            if not sub:
                continue
            p = os.path.join(cfg.model.source_path, sub,
                             f"{cam.image_name}.png")
            if not os.path.exists(p):
                continue
            rgba = torch.tensor(_load_image_any(p), device=dev)
            rgb = rgba[..., :3]
            mask = (rgba[..., 3:4] if rgba.shape[-1] == 4
                    else torch.ones_like(rgb[..., :1]))
            if rgb.shape[:2] != (h, w):
                rgb = resize_bilinear(rgb, h, w)
                mask = resize_bilinear(mask, h, w)
            return rgb * mask, mask
        return None, None

    bg_val = 1.0 if cfg.model.white_background else 0.0
    results = {}
    out_root = os.path.join(args.model_path, "relight")
    env_list = []
    for env_path in args.envmaps:
        name = os.path.splitext(os.path.basename(env_path))[0]
        hdr = torch.tensor(_load_image_any(env_path)[..., :3], device=dev)
        env = relight.build_relight_env(hdr, transform=transform)
        out_dir = os.path.join(out_root, name)
        os.makedirs(out_dir, exist_ok=True)
        env_list.append((name, env, out_dir))
    acc = {name: {"psnr": [], "ssim": [], "lpips": [], "fallback": False}
           for name, _, _ in env_list}
    for cam in cams:
        t0 = time.perf_counter()
        cam_p = cam.params(dev)
        imgs, alpha, stats = relight_view(
            params, aux, grid, cam_p, [e for _, e, _ in env_list], tracer_cfg,
            shade_cfg, fg_lut, base_scale, w, h, cfg.model.sh_degree,
            cfg.pipe.wo_indirect_relight)
        for (name, env, out_dir), img in zip(env_list, imgs):
            if not args.no_metrics:
                gt_img, gt_mask = per_env_gt(name, cam)
                cmp_img = None
                if gt_img is not None:
                    cmp_img = img * gt_mask + (1 - gt_mask) * bg_val
                elif cam.image is not None:
                    # no relit GT for this envmap: compare with the
                    # training-illumination frame, recorded under the
                    # *_trainlight keys (never *_pbr)
                    if not acc[name]["fallback"]:
                        print(f"WARNING: no relit GT found for envmap "
                              f"'{name}' — falling back to the training-"
                              f"illumination image; metrics recorded as "
                              f"psnr_trainlight (not psnr_pbr)", flush=True)
                        acc[name]["fallback"] = True
                    gt_img = torch.tensor(cam.image, device=dev)
                    cmp_img = img
                if gt_img is not None:
                    acc[name]["psnr"].append(float(M.psnr(cmp_img, gt_img)))
                    acc[name]["ssim"].append(float(M.ssim(cmp_img, gt_img)))
                    lp = M.lpips_fn(cmp_img, gt_img)
                    if lp is not None:
                        acc[name]["lpips"].append(lp)
                    os.makedirs(os.path.join(out_dir, "gt"), exist_ok=True)
                    write_png8(os.path.join(out_dir, "gt",
                                            f"{cam.image_name}.png"), gt_img)
            write_png8(os.path.join(out_dir, f"{cam.image_name}.png"), img)
            if args.save_env_composite:
                rays = cam_p.ray_dirs(w, h, normalize=True)
                env_bg = rgb_to_srgb(relight.env_query(
                    env, rays.reshape(-1, 3))).reshape(h, w, 3)
                comp = img + torch.clamp(env_bg, 0, 1) * (1 - alpha)
                write_png8(os.path.join(out_dir, f"{cam.image_name}_env.png"),
                           comp)
        print(f"[{cam.image_name}] done ({len(env_list)} envs, "
              f"{stats['fg_pixels']} foreground pixels, "
              f"{time.perf_counter() - t0:.2f} s)", flush=True)
    for name, _, _ in env_list:
        if acc[name]["psnr"]:
            sfx = "trainlight" if acc[name]["fallback"] else "pbr"
            results[name] = {
                f"psnr_{sfx}": float(np.mean(acc[name]["psnr"])),
                f"ssim_{sfx}": float(np.mean(acc[name]["ssim"])),
                f"lpips_{sfx}": (float(np.mean(acc[name]["lpips"]))
                                 if acc[name]["lpips"] else None),
            }
            print(name, results[name], flush=True)

    envs = [r for r in results.values() if isinstance(r, dict)]
    for k in ("psnr_pbr", "ssim_pbr", "lpips_pbr"):
        vals = [r[k] for r in envs if r.get(k) is not None]
        results[f"{k}_avg"] = float(np.mean(vals)) if vals else None
    with open(os.path.join(args.model_path, "relighting_results.json"),
              "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({k: results[f"{k}_avg"]
                      for k in ("psnr_pbr", "ssim_pbr", "lpips_pbr")}),
          flush=True)


if __name__ == "__main__":
    main()
