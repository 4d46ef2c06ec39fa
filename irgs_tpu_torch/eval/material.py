"""Material (albedo, roughness) evaluation and albedo-scale CLI, ≙
eval_material.py.

    python -m irgs_tpu_torch.eval.material -m <model_dir> --compute_scale
    python -m irgs_tpu_torch.eval.material -m <model_dir>
    ... --device cpu                                    (the plain path)

`--compute_scale` rasterizes every train view of the run's dataset, takes the
per-channel ratio of the GT albedo (`<source>/albedo/<view>.*`, sRGB) to the
predicted base colour over the foreground and writes `albedo_scale.json`
(median of one channel, per-channel medians, per-channel means). The eval
pass rescales the base colour by `--albedo_rescale`'s entry and writes
`material_results.json` (albedo PSNR and SSIM, roughness PSNR) over the test
views that have GT maps. GT maps at another resolution are resized as
`jax.image.resize(..., "bilinear")` resizes them. `--device` defaults to
cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.eval.material",
        description=__doc__.splitlines()[0])
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--compute_scale", action="store_true")
    parser.add_argument("--albedo_rescale", type=int, default=2)
    parser.add_argument("--albedo_subdir", default="albedo")
    parser.add_argument("--roughness_subdir", default="roughness")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                             "PyTorch path)")
    return parser


def material_maps(params, aux, cam, w: int, h: int, sh_degree: int):
    """The G-buffer's base colour [H, W, 3], roughness [H, W, 1] and alpha
    [H, W] of one view (one rasterization, no shading)."""
    import torch
    from ..ops import surfel_raster as sr
    with torch.no_grad():
        feats = torch.cat([params.get_base_color(), params.get_roughness()],
                          -1)
        raster = sr.rasterize(
            params.xyz, params.get_scaling(), params.rotation,
            params.get_opacity()[:, 0], params.get_features(), feats, None,
            cam, torch.zeros(3, device=params.xyz.device), img_w=w, img_h=h,
            active_sh_degree=sh_degree, alive=aux.alive)
    return raster.feature[..., :3], raster.feature[..., 3:4], raster.alpha


def main(argv=None):
    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import load_config
    from ..eval import metrics as M
    from ..scene.datasets import _load_image_any, load_scene
    from ..utils.image import resize_bilinear
    from ..utils.math3d import rgb_to_srgb, srgb_to_rgb
    from .common import find_gt_map, load_trained

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.model_path)
    params, aux, _ = load_trained(args.model_path, args.iteration, cfg, dev)

    info = load_scene(cfg.model.source_path, cfg.model.white_background, True,
                      resolution=cfg.model.resolution)
    cams = (info.train_cameras if args.compute_scale
            else info.test_cameras or info.train_cameras)
    h, w = cams[0].height, cams[0].width

    def load_gt_map(path):
        """A GT map at the eval resolution (the dataset may hold it at
        another)."""
        img = torch.tensor(_load_image_any(path), device=dev)
        if img.shape[:2] != (h, w):
            img = resize_bilinear(img, h, w)
        return img

    def maps(cam):
        return material_maps(params, aux, cam.params(dev), w, h,
                             cfg.model.sh_degree)

    if args.compute_scale:
        gts, ours = [], []
        for cam in cams:
            path = find_gt_map(cfg.model.source_path, args.albedo_subdir,
                               cam.image_name)
            if path is None:
                continue
            gt_albedo = load_gt_map(path)[..., :3]
            base, _, alpha = maps(cam)
            m = alpha > 0.5
            if cam.mask is not None:
                m = m & torch.tensor(cam.mask, device=dev)
            gts.append(srgb_to_rgb(gt_albedo)[m].cpu().numpy())
            ours.append(base[m].cpu().numpy())
        gts = np.concatenate(gts)
        ours = np.concatenate(ours)
        ratio = gts / np.maximum(ours, 1e-6)
        scale_json = {
            "0": [1.0, 1.0, 1.0],
            "1": [float(np.median(ratio[:, 0]))] * 3,
            "2": [float(np.median(ratio[:, c])) for c in range(3)],
            "3": [float(np.mean(ratio[:, c])) for c in range(3)],
        }
        with open(os.path.join(args.model_path, "albedo_scale.json"), "w") as f:
            json.dump(scale_json, f)
        print(json.dumps(scale_json), flush=True)
        return

    with open(os.path.join(args.model_path, "albedo_scale.json")) as f:
        scale = torch.tensor(json.load(f)[str(args.albedo_rescale)],
                             dtype=torch.float32, device=dev)

    psnr_a, ssim_a, psnr_r = [], [], []
    for cam in cams:
        apath = find_gt_map(cfg.model.source_path, args.albedo_subdir,
                            cam.image_name)
        if apath is None:
            continue
        gt_albedo = srgb_to_rgb(load_gt_map(apath)[..., :3])
        base, rough, alpha = maps(cam)
        pred = rgb_to_srgb(base * scale[None, None]) * alpha[..., None]
        gt_img = rgb_to_srgb(gt_albedo) * alpha[..., None]
        psnr_a.append(float(M.psnr(pred, gt_img)))
        ssim_a.append(float(M.ssim(pred, gt_img)))
        rpath = find_gt_map(cfg.model.source_path, args.roughness_subdir,
                            cam.image_name)
        if rpath is not None:
            gt_rough = load_gt_map(rpath)[..., :1]
            psnr_r.append(float(M.psnr(rough * alpha[..., None],
                                       gt_rough * alpha[..., None])))
    results = {"psnr_albedo": float(np.mean(psnr_a)) if psnr_a else None,
               "ssim_albedo": float(np.mean(ssim_a)) if ssim_a else None,
               "psnr_roughness": float(np.mean(psnr_r)) if psnr_r else None}
    with open(os.path.join(args.model_path, "material_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
