"""NVS rendering and metrics CLI, ≙ render.py.

    python -m irgs_tpu_torch.render -m <model_dir> [--max_images N]
    python -m irgs_tpu_torch.render -m <model_dir> --device cpu   (plain path)

Loads the latest (or `--iteration`) stage-2 PLY of a training run and its
cfg.json (every config option can be overridden, e.g. `--light_sample_num
256`), renders the test split (`--no-skip_train` adds the train split) with
`render_ir_eval`, writes each view's render and six AOVs as PNGs under
`<split>/ours_<it>/` and `<split>/nvs_results.json` (PSNR, SSIM, LPIPS and
the reference's `*_avg` aliases). LPIPS is null without VGG weights.
`--device` defaults to cuda and raises without a card. `--n_devices N` shards
each pixel's MC samples over N ranks, one process each (on cuda one per
card over NCCL, with `--device cpu` N gloo CPU processes); rank 0 writes the
images and metrics.
"""

from __future__ import annotations

import argparse
import json
import os

AOV_PNGS = ("base_color", "roughness", "diffuse", "specular", "visibility",
            "light_indirect")


def _parser(cfg) -> argparse.ArgumentParser:
    from ..config import add_config_args
    parser = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.render",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action=argparse.BooleanOptionalAction,
                        default=True)
    parser.add_argument("--skip_test", action="store_true", default=False)
    parser.add_argument("--max_images", type=int, default=-1)
    parser.add_argument("--n_devices", type=int, default=1,
                        help="sample-sharded eval over N ranks (one per card "
                             "on cuda, CPU processes with --device cpu)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                             "PyTorch path)")
    add_config_args(parser, cfg)
    return parser


def main(argv=None):
    import sys

    from .. import resolve_device
    from ..config import Config
    from ..parallel.dp import launch_ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    parser = _parser(Config())
    args = parser.parse_args(argv)
    if not args.model_path:
        parser.error("-m/--model_path is required")
    if args.n_devices > 1:
        launch_ranks(_render_rank, args.n_devices, args.device, (argv,))
        return
    _render(args, resolve_device(args.device))


def _render_rank(mesh, device, argv):
    """One rank of `--n_devices` N; rank 0 alone prints."""
    import sys

    from ..config import Config
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")
    _render(_parser(Config()).parse_args(argv), device, mesh)


def _render(args, dev, mesh=None):
    import numpy as np
    import torch

    from ..config import apply_args, load_config
    from ..eval import metrics as M
    from ..eval.common import load_trained, write_png8
    from ..ops import grid_tracer as gt
    from ..render import eval as reval
    from ..scene.datasets import LIGHT_ROTATE_TRANSFORM, load_scene

    lead = mesh is None or mesh.rank == 0     # the rank that writes
    cfg = apply_args(load_config(args.model_path), args)
    params, aux, it = load_trained(args.model_path, args.iteration, cfg, dev)

    info = load_scene(cfg.model.source_path, cfg.model.white_background,
                      eval_split=True, resolution=cfg.model.resolution)
    splits = []
    if not args.skip_test:
        splits.append(("test", info.test_cameras or info.train_cameras))
    if not args.skip_train:
        splits.append(("train", info.train_cameras))
    cams = splits[0][1] if splits else info.train_cameras
    if args.max_images > 0:
        splits = [(n, cs[:args.max_images]) for n, cs in splits]
        cams = cams[:args.max_images]
    transform = (torch.tensor(LIGHT_ROTATE_TRANSFORM, device=dev)
                 if info.light_rotate else None)

    h, w = cams[0].height, cams[0].width
    ecfg = reval.EvalConfig(
        img_w=w, img_h=h, active_sh_degree=cfg.model.sh_degree,
        diffuse_sample_num=cfg.pipe.diffuse_sample_num,
        light_sample_num=cfg.pipe.light_sample_num,
        wo_indirect=cfg.pipe.wo_indirect,
        white_background=cfg.model.white_background,
        env_activation=cfg.model.envmap_activation,
        tracer=gt.TracerConfig.from_pipe(cfg.pipe, eval=True))
    grid = gt.build_grid_from_gaussians(params, aux, ecfg.tracer)

    vgg = M.load_vgg16_weights()
    for split_name, split_cams in splits:
        out_dir = os.path.join(args.model_path, split_name, f"ours_{it}")
        psnrs, ssims, lpipss = [], [], []
        for i, cam in enumerate(split_cams):
            out = reval.render_ir_eval(params, aux, grid, cam.params(dev), ecfg,
                                       env_transform=transform, mesh=mesh)
            if not lead:
                continue
            render = torch.clamp(out["render"], 0, 1)
            gt_img = torch.tensor(cam.image, device=dev)
            psnrs.append(float(M.psnr(render, gt_img)))
            ssims.append(float(M.ssim(render, gt_img)))
            lpipss.append(M.lpips_fn(render, gt_img, vgg))
            os.makedirs(out_dir, exist_ok=True)
            write_png8(os.path.join(out_dir, f"{cam.image_name}_render.png"),
                       render)
            for k in AOV_PNGS:
                write_png8(os.path.join(out_dir, f"{cam.image_name}_{k}.png"),
                           out[k])
            print(f"[{split_name} {i+1}/{len(split_cams)}] {cam.image_name} "
                  f"psnr={psnrs[-1]:.2f}", flush=True)
        if not lead:
            continue

        results = {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean(ssims)),
            "lpips": None if lpipss[0] is None else float(np.mean(lpipss)),
            # the reference's *_avg aliases, which collect scripts read
            "psnr_avg": float(np.mean(psnrs)),
            "ssim_avg": float(np.mean(ssims)),
            "lpips_avg": None if lpipss[0] is None else float(np.mean(lpipss)),
            "per_image_psnr": psnrs,
        }
        with open(os.path.join(args.model_path, split_name,
                               "nvs_results.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(split_name,
              json.dumps({k: results[k] for k in ("psnr", "ssim", "lpips")}),
              flush=True)


if __name__ == "__main__":
    main()
