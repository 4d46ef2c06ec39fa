"""Replay a non-finite-loss reproducer that `python -m irgs_tpu_torch.train`
dumped (≙ tools/load_reproducer.py).

    python -m irgs_tpu_torch.tools.load_reproducer \\
        <model_dir>/reproducer_NNNNNN.ckpt [--toy] [--device cuda]

The trainer saves, when a step's loss is not finite, the state from before
that step, the generator state its draws came from, the camera index, the
seed and the loss. This tool rebuilds the run's scene (`--toy`, or the
dataset folder of the run's cfg.json, read as the trainer reads it),
restores the state, draws the step's uniforms again from the stored
generator state and replays that one step under
`torch.autograd.detect_anomaly(check_nan=True)`, the counterpart of
`jax_debug_nans`: the first backward function that returns a NaN raises with
the traceback of the forward operation that made it. Otherwise the step's
metrics are printed. `--toy` rebuilds the trainer's toy run (the replayed
camera's frame rendered from the true scene) rather than the JAX tool's
grey frames, so that the step replayed is the step that ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os


def main(argv=None):
    import torch

    from .. import resolve_device
    from ..config import load_config
    from ..ops import grid_tracer as gt
    from ..train import stage2 as s2
    from ..utils.checkpoint import load_checkpoint

    ap = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.load_reproducer",
        description=__doc__.splitlines()[0])
    ap.add_argument("reproducer")
    ap.add_argument("--toy", action="store_true")
    ap.add_argument("--debug_nans", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tensors, manifest = load_checkpoint(args.reproducer, dev)
    model_dir = os.path.dirname(os.path.abspath(args.reproducer))
    cfg = load_config(model_dir)
    i = int(manifest["cam_index"])

    if args.toy or not cfg.model.source_path:
        from ..train.__main__ import _toy_scene
        _, _, cams, gt_images, masks = _toy_scene(cfg, dev, views=(i,))
    else:
        from ..scene.datasets import load_scene
        info = load_scene(cfg.model.source_path, cfg.model.white_background,
                          eval_split=cfg.model.eval,
                          resolution=cfg.model.resolution)
        cams = info.train_cameras
        gt_images = [c.image for c in cams]
        masks = [c.mask for c in cams]

    h, w = gt_images[i].shape[:2]
    st = s2.from_configs(cfg, img_w=w, img_h=h)
    state = s2.state_from_tensors(tensors, cfg.opt, dev,
                                  where=args.reproducer)
    print(f"replaying iter {manifest['iteration']} (cam {i}, recorded loss "
          f"{manifest.get('loss')})", flush=True)

    grid = gt.build_grid_from_gaussians(state.params, state.aux, st.tracer)
    gen = torch.Generator(dev)
    gen.set_state(tensors["generator_state"].cpu())
    draws = s2.draw_stage2(gen, st, dev)
    gt_img = torch.tensor(gt_images[i], dtype=torch.float32, device=dev)
    mask = None if masks[i] is None else torch.tensor(masks[i], device=dev)
    anomaly = (torch.autograd.detect_anomaly(check_nan=True)
               if args.debug_nans else contextlib.nullcontext())
    with anomaly:
        state, metrics = s2.stage2_step(state, grid, cams[i].params(dev),
                                        gt_img, mask, draws, st=st)
    out = {k: float(v) for k, v in metrics.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
