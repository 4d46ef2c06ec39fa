"""Mesh export CLI: fuse a stage-1 run's rendered depths into a TSDF and
write its triangle mesh, ≙ extract_mesh.py.

    python -m irgs_tpu_torch.extract_mesh -m <stage1_run> [-s <scene_dir>]
    python -m irgs_tpu_torch.extract_mesh -m <stage1_run> --unbounded
    python -m irgs_tpu_torch.extract_mesh --toy -m <out_dir>
    python -m irgs_tpu_torch.extract_mesh ... --device cpu   (the plain CPU path)

Bounded (default): the training views' surface depths (alpha > 0.5) fused
into a `--mesh_res`³ TSDF over the alive Gaussians' box
(`stage1_full.reconstruct_tsdf`), meshed by marching tetrahedra.
`--unbounded`: the same depths fused on a contracted grid around the
camera ring's centre (`extract_mesh_unbounded`). Writes
<model>/mesh/fuse.ply (the welded mesh) and fuse_post.ply (the
`--num_cluster` largest clusters). The run's checkpoint is
`chkpnt<--iteration>.ckpt`, or its latest. `--device` defaults to cuda;
without a card the run raises, it does not fall back to the CPU.
`--voxel_size` and `--sdf_trunc` are accepted as extract_mesh.py accepts
them and, as there, unused: the voxel is the depth truncation over
`--mesh_res`, the SDF truncation five voxels.
"""

from __future__ import annotations

import argparse
import os
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.extract_mesh",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("-s", "--source_path", default="")
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--unbounded", action="store_true")
    ap.add_argument("--mesh_res", type=int, default=256)
    ap.add_argument("--depth_trunc", type=float, default=-1.0)
    ap.add_argument("--voxel_size", type=float, default=-1.0)
    ap.add_argument("--sdf_trunc", type=float, default=-1.0)
    ap.add_argument("--num_cluster", type=int, default=50)
    ap.add_argument("--toy", action="store_true",
                    help="the procedural toy sphere and 16 ring views")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cuda, or cpu for the plain PyTorch "
                         "path)")
    return ap


def _load_run(args, dev):
    """A stage-1 run's Gaussians, views and sizes (≙ extract_mesh.py:54-66)."""
    from ..config import load_config
    from ..scene.datasets import load_scene
    from ..train import stage1_full as s1

    cfg = load_config(args.model_path, stage1=True)
    if args.source_path:
        cfg.model.source_path = args.source_path
    ckpt = args.model_path if args.iteration < 0 else os.path.join(
        args.model_path, f"chkpnt{args.iteration}.ckpt")
    state, it = s1.load_stage1_checkpoint(ckpt, device=dev)
    print(f"stage-1 checkpoint @ iter {it} ({state.aux.n_alive} gaussians)",
          flush=True)
    info = load_scene(cfg.model.source_path, cfg.model.white_background,
                      eval_split=False, resolution=cfg.model.resolution)
    return (state.params, state.aux, info.train_cameras, info.radius,
            state.params.max_sh_degree, cfg.pipe.dup_capacity or 2 ** 20)


def main(argv=None):
    import numpy as np
    import torch

    from .. import resolve_device
    from ..ops import tsdf as T
    from ..render import ref_gaussian as rg
    from ..train import stage1_full as s1
    from ..utils import ply

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.toy:
        from ..scene import toy
        params, aux = toy.make_sphere_scene(n_surface=4096, n_capacity=8192,
                                            device=dev)
        cams = toy.make_ring_cameras(16, width=128, height_px=128)
        cameras_extent, sh_deg, dup_capacity = 3.3, 3, 2 ** 18
    else:
        (params, aux, cams, cameras_extent, sh_deg,
         dup_capacity) = _load_run(args, dev)
    h, w = cams[0].height, cams[0].width
    out_dir = os.path.join(args.model_path, "mesh")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()

    with torch.no_grad():
        if args.unbounded:
            # the views' surface depths and projections; the bounding sphere
            # from the camera centres (≙ estimate_bounding_sphere,
            # mesh_utils.py:125-137, its focus point the centroid)
            bg = torch.zeros(3, device=dev)
            depths, projs = [], []
            for cam in cams:
                cp = cam.params(dev)
                pkg = rg.render_initial(params, aux, cp, bg, img_w=w, img_h=h,
                                        active_sh_degree=sh_deg,
                                        dup_capacity=dup_capacity)
                depths.append(pkg["surf_depth"] * (pkg["alpha"][..., 0] > 0.5))
                projs.append(cp.full_proj)
            centers = np.stack([cam.cam_pos for cam in cams])
            center = centers.mean(0)
            radius = float(np.linalg.norm(centers - center, axis=-1).min())
            verts, faces = T.extract_mesh_unbounded(
                torch.stack(depths), torch.stack(projs),
                params.xyz.detach()[aux.alive], center, radius,
                resolution=args.mesh_res)
        else:
            depth_trunc = (cameras_extent * 2.0 if args.depth_trunc < 0
                           else args.depth_trunc)
            vol = s1.reconstruct_tsdf(
                params, aux, cams, img_w=w, img_h=h, active_sh_degree=sh_deg,
                mesh_res=args.mesh_res, depth_trunc=depth_trunc,
                cameras_extent=cameras_extent, dup_capacity=dup_capacity)
            verts, faces = T.extract_mesh(vol)
    print(f"fused+meshed in {time.time() - t0:.1f}s: {verts.shape[0]} verts "
          f"/ {faces.shape[0]} tris", flush=True)

    def save(path, v, f):
        vd = ply.structured_from_dict({"x": v[:, 0], "y": v[:, 1],
                                       "z": v[:, 2]})
        ply.write_ply(path, vd, faces=f)
        print("wrote", path, flush=True)

    save(os.path.join(out_dir, "fuse.ply"), *T.merge_vertices(verts, faces))
    pv, pf = T.post_process_mesh(verts, faces,
                                 cluster_to_keep=args.num_cluster)
    print(f"post-process: {len(pv)} verts / {len(pf)} tris", flush=True)
    save(os.path.join(out_dir, "fuse_post.ply"), pv, pf)


if __name__ == "__main__":
    main()
