"""A dataset with analytic ground truth, written with no download
(≙ tools/make_dataset.py).

    python -m irgs_tpu_torch.tools.make_dataset --out <dir> [--img 400]
        [--n_train 64] [--n_test 8] [--spp 256 128] [--ss 1] [--device cuda]

A NeRF-Blender-layout scene (transforms_{train,test}.json and RGBA PNG
frames) whose frames come from an analytic renderer, not from the Gaussian
pipeline under test: an exact sphere over a checker ground disk (the shadow
layout of scene/toy.py make_shadow_scene), exact ray-tested visibility, and
one bounce of diffuse indirect light read from radiosity textures. The
material model (Lambert plus render/ir.py's GGX lobe) and the Monte-Carlo
estimator (render/ir.py rendering_equation: the deterministic Fibonacci
hemisphere samples and the environment's importance samples, MIS) are the
ones the evals use, so the recorded NVS and relighting PSNR measure
reconstruction, not a disagreement of estimators.

Outputs under --out:
  transforms_train.json + train/r_*.png
  transforms_test.json  + test/r_1000*.png
  albedo/r_*.png, roughness/r_*.png     GT material maps of both splits
  gt_env.exr                            the training illumination
  points3d.ply                          with --points N only
  <env>.exr + <env>/r_1000*.png         per relight envmap: HDR and relit
                                        test frames
  dataset_meta.json

Every argument of the JAX tool is accepted, plus ``--device`` (default
cuda; without a card the run raises) and ``--points N`` (an init cloud of
N points on the analytic surfaces, in place of the readers' 100k random
points). PNG frames go
through utils/png.py, EXR through utils/exr.py.

The environment's light samples are the port's counter-hash draws
(scene/envlight.py draw_light, keyed by pixel id), not JAX's threefry
draws, so the frames equal the JAX tool's only within Monte-Carlo noise.
Every function that shades takes ``draws_fn(env_pdf, pixel_ids, n)``,
returning envlight.LightDraws; the tests pass one that computes JAX's draws
and then hold the port's pixels against the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import types

import numpy as np
import torch

from .. import resolve_device
from ..render import ir
from ..scene import envlight
from ..scene.cameras import Camera
from ..utils import png
from ..utils.exr import write_exr
from ..utils.math3d import rgb_to_srgb, safe_normalize

# --- analytic scene (the fields of toy.make_shadow_scene) -----------------

SPH_C = (0.0, 0.05, 0.0)
SPH_R = 0.6
GND_Y = -0.65
GND_R = 2.0
EPS = 1e-3


def _vec(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def intersect(ro, rd):
    """Exact nearest hit. ro/rd [N, 3] (rd unit) -> (t, obj, pos, nrm);
    obj: 0 miss, 1 sphere, 2 ground disk."""
    inf = torch.tensor(float("inf"), device=ro.device)
    c0 = _vec(SPH_C, ro)
    oc = ro - c0
    b = torch.sum(oc * rd, -1)
    c = torch.sum(oc * oc, -1) - SPH_R * SPH_R
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t_s = torch.where(t0 > EPS, t0, t1)
    hit_s = (disc > 0) & (t_s > EPS)
    t_s = torch.where(hit_s, t_s, inf)

    dy = rd[..., 1]
    t_p = (GND_Y - ro[..., 1]) / torch.where(torch.abs(dy) < 1e-9,
                                             torch.full_like(dy, 1e-9), dy)
    pp = ro + t_p[..., None] * rd
    hit_p = (t_p > EPS) & (pp[..., 0] ** 2 + pp[..., 2] ** 2 <= GND_R ** 2)
    t_p = torch.where(hit_p, t_p, inf)

    t = torch.minimum(t_s, t_p)
    fin = torch.isfinite(t)
    obj = torch.where(fin, torch.where(t_s <= t_p, 1, 2), 0).to(torch.int32)
    pos = ro + torch.where(fin, t, torch.zeros_like(t))[..., None] * rd
    up = _vec([0.0, 1.0, 0.0], ro).expand(pos.shape)
    nrm = torch.where((obj == 1)[..., None], safe_normalize(pos - c0), up)
    return t, obj, pos, nrm


def occluded(ro, rd):
    _, obj, _, _ = intersect(ro, rd)
    return obj > 0


def materials(pos, obj):
    """base_color [., 3], roughness [., 1] of the hit points: a checker
    ground at roughness 0.6, a two-tone sphere whose roughness rises from
    0.15 at its bottom to 0.75 at its top."""
    checker = torch.remainder(torch.floor(pos[..., 0] / 0.35)
                              + torch.floor(pos[..., 2] / 0.35), 2.0) >= 1.0
    g_col = torch.where(checker[..., None], _vec([0.75, 0.72, 0.65], pos),
                        _vec([0.18, 0.16, 0.22], pos))
    ang = torch.atan2(pos[..., 0], pos[..., 2])
    s_col = torch.where((torch.sin(8.0 * ang) > 0)[..., None],
                        _vec([0.7, 0.3, 0.15], pos),
                        _vec([0.15, 0.4, 0.65], pos))
    ymin, ymax = 0.05 - SPH_R, 0.05 + SPH_R   # sphere centre y = 0.05
    s_rough = torch.clamp(0.15 + 0.6 * (pos[..., 1:2] - ymin) / (ymax - ymin),
                          0.15, 0.75)
    sph = (obj == 1)[..., None]
    base = torch.where(sph, s_col, g_col)
    rough = torch.where(sph, s_rough, torch.full_like(s_rough, 0.6))
    return base, rough


# --- envmaps (linear HDR lat-long, envlight's direction convention) -------

def blob_env(h, w, blobs, sky=0.15):
    v, u = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                       indexing="ij")
    env = np.full((h, w, 3), sky, np.float32)
    for color, (cu, cv), s, amp in blobs:
        d2 = (u - cu) ** 2 + (v - cv) ** 2
        env += amp * np.exp(-d2 / (2 * s * s))[..., None] * np.asarray(color)
    return env.astype(np.float32)


def make_envs(res):
    h, w = res, 2 * res
    train = blob_env(h, w, [
        ([1.0, 0.9, 0.7], (0.3, 0.3), 0.05, 6.0),
        ([0.5, 0.7, 1.0], (0.75, 0.45), 0.08, 3.0)])
    sunset = blob_env(h, w, [
        ([1.0, 0.55, 0.25], (0.6, 0.42), 0.06, 8.0),
        ([0.3, 0.45, 0.9], (0.1, 0.25), 0.1, 2.0)], sky=0.08)
    sun = blob_env(h, w, [
        ([1.0, 0.95, 0.8], (0.22, 0.25), 0.03, 40.0)], sky=0.06)
    return {"gt_env": train, "sunset": sunset, "sun": sun}


# --- the GT renderer: rendering_equation with analytic visibility and
# --- cached one-bounce indirect light --------------------------------------

GRID_G = 512          # ground radiosity texture (GRID_G² over [-2, 2]²)
GRID_S = (256, 512)   # sphere radiosity texture (lat-long)
RAD_SPP = (192, 128)  # irradiance samples (diffuse, light)
RAD_CHUNK = 2048      # points per irradiance call


def _shade_cfg(spp):
    return ir.ShadeConfig(diffuse_sample_num=spp[0], light_sample_num=spp[1],
                          light_t_min=0.05, training=False,
                          env_activation="none")


def _draws(draws_fn, env_pdf, pixel_ids, spp):
    if draws_fn is None or spp[1] == 0:
        return None
    return draws_fn(env_pdf, pixel_ids, spp[1])


def build_radiosity(env_lin, env_pdf, spp=None, grid_g=None, grid_s=None,
                    draws_fn=None):
    """Direct-lit diffuse outgoing radiance textures of both objects:
    L(y) = albedo(y)/π · E(y), E by the shared MIS estimator with analytic
    visibility. Secondary rays then cost one texture read (one bounce of
    indirect light; deeper bounces and secondary specular are left out of
    the GT, as dataset_meta.json says). -> (rad_g [G, G, 3], rad_s
    [Sh, Sw, 3]) on env_lin's device."""
    spp = tuple(spp or RAD_SPP)
    grid_g = grid_g or GRID_G
    sh, sw = grid_s or GRID_S
    dev = env_lin.device
    cfg = _shade_cfg(spp)

    def occl_trace(ro, rd):
        b, s, _ = ro.shape
        occ = occluded(ro.reshape(-1, 3), rd.reshape(-1, 3))
        return types.SimpleNamespace(
            alpha=occ.reshape(b, s).to(torch.float32),
            color=torch.zeros((b, s, 3), device=dev))

    def irradiance(pts, nrm):
        # f_d = 1 (base colour π): the "diffuse" output is E
        n = pts.shape[0]
        ids = torch.arange(n, device=dev)
        res = ir.rendering_equation(
            torch.full((n, 3), math.pi, device=dev),
            torch.ones((n, 1), device=dev), nrm, pts, nrm, env_lin, env_pdf,
            occl_trace, cfg, pixel_ids=ids,
            light_draws=_draws(draws_fn, env_pdf, ids, spp))
        return res["diffuse"]

    def chunked(pts, nrm):
        return torch.cat([irradiance(pts[i:i + RAD_CHUNK],
                                     nrm[i:i + RAD_CHUNK])
                          for i in range(0, pts.shape[0], RAD_CHUNK)])

    # ground grid
    xs = ((torch.arange(grid_g, device=dev, dtype=torch.float32) + 0.5)
          / grid_g * (2 * GND_R) - GND_R)
    gx, gz = torch.meshgrid(xs, xs, indexing="ij")
    gp = torch.stack([gx, torch.full_like(gx, GND_Y), gz], -1).reshape(-1, 3)
    gn = _vec([0.0, 1.0, 0.0], gp).expand(gp.shape)
    e_g = chunked(gp, gn).reshape(grid_g, grid_g, 3)
    alb_g, _ = materials(gp.reshape(grid_g, grid_g, 3),
                         torch.full((grid_g, grid_g), 2, dtype=torch.int32,
                                    device=dev))
    rad_g = alb_g / math.pi * e_g

    # sphere lat-long grid
    dirs = envlight.env_image_dirs(sh, sw, device=dev).reshape(-1, 3)
    sp = _vec(SPH_C, dirs) + SPH_R * dirs
    e_s = chunked(sp, dirs).reshape(sh, sw, 3)
    alb_s, _ = materials(sp.reshape(sh, sw, 3),
                         torch.full((sh, sw), 1, dtype=torch.int32,
                                    device=dev))
    rad_s = alb_s / math.pi * e_s
    return rad_g, rad_s


def radiosity_lookup(pos, obj, rad_g, rad_s):
    """Nearest texel of the radiosity textures at hit points (0 on a miss)."""
    grid_g = rad_g.shape[0]
    sh, sw = rad_s.shape[:2]
    gi = torch.clamp(((pos[..., 0] + GND_R) / (2 * GND_R) * grid_g)
                     .to(torch.int32), 0, grid_g - 1).long()
    gk = torch.clamp(((pos[..., 2] + GND_R) / (2 * GND_R) * grid_g)
                     .to(torch.int32), 0, grid_g - 1).long()
    lg = rad_g[gi, gk]
    d = safe_normalize(pos - _vec(SPH_C, pos))
    u, v = envlight.dirs_to_uv(d)
    si = torch.clamp((v * sh).to(torch.int32), 0, sh - 1).long()
    sj = torch.clamp((u * sw).to(torch.int32), 0, sw - 1).long()
    ls = rad_s[si, sj]
    out = torch.where((obj == 1)[..., None], ls, lg)
    return torch.where((obj > 0)[..., None], out, torch.zeros_like(out))


def make_frame_renderer(env_lin, env_pdf, rad_g, rad_s, W, H, spp, chunk,
                        draws_fn=None):
    """-> render(camp, ss): one supersampled frame of the analytic scene."""
    spp = tuple(spp)
    cfg = _shade_cfg(spp)

    def primary(camp):
        rd = camp.ray_dirs(W, H).reshape(-1, 3)
        ro = camp.cam_pos.expand(rd.shape)
        _, obj, pos, nrm = intersect(ro, rd)
        return rd, obj, pos, nrm

    def analytic_trace(ro, rd):
        b, s, _ = ro.shape
        _, obj_t, pos_t, _ = intersect(ro.reshape(-1, 3), rd.reshape(-1, 3))
        col = radiosity_lookup(pos_t, obj_t, rad_g, rad_s)
        return types.SimpleNamespace(
            alpha=(obj_t > 0).reshape(b, s).to(torch.float32),
            color=col.reshape(b, s, 3))

    def shade(pos, nrm, wo, obj, pid):
        base, rough = materials(pos, obj)
        res = ir.rendering_equation(
            base, rough, nrm, pos, wo, env_lin, env_pdf, analytic_trace, cfg,
            pixel_ids=pid, light_draws=_draws(draws_fn, env_pdf, pid, spp))
        return res["diffuse"] + res["specular"]

    def render(camp, ss=2):
        """ss x ss supersampled frame -> (linear premultiplied rgb, alpha,
        premultiplied linear albedo, premultiplied roughness) [H, W, *],
        numpy."""
        dev = camp.cam_pos.device
        acc_rgb = torch.zeros((H * W, 3), device=dev)
        acc_a = torch.zeros((H * W,), device=dev)
        acc_alb = torch.zeros((H * W, 3), device=dev)
        acc_rgh = torch.zeros((H * W,), device=dev)
        offs = [(i + 0.5) / ss - 0.5 for i in range(ss)]
        for dx in offs:
            for dy in offs:
                cp = camp._replace(cx=camp.cx - dx, cy=camp.cy - dy)
                rd, obj, pos, nrm = primary(cp)
                fg = torch.nonzero(obj > 0).reshape(-1)
                n_fg = fg.numel()
                if n_fg == 0:
                    continue
                base, rough = materials(pos[fg], obj[fg])
                acc_alb[fg] += base
                acc_rgh[fg] += rough[:, 0]
                n_pad = -(-n_fg // chunk) * chunk
                idx = torch.zeros(n_pad, dtype=torch.int64, device=dev)
                idx[:n_fg] = fg
                rgb = torch.cat([shade(pos[sl], nrm[sl], -rd[sl], obj[sl], sl)
                                 for sl in idx.split(chunk)])
                acc_rgb[fg] += rgb[:n_fg]
                acc_a[fg] += 1.0
        n_ss = ss * ss
        out = ((acc_rgb / n_ss).reshape(H, W, 3), (acc_a / n_ss).reshape(H, W),
               (acc_alb / n_ss).reshape(H, W, 3),
               (acc_rgh / n_ss).reshape(H, W))
        return tuple(x.cpu().numpy() for x in out)

    return render


# --- cameras and transforms ------------------------------------------------

def spiral_cameras(n, W, H, fov=0.8, seed=0, radius=(2.6, 3.4),
                   elev=(8.0, 55.0), name_offset=0):
    """n cameras on a golden-angle spiral of the upper hemisphere looking at
    the origin; returns (Camera list, OpenGL c2w list)."""
    rng = np.random.RandomState(seed)
    cams, c2ws = [], []
    for i in range(n):
        az = 2 * math.pi * ((i * 0.61803398875) % 1.0)
        el = math.radians(elev[0] + (elev[1] - elev[0]) * ((i + 0.5) / n))
        r = rng.uniform(*radius)
        pos = np.array([r * math.cos(el) * math.cos(az),
                        r * math.sin(el),
                        r * math.cos(el) * math.sin(az)])
        fwd = -pos / np.linalg.norm(pos)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=-1)   # c2w rotation, COLMAP
        T = -R.T @ pos
        cams.append(Camera(i, R, T, fovx=fov, fovy=fov, image=None,
                           width=W, height=H,
                           image_name=f"r_{name_offset + i}"))
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = pos
        c2w[:3, 1:3] *= -1          # COLMAP -> OpenGL (the reader flips back)
        c2ws.append(c2w)
    return cams, c2ws


def write_transforms(path, fov, c2ws, split, name_offset=0):
    frames = [{"file_path": f"./{split}/r_{name_offset + i}",
               "transform_matrix": c2w.tolist()}
              for i, c2w in enumerate(c2ws)]
    with open(path, "w") as f:
        json.dump({"camera_angle_x": fov, "frames": frames}, f)


def srgb_rgba(rgb_lin_premul, alpha):
    """Premultiplied linear rgb and alpha -> uint8 sRGB RGBA, as the JAX tool
    writes it (straight colour, truncated to 8 bits)."""
    a = np.clip(alpha, 0, 1)
    straight = rgb_lin_premul / np.maximum(a[..., None], 1e-6)
    srgb = np.clip(rgb_to_srgb(torch.from_numpy(
        np.ascontiguousarray(straight, np.float32))).numpy(), 0, 1)
    rgba = np.concatenate([srgb, a[..., None]], -1)
    return (rgba * 255).astype(np.uint8)


def save_png(path, rgb_lin_premul, alpha):
    png.write_png(path, srgb_rgba(rgb_lin_premul, alpha))


def roughness_u8(rgh, alpha):
    """Premultiplied roughness -> the grey uint8 RGB map of the JAX tool."""
    r8 = (np.clip(rgh / np.maximum(alpha, 1e-6), 0, 1) * 255).astype(np.uint8)
    return np.stack([r8] * 3, -1)


def surface_points(n, seed=0):
    """n points on the analytic surfaces, by area (the sphere and the ground
    disk), with their albedo in sRGB as uint8 colours: a sparse cloud such
    as structure from motion gives."""
    rng = np.random.RandomState(seed)
    a_s, a_g = 4 * math.pi * SPH_R ** 2, math.pi * GND_R ** 2
    n_s = int(round(n * a_s / (a_s + a_g)))
    d = rng.standard_normal((n_s, 3))
    sph = np.asarray(SPH_C) + SPH_R * d / np.linalg.norm(d, axis=1,
                                                        keepdims=True)
    r = GND_R * np.sqrt(rng.random_sample(n - n_s))
    th = 2 * math.pi * rng.random_sample(n - n_s)
    gnd = np.stack([r * np.cos(th), np.full_like(r, GND_Y), r * np.sin(th)],
                   1)
    xyz = np.concatenate([sph, gnd]).astype(np.float32)
    obj = torch.cat([torch.ones(n_s, dtype=torch.int32),
                     torch.full((n - n_s,), 2, dtype=torch.int32)])
    base, _ = materials(torch.from_numpy(xyz), obj)
    rgb = (rgb_to_srgb(base).numpy() * 255 + 0.5).astype(np.uint8)
    return xyz, rgb


def write_points(path, n, seed=0):
    """points3d.ply of surface_points(n)."""
    from ..utils.ply import write_ply
    xyz, rgb = surface_points(n, seed)
    v = np.zeros(n, [("x", "f4"), ("y", "f4"), ("z", "f4"), ("red", "u1"),
                     ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        v[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        v[k] = rgb[:, i]
    write_ply(path, v)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m irgs_tpu_torch.tools."
                                 "make_dataset",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--img", type=int, default=800)
    ap.add_argument("--n_train", type=int, default=100)
    ap.add_argument("--n_test", type=int, default=8)
    ap.add_argument("--spp", type=int, nargs=2, default=(512, 256))
    ap.add_argument("--ss", type=int, default=2, help="supersampling grid")
    ap.add_argument("--env_res", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=1024,
                    help="pixels per shading call")
    ap.add_argument("--relight_envs", nargs="*", default=["sunset", "sun"])
    ap.add_argument("--grid", type=int, nargs=2, default=(512, 256),
                    metavar=("GROUND", "SPHERE_H"),
                    help="radiosity texture resolutions")
    ap.add_argument("--rad_spp", type=int, nargs=2, default=(512, 512))
    ap.add_argument("--points", type=int, default=0,
                    help="also write points3d.ply: N points on the analytic "
                         "surfaces, coloured by their albedo (0: none; the "
                         "readers then draw 100k random points)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    grid_g = args.grid[0]
    grid_s = (args.grid[1], 2 * args.grid[1])
    rad_spp = tuple(args.rad_spp)

    os.makedirs(args.out, exist_ok=True)
    W = H = args.img
    fov = 0.8
    envs = make_envs(args.env_res)
    for name in ["gt_env"] + args.relight_envs:
        write_exr(os.path.join(args.out, f"{name}.exr"), envs[name])

    train_cams, train_c2w = spiral_cameras(args.n_train, W, H, fov, seed=0)
    # test frames numbered from 1000: image names stay unique across the
    # splits, so the albedo/roughness folders hold both
    test_cams, test_c2w = spiral_cameras(args.n_test, W, H, fov, seed=1,
                                         elev=(12.0, 50.0), name_offset=1000)
    write_transforms(os.path.join(args.out, "transforms_train.json"),
                     fov, train_c2w, "train")
    write_transforms(os.path.join(args.out, "transforms_test.json"),
                     fov, test_c2w, "test", name_offset=1000)
    if args.points:
        write_points(os.path.join(args.out, "points3d.ply"), args.points)
    alb_dir = os.path.join(args.out, "albedo")
    rgh_dir = os.path.join(args.out, "roughness")
    os.makedirs(alb_dir, exist_ok=True)
    os.makedirs(rgh_dir, exist_ok=True)
    timings = {}

    def render_set(cams, out_dir, env_name, save_materials=False):
        os.makedirs(out_dir, exist_ok=True)
        env_lin = torch.from_numpy(envs[env_name]).to(dev)
        env_pdf = envlight.build_pdf(env_lin, activation="none")
        t0 = time.time()
        rad_g, rad_s = build_radiosity(env_lin, env_pdf, rad_spp, grid_g,
                                       grid_s)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_rad = time.time() - t0
        print(f"[{env_name}] radiosity textures {t_rad:.1f}s", flush=True)
        render = make_frame_renderer(env_lin, env_pdf, rad_g, rad_s, W, H,
                                     tuple(args.spp), args.chunk)
        t_frames = time.time()
        for cam in cams:
            t0 = time.time()
            rgb, a, alb, rgh = render(cam.params(dev), ss=args.ss)
            save_png(os.path.join(out_dir, f"{cam.image_name}.png"), rgb, a)
            if save_materials:
                # GT albedo as an sRGB png (≙ the Synthetic4Relight albedo
                # maps that the material eval reads through srgb_to_rgb)
                save_png(os.path.join(alb_dir, f"{cam.image_name}.png"),
                         alb, a)
                png.write_png(os.path.join(rgh_dir, f"{cam.image_name}.png"),
                              roughness_u8(rgh, a))
            print(f"[{env_name}] {out_dir}/{cam.image_name}.png "
                  f"{time.time() - t0:.1f}s", flush=True)
        timings[f"{os.path.basename(out_dir)}_{env_name}"] = {
            "radiosity_s": t_rad, "frames_s": time.time() - t_frames,
            "frames": len(cams)}

    render_set(test_cams, os.path.join(args.out, "test"), "gt_env",
               save_materials=True)
    for name in args.relight_envs:
        render_set(test_cams, os.path.join(args.out, name), name)
    render_set(train_cams, os.path.join(args.out, "train"), "gt_env",
               save_materials=True)

    meta = {"img": args.img, "spp": list(args.spp), "ss": args.ss,
            "n_train": args.n_train, "n_test": args.n_test,
            "gt": "analytic sphere+disk, exact visibility, one-bounce "
                  "diffuse indirect (radiosity texture); estimator = "
                  "ir.rendering_equation (deterministic fib + env MIS)",
            "relight_envs": args.relight_envs,
            "light_draws": "irgs_tpu_torch envlight.draw_light (counter "
                           "hash, keyed by pixel id)",
            "grid": list(args.grid), "rad_spp": list(rad_spp),
            "device": str(dev), "timings_s": timings}
    if dev.type == "cuda":
        meta["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(args.out, "dataset_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    print("dataset written to", args.out, flush=True)


if __name__ == "__main__":
    main()
