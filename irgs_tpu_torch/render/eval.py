"""Full-frame eval rendering, the NVS path (≙ irgs_tpu/render/eval.py).

One G-buffer rasterization, then every foreground pixel (or, without
`compact_fg`, every pixel) is MC-shaded through the rendering equation in
chunks of `EvalConfig.pixel_chunk` pixels, each chunk's incident rays traced
by the grid tracer; the result is the reference's set of 18 AOVs. The frame
runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import grid_tracer as gt
from ..ops import surfel_raster as sr
from ..scene import envlight
from ..scene.cameras import CameraParams
from ..utils.math3d import rgb_to_srgb
from . import ir


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Same fields and defaults as irgs_tpu's EvalConfig."""
    img_w: int
    img_h: int
    active_sh_degree: int = 3
    diffuse_sample_num: int = 512
    light_sample_num: int = 256
    light_t_min: float = 0.05
    wo_indirect: bool = False
    white_background: bool = False
    dup_capacity: int = 2 ** 21
    chunk_point_samples: int = 2 ** 20
    depth_ratio: float = 0.0
    env_activation: str = "exp"
    tracer: gt.TracerConfig = dataclasses.field(default_factory=gt.TracerConfig)

    @property
    def pixel_chunk(self) -> int:
        """Pixels per shade call: the largest power of two whose samples fit
        `chunk_point_samples`, within [128, 4096]."""
        s = self.diffuse_sample_num + self.light_sample_num
        c = max(self.chunk_point_samples // s, 128)
        return min(1 << (c.bit_length() - 1), 4096)


def _gbuffer(params, aux, cam: CameraParams, cfg: EvalConfig):
    """Rasterize the frame's G-buffer -> (RasterOut, derived maps)."""
    features = torch.cat([params.get_base_color(), params.get_roughness()], -1)
    raster = sr.rasterize(
        params.xyz, params.get_scaling(), params.rotation,
        params.get_opacity()[:, 0], params.get_features(), features, None,
        cam, torch.zeros(3, device=params.xyz.device), img_w=cfg.img_w,
        img_h=cfg.img_h, active_sh_degree=cfg.active_sh_degree,
        dup_capacity=cfg.dup_capacity, alive=aux.alive)
    maps = ir.derive_geometry_maps(raster, cam, cfg.img_w, cfg.img_h,
                                   depth_ratio=cfg.depth_ratio)
    return raster, maps


def _shade_impl(px_c, env_raw, pdf, trace_fn, env_transform, cfg: EvalConfig,
                light_draws=None, shard=None):
    """One pixel chunk through the MC rendering equation; its light samples
    are keyed by the pixel ids, or come from the `light_draws` hook. With
    `shard` (a parallel.Mesh) this rank traces its slice of the samples."""
    pid = px_c["pid"][:, 0]
    shade_cfg = ir.ShadeConfig(
        diffuse_sample_num=cfg.diffuse_sample_num,
        light_sample_num=cfg.light_sample_num, light_t_min=cfg.light_t_min,
        wo_indirect=cfg.wo_indirect, training=False,
        env_activation=cfg.env_activation)
    return ir.rendering_equation(
        px_c["base"], px_c["rough"], px_c["normal"], px_c["points"],
        px_c["wo"], env_raw, pdf, trace_fn, shade_cfg,
        env_transform=env_transform, pixel_ids=pid,
        light_draws=None if light_draws is None else light_draws(pid),
        shard=shard)


@torch.no_grad()
def render_ir_eval(params, aux, grid, cam: CameraParams, cfg: EvalConfig,
                   env_override=None, env_transform=None, key=None, mesh=None,
                   compact_fg: bool = True, stats_out: dict | None = None,
                   light_draws=None):
    """Render one eval view with all AOVs: a dict of [H, W, C] images.

    `compact_fg`: shade only the foreground pixels (render alpha > 0, the
    reference's eval pixel set); background pixels compose from the
    background or the environment with no MC contribution. Otherwise every
    pixel is shaded. Both split the pixels into the same chunks as the JAX
    package, so that each chunk's re-trace rounds see the same rays.

    `key` is unused: eval draws are deterministic (the light samples are
    keyed by pixel id with seed 0). `light_draws`, a callable from a chunk's
    pixel ids [n] to its `envlight.LightDraws`, replaces the sampler's draws
    (a test feeds JAX's). `mesh`, a parallel.Mesh: every rank rasterizes
    the same G-buffer and shades the same chunks, tracing its 1/size slice
    of each pixel's samples; the chunk's results are averaged over the
    ranks (the sample count must divide the mesh size). `stats_out`, when
    given, receives the
    frame's `raster_overflow`, `shaded_pixels` (foreground pixels, or all),
    `shaded_rays` (their incident rays), `traced_rays` (those plus the last
    chunk's padding, which retraces pixel 0) and the tracer's
    `trace_trunc_frac` / `trace_more_frac` averaged over the chunks that
    report them."""
    spp = cfg.diffuse_sample_num + cfg.light_sample_num
    if mesh is not None and spp % mesh.size:
        raise ValueError(f"render_ir_eval: the sample count {spp} must divide "
                         f"the mesh size {mesh.size}")
    dev = params.xyz.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0,
                    dtype=torch.float32, device=dev)
    w, h = cfg.img_w, cfg.img_h
    raster, maps = _gbuffer(params, aux, cam, cfg)
    alpha = maps["alpha"]

    env_raw = params.env if env_override is None else env_override
    pdf = envlight.build_pdf(env_raw, activation=cfg.env_activation)
    tstats: dict = {}
    trace_fn = ir.make_trace_fn(params, aux, grid, cfg.tracer, cam.cam_pos,
                                cfg.active_sh_degree, stats_out=tstats)

    flat = lambda x: x.reshape(-1, x.shape[-1])
    n_px = w * h
    px = dict(
        base=flat(raster.feature[..., :3]),
        rough=flat(raster.feature[..., 3:4]),
        normal=flat(maps["normal_map"]),
        points=flat(maps["points"]),
        wo=-flat(maps["rays_d"]),
        pid=torch.arange(n_px, dtype=torch.int32, device=dev)[:, None],
    )
    pc = cfg.pixel_chunk
    chunk_stats = []

    def shade(px_c):
        tstats.clear()
        re_c = _shade_impl(px_c, env_raw, pdf, trace_fn, env_transform, cfg,
                           light_draws, shard=mesh)
        chunk_stats.append(dict(tstats))
        return re_c

    if compact_fg:
        fg = torch.nonzero(alpha[..., 0].reshape(-1) > 0).reshape(-1)
        if fg.numel() == 0:
            fg = torch.zeros(1, dtype=torch.long, device=dev)
        n_fg = n_shaded = fg.numel()
        n_chunks = -(-n_fg // pc)
        idx = torch.zeros(n_chunks * pc, dtype=torch.long, device=dev)
        idx[:n_fg] = fg
        px_sel = {k: v[idx] for k, v in px.items()}
        outs = [shade({k: v[c * pc:(c + 1) * pc] for k, v in px_sel.items()})
                for c in range(n_chunks)]
        re = {}
        for k in outs[0]:
            acc = torch.cat([o[k] for o in outs])[:n_fg]
            buf = torch.zeros((n_px, acc.shape[-1]), dtype=torch.float32,
                              device=dev)
            buf[fg] = acc
            re[k] = buf.reshape(h, w, -1)
    else:
        n_shaded = n_px
        pad = (-n_px) % pc
        pxp = {k: torch.nn.functional.pad(v, (0, 0, 0, pad))
               for k, v in px.items()}
        outs = [shade({k: v[a:a + pc] for k, v in pxp.items()})
                for a in range(0, n_px + pad, pc)]
        re = {k: torch.cat([o[k] for o in outs])[:n_px].reshape(h, w, -1)
              for k in outs[0]}

    if stats_out is not None:
        stats_out.update(
            raster_overflow=int(raster.overflow), shaded_pixels=n_shaded,
            shaded_rays=n_shaded * spp,
            traced_rays=len(chunk_stats) * pc * spp)
        for k in ("trace_trunc_frac", "trace_more_frac"):
            vals = [float(c[k]) for c in chunk_stats if k in c]
            if vals:
                stats_out[k] = sum(vals) / len(vals)

    rendered_full = rgb_to_srgb(re["diffuse"] + re["specular"])
    final = rendered_full * alpha + bg[None, None] * (1 - alpha)
    env_dirs = maps["rays_d"]
    direct = rgb_to_srgb(envlight.query_env(env_raw, env_dirs,
                                            activation=cfg.env_activation,
                                            transform=env_transform))
    return {
        "render": final,
        "render_env": rendered_full * alpha + direct * (1 - alpha),
        "render_sh": rgb_to_srgb(raster.color) + bg[None, None] * (1 - alpha),
        "diffuse": rgb_to_srgb(re["diffuse"]),
        "specular": rgb_to_srgb(re["specular"]),
        "env_only": direct,
        "base_color": rgb_to_srgb(raster.feature[..., :3]) * alpha,
        "base_color_linear": raster.feature[..., :3] * alpha,
        "roughness": raster.feature[..., 3:4] * alpha,
        "rend_alpha": alpha,
        "rend_normal": maps["rend_normal"],
        "surf_normal": maps["surf_normal"],
        "surf_depth": maps["surf_depth"][..., None],
        "rend_dist": raster.distortion[..., None],
        "visibility": re["visibility"] * alpha,
        "light": rgb_to_srgb(re["light"] * alpha),
        "light_indirect": rgb_to_srgb(re["light_indirect"] * alpha),
        "light_direct": rgb_to_srgb(re["light_direct"] * alpha),
    }
