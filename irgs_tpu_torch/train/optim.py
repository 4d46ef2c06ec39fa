"""Per-parameter-group Adam (≙ irgs_tpu/train/optim.py:19-80).

One `torch.optim.Adam` (eps 1e-15) over the parameter groups, with the
exponential position-lr schedule. Learning-rate scaling follows stage 2:
with lr_scale == 0 the geometry groups (xyz, opacity, scaling, rotation)
are frozen — left out of the optimizer, as optax.set_to_zero leaves them
unchanged.
"""

from __future__ import annotations

import math

import torch


def expon_lr_schedule(lr_init: float, lr_final: float, max_steps: int,
                      lr_delay_steps: int = 0, lr_delay_mult: float = 1.0):
    """Log-linear interpolation with an optional delayed warm-up."""
    def schedule(step: int) -> float:
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay = 1.0
        return delay * log_lerp
    return schedule


class GaussianOptimizer:
    """Adam over the named parameter tensors of a GaussianParams."""

    def __init__(self, params, opt, spatial_lr_scale: float = 1.0):
        lr_scale = opt.lr_scale
        self.xyz_schedule = None
        if lr_scale > 0:
            self.xyz_schedule = expon_lr_schedule(
                opt.position_lr_init * spatial_lr_scale * lr_scale,
                opt.position_lr_final * spatial_lr_scale * max(lr_scale, 1e-12),
                opt.position_lr_max_steps,
                lr_delay_mult=opt.position_lr_delay_mult)
        lrs = {
            "xyz": self.xyz_schedule(0) if self.xyz_schedule else 0.0,
            "features_dc": opt.features_lr,
            "features_rest": opt.features_lr / 20.0,
            "opacity": opt.opacity_lr * lr_scale,
            "scaling": opt.scaling_lr * lr_scale,
            "rotation": opt.rotation_lr * lr_scale,
            "base_color": opt.base_color_lr,
            "metallic": opt.metallic_lr,
            "roughness": opt.roughness_lr,
            "env": opt.envmap_cubemap_lr,
        }
        tensors = params.tensors()
        groups = [{"params": [tensors[k]], "lr": lr, "name": k}
                  for k, lr in lrs.items() if lr > 0.0]
        self.frozen = [k for k, lr in lrs.items() if lr == 0.0]
        self.adam = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-15)

    def step(self, step_index: int) -> None:
        """Apply one update; `step_index` (0-based) drives the xyz schedule."""
        if self.xyz_schedule is not None:
            for g in self.adam.param_groups:
                if g["name"] == "xyz":
                    g["lr"] = self.xyz_schedule(step_index)
        self.adam.step()

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)
