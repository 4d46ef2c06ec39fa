"""Stage-1 (Ref-Gaussian) model state (≙ irgs_tpu/scene/ref_gaussians.py):
the Gaussian-surfel core plus indirect-radiance SH and two trainable
cubemap environment lights, and the reset ops of the stage-1 schedule.

The parameters keep the JAX layout and static capacity, so that they map
1:1 (`params_from_numpy(..., cls=RefGaussianParams)`). The reset ops change
the leaf tensors in place, because the optimizer holds them; each is paired
with `train/optim.RefOptimizer.zero_moments` for the groups it touches, as
the reference's replace_tensor_to_optimizer zeroes Adam's moments and keeps
its step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import math3d
from . import cubemap as cm
from .gaussians import GaussianAux, GaussianParams  # noqa: F401 (re-export)

REF_FIELDS = ("xyz", "base_color", "metallic", "roughness", "features_dc",
              "features_rest", "indirect_dc", "indirect_rest", "scaling",
              "rotation", "opacity", "env1", "env2")


@dataclasses.dataclass
class RefGaussianParams:
    xyz: torch.Tensor             # [N, 3]
    base_color: torch.Tensor      # [N, 3] raw (plain sigmoid)
    metallic: torch.Tensor        # [N, 1] raw
    roughness: torch.Tensor       # [N, 1] raw
    features_dc: torch.Tensor     # [N, 1, 3]
    features_rest: torch.Tensor   # [N, K-1, 3]
    indirect_dc: torch.Tensor     # [N, 1, 3]
    indirect_rest: torch.Tensor   # [N, K-1, 3]
    scaling: torch.Tensor         # [N, 2] log
    rotation: torch.Tensor        # [N, 4]
    opacity: torch.Tensor         # [N, 1] logit
    env1: torch.Tensor            # [6, R, R, 3] raw cubemap (sigmoid)
    env2: torch.Tensor            # [6, R, R, 3]
    max_sh_degree: int = 3

    FIELDS = REF_FIELDS

    # activations shared with GaussianParams
    n_capacity = GaussianParams.n_capacity
    tensors = GaussianParams.tensors
    get_scaling = GaussianParams.get_scaling
    get_opacity = GaussianParams.get_opacity
    get_metallic = GaussianParams.get_metallic
    get_roughness = GaussianParams.get_roughness
    get_features = GaussianParams.get_features
    world_normals = GaussianParams.world_normals

    def get_base_color(self):
        # stage 1's plain sigmoid (ref_gaussian_model.py:65-66), unlike
        # stage 2's sigmoid·0.77 + 0.03
        return torch.sigmoid(self.base_color)

    def get_indirect(self):
        return torch.cat([self.indirect_dc, self.indirect_rest], dim=1)

    @property
    def per_point_fields(self) -> tuple[str, ...]:
        """The fields with a row per Gaussian (all but the cubemaps)."""
        return tuple(f for f in self.FIELDS if f not in ("env1", "env2"))


def init_ref_from_pcd(points, colors, n_capacity: int, max_sh_degree: int = 3,
                      env_res: int = 128, init_metallic: float = 0.01,
                      init_roughness: float = 0.1, knn_dist2=None,
                      device=None):
    """≙ irgs_tpu init_ref_from_pcd: create_from_pcd's geometry and SH,
    zero indirect SH and two zero cubemaps (sigmoid 0.5)."""
    from .gaussians import create_from_pcd
    base, aux = create_from_pcd(points, colors, n_capacity, max_sh_degree,
                                env_resolution=8,
                                init_metallic=init_metallic,
                                init_roughness=init_roughness,
                                knn_dist2=knn_dist2, device=device)
    dev = base.xyz.device
    k = (max_sh_degree + 1) ** 2
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    params = RefGaussianParams(
        xyz=base.xyz, base_color=base.base_color, metallic=base.metallic,
        roughness=base.roughness, features_dc=base.features_dc,
        features_rest=base.features_rest,
        indirect_dc=z(n_capacity, 1, 3), indirect_rest=z(n_capacity, k - 1, 3),
        scaling=base.scaling, rotation=base.rotation, opacity=base.opacity,
        env1=z(6, env_res, env_res, 3), env2=z(6, env_res, env_res, 3),
        max_sh_degree=max_sh_degree)
    return params, aux


class EnvMips:
    """Prefiltered state of one trainable cubemap (≙ EnvLightMip after
    build_mips). Rebuilt every step, differentiable to the raw cubemap."""

    def __init__(self, specular: list, diffuse):
        self.specular = specular
        self.diffuse = diffuse

    @staticmethod
    def build(env_raw, min_res: int = 16):
        spec, diff = cm.build_specular_mips(env_raw, min_res=min_res)
        return EnvMips(spec, diff)

    def query(self, dirs, mode: str = "pure_env", roughness=None):
        """Sigmoid-activated query (light.py:91-123)."""
        if mode == "diffuse":
            light = cm.sample_cubemap(self.diffuse, dirs)
        elif mode == "pure_env":
            light = cm.sample_cubemap(self.specular[0], dirs)
        else:
            mip = cm.roughness_to_mip(roughness[..., 0], len(self.specular))
            light = cm.sample_cubemap_mip(self.specular, dirs, mip)
        return torch.sigmoid(light)


# ---------------------------------------------------------------------------
# stage-1 schedule ops (≙ ref_gaussian_model.py:392-499), in place
# ---------------------------------------------------------------------------

def _raw(fn, value: float) -> float:
    return float(fn(torch.tensor(value, dtype=torch.float32)))


def _inv_sigmoid_clipped(x):
    return math3d.inverse_sigmoid(torch.clamp(x, 1e-6, 1 - 1e-6))


@torch.no_grad()
def reset_opacity0(params, alive=None, max_opacity: float = 0.01):
    """≙ reset_opacity_mask0: opacities clamped to at most `max_opacity`."""
    new = torch.clamp(torch.sigmoid(params.opacity), max=max_opacity)
    params.opacity.copy_(_inv_sigmoid_clipped(new))
    return params


@torch.no_grad()
def reset_opacity1(params, reset_v: float = 0.9):
    """≙ reset_opacity_mask1: opacity to `reset_v`, except where it is
    above it already."""
    keep = torch.sigmoid(params.opacity) > reset_v
    params.opacity.copy_(torch.where(
        keep, params.opacity,
        torch.full_like(params.opacity, _raw(math3d.inverse_sigmoid,
                                             reset_v))))
    return params


@torch.no_grad()
def reset_metallic(params, init_value: float = 0.01):
    """≙ reset_metallic_mask: metallic raised to at least `init_value`."""
    new = torch.clamp(torch.sigmoid(params.metallic), min=init_value)
    params.metallic.copy_(_inv_sigmoid_clipped(new))
    return params


def draw_uniform(generator, shape, device):
    """U[0, 1) float32 draws of `shape` from `generator` (on `device`)."""
    return torch.rand(shape, generator=generator, device=device)


@torch.no_grad()
def dist_color(params, uniforms, metallic_thr: float = 0.02,
               dist_range: float = 0.4):
    """≙ dist_color: the DC colour of non-metallic Gaussians jittered by
    U(-range, range). `uniforms` [N, 1, 3] in [0, 1): the draws (JAX's,
    or draw_uniform's)."""
    m = torch.sigmoid(params.metallic)[:, 0] > metallic_thr
    noise = uniforms * (2 * dist_range) - dist_range
    params.features_dc.copy_(torch.where(m[:, None, None], params.features_dc,
                                         params.features_dc + noise))
    return params


@torch.no_grad()
def reset_scale(params, metallic_thr: float, factor: float = 1.5,
                rough_thr: float = 0.1):
    """≙ reset_scale / enlarge_metallic_scales: the scales of Gaussians that
    are metallic (>= thr) and smooth (roughness <= rough_thr) grow by
    `factor`; pair with zero_moments("scaling")."""
    keep = ((torch.sigmoid(params.metallic)[:, 0] < metallic_thr)
            | (torch.sigmoid(params.roughness)[:, 0] > rough_thr))
    params.scaling.copy_(torch.where(keep[:, None], params.scaling,
                                     params.scaling + math.log(factor)))
    return params


@torch.no_grad()
def reset_base_color(params, uniforms, reset_value: float = 0.5,
                     noise_level: float = 0.05):
    """≙ reset_base_color: base colour to reset_value + U(-noise/2, noise/2)
    through the stage-1 sigmoid. `uniforms` [N, 3] in [0, 1)."""
    noise = (uniforms - 0.5) * noise_level
    new = torch.clamp(reset_value + noise, 0.0, 1.0)
    params.base_color.copy_(_inv_sigmoid_clipped(new))
    return params


@torch.no_grad()
def reset_metallic_full(params, reset_value: float = 0.01):
    """≙ reset_metallic: every metallic value to `reset_value`."""
    v = _raw(math3d.inverse_sigmoid, min(max(reset_value, 1e-6), 1 - 1e-6))
    params.metallic.fill_(v)
    return params


@torch.no_grad()
def reset_roughness(params, reset_value: float = 0.1):
    """≙ reset_roughness."""
    v = _raw(math3d.inverse_sigmoid, min(max(reset_value, 1e-6), 1 - 1e-6))
    params.roughness.fill_(v)
    return params


@torch.no_grad()
def reset_features_rest(params):
    """≙ reset_features: the non-DC SH zeroed."""
    params.features_rest.zero_()
    params.indirect_rest.zero_()
    return params
