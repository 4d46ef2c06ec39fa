"""The Gaussian-surfel parameter set at static capacity (≙ irgs_tpu/scene/
gaussians.py:39-105).

Every tensor has a fixed capacity `n_capacity` with an `alive` mask, so the
parameters map 1:1 onto the JAX package's `GaussianParams` (same field names
and layouts). Raw (pre-activation) parameters:
  scaling: log-scale (2D surfels) -> exp;  opacity: logit -> sigmoid;
  base_color -> sigmoid * 0.77 + 0.03;  metallic/roughness -> sigmoid;
  rotation: unnormalized (w,x,y,z) quaternion;  env: raw lat-long grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..utils import math3d

PARAM_FIELDS = ("xyz", "base_color", "metallic", "roughness", "features_dc",
                "features_rest", "scaling", "rotation", "opacity", "env")


@dataclasses.dataclass
class GaussianParams:
    """Optimized parameters; each field is a leaf tensor."""
    xyz: torch.Tensor            # [N, 3]
    base_color: torch.Tensor     # [N, 3] raw
    metallic: torch.Tensor       # [N, 1] raw
    roughness: torch.Tensor      # [N, 1] raw
    features_dc: torch.Tensor    # [N, 1, 3] SH dc
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor        # [N, 2] log
    rotation: torch.Tensor       # [N, 4] unnormalized quats
    opacity: torch.Tensor        # [N, 1] logit
    env: torch.Tensor            # [He, We, 3] raw lat-long envmap
    max_sh_degree: int = 3

    @property
    def n_capacity(self) -> int:
        return self.xyz.shape[0]

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}

    def get_scaling(self):
        return torch.exp(self.scaling)

    def get_opacity(self):
        return torch.sigmoid(self.opacity)

    def get_base_color(self):
        return torch.sigmoid(self.base_color) * 0.77 + 0.03

    def get_roughness(self):
        return torch.sigmoid(self.roughness)

    def get_features(self):
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def world_normals(self, cam_pos=None):
        """3rd rotation column, optionally flipped toward the camera."""
        n = math3d.quat_to_rotmat(self.rotation)[:, :, 2]
        if cam_pos is not None:
            n, _ = math3d.flip_align_view(n, self.xyz - cam_pos)
        return math3d.safe_normalize(n)


@dataclasses.dataclass
class GaussianAux:
    """Non-optimized bookkeeping."""
    alive: torch.Tensor          # [N] bool
    active_sh_degree: int = 3


def inverse_base_color_activation(x):
    return math3d.inverse_sigmoid((x - 0.03) / 0.77)


def params_from_numpy(fields: dict, alive: np.ndarray, device,
                      max_sh_degree: int = 3, active_sh_degree: int = 3):
    """Carry a parameter set across: numpy arrays of the JAX `GaussianParams`
    fields (same names and layouts) -> (GaussianParams, GaussianAux) on
    `device`, as float32 leaf tensors."""
    missing = [f for f in PARAM_FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing parameter fields: {missing}")
    device = resolve_device(device)
    t = {f: torch.tensor(np.asarray(fields[f], np.float32), device=device)
         for f in PARAM_FIELDS}
    n = t["xyz"].shape[0]
    alive_t = torch.tensor(np.asarray(alive, bool), device=device)
    if alive_t.shape != (n,):
        raise ValueError(f"alive must have shape ({n},), got {tuple(alive_t.shape)}")
    return (GaussianParams(**t, max_sh_degree=max_sh_degree),
            GaussianAux(alive=alive_t, active_sh_degree=active_sh_degree))


def empty_params(n_capacity: int, max_sh_degree: int = 3,
                 env_shape=(64, 128, 3), device=None):
    """Zero-filled (params, aux) of the given shapes on `device` (identity
    rotations, nothing alive): the structure a checkpoint is loaded into
    (≙ irgs_tpu empty_params, gaussians.py:177-196)."""
    device = resolve_device(device)
    k = (max_sh_degree + 1) ** 2
    z = lambda *s: torch.zeros((n_capacity,) + s, dtype=torch.float32,
                               device=device)
    rotation = z(4)
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=z(3), base_color=z(3), metallic=z(1), roughness=z(1),
        features_dc=z(1, 3), features_rest=z(k - 1, 3), scaling=z(2),
        rotation=rotation, opacity=z(1),
        env=torch.zeros(tuple(env_shape), dtype=torch.float32, device=device),
        max_sh_degree=max_sh_degree)
    aux = GaussianAux(alive=torch.zeros(n_capacity, dtype=torch.bool,
                                        device=device), active_sh_degree=0)
    return params, aux


# ---------------------------------------------------------------------------
# PLY artifact I/O: the reference's attribute layout
# (construct_list_of_attributes, scene/gaussian_model.py:409-424), so that a
# PLY of either package loads in the other
# ---------------------------------------------------------------------------

def _sidecar(path: str, suffix: str) -> str:
    return path.replace(".ply", suffix)


def save_ply(path: str, params: GaussianParams, aux: GaussianAux,
             env_activation: str = "exp") -> None:
    """The alive Gaussians as a PLY, plus the envmap sidecars (≙ irgs_tpu
    save_ply, gaussians.py:204-249): `_env.npy` (the raw grid), `1.exr` (the
    activated map) and `1.map` (the raw grid in the reference's torch format,
    {"state_dict": {"base": ...}, "activation": name})."""
    from ..utils.exr import write_exr
    from ..utils.ply import structured_from_dict, write_ply
    from . import envlight

    alive = aux.alive.detach().cpu().numpy()
    sel = lambda x: x.detach().cpu().numpy()[alive]
    fields = {}
    xyz = sel(params.xyz)
    for i, c in enumerate("xyz"):
        fields[c] = xyz[:, i]
    fdc = sel(params.features_dc).transpose(0, 2, 1).reshape(len(xyz), -1)
    for i in range(fdc.shape[1]):
        fields[f"f_dc_{i}"] = fdc[:, i]
    frest = sel(params.features_rest).transpose(0, 2, 1).reshape(len(xyz), -1)
    for i in range(frest.shape[1]):
        fields[f"f_rest_{i}"] = frest[:, i]
    fields["opacity"] = sel(params.opacity)[:, 0]
    fields["metallic"] = sel(params.metallic)[:, 0]
    fields["roughness"] = sel(params.roughness)[:, 0]
    bc = sel(params.base_color)
    for i in range(3):
        fields[f"base_color_{i}"] = bc[:, i]
    sc = sel(params.scaling)
    for i in range(sc.shape[1]):
        fields[f"scale_{i}"] = sc[:, i]
    rt = sel(params.rotation)
    for i in range(4):
        fields[f"rot_{i}"] = rt[:, i]
    write_ply(path, structured_from_dict(fields),
              comments=("irgs_tpu gaussian surfels",))
    env_raw = params.env.detach().cpu()
    np.save(_sidecar(path, "_env.npy"), env_raw.numpy())
    with torch.no_grad():
        write_exr(_sidecar(path, "1.exr"),
                  envlight.activate(env_raw, env_activation).numpy())
    torch.save({"state_dict": {"base": env_raw.clone()},
                "activation": env_activation}, _sidecar(path, "1.map"))


def _env_from_sidecars(path: str, env_activation: str) -> np.ndarray:
    """The raw envmap beside a PLY: `_env.npy`, else `1.map`, else `1.exr`
    with the activation inverted, else zeros (≙ irgs_tpu load_ply)."""
    import os
    if os.path.exists(_sidecar(path, "_env.npy")):
        return np.load(_sidecar(path, "_env.npy"))
    map_path = _sidecar(path, "1.map")
    if os.path.exists(map_path):
        blob = torch.load(map_path, map_location="cpu", weights_only=True)
        if blob.get("activation", "exp") != env_activation:
            raise ValueError(
                f"envmap sidecar {map_path} was saved with activation "
                f"{blob.get('activation')!r} but the model is configured "
                f"for {env_activation!r}; the raw grid would be "
                f"misinterpreted")
        return blob["state_dict"]["base"].detach().numpy()
    exr_path = _sidecar(path, "1.exr")
    if os.path.exists(exr_path):
        from ..utils.exr import read_exr_rgb
        act = torch.clamp(torch.tensor(read_exr_rgb(exr_path)), min=1e-8)
        if env_activation == "exp":
            env = torch.log(act)
        elif env_activation == "softplus":
            env = torch.where(act > 20.0, act,
                              torch.log(torch.expm1(torch.clamp(act, max=20.0))))
        else:
            raise ValueError(
                f"cannot invert envmap activation {env_activation!r} from "
                f"the .exr sidecar {exr_path}; save the raw grid instead")
        return env.numpy()
    return np.zeros((64, 128, 3), np.float32)


def load_ply(path: str, n_capacity: int, max_sh_degree: int = 3,
             env_activation: str = "exp", device=None):
    """A Gaussian PLY (and its envmap sidecar) -> (GaussianParams,
    GaussianAux) at `n_capacity` on `device` (≙ irgs_tpu load_ply,
    gaussians.py:252-333)."""
    from ..utils.ply import read_ply
    el = read_ply(path)["vertex"].data
    n = len(el)
    if n > n_capacity:
        raise ValueError(f"{path}: {n} points > capacity {n_capacity}")
    k = (max_sh_degree + 1) ** 2

    def col(*names):
        return np.stack([np.asarray(el[nm], np.float32) for nm in names], axis=1)

    xyz = col("x", "y", "z")
    fdc = col("f_dc_0", "f_dc_1", "f_dc_2").reshape(n, 3, 1)
    rest_names = sorted((nm for nm in el.dtype.names if nm.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    frest = (col(*rest_names).reshape(n, 3, k - 1) if rest_names
             else np.zeros((n, 3, 0), np.float32))

    def pad(x, fill=0.0):
        out = np.full((n_capacity,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    fields = dict(
        xyz=pad(xyz),
        base_color=pad(col("base_color_0", "base_color_1", "base_color_2")),
        metallic=pad(col("metallic")),
        roughness=pad(col("roughness")),
        features_dc=pad(fdc.transpose(0, 2, 1)),
        features_rest=pad(frest.transpose(0, 2, 1)),
        scaling=pad(col("scale_0", "scale_1"), fill=-10.0),
        rotation=pad(col("rot_0", "rot_1", "rot_2", "rot_3"), fill=1.0),
        opacity=pad(col("opacity"), fill=-12.0),
        env=_env_from_sidecars(path, env_activation))
    return params_from_numpy(fields, np.arange(n_capacity) < n, device,
                             max_sh_degree=max_sh_degree,
                             active_sh_degree=max_sh_degree)

