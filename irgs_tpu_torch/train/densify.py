"""Densification and pruning at static capacity (≙ irgs_tpu/train/densify.py).

Capacity stays fixed: clone and split write new Gaussians into dead slots
(the first `max_new` selected rows matched to the dead slots in order),
prune clears the alive mask, and the Adam moments of freshly written rows
are zeroed (`RefOptimizer.zero_rows`), with the step count kept. The
parameters are updated in place, because the optimizer holds them.

The split's position offsets are N(0, scale) draws: `split_normals`
[n_split, max_new, 3] (the JAX draws in the tests), or from `generator`.
"""

from __future__ import annotations

import torch

from ..scene.gaussians import GaussianAux
from ..utils.math3d import quat_to_rotmat


def _alloc_dead_slots(alive, selected, max_new: int):
    """Match the first `max_new` selected rows to dead slots, in index
    order -> (src [max_new], dst [max_new], ok [max_new])."""
    n = alive.shape[0]
    dead_order = torch.argsort(alive.to(torch.int32), stable=True)
    sel_order = torch.argsort((~selected).to(torch.int32), stable=True)
    k = torch.clamp(torch.arange(max_new, device=alive.device), max=n - 1)
    ok = (torch.arange(max_new, device=alive.device)
          < torch.minimum(selected.sum(), (~alive).sum()))
    return sel_order[k], dead_order[k], ok


def _copy_rows(params, src, dst):
    """params[dst] = params[src] for every per-Gaussian field (src and dst
    are disjoint: selected rows are alive, slots dead)."""
    for f in params.per_point_fields:
        x = getattr(params, f)
        x[dst] = x[src]


def draw_split_normals(generator, n_split: int, max_new: int, device):
    return torch.randn((n_split, max_new, 3), generator=generator,
                       device=device)


@torch.no_grad()
def densify_and_prune(params, aux: GaussianAux, optimizer, *,
                      grad_threshold: float, min_opacity: float,
                      extent: float, max_screen_size: int,
                      percent_dense: float = 0.01, max_new: int = 4096,
                      n_split: int = 2, split_normals=None, generator=None):
    """One densification round (≙ irgs_tpu densify_and_prune, :86):
    clone the small high-gradient Gaussians, split the large ones into
    `n_split` children (the parent dies), prune the transparent (and, with
    `max_screen_size`, the too large). Updates `params` and the optimizer
    in place; returns (aux with zeroed statistics, stats)."""
    n = params.n_capacity
    dev = params.xyz.device
    if split_normals is None:
        split_normals = draw_split_normals(generator, n_split, max_new, dev)
    grads = torch.nan_to_num(aux.xyz_gradient_accum
                             / torch.clamp(aux.denom, min=1e-12))
    scaling = params.get_scaling()
    max_scale = scaling.max(dim=-1).values
    high_grad = (grads >= grad_threshold) & aux.alive

    # clone (small Gaussians): a copy in a dead slot
    clone_sel = high_grad & (max_scale <= percent_dense * extent)
    src, dst, ok = _alloc_dead_slots(aux.alive, clone_sel, max_new)
    src, dst = src[ok], dst[ok]
    n_cloned = int(dst.shape[0])
    _copy_rows(params, src, dst)
    optimizer.zero_rows(dst, n)
    alive = aux.alive.clone()
    alive[dst] = True

    # split (large Gaussians): n_split children, the parent pruned
    split_sel = high_grad & (max_scale > percent_dense * extent)
    for rep in range(n_split):
        src, dst, ok = _alloc_dead_slots(alive, split_sel, max_new)
        stds = scaling[src]
        samples = split_normals[rep] * torch.cat(
            [stds, torch.zeros_like(stds[:, :1])], dim=-1)
        src, dst, samples, stds = src[ok], dst[ok], samples[ok], stds[ok]
        _copy_rows(params, src, dst)
        optimizer.zero_rows(dst, n)
        rot = quat_to_rotmat(params.rotation[src])
        offset = torch.einsum("nij,nj->ni", rot, samples)
        params.xyz[dst] = params.xyz[src] + offset
        params.scaling[dst] = torch.log(torch.clamp(stds / (0.8 * n_split),
                                                    min=1e-12))
        alive[dst] = True
    alive = alive & ~split_sel

    # prune
    prune = params.get_opacity()[:, 0] < min_opacity
    if max_screen_size > 0:
        prune = (prune | (aux.max_radii2d > max_screen_size)
                 | (max_scale > 0.1 * extent))
    alive = alive & ~prune
    new_aux = GaussianAux(alive, aux.active_sh_degree).with_zero_stats()
    stats = {"n_alive": int(alive.sum()), "n_cloned": n_cloned,
             "n_split": int(split_sel.sum())}
    return new_aux, stats


@torch.no_grad()
def add_densification_stats(aux: GaussianAux, means2d_grad, radii):
    """≙ irgs_tpu add_densification_stats, :153: the screen-space gradient
    norms and radii of the Gaussians seen in a step, in place."""
    vis = radii > 0
    r = radii.to(torch.float32)
    gnorm = torch.linalg.vector_norm(means2d_grad, dim=-1)
    aux.max_radii2d.copy_(torch.where(vis, torch.maximum(aux.max_radii2d, r),
                                      aux.max_radii2d))
    aux.xyz_gradient_accum.add_(torch.where(vis, gnorm,
                                            torch.zeros_like(gnorm)))
    aux.denom.add_(vis.to(torch.float32))
    return aux


@torch.no_grad()
def reset_opacity(params, optimizer, max_opacity: float = 0.01):
    """≙ irgs_tpu reset_opacity, :167: opacities clipped to at most
    `max_opacity`, the opacity group's Adam moments zeroed."""
    from ..utils.math3d import inverse_sigmoid
    new_op = torch.clamp(params.get_opacity(), max=max_opacity)
    params.opacity.copy_(inverse_sigmoid(torch.clamp(new_op, 1e-6, 1 - 1e-6)))
    optimizer.zero_moments(("opacity",))
    return params
