"""Core 3D math on torch tensors (the slice's subset of irgs_tpu/utils/math3d.py).

Quaternions are (w, x, y, z); matrices act on column vectors. Clamps use
``torch.maximum``/``torch.minimum`` rather than ``clamp`` wherever JAX used
``jnp.maximum``/``jnp.clip``: both split the gradient evenly on ties, so the
gradients match the reference exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _c(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def maximum(x, v):
    return torch.maximum(x, _c(v, x))


def minimum(x, v):
    return torch.minimum(x, _c(v, x))


def clip(x, lo, hi):
    """jnp.clip with JAX's gradient on ties (half to each side)."""
    return minimum(maximum(x, lo), hi)


class _GatherRows(torch.autograd.Function):
    """index_select of several tables [N, ...] by one index; the backward
    sums the gradients of all of them with one ops/segment_sum.
    scatter_add_rows over their columns side by side ([M, ΣW]; the kernel
    reads each table's gradient in place): on the card one sort of the index
    and fixed-order sums, so that the gradients have the same bits on every
    run (index_select's own backward, index_add_, adds with atomics); on the
    CPU index_add_."""

    @staticmethod
    def forward(ctx, flat_idx, *xs):
        ctx.save_for_backward(flat_idx)
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.index_select(0, flat_idx) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        from ..ops.segment_sum import scatter_add_rows
        (flat_idx,) = ctx.saved_tensors
        m, need = flat_idx.shape[0], ctx.needs_input_grad[1:]
        cols = [g.reshape(m, -1) for g, n in zip(gs, need) if n]
        gx = scatter_add_rows(cols, flat_idx, ctx.shapes[0][0])
        parts = iter(torch.split(gx, [c.shape[1] for c in cols], 1))
        return (None, *(next(parts).reshape(s) if n else None
                        for s, n in zip(ctx.shapes, need)))


def gather_rows_many(tables, idx):
    """[x[idx] for x in tables] along the first axis, which every table
    shares, for index tensors of any shape. The gradient of all of them is
    one deterministic scatter-add (ops/segment_sum.py): one sort of `idx`
    and one reduction of their gradient rows side by side."""
    flat = idx.reshape(-1)
    if any(x.shape[0] != tables[0].shape[0] for x in tables):
        raise ValueError("gather_rows_many: the tables differ in rows: "
                         f"{[tuple(x.shape) for x in tables]}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tables):
        outs = _GatherRows.apply(flat, *tables)
    else:
        outs = [x.index_select(0, flat) for x in tables]
    return [o.reshape(idx.shape + x.shape[1:]) for o, x in zip(outs, tables)]


def gather_rows(x, idx):
    """x[idx] along the first axis, for index tensors of any shape. Its
    gradient is a deterministic scatter-add (ops/segment_sum.py); the
    gradient of advanced indexing sorts the indices and sums each run
    serially, which costs seconds on the card when a few rows are gathered
    millions of times."""
    return gather_rows_many((x,), idx)[0]


def safe_normalize(x, eps: float = 1e-20):
    """Normalize along the last axis without NaN at zero length."""
    return x / torch.sqrt(maximum(torch.sum(x * x, dim=-1, keepdim=True), eps))


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def quat_normalize(q, eps: float = 1e-12):
    return q / maximum(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)


def quat_to_rotmat(q):
    """(w,x,y,z) [..., 4] -> rotation matrix [..., 3, 3]; columns are the
    rotated basis vectors (≙ irgs_tpu quat_to_rotmat)."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], dim=-1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], dim=-1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rotmat_to_quat(R):
    """Rotation matrix [..., 3, 3] -> quaternion (w,x,y,z)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    s0 = torch.sqrt(maximum(tr + 1.0, 1e-12)) * 2
    b0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = torch.sqrt(maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2
    b1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = torch.sqrt(maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2
    b2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = torch.sqrt(maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2
    b3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)
    c0 = (tr > 0)[..., None]
    c1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    c2 = (m11 >= m22)[..., None]
    q = torch.where(c0, b0, torch.where(c1, b1, torch.where(c2, b2, b3)))
    return quat_normalize(q)


def flip_align_view(normal, viewdir):
    """Flip `normal` to point against `viewdir`. Returns (normal, non_flip)."""
    d = torch.sum(normal * viewdir, dim=-1, keepdim=True)
    non_flip = d <= 0
    return torch.where(non_flip, normal, -normal), non_flip


def rotation_between_z(vec):
    """Rotation taking +z to `vec` [..., 3] -> [..., 3, 3], with the -I
    fallback at vec ≈ -z (≙ irgs_tpu rotation_between_z)."""
    v1 = -vec[..., 1]
    v2 = vec[..., 0]
    z = vec[..., 2]
    cos_p_1 = maximum(z + 1.0, 1e-7)
    one = torch.ones_like(v1)
    R = torch.stack([
        torch.stack([one - v2 * v2 / cos_p_1, v1 * v2 / cos_p_1, v2], dim=-1),
        torch.stack([v1 * v2 / cos_p_1, one - v1 * v1 / cos_p_1, -v1], dim=-1),
        torch.stack([-v2, v1, one - (v1 * v1 + v2 * v2) / cos_p_1], dim=-1),
    ], dim=-2)
    neg_eye = -torch.eye(3, dtype=vec.dtype, device=vec.device)
    return torch.where((z + 1.0 > 0)[..., None, None], R, neg_eye)


def rgb_to_srgb(img, clip_out: bool = True):
    """Linear -> sRGB (≙ irgs_tpu rgb_to_srgb)."""
    out = torch.where(
        img > 0.0031308,
        torch.pow(maximum(img, 0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * img)
    if clip_out:
        out = clip(out, 0.0, 1.0)
    return out


def srgb_to_rgb(img):
    """sRGB -> linear (≙ irgs_tpu srgb_to_rgb)."""
    return torch.where(
        img <= 0.04045, img / 12.92,
        torch.pow((maximum(img, 0.04045) + 0.055) / 1.055, 2.4))


# ---------------------------------------------------------------------------
# Camera matrices (host-side numpy; built once per camera)
# ---------------------------------------------------------------------------

def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 world-to-camera matrix; `R` camera-to-world rotation, `t`
    world-to-camera translation."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """Perspective projection, clip = P @ view (w_clip = +z_view)."""
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / math.tan(fovx / 2)
    P[1, 1] = 1.0 / math.tan(fovy / 2)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def projection_matrix_from_K(znear: float, zfar: float, H: int, W: int,
                             K: np.ndarray) -> np.ndarray:
    """Perspective projection from intrinsics K (≙ irgs_tpu
    projection_matrix_from_K, the reference's getProjectionMatrixCorrect)."""
    top = K[1, 2] / K[1, 1] * znear
    bottom = -(H - K[1, 2]) / K[1, 1] * znear
    right = K[0, 2] / K[0, 0] * znear
    left = -(W - K[0, 2]) / K[0, 0] * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))
