"""k-nearest-neighbour mean squared distance (≙ irgs_tpu/ops/knn.py, itself
≙ simple-knn's distCUDA2).

Used once, at initialisation, to set the Gaussians' scales. A chunked brute
force: each chunk of query points takes its squared distances to every
point through |a - b|² = |a|² + |b|² - 2a·b (one matrix product) and keeps
the k smallest with topk, as the JAX version does with lax.top_k. Above
50k points `create_from_pcd` takes the Morton-window search of
utils/native.py instead, as the JAX package does.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def mean_knn_dist2(points, k: int = 3, chunk: int = 1024):
    """points [N, 3] float32 -> [N]: the mean of the k smallest squared
    distances to other points (the point itself is left out, duplicates of
    it are not), clamped at 0."""
    n = points.shape[0]
    dev = points.device
    pad = (-n) % chunk
    pts = torch.cat([points.to(torch.float32),
                     torch.full((pad, 3), 1e9, dtype=torch.float32,
                                device=dev)])
    sq = torch.sum(pts * pts, dim=-1)
    col = torch.arange(pts.shape[0], device=dev)
    out = []
    for a in range(0, pts.shape[0], chunk):
        q, qsq = pts[a:a + chunk], sq[a:a + chunk]
        d2 = qsq[:, None] + sq[None, :] - 2.0 * (q @ pts.T)
        mask = (col[a:a + chunk, None] == col[None, :]) | (col[None, :] >= n)
        d2 = torch.where(mask, torch.full_like(d2, float("inf")), d2)
        out.append(torch.topk(d2, k, dim=-1, largest=False).values.mean(-1))
    return torch.clamp(torch.cat(out)[:n], min=0.0)
