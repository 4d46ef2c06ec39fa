"""Flattened training-ray bank for ray-batch sampling
(≙ irgs_tpu/scene/raybank.py).

Every training pixel of every camera becomes one (origin, direction, rgb)
record, and batches are drawn uniformly over the whole bank (≙ reference
Scene.train_rays + get_batch_rays, scene/__init__.py:96-110, 133-136). As in
the reference and the JAX package, no trainer calls it: it is the same
surface, held by the tests.

The bank is built on the host in numpy; `get_batch_rays` draws the JAX
package's indices from the same ``np.random.RandomState`` and returns
tensors on the bank's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class RayBank:
    def __init__(self, cams, batch_size: int = 2 ** 16, device=None):
        """cams: list of Camera (scene/cameras.py) with .image loaded."""
        self.device = resolve_device(device)
        ro, rd, rgb = [], [], []
        for cam in cams:
            cp = cam.params("cpu")
            dirs = cp.ray_dirs(cam.width, cam.height,
                               normalize=True).numpy().reshape(-1, 3)
            origin = np.broadcast_to(cp.cam_pos.numpy()[None], dirs.shape)
            ro.append(origin.astype(np.float32))
            rd.append(dirs.astype(np.float32))
            rgb.append(np.asarray(cam.image, np.float32).reshape(-1, 3))
        self.rays_o = np.concatenate(ro)
        self.rays_d = np.concatenate(rd)
        self.rays_rgb = np.concatenate(rgb)
        self.batch_size = batch_size
        self._rng = np.random.RandomState(0)

    def __len__(self):
        return self.rays_o.shape[0]

    def get_batch_rays(self, rng: np.random.RandomState | None = None):
        """Uniform random ray batch -> (rays_o [B, 3], rays_d [B, 3],
        rgb [B, 3]) on the bank's device."""
        rng = rng or self._rng
        idx = rng.randint(0, len(self), size=self.batch_size)
        put = lambda a: torch.from_numpy(a[idx]).to(self.device)
        return put(self.rays_o), put(self.rays_d), put(self.rays_rgb)
