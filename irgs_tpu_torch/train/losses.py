"""Loss library (≙ irgs_tpu/train/losses.py). Images are [H, W, C]."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.math3d import clip, maximum


def l1_loss(x, y):
    return torch.abs(x - y).mean()


def l2_loss(x, y):
    return ((x - y) ** 2).mean()


def psnr(img, gt):
    """20·log10(1/√mse)."""
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(maximum(mse, 1e-12)))


def _gaussian_window(size: int = 11, sigma: float = 1.5):
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.tensor(np.outer(g, g).astype(np.float32))


def _depthwise(x, kernel, padding):
    """[H, W, C] depthwise conv with a [k, k] kernel -> [H', W', C]."""
    c = x.shape[-1]
    lhs = x.permute(2, 0, 1)[None]
    rhs = kernel.to(x.device).expand(c, 1, *kernel.shape)
    return F.conv2d(lhs, rhs, padding=padding, groups=c)[0].permute(1, 2, 0)


def ssim(img1, img2, window_size: int = 11):
    """SSIM, 11×11 σ=1.5 Gaussian window, zero padding."""
    w = _gaussian_window(window_size)
    conv = lambda x: _depthwise(x, w, window_size // 2)
    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(img1 * img1) - mu1_sq
    s2 = conv(img2 * img2) - mu2_sq
    s12 = conv(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = (((2 * mu12 + c1) * (2 * s12 + c2))
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return m.mean()


_SOBEL_X = torch.tensor(np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                                 np.float32) / 8.0)


def _sobel_grads(x):
    """[H, W, C] -> (gx, gy), normalized Sobel with replicate padding."""
    xp = F.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")
    xp = xp[0].permute(1, 2, 0)
    return _depthwise(xp, _SOBEL_X, 0), _depthwise(xp, _SOBEL_X.T, 0)


def first_order_edge_aware_loss(data, img):
    """Σ_g |∂g data| · exp(-|∂g img|), mean."""
    dgx, dgy = _sobel_grads(data)
    igx, igy = _sobel_grads(img)
    return (torch.abs(dgx) * torch.exp(-torch.abs(igx))
            + torch.abs(dgy) * torch.exp(-torch.abs(igy))).mean()


def tv_loss(x):
    """Squared total variation. x: [H, W, C]."""
    return (torch.square(x[1:, :] - x[:-1, :]).mean()
            + torch.square(x[:, 1:] - x[:, :-1]).mean())


def mask_entropy_loss(alpha, mask):
    """Binary cross-entropy pushing alpha to the image mask."""
    o = clip(alpha, 1e-6, 1 - 1e-6)
    m = mask.to(o.dtype)
    return -(m * torch.log(o) + (1 - m) * torch.log(1 - o)).mean()


def normal_consistency_loss(rend_normal, surf_normal):
    """1 - n·n' between rendered and depth-derived normals."""
    return (1.0 - torch.sum(rend_normal * surf_normal, dim=-1)).mean()
