"""Image metrics: PSNR, SSIM and VGG-LPIPS (≙ irgs_tpu/eval/metrics.py).

`psnr` and `ssim` are those of train/losses.py. LPIPS needs the VGG16
ImageNet conv weights and the lpips v0.1 linear weights; the repository
ships neither, so `load_vgg16_weights` probes for them (the
``IRGS_TPU_VGG16_NPZ`` npz, ``assets/vgg16_lpips.npz``, then torchvision's
VGG16 checkpoint in the torch hub cache) and `lpips_fn` returns None when
none is found. Nothing is downloaded. The convolutions are PyTorch's own
(``F.conv2d``, ``F.max_pool2d``), as the reference uses XLA's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..train.losses import psnr, ssim  # noqa: F401  (re-export)

_LPIPS_BLOCKS = 5
# BaseNet z_score buffers of the vendored lpips module, applied to [0, 1]
# images directly
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 conv plan: (out_channels | "M" maxpool); features are taken after the
# relus of features indices [4, 9, 16, 23, 30]
_VGG_ARCH = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
_CAPTURE_RELUS = {1, 3, 6, 10, 14}

_warned_no_weights = False


def _candidate_weight_paths():
    """Where weights are looked for, in order: the npz named by
    IRGS_TPU_VGG16_NPZ, the repository's assets copy, torchvision's VGG16
    checkpoint in the torch hub cache."""
    yield os.environ.get("IRGS_TPU_VGG16_NPZ", ""), "npz"
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    yield os.path.join(here, "assets", "vgg16_lpips.npz"), "npz"
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch"))
    yield os.path.join(torch_home, "hub", "checkpoints",
                       "vgg16-397923af.pth"), "torch_vgg"


def _from_torchvision(path):
    """conv{i}_w / conv{i}_b from a torchvision VGG16 state dict, or None
    when it does not hold the 13 convolutions."""
    sd = torch.load(path, map_location="cpu")
    idxs = sorted(int(k.split(".")[1]) for k in sd
                  if k.startswith("features") and k.endswith(".weight"))
    if len(idxs) < 13:
        return None
    out = {}
    for ci, idx in enumerate(idxs):
        out[f"conv{ci}_w"] = sd[f"features.{idx}.weight"].numpy()
        out[f"conv{ci}_b"] = sd[f"features.{idx}.bias"].numpy()
    return out      # no lin weights: the "lpips-like" unit weighting


def load_vgg16_weights(quiet: bool = False):
    """A dict of numpy arrays (conv{i}_w [O, I, 3, 3], conv{i}_b [O],
    optionally lin{i}_w [C]), or None with one warning."""
    global _warned_no_weights
    for path, kind in _candidate_weight_paths():
        if not path or not os.path.exists(path):
            continue
        if kind == "npz":
            return dict(np.load(path))
        weights = _from_torchvision(path)
        if weights is not None:
            return weights
    if not _warned_no_weights and not quiet:
        _warned_no_weights = True
        print("WARNING: no VGG16/LPIPS weights found (probed "
              "IRGS_TPU_VGG16_NPZ, assets/vgg16_lpips.npz, TORCH_HOME "
              "checkpoints); lpips is recorded as null.",
              file=sys.stderr, flush=True)
    return None


def _vgg_features(x, weights):
    """x [H, W, 3] in [0, 1] -> the 5 channel-normalized feature maps."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    h = ((x - shift) / scale).permute(2, 0, 1)[None]
    conv_idx = relu_index = 0
    outs = []
    for a in _VGG_ARCH:
        if a == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        w = torch.as_tensor(weights[f"conv{conv_idx}_w"], device=x.device)
        b = torch.as_tensor(weights[f"conv{conv_idx}_b"], device=x.device)
        h = F.relu(F.conv2d(h, w, b, padding=1))
        if relu_index in _CAPTURE_RELUS:
            norm = torch.sqrt(torch.sum(h * h, dim=1, keepdim=True))
            outs.append(h / (norm + 1e-10))
        conv_idx += 1
        relu_index += 1
        if len(outs) == _LPIPS_BLOCKS:
            break
    return outs


@torch.no_grad()
def lpips_fn(img1, img2, weights=None):
    """LPIPS(vgg) distance between [H, W, 3] images in [0, 1]: squared
    feature differences through the lpips 1x1 linear layers (lin{i}_w),
    spatially averaged and summed over blocks; unit linear weights when only
    the conv weights are present. None without weights."""
    weights = weights if weights is not None else load_vgg16_weights()
    if weights is None:
        return None
    f1 = _vgg_features(img1, weights)
    f2 = _vgg_features(img2, weights)
    dist = 0.0
    for i, (a, b) in enumerate(zip(f1, f2)):
        diff = (a - b) ** 2
        key = f"lin{i}_w"
        if key in weights:
            w = torch.as_tensor(weights[key], device=a.device).reshape(1, -1, 1, 1)
            diff = diff * w
        dist = dist + float(torch.mean(torch.sum(diff, dim=1)))
    return dist
