"""irgs_tpu_torch — the PyTorch + CUDA port of irgs_tpu, for NVIDIA Hopper.

The JAX package ``irgs_tpu`` is the reference; this package mirrors its
layout (``ops/ scene/ render/ train/ eval/ parallel/ utils/``) and module
names so that each counterpart is easy to find. It imports ``torch`` and
numpy, never ``jax`` and nothing of ``irgs_tpu`` (whose ``__init__`` imports
JAX and sets global config).

The per-tile surfel blend that ``irgs_tpu`` wrote as a Pallas TPU kernel is a
hand-written CUDA kernel here (``csrc/raster_blend.cu``, bound in
``ops/raster_blend.py``); the rest is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# fp32 throughout, as irgs_tpu sets jax_default_matmul_precision=highest:
# no TF32 in matmuls, and none in cuDNN convolutions (SSIM is a conv). The
# convolutions' backward takes deterministic algorithms, so that a step's
# gradients have the same bits on every run, as the reference's do.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cudnn.deterministic = True


def resolve_device(device=None) -> _torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    there is no silent CPU fallback."""
    dev = _torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "irgs_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
