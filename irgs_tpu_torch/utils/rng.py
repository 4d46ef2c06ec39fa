"""Counter-based random bits: a pure function of (seed, id, sample, stream),
and the chi-square check of draws against their pmf.

The light sampler draws from these instead of a generator's state, so that
a pixel's draws depend only on its id (chunking and foreground compaction do
not change them) and the card computes the same bits as the CPU. Every value
is a 32-bit word held in int64 and every product is split into 16-bit halves,
so no intermediate exceeds 2^48 and nothing depends on how a device handles
signed overflow.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64."""
    lo = x * (c & _M16)
    hi = ((x * (c >> 16)) & _M16) << 16
    return (lo + hi) & _M32


def mix32(x):
    """The lowbias32 integer hash (C. Wellons) of 32-bit words in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_words(seed, ids, samples, stream: int):
    """32-bit words in int64, one per element of `ids` (broadcast against
    `samples`): each a hash of (seed, id, sample, stream). `seed` is an int
    or an int64 tensor scalar; `ids` and `samples` are int64 tensors."""
    h = mix32((torch.as_tensor(seed, dtype=torch.int64, device=ids.device)
               + 0x9E3779B9 * (stream + 1)) & _M32)
    h = mix32(h ^ (ids & _M32))
    return mix32(h ^ (samples & _M32))


def uniform24(seed, ids, samples, stream: int):
    """float32 uniforms in [0, 1) on a 2^-24 lattice (exact in float32)."""
    return (hash_words(seed, ids, samples, stream) >> 8).to(torch.float32) \
        * (1.0 / (1 << 24))


def uniform53(seed, ids, samples, stream: int):
    """float64 uniforms in [0, 1) on a 2^-53 lattice, from two words (streams
    `stream` and `stream + 1`)."""
    a = hash_words(seed, ids, samples, stream) >> 5             # 27 bits
    b = hash_words(seed, ids, samples, stream + 1) >> 6         # 26 bits
    return ((a << 26) + b).to(torch.float64) * (1.0 / (1 << 53))


def chi_square_z(idx, pmf) -> tuple[float, int]:
    """Chi-square of the counts of the drawn indices `idx` against n·pmf,
    over the bins whose expected count is at least 5 (the rest pooled into
    one bin), as a z-score by the Wilson-Hilferty approximation -> (z,
    degrees of freedom). |z| < 4 passes a draw of the pmf's distribution."""
    p = pmf.reshape(-1).double().cpu().numpy()
    p = p / p.sum()
    n = idx.numel()
    counts = np.bincount(idx.reshape(-1).cpu().numpy(), minlength=p.size)
    exp = n * p
    big = exp >= 5
    obs = np.append(counts[big], counts[~big].sum())
    e = np.append(exp[big], exp[~big].sum())
    keep = e > 0
    chi2 = float(((obs[keep] - e[keep]) ** 2 / e[keep]).sum())
    k = int(keep.sum()) - 1
    z = ((chi2 / k) ** (1 / 3) - (1 - 2 / (9 * k))) / math.sqrt(2 / (9 * k))
    return z, k
