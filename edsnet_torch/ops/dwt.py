"""Single-level Haar/db1 DWT as strided tensor ops, differentiable.

Counterpart of edsnet_tpu/ops/dwt.py (``haar_dwt``, ``haar_idwt``), with
pywt's conventions (mode 'symmetric', 'haar'):
- cA[j] = (x[2j] + x[2j+1]) / sqrt(2);
- cD[j] = (x[2j] - x[2j+1]) / sqrt(2);
- odd length: the last sample is repeated (symmetric extension), giving
  cA[-1] = x[n-1] * sqrt(2), cD[-1] = 0.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INV_SQRT2 = 0.7071067811865476


def haar_dwt(x: torch.Tensor, dim: int = 1
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-level Haar DWT along ``dim`` -> (cA, cD), each of length
    ceil(n / 2) there."""
    x = x.movedim(dim, 0)
    if x.shape[0] % 2 == 1:
        x = torch.cat([x, x[-1:]], dim=0)
    even, odd = x[0::2], x[1::2]
    ca = (even + odd) * _INV_SQRT2
    cd = (even - odd) * _INV_SQRT2
    return ca.movedim(0, dim), cd.movedim(0, dim)


def haar_idwt(ca: torch.Tensor, cd: torch.Tensor, dim: int = 1
              ) -> torch.Tensor:
    """Inverse single-level Haar DWT (exact for even-length originals)."""
    ca, cd = ca.movedim(dim, 0), cd.movedim(dim, 0)
    even = (ca + cd) * _INV_SQRT2
    odd = (ca - cd) * _INV_SQRT2
    out = torch.stack([even, odd], dim=1).reshape((-1,) + ca.shape[1:])
    return out.movedim(0, dim)
