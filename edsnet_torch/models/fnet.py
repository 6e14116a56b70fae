"""FNet / Fourier-mixing backbone (3 orientations).

Counterpart of edsnet_tpu/models/fnet.py (``_dft_mats``, ``fft_mix``,
``FNetLayer``).  Orientations:
- 'temporal':     Re(FFT over the time axis);
- 'feature_wise': Re(FFT over the channel axis);
- 'paper':        Re(FFT_time(FFT_channel(x))), the FNet formulation.

Without a mask the time axis takes ``torch.fft``.  With a mask each video
is transformed at its true length n: Re(DFT_n) is a per-video (L, L)
cos/sin matrix applied to the time axis, so every real position equals
the unpadded computation; padded rows are garbage that the heads mask.
The channel FFT has a static length and keeps ``torch.fft``.

Dtypes as in JAX: an FFT of bfloat16 data runs in complex64 (``jnp.fft``
upcasts), and the bfloat16 DFT matrices meet its float32 parts in float32
products, so under ``--compute-dtype bfloat16`` the 'paper' and
'feature_wise' mixes return float32 and the masked 'temporal' one bfloat16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from edsnet_torch.models.common import (Dropout, LayerNorm, Linear,
                                        apply_mask, promote)

_TWO_PI = 6.283185307179586


def _dft_mats(lengths: torch.Tensor, n: int, dtype: torch.dtype
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-video Re/Im parts of the truncated DFT_n matrix, padded to
    (L, L): cos[b, j, k] = cos(2 pi j k / n_b) for j, k < n_b, else 0 (same
    for sin).  The phase is reduced with an integer modulo before the float
    division: j k reaches L^2, where a float cos() would lose the
    precision."""
    j = torch.arange(n, device=lengths.device)
    jk = j[:, None] * j[None, :]                           # [L, L] int64
    lb = torch.clamp(lengths.to(torch.int64), min=1)[:, None, None]
    phase = (jk[None] % lb).to(dtype) * (_TWO_PI / lb.to(dtype))
    valid = (j[None, :, None] < lb) & (j[None, None, :] < lb)
    cos = torch.where(valid, torch.cos(phase), 0.0)
    sin = torch.where(valid, torch.sin(phase), 0.0)
    return cos, sin


def _fft(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.fft.fft`` in at least complex64, as ``jnp.fft.fft``."""
    return torch.fft.fft(x.to(torch.promote_types(x.dtype, torch.float32)),
                         dim=dim)


def fft_mix(x: torch.Tensor, orientation: str,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, N, F] (mask [B, N] bool) -> the real Fourier mix [B, N, F]."""
    if orientation == "feature_wise":
        return _fft(x, -1).real
    if orientation not in ("temporal", "paper"):
        raise ValueError(f"Invalid fft orientation {orientation}")

    if mask is None:
        if orientation == "temporal":
            return _fft(x, -2).real
        return torch.fft.fft(_fft(x, -1), dim=-2).real

    lengths = mask.to(torch.int64).sum(dim=-1)
    cos, sin = _dft_mats(lengths, x.shape[1], x.dtype)
    if orientation == "temporal":
        return cos @ x                                      # Re(DFT_n x)
    z = _fft(x, -1)                                         # channel FFT first
    # Re(DFT_n z)
    return torch.matmul(*promote(cos, z.real)) \
        + torch.matmul(*promote(sin, z.imag))


class FNetLayer(nn.Module):
    """LN(fft + x) then LN(relu(fc(x)) + x), dropout 0.5 after the ReLU."""

    def __init__(self, num_feature: int, dropout: float = 0.5,
                 orientation: str = "paper"):
        super().__init__()
        self.orientation = orientation
        self.skip_norm = LayerNorm(num_feature)
        self.fc = Linear(num_feature, num_feature)
        self.dropout = Dropout(dropout)
        self.out_norm = LayerNorm(num_feature)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = apply_mask(x, mask)
        x = self.skip_norm(fft_mix(x, self.orientation, mask) + x)
        h = self.dropout(torch.relu(self.fc(x)))
        return self.out_norm(h + x)
