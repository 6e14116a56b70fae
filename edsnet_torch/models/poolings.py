"""ROI (multi-scale stride-1 average) pooling and the flat / FFT / DWT
window poolings.

Counterpart of edsnet_tpu/models/poolings.py: ``roi_avg_pool`` and
``roi_multi_scale`` (AvgPool1d(scale, stride=1, padding=scale//2) with
count_include_pad, so the divisor is always ``scale``; position i averages
[i - s//2, i - s//2 + s - 1] with zeros outside, via prefix sums), and
``Pooling`` in its fused form, the one JAX's CLIs run: each variant a
windowed linear map with folded weights (ops/window_linear.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edsnet_torch.models.common import xavier2_flax_
from edsnet_torch.ops import window_linear as wl

# pooling type -> (fold of the fc weights, coarse map or None)
VARIANTS = {"fft": (wl.fft_weight_fold, wl.fft_coarse),
            "dwt": (wl.dwt_weight_fold, wl.dwt_coarse),
            "flat-pooling": (wl.flat_weight_fold, None)}


def roi_avg_pool(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, N, H) -> (B, N, H) stride-1 avg pool, zero padded.  The prefix
    sums run in at least f32 and the result is cast back to x's dtype: a
    bfloat16 prefix sum would lose the window's low bits."""
    b, n, h = x.shape
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    pad = acc.new_zeros((b, scale, h))
    cs = torch.cumsum(torch.cat([pad, acc, pad], dim=1), dim=1)
    cs = torch.cat([acc.new_zeros((b, 1, h)), cs], dim=1)
    lo = torch.arange(n, device=x.device) - scale // 2 + scale
    window_sum = cs[:, lo + scale, :] - cs[:, lo, :]
    return (window_sum / scale).to(x.dtype)


def roi_multi_scale(x: torch.Tensor, scales: Sequence[int]) -> torch.Tensor:
    """(B, N, H) -> (B, N, S, H) ROI pooling at each anchor scale."""
    return torch.stack([roi_avg_pool(x, s) for s in scales], dim=2)


class Pooling(nn.Module):
    """flat / fft / dwt window pooling at the single scale ``scales[0]``,
    as the reference pools:
    - 'fft': coarse = mean over the window of Re(FFT(window)); fine =
      GELU(fc(flatten(Re(FFT(window)))));
    - 'dwt': coarse = mean over the Haar cA; fine = GELU(fc(flatten(cA)));
      the window must be even (fc_kernel is sized (scale//2) * H);
    - 'flat-pooling': fine = GELU(fc(flatten(window))), no coarse.
    The fc is two raw leaves of the flax names and layout, ``fc_kernel``
    [in_dim, num_hidden] and ``fc_bias``.  ``emit_coarse`` False leaves the
    coarse tensor out (the fused head pools its cls projection itself,
    ``_AnchorHeads.fused_linear_coarse``); the parameters are the same."""

    def __init__(self, scales: Sequence[int], pooling_type: str,
                 num_feature: int, num_hidden: int,
                 emit_coarse: bool = True):
        super().__init__()
        self.scale = int(list(scales)[0])
        if pooling_type not in VARIANTS:
            raise ValueError(f"Invalid pooling type {pooling_type}")
        if pooling_type == "dwt" and self.scale % 2:
            raise ValueError(f"dwt pooling needs an even --anchor-scales "
                             f"window, got {self.scale}")
        self.pooling_type = pooling_type
        self.emit_coarse = emit_coarse
        slots = self.scale // 2 if pooling_type == "dwt" else self.scale
        self.fc_kernel = nn.Parameter(torch.empty(slots * num_feature,
                                                  num_hidden))
        self.fc_bias = nn.Parameter(torch.empty(num_hidden))
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        """fc_kernel xavier-uniform (gain sqrt(2), flax's fans), fc_bias
        0.1, as flax's XAVIER2 and BIAS01."""
        xavier2_flax_(self.fc_kernel, generator)
        with torch.no_grad():
            self.fc_bias.fill_(0.1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, N, H] -> (coarse [B, N, H], fine [B, N, num_hidden]), or
        (fine,) for flat-pooling or without ``emit_coarse``."""
        fold, coarse_fn = VARIANTS[self.pooling_type]
        fine = F.gelu(wl.windowed_linear(
            x, fold(self.fc_kernel, self.scale), self.fc_bias))
        if coarse_fn is None or not self.emit_coarse:
            return (fine,)
        return self.coarse(x), fine

    def coarse(self, x: torch.Tensor) -> torch.Tensor:
        """The coarse map (fft, dwt) at this pooling's scale: linear, and
        per channel, so it also pools a projection of x."""
        return VARIANTS[self.pooling_type][1](x, self.scale)
