"""ROI (multi-scale stride-1 average) pooling.

Counterpart of edsnet_tpu/models/poolings.py:roi_avg_pool and
roi_multi_scale: AvgPool1d(scale, stride=1, padding=scale//2) with
count_include_pad, so the divisor is always ``scale``; position i averages
[i - s//2, i - s//2 + s - 1] with zeros outside, via prefix sums.
"""
from __future__ import annotations

from typing import Sequence

import torch


def roi_avg_pool(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, N, H) -> (B, N, H) stride-1 avg pool, zero padded."""
    b, n, h = x.shape
    pad = x.new_zeros((b, scale, h))
    cs = torch.cumsum(torch.cat([pad, x, pad], dim=1), dim=1)
    cs = torch.cat([x.new_zeros((b, 1, h)), cs], dim=1)
    lo = torch.arange(n, device=x.device) - scale // 2 + scale
    window_sum = cs[:, lo + scale, :] - cs[:, lo, :]
    return window_sum / scale


def roi_multi_scale(x: torch.Tensor, scales: Sequence[int]) -> torch.Tensor:
    """(B, N, H) -> (B, N, S, H) ROI pooling at each anchor scale."""
    return torch.stack([roi_avg_pool(x, s) for s in scales], dim=2)
