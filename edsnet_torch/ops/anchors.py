"""Anchor machinery for the anchor-based head (evaluate path).

Counterpart of edsnet_tpu/ops/anchors.py: ``get_anchors`` and
``anchor_scales_list``.  The label-generation functions come with the
training slice.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def get_anchors(seq_len: int, scales: Sequence[int],
                device: torch.device | str = "cpu") -> torch.Tensor:
    """[N, S, 2] int32 center-width anchors: (pos, scale)."""
    pos = torch.arange(seq_len, dtype=torch.int32, device=device)
    sc = torch.as_tensor(list(scales), dtype=torch.int32, device=device)
    centers = pos[:, None].expand(seq_len, len(sc))
    widths = sc[None, :].expand(seq_len, len(sc))
    return torch.stack([centers, widths], dim=-1)


def anchor_scales_list(anchor_scales) -> List[int]:
    if isinstance(anchor_scales, int):
        return [anchor_scales]
    return list(anchor_scales)
