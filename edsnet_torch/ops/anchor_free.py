"""Anchor-free (FCOS-style) labels: per-position distances to the ends of
the keyshot segment that holds the position, their centerness, and the
decode of such offsets into boxes.

Counterpart of edsnet_tpu/ops/anchor_free.py.  The numpy functions
(``get_loc_label_np``, ``get_ctr_label_np``) are the host label path that
training uses (data/batching.py:prepare_af_item); the torch functions take
any leading axes and run on the tensor's device, the run lengths by
cumulative maxima rather than a loop over positions.  ``offset2bbox`` is
the heads' box decode (models/dsnet_af.py:_af_predict).
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def _run_lengths(inside: torch.Tensor) -> torch.Tensor:
    """Length of the run of ones ending at each position, along the last
    axis (0 outside a run)."""
    n = inside.shape[-1]
    idx = torch.arange(n, device=inside.device).expand_as(inside)
    last_zero = torch.where(inside, -1, idx).cummax(dim=-1).values
    return torch.where(inside, idx - last_zero, 0)


def get_loc_label(target: torch.Tensor) -> torch.Tensor:
    """[..., N] 0/1 target -> [..., N, 2] float32 (distance to the segment's
    first position, distance to its last); (0, 0) outside any segment.
    Padding must be 0."""
    inside = target > 0
    run_l = _run_lengths(inside)
    run_r = _run_lengths(inside.flip(-1)).flip(-1)
    offsets = torch.stack([run_l - 1, run_r - 1], dim=-1).to(torch.float32)
    return torch.where(inside[..., None], offsets, 0.0)


def get_ctr_label(target: torch.Tensor, offset: torch.Tensor,
                  eps: float = _EPS) -> torch.Tensor:
    """Centerness min(l, r) / (max(l, r) + eps) inside the target, 0
    outside."""
    offset = offset.to(torch.float32)
    ol, orr = offset[..., 0], offset[..., 1]
    ctr = torch.minimum(ol, orr) / (torch.maximum(ol, orr) + eps)
    return torch.where(target.to(torch.bool), ctr, 0.0)


def offset2bbox(offsets: torch.Tensor) -> torch.Tensor:
    """[..., N, 2] (l, r) offsets -> [..., N, 2] boxes (i - l, i + r + 1),
    with i a float32 position: integer offsets give float32 boxes, floating
    ones the wider of their type and float32, as in JAX."""
    if not offsets.is_floating_point():
        offsets = offsets.to(torch.float32)
    idx = torch.arange(offsets.shape[-2], dtype=torch.float32,
                       device=offsets.device)
    return torch.stack([idx - offsets[..., 0], idx + offsets[..., 1] + 1],
                       dim=-1)


def get_loc_label_np(target) -> np.ndarray:
    """``get_loc_label`` for one video on the host: [N] -> [N, 2]."""
    m = np.asarray(target).astype(np.int32)
    idx = np.arange(m.shape[0])
    last_zero = np.maximum.accumulate(np.where(m == 0, idx, -1))
    run_l = idx - last_zero
    last_zero_r = np.maximum.accumulate(np.where(m[::-1] == 0, idx, -1))
    run_r = (idx - last_zero_r)[::-1]
    inside = m > 0
    return np.stack([np.where(inside, (run_l - 1).astype(np.float32), 0.0),
                     np.where(inside, (run_r - 1).astype(np.float32), 0.0)],
                    axis=-1)


def get_ctr_label_np(target, offset, eps: float = _EPS) -> np.ndarray:
    """``get_ctr_label`` for one video on the host, float32."""
    target = np.asarray(target).astype(bool)
    offset = np.asarray(offset, np.float32)
    ol, orr = offset[..., 0], offset[..., 1]
    ctr = np.minimum(ol, orr) / (np.maximum(ol, orr) + eps)
    return np.where(target, ctr, 0.0).astype(np.float32)
