"""Anchor machinery for the anchor-based head.

Counterpart of edsnet_tpu/ops/anchors.py: ``get_anchors``,
``bbox2offset``, ``offset2bbox`` and ``anchor_scales_list`` on tensors, and
the host numpy label functions ``get_anchors_np``, ``_iou_cw_np`` and
``get_pos_label_np`` (the loc label goes to the last matching target, the
reference's loop order).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def get_anchors(seq_len: int, scales: Sequence[int],
                device: torch.device | str = "cpu") -> torch.Tensor:
    """[N, S, 2] int32 center-width anchors: (pos, scale)."""
    pos = torch.arange(seq_len, dtype=torch.int32, device=device)
    sc = torch.as_tensor(list(scales), dtype=torch.int32, device=device)
    centers = pos[:, None].expand(seq_len, len(sc))
    widths = sc[None, :].expand(seq_len, len(sc))
    return torch.stack([centers, widths], dim=-1)


def bbox2offset(bboxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """CW boxes -> offset labels (center offset over width, log width
    ratio)."""
    bboxes = bboxes.to(torch.float32)
    anchors = anchors.to(torch.float32)
    oc = (bboxes[..., 0] - anchors[..., 0]) / anchors[..., 1]
    ow = torch.log(bboxes[..., 1] / anchors[..., 1])
    return torch.stack([oc, ow], dim=-1)


def offset2bbox(offsets: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Predicted offsets -> CW boxes, flattened to [K, 2]."""
    offsets = offsets.to(torch.float32).reshape(-1, 2)
    anchors = anchors.to(torch.float32).reshape(-1, 2)
    bc = offsets[:, 0] * anchors[:, 1] + anchors[:, 0]
    bw = torch.exp(offsets[:, 1]) * anchors[:, 1]
    return torch.stack([bc, bw], dim=-1)


def anchor_scales_list(anchor_scales) -> List[int]:
    if isinstance(anchor_scales, int):
        return [anchor_scales]
    return list(anchor_scales)


# host numpy label functions (run once per video at data preparation)

def _iou_cw_np(a: np.ndarray, t: np.ndarray) -> np.ndarray:
    """IoU of CW boxes with the hull-span denominator; zero spans get
    1e-6."""
    a_l, a_r = a[..., 0] - a[..., 1] * 0.5, a[..., 0] + a[..., 1] * 0.5
    t_l, t_r = t[..., 0] - t[..., 1] * 0.5, t[..., 0] + t[..., 1] * 0.5
    inter = np.maximum(np.minimum(a_r, t_r) - np.maximum(a_l, t_l), 0.0)
    union = np.maximum(a_r, t_r) - np.minimum(a_l, t_l)
    union = np.where(union <= 0.0, 1e-6, union)
    return inter / union


def get_anchors_np(seq_len: int, scales: Sequence[int]) -> np.ndarray:
    """Numpy ``get_anchors``: [N, S, 2] int32."""
    pos = np.arange(seq_len, dtype=np.int32)
    sc = np.asarray(list(scales), dtype=np.int32)
    centers = np.broadcast_to(pos[:, None], (seq_len, len(sc)))
    widths = np.broadcast_to(sc[None, :], (seq_len, len(sc)))
    return np.stack([centers, widths], axis=-1)


def get_pos_label_np(anchors, targets, iou_thresh: float, target_valid=None):
    """Positive labels: anchors [N, S, 2] CW, targets [T, 2] CW (padded rows
    masked out by ``target_valid``), positive when IoU > ``iou_thresh``.

    Returns (cls_label [N, S] int32 0/1, loc_label [N, S, 2] float32); an
    anchor positive to several targets takes the offset to the last one."""
    anchors = np.asarray(anchors, np.float32)
    n, s, _ = anchors.shape
    flat = anchors.reshape(n * s, 2)
    targets = np.asarray(targets, np.float32).reshape(-1, 2)
    t = targets.shape[0]

    iou = _iou_cw_np(flat[None, :, :], targets[:, None, :])  # [T, A]
    pos = iou > iou_thresh
    if target_valid is not None:
        pos = pos & np.asarray(target_valid, bool)[:, None]

    cls_label = np.any(pos, axis=0).astype(np.int32)
    if t:
        last_t = np.max(np.where(pos, np.arange(t)[:, None], -1), axis=0)
        chosen = targets[np.clip(last_t, 0, t - 1)]
    else:
        last_t = np.full(n * s, -1)
        chosen = np.zeros((n * s, 2), np.float32)
    oc = (chosen[:, 0] - flat[:, 0]) / flat[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        ow = np.log(chosen[:, 1] / flat[:, 1])
    offsets = np.stack([oc, ow], axis=-1).astype(np.float32)
    loc_label = np.where((last_t >= 0)[:, None], offsets, 0.0)
    return (cls_label.reshape(n, s),
            loc_label.reshape(n, s, 2).astype(np.float32))
