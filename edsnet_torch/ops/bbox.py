"""1-D box IoU and batched greedy NMS.

Counterpart of edsnet_tpu/ops/bbox.py: ``iou_lr`` keeps the reference's
convex-hull denominator, and ``nms_masked`` the deterministic tie order
(stable ascending argsort, flipped: among equal scores the larger original
index goes first).  The batch dimension is written out instead of vmapped.
"""
from __future__ import annotations

from typing import Optional

import torch


def iou_lr(anchor_bbox: torch.Tensor, target_bbox: torch.Tensor
           ) -> torch.Tensor:
    """IoU of LR boxes with the hull-span denominator; broadcasts over
    leading dims: [..., 2] x [..., 2] -> [...]."""
    a = anchor_bbox.to(torch.float32)
    t = target_bbox.to(torch.float32)
    a_l, a_r = a[..., 0], a[..., 1]
    t_l, t_r = t[..., 0], t[..., 1]
    inter = torch.clamp(torch.minimum(a_r, t_r) - torch.maximum(a_l, t_l),
                        min=0.0)
    union = torch.maximum(a_r, t_r) - torch.minimum(a_l, t_l)
    union = torch.where(union <= 0.0, 1e-6, union)
    return inter / union


def nms_masked(scores: torch.Tensor, bboxes: torch.Tensor, thresh: float,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy score-sorted NMS over 1-D LR boxes, per batch row.

    :param scores: [B, N] confidences.
    :param bboxes: [B, N, 2] LR boxes; boxes with left >= right are dropped.
    :param thresh: suppress when iou >= thresh.
    :param valid: optional [B, N] bool mask of live entries.
    :return: keep [B, N] bool over the original order.

    The suppression matrix is built once in score-sorted order.  The greedy
    pass then walks it with two tensor ops per position and no host sync.
    IoU is symmetric, so with the diagonal cleared a kept box is never
    suppressed later, and the surviving ``alive`` mask is the kept set.
    """
    scores = scores.to(torch.float32)
    bboxes = bboxes.to(torch.float32)
    b, n = scores.shape
    alive = bboxes[..., 0] < bboxes[..., 1]
    if valid is not None:
        alive = alive & valid.to(torch.bool)

    order = torch.argsort(scores, dim=-1, stable=True).flip(-1)
    boxes_s = torch.gather(bboxes, 1, order[..., None].expand(b, n, 2))
    suppress = iou_lr(boxes_s[:, :, None, :], boxes_s[:, None, :, :]) >= thresh
    suppress.diagonal(dim1=1, dim2=2).fill_(False)
    alive_s = torch.gather(alive, 1, order)
    for i in range(n):
        alive_s.masked_fill_(alive_s[:, i:i + 1] & suppress[:, i], False)
    return torch.zeros_like(alive).scatter_(1, order, alive_s)
