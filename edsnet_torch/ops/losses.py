"""Anchor-based training losses, masked, one value per video.

Counterpart of edsnet_tpu/ops/losses.py: ``_masked_mean``, ``smooth_l1``,
``ab_loc_loss`` and ``ab_cls_loss``, with eps 1e-8 and ``max(sum, 1)``
denominators.  The TPU package defines them for one video and vmaps them in
the train step; here they take a leading video axis and reduce every other
axis, so ``[B, ...]`` inputs give ``[B]`` losses.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-video mean of ``x`` over ``mask``: [B, ...] -> [B]."""
    x = x.flatten(1)
    mask = mask.flatten(1).to(x.dtype)
    return (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth L1 with beta 1."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def ab_loc_loss(pred_loc: torch.Tensor, test_loc: torch.Tensor,
                cls_label: torch.Tensor, use_smooth: bool = True
                ) -> torch.Tensor:
    """Smooth-L1 (or L1) offset loss over positive anchors.

    :param pred_loc: [B, N, S, 2]; ``test_loc`` the same.
    :param cls_label: [B, N, S], 1 = positive.
    :return: [B].
    """
    pos = (cls_label == 1)[..., None].expand_as(pred_loc)
    err = smooth_l1(pred_loc, test_loc) if use_smooth \
        else torch.abs(pred_loc - test_loc)
    return _masked_mean(err, pos)


def ab_cls_loss(pred: torch.Tensor, test: torch.Tensor,
                eps: float = _EPS) -> torch.Tensor:
    """0.5 * (mean -log p over positives + mean -log(1 - p) over
    negatives); label 1 = positive, -1 = negative, 0 = ignored.
    [B, ...] -> [B]."""
    pred = pred.to(torch.float32)
    loss_pos = _masked_mean(-torch.log(torch.clamp(pred, min=eps)),
                            test == 1)
    loss_neg = _masked_mean(-torch.log(torch.clamp(1.0 - pred, min=eps)),
                            test == -1)
    return 0.5 * (loss_pos + loss_neg)
