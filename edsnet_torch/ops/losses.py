"""Training losses, masked, one value per video: anchor-based and
anchor-free.

Counterpart of edsnet_tpu/ops/losses.py: ``_masked_mean``, ``smooth_l1``,
``ab_loc_loss``, ``ab_cls_loss``, ``focal_loss``, ``af_cls_loss``,
``iou_offset``, ``af_loc_loss`` and ``af_ctr_loss``, with eps 1e-8 and
``max(sum, 1)`` denominators.  The TPU package defines them for one video
and vmaps them in the train step; here they take a leading video axis and
reduce every other axis, so ``[B, ...]`` inputs give ``[B]`` losses.

The anchor-free losses compute JAX's formulas operation for operation,
bounds included (``jnp.maximum`` / ``jnp.clip`` become ``torch.maximum`` /
``torch.minimum``, which split the gradient at a tie as JAX does), so that
p at 0 or 1 and infinite extents give JAX's values: e.g. the centerness
clip's upper bound 1 - 1e-8 is 1.0 in float32, and a prediction of 1.0
there gives JAX's NaN.
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


def _bound(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """jnp.maximum(x, lo) then jnp.minimum(x, hi), the bounds in x's
    dtype."""
    if lo is not None:
        x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype, device=x.device))
    return x


def focal_loss(x: torch.Tensor, y: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Binary focal loss over two-column predictions, summed per video
    (JAX's ``reduction="sum"``, the one its callers use).

    :param x: [B, N, 2] columns (1 - p, p); ``y``: [B, N] labels in {0, 1}.
    :param weight: optional [B, N] applied before the sum.
    :return: [B].
    """
    x = x.to(torch.float32)
    t = torch.nn.functional.one_hot(y.to(torch.int64), x.shape[-1]).to(
        x.dtype)
    p_t = x * t + (1 - x) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    fl = -alpha_t * (1 - p_t) ** gamma * torch.log(_bound(p_t, lo=_EPS))
    if weight is not None:
        fl = fl * weight[..., None]
    return fl.flatten(1).sum(dim=1)


def af_cls_loss(pred: torch.Tensor, test: torch.Tensor, kind: str,
                mask: torch.Tensor) -> torch.Tensor:
    """Focal or cross-entropy loss over (1 - p, p) at the mask's positions,
    divided by max(#positives there, 1).  [B, N] -> [B]."""
    pred = pred.to(torch.float32)
    mask = mask.to(torch.bool)
    test_i = test.to(torch.int32)
    num_pos = torch.clamp(torch.where(mask, test_i, 0).sum(dim=1), min=1)
    two_col = torch.stack([1.0 - pred, pred], dim=-1)
    if kind == "focal":
        loss = focal_loss(two_col, test_i, weight=mask.to(pred.dtype))
    elif kind == "cross-entropy":
        logp = torch.log(_bound(two_col, lo=_EPS))
        nll = -torch.gather(logp, -1, test_i.to(torch.int64)[..., None]
                            )[..., 0]
        loss = _masked_mean(nll, mask)
    else:
        raise ValueError(f"Invalid loss type {kind}")
    return loss / num_pos.to(torch.float32)


def iou_offset(offset_a: torch.Tensor, offset_b: torch.Tensor,
               eps: float = _EPS) -> torch.Tensor:
    """IoU of (l, r) extent pairs about the same position: [..., 2] ->
    [...]."""
    a_l, a_r = offset_a[..., 0], offset_a[..., 1]
    b_l, b_r = offset_b[..., 0], offset_b[..., 1]
    len_a = a_l + a_r
    len_b = b_l + b_r
    inter = torch.minimum(a_l, b_l) + torch.minimum(a_r, b_r)
    inter = _bound(inter, lo=0.0)
    union = len_a + len_b - inter
    union = torch.where(union <= 0, eps, union)
    return inter / union


def af_loc_loss(pred_loc: torch.Tensor, test_loc: torch.Tensor,
                cls_label: torch.Tensor, kind: str = "soft-iou",
                eps: float = _EPS) -> torch.Tensor:
    """Soft-IoU (-log(iou + eps)) or smooth-L1 over positive positions.
    pred_loc, test_loc [B, N, 2]; cls_label [B, N] -> [B]."""
    pos = cls_label.to(torch.bool)
    if kind == "soft-iou":
        iou = iou_offset(pred_loc, test_loc)
        return _masked_mean(-torch.log(iou + eps), pos)
    if kind == "smooth-l1":
        return _masked_mean(smooth_l1(pred_loc, test_loc),
                            pos[..., None].expand_as(pred_loc))
    raise ValueError(f"Invalid loss type {kind}")


def af_ctr_loss(pred: torch.Tensor, test: torch.Tensor,
                pos_mask: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy over positive positions, p clipped to
    [1e-8, 1 - 1e-8] in float32.  [B, N] -> [B]."""
    p = _bound(pred.to(torch.float32), lo=_EPS, hi=1.0 - _EPS)
    t = test.to(torch.float32)
    bce = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
    return _masked_mean(bce, pos_mask.to(torch.bool))
