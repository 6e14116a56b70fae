"""The anchor-based train step: label sampling, forward, masked losses,
backward and the Adam update over one padded batch of videos.

Counterpart of edsnet_tpu/parallel/steps.py (``make_optimizer``,
``resolve_batch``, ``_sample_marks``, ``build_ab_cls_labels``,
``ab_train_step``), on one device.  The step queues its work on the
device and returns its losses as device tensors: nothing in it waits for
the device.  The model runs in training mode, so the attention backbone
takes its dense path with dropout on the attention map, as the TPU
package's step does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from edsnet_torch.ops import losses as L


def make_optimizer(params, lr: float, weight_decay: float
                   ) -> torch.optim.Optimizer:
    """Adam whose L2 term is added to the gradient before the moments
    (torch's ``weight_decay``; optax ``add_decayed_weights`` then
    ``adam`` in the TPU package)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def resolve_batch(batch: Dict) -> Dict:
    """A batch is either explicit tensors, or a length-bucket ``pool``
    resident on the device plus this step's row indices (``gather_idx``)
    and validity (``video_valid``), gathered here on the device."""
    if "pool" not in batch:
        return batch
    idx = batch["gather_idx"]
    out = {k: v[idx] for k, v in batch["pool"].items()}
    out["video_valid"] = batch["video_valid"]
    return out


def _sample_marks(eligible: torch.Tensor, num: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Mark the ``num[b]`` eligible entries of each row b with the smallest
    uniform draws ``u`` (ties broken by flat index), exactly ``min(num,
    eligible)`` of them.

    :param eligible: [B, ...] bool.
    :param num: [B] int.
    :param u: uniform draws, the shape of ``eligible``.
    :return: [B, ...] bool marks.
    """
    b = eligible.shape[0]
    flat = eligible.reshape(b, -1)
    draws = torch.where(flat, u.reshape(b, -1), torch.inf)
    order = torch.argsort(draws, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(flat.shape[1], device=flat.device)
        .expand_as(order))
    return (flat & (rank < num[:, None])).reshape(eligible.shape)


def build_ab_cls_labels(batch: Dict, generator: Optional[torch.Generator],
                        neg_ratio: float, inc_ratio: float) -> torch.Tensor:
    """Per-video random negatives and incompletes -> -1/0/1 labels; the
    uniform draws come from ``generator``."""
    num_pos = batch["num_pos"]
    num_neg = (neg_ratio * num_pos).to(torch.int32)
    num_inc = (inc_ratio * num_pos).to(torch.int32)
    device = num_pos.device

    def draws(shape):
        return torch.rand(shape, generator=generator, device=device)

    neg = _sample_marks(batch["neg_eligible"], num_neg,
                        draws(batch["neg_eligible"].shape))
    inc = _sample_marks(batch["inc_eligible"], num_inc,
                        draws(batch["inc_eligible"].shape))
    return torch.where(neg | inc, -1, batch["cls_pos"])


def ab_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  batch: Dict, generator: Optional[torch.Generator], *,
                  lambda_reg: float, neg_ratio: float, inc_ratio: float,
                  cls_label: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """One step over a padded batch -> {loss, cls_loss, loc_loss} as
    device scalars.

    Labels are sampled with ``generator`` unless ``cls_label`` [B, N, S]
    is given.  Per-video losses are weighted by ``video_valid & num_pos >
    0`` over ``max(sum of weights, 1)``.  Dropout draws from the model's
    own generators (models/common.py:set_dropout_generator)."""
    batch = resolve_batch(batch)
    if cls_label is None:
        cls_label = build_ab_cls_labels(batch, generator, neg_ratio,
                                        inc_ratio)
    w = (batch["video_valid"] & (batch["num_pos"] > 0)).to(torch.float32)
    denom = torch.clamp(w.sum(), min=1.0)

    model.train()
    pred_cls, pred_loc = model(batch["seq"], batch["mask"])
    loc = L.ab_loc_loss(pred_loc, batch["loc_label"], cls_label)
    cls = L.ab_cls_loss(pred_cls, cls_label)
    loss = ((cls + lambda_reg * loc) * w).sum() / denom

    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    with torch.no_grad():
        return {"loss": loss.detach(), "cls_loss": (cls * w).sum() / denom,
                "loc_loss": (loc * w).sum() / denom}
