"""Anchor-based DSNet head (shallow depth, ROI pooling), batched + masked.

Counterpart of edsnet_tpu/models/dsnet.py: ``_decode_predictions``, the
weight-tied ``_FcTrunk``, ``_AnchorHeads.fused_roi`` and ``DSNet``.
Submodule names follow the flax param tree so the weight bridge
(convert.py) maps names one to one.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edsnet_torch.models.base import build_base_model
from edsnet_torch.models.common import LN_EPS, FcBlock, apply_mask
from edsnet_torch.models.poolings import roi_multi_scale
from edsnet_torch.ops.anchors import anchor_scales_list, get_anchors


def _decode_predictions(pred_cls: torch.Tensor, pred_loc: torch.Tensor,
                        anchor_scales: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,N,S) cls + (B,N,S,2) offsets -> flat cls [B, N*S] + LR boxes
    [B, N*S, 2]."""
    b, n, s = pred_cls.shape
    anchors = get_anchors(n, anchor_scales, pred_cls.device).to(torch.float32)
    anchors = anchors[None].expand(b, n, s, 2).reshape(b, -1, 2)
    off = pred_loc.reshape(b, -1, 2)
    bc = off[..., 0] * anchors[..., 1] + anchors[..., 0]
    bw = torch.exp(off[..., 1]) * anchors[..., 1]
    boxes_lr = torch.stack([bc - bw * 0.5, bc + bw * 0.5], dim=-1)
    return pred_cls.reshape(b, -1), boxes_lr


class _FcTrunk(nn.Module):
    """fc1 -> fc_depth x one shared fc_block (the reference's tied trunk)."""

    def __init__(self, num_feature: int, num_hidden: int, fc_depth: int):
        super().__init__()
        self.fc_depth = fc_depth
        self.fc1 = nn.Linear(num_feature, num_hidden)
        self.fc_block = FcBlock(num_hidden, num_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        for _ in range(self.fc_depth):
            x = self.fc_block(x)
        return x


class _AnchorHeads(nn.Module):
    """fc_cls (sigmoid) + fc_loc with the projections hoisted before the
    linear ROI pooling: pool(x) @ W + b == pool(x @ W) + b, and the bias
    stays outside the pool (its zero padding would average it)."""

    def __init__(self, num_hidden: int):
        super().__init__()
        self.fc_cls = nn.Linear(num_hidden, 1)
        self.fc_loc = nn.Linear(num_hidden, 2)

    def fused_roi(self, out: torch.Tensor, scales: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        zc = F.linear(out, self.fc_cls.weight)
        zl = F.linear(out, self.fc_loc.weight)
        pooled = roi_multi_scale(torch.cat([zc, zl], dim=-1), scales)
        pred_cls = torch.sigmoid(pooled[..., 0] + self.fc_cls.bias[0])
        pred_loc = pooled[..., 1:] + self.fc_loc.bias
        return pred_cls, pred_loc


class DSNet(nn.Module):
    """The EDSNet anchor-based head, shallow depth, ROI pooling."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 anchor_scales: Sequence[int], num_head: int,
                 fc_depth: int = 5, pooling_type: str = "roi",
                 use_pallas: Optional[bool] = None):
        super().__init__()
        if pooling_type != "roi":
            raise NotImplementedError(
                f"--pooling-type {pooling_type} is not ported yet (ROADMAP.md "
                f"Queue A item 10); this slice serves roi pooling")
        self.scales = anchor_scales_list(anchor_scales)
        self.base_model = build_base_model(base_model, num_feature, num_head,
                                           use_pallas)
        self.layer_norm = nn.LayerNorm(num_feature, eps=LN_EPS)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth)
        self.heads = _AnchorHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, N, F], mask [B, N] bool -> (cls [B, N, S], loc
        [B, N, S, 2])."""
        out = self.base_model(x, mask) + x
        out = self.trunk(self.layer_norm(out))
        out = apply_mask(out, mask)
        return self.heads.fused_roi(out, self.scales)

    def predict(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward + anchor decode; needs eval mode."""
        if self.training:
            raise RuntimeError("DSNet.predict is the deterministic pass: "
                               "call model.eval() first")
        pred_cls, pred_loc = self(x, mask)
        return _decode_predictions(pred_cls, pred_loc, self.scales)
