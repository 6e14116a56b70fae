"""Anchor-free DSNet heads (FCOS-style cls / loc / ctr), batched + masked.

Counterpart of edsnet_tpu/models/dsnet_af.py: ``_AFHeads``,
``_af_predict``, ``DSNetAF`` (shallow), ``DSNetAFOriginal``,
``DSNetAFDeepAttention`` and ``DSNetAFMultiAttention`` (local-global).  Each head returns per position pred_cls [B, N]
in (0, 1), pred_loc [B, N, 2] = exp(raw) (l, r) extents and pred_ctr
[B, N] in (0, 1); ``predict`` scales cls by centerness and the mask,
normalises each row by its max and decodes (i - l, i + r + 1) boxes.
The tracer (utils/profiling.py) sees that decode as the span
``af/decode``, and counts the valid positions decoded (``af.boxes``) and
the valid boxes that reach past [0, len) before ``predict_nms`` clips
them (``af.clipped``).

Unlike the anchor-based ``DSNet``, the trunk's output is not masked: the
mask enters only through ``cls * mask`` in ``predict``, as in JAX.
Submodule names follow the flax param tree so the weight bridge
(convert.py) maps names one to one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from edsnet_torch.models.base import build_base_model
from edsnet_torch.models.common import Dropout, LayerNorm, Linear
from edsnet_torch.models.dsnet import _FcTrunk
from edsnet_torch.models.encoder import LocalGlobalEncoder
from edsnet_torch.models.graphed import eval_forward
from edsnet_torch.ops.anchor_free import offset2bbox
from edsnet_torch.utils.profiling import count, count_nonzero, enabled, span

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class _AFHeads(nn.Module):
    """sigmoid(fc_cls), exp(fc_loc), sigmoid(fc_ctr)."""

    def __init__(self, num_hidden: int):
        super().__init__()
        self.fc_cls = Linear(num_hidden, 1)
        self.fc_loc = Linear(num_hidden, 2)
        self.fc_ctr = Linear(num_hidden, 1)

    def forward(self, out: torch.Tensor) -> Outputs:
        return (torch.sigmoid(self.fc_cls(out)[..., 0]),
                torch.exp(self.fc_loc(out)),
                torch.sigmoid(self.fc_ctr(out)[..., 0]))


def _af_predict(pred_cls: torch.Tensor, pred_loc: torch.Tensor,
                pred_ctr: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cls * ctr (* mask) over its row max + 1e-8, and (l, r) extents ->
    boxes [B, N, 2].  An all-padding row scores 0 / 1e-8 = 0."""
    cls = pred_cls * pred_ctr
    if mask is not None:
        cls = cls * mask.to(cls.dtype)
    cls = cls / (cls.amax(dim=-1, keepdim=True) + 1e-8)
    return cls, offset2bbox(pred_loc)


def _count_decode(boxes: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    """The tracer's counters of a decode: ``af.boxes``, the valid
    positions (B x N without a mask), and ``af.clipped``, the valid boxes
    with left < 0 or right > the row's length."""
    if mask is None:
        count("af.boxes", boxes.shape[0] * boxes.shape[1])
        out = (boxes[..., 0] < 0) | (boxes[..., 1] > boxes.shape[1])
    else:
        valid = mask.to(torch.bool)
        count_nonzero("af.boxes", valid)
        lens = valid.sum(dim=-1, keepdim=True)
        out = ((boxes[..., 0] < 0) | (boxes[..., 1] > lens)) & valid
    count_nonzero("af.clipped", out)


class _AnchorFree(nn.Module):
    """The shared deterministic decode of the anchor-free heads."""

    def predict(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward (``models/graphed.py:eval_forward``) +
        box decode; needs eval mode."""
        if self.training:
            raise RuntimeError(f"{type(self).__name__}.predict is the "
                               f"deterministic pass: call model.eval() first")
        outputs = eval_forward(self, x, mask)
        with span("af/decode"):
            scores, boxes = _af_predict(*outputs, mask)
        if enabled():
            _count_decode(boxes, mask)
        return scores, boxes


class DSNetAF(_AnchorFree):
    """The shallow anchor-free head: backbone + residual, LayerNorm, the fc
    trunk (tied unless ``tie_fc_blocks`` is False), the three heads."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 num_head: int, fc_depth: int = 5,
                 use_pallas: Optional[bool] = None,
                 orientation: str = "paper", tie_fc_blocks: bool = True):
        super().__init__()
        self.base_model = build_base_model(base_model, num_feature, num_head,
                                           use_pallas, orientation)
        self.layer_norm = LayerNorm(num_feature)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth,
                              tie_fc_blocks)
        self.heads = _AFHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Outputs:
        out = self.base_model(x, mask) + x
        return self.heads(self.trunk(self.layer_norm(out)))


class DSNetAFOriginal(_AnchorFree):
    """The reference's DSNet-AF: backbone + residual, LayerNorm, then fc1 ->
    ReLU -> Dropout(0.5) -> fc1_norm in place of the trunk.  Its backbone
    takes no orientation (fourier runs at "paper"), as in JAX."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 num_head: int, use_pallas: Optional[bool] = None):
        super().__init__()
        self.base_model = build_base_model(base_model, num_feature, num_head,
                                           use_pallas)
        self.layer_norm = LayerNorm(num_feature)
        self.fc1 = Linear(num_feature, num_hidden)
        self.dropout = Dropout(0.5)
        self.fc1_norm = LayerNorm(num_hidden)
        self.heads = _AFHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Outputs:
        out = self.layer_norm(self.base_model(x, mask) + x)
        h = self.fc1_norm(self.dropout(torch.relu(self.fc1(out))))
        return self.heads(h)


class DSNetAFDeepAttention(_AnchorFree):
    """Two stacked backbones, ``base_model1`` with max(num_head // 2, 1)
    heads feeding ``base_model2`` with ``num_head``, and the residual
    x + out1 + out2 before the LayerNorm and trunk."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 num_head: int, fc_depth: int = 5,
                 use_pallas: Optional[bool] = None,
                 orientation: str = "paper", tie_fc_blocks: bool = True):
        super().__init__()
        self.base_model1 = build_base_model(base_model, num_feature,
                                            max(num_head // 2, 1),
                                            use_pallas, orientation)
        self.base_model2 = build_base_model(base_model, num_feature, num_head,
                                            use_pallas, orientation)
        self.layer_norm = LayerNorm(num_feature)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth,
                              tie_fc_blocks)
        self.heads = _AFHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Outputs:
        out1 = self.base_model1(x, mask)
        out = x + out1 + self.base_model2(out1, mask)
        return self.heads(self.trunk(self.layer_norm(out)))


class DSNetAFMultiAttention(_AnchorFree):
    """The local-global encoder (``multiattention``: 4 segments, 2 local
    heads) with no residual, then the trunk and the three heads."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 num_head: int, fc_depth: int = 5,
                 use_pallas: Optional[bool] = None,
                 orientation: str = "paper", tie_fc_blocks: bool = True):
        super().__init__()
        self.multiattention = LocalGlobalEncoder(
            base_model, orientation, num_feature, num_head, num_segments=4,
            local_attention_head=2, use_pallas=use_pallas)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth,
                              tie_fc_blocks)
        self.heads = _AFHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Outputs:
        return self.heads(self.trunk(self.multiattention(x, mask)))
