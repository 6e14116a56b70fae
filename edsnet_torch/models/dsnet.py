"""Anchor-based DSNet heads, batched + masked: shallow (ROI, flat, FFT or
DWT pooling), original, deep, local-global and the motion head
(cross-attention over motion features).

Counterpart of edsnet_tpu/models/dsnet.py: ``_decode_predictions``,
``_FcTrunk`` (weight-tied by default), ``_AnchorHeads`` (its fused
formulations, the ones JAX's CLIs run), ``DSNet``, ``DSNetOriginal``,
``DSNetDeepAttention``, ``DSNetMultiAttention``,
``_CrossAttentionDecoderLayer`` and ``DSNetMotionFeatures``.  Submodule
names follow the flax param tree so the weight bridge (convert.py) maps
names one to one.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from edsnet_torch.models.base import build_base_model
from edsnet_torch.models.common import (Dropout, FcBlock, LayerNorm, Linear,
                                        apply_mask, promote)
from edsnet_torch.models.encoder import ClassicEncoder, LocalGlobalEncoder
from edsnet_torch.models.graphed import eval_forward
from edsnet_torch.models.mha import DenseGeneral, MultiHeadDotProductAttention
from edsnet_torch.models.poolings import Pooling, roi_multi_scale
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
    """fc1 -> fc_depth x fc_block: one shared ``fc_block`` (the reference's
    tied trunk), or ``fc_block_{i}`` each its own when untied."""

    def __init__(self, num_feature: int, num_hidden: int, fc_depth: int,
                 tie_fc_blocks: bool = True):
        super().__init__()
        self.fc1 = Linear(num_feature, num_hidden)
        if tie_fc_blocks:
            self.fc_block = FcBlock(num_hidden, num_hidden)
            self.blocks = [self.fc_block] * fc_depth
        else:
            for i in range(fc_depth):
                self.add_module(f"fc_block_{i}",
                                FcBlock(num_hidden, num_hidden))
            self.blocks = [getattr(self, f"fc_block_{i}")
                           for i in range(fc_depth)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        for block in self.blocks:
            x = block(x)
        return x


class _AnchorHeads(nn.Module):
    """fc_cls (sigmoid) + fc_loc with the projections hoisted before the
    linear poolings: pool(x) @ W + b == pool(x @ W) + b, and the bias
    stays outside the pool (its zero padding would average it)."""

    def __init__(self, num_hidden: int):
        super().__init__()
        self.fc_cls = Linear(num_hidden, 1)
        self.fc_loc = Linear(num_hidden, 2)

    def fused_roi(self, out: torch.Tensor, scales: Sequence[int],
                  fine_loc: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ROI heads; with ``fine_loc`` (flat-pooling) fc_loc reads that
        already pooled [B, N, H] tensor instead, at the one scale."""
        zc = F.linear(*promote(out, self.fc_cls.weight))
        if fine_loc is not None:
            pred_cls = torch.sigmoid(roi_multi_scale(zc, scales)[..., 0]
                                     + self.fc_cls.bias[0])
            return pred_cls, self.fc_loc(fine_loc[:, :, None, :])
        zl = F.linear(*promote(out, self.fc_loc.weight))
        pooled = roi_multi_scale(torch.cat([zc, zl], dim=-1), scales)
        pred_cls = torch.sigmoid(pooled[..., 0] + self.fc_cls.bias[0])
        pred_loc = pooled[..., 1:] + self.fc_loc.bias
        return pred_cls, pred_loc

    def fused_linear_coarse(self, out: torch.Tensor,
                            coarse_fn: Callable[[torch.Tensor], torch.Tensor],
                            fine: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fft / dwt heads: both coarse maps are linear and act on each
        channel alone, so fc_cls(coarse(out)) == coarse(fc_cls(out)) and
        the trunk is contracted to one channel before the pooling; fc_loc
        reads the nonlinear fine tensor.  -> cls [B, N, 1], loc
        [B, N, 1, 2]."""
        zc = F.linear(*promote(out, self.fc_cls.weight))
        pred_cls = torch.sigmoid(coarse_fn(zc) + self.fc_cls.bias[0])
        return pred_cls, self.fc_loc(fine[:, :, None, :])


class _AnchorBased(nn.Module):
    """The shared deterministic decode of the anchor-based heads; each
    sets ``scales`` (the anchor scales, also read by the evaluator)."""

    scales: Sequence[int]

    def predict(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward (``models/graphed.py:eval_forward``) +
        anchor decode; needs eval mode."""
        if self.training:
            raise RuntimeError(f"{type(self).__name__}.predict is the "
                               f"deterministic pass: call model.eval() first")
        pred_cls, pred_loc = eval_forward(self, x, mask)
        return _decode_predictions(pred_cls, pred_loc, self.scales)


class DSNet(_AnchorBased):
    """The EDSNet anchor-based head, shallow depth: backbone + residual,
    LayerNorm, the fc trunk (``tie_fc_blocks`` as ``_FcTrunk``'s), the
    mask, and ROI pooling or, at the single scale ``anchor_scales[0]``,
    the flat / fft / dwt ``Pooling``."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 anchor_scales: Sequence[int], num_head: int,
                 fc_depth: int = 5, pooling_type: str = "roi",
                 use_pallas: Optional[bool] = None,
                 orientation: str = "paper", tie_fc_blocks: bool = True):
        super().__init__()
        self.scales = anchor_scales_list(anchor_scales)
        self.pooling_type = pooling_type
        if pooling_type != "roi" and len(self.scales) != 1:
            raise ValueError(f"{pooling_type} pooling uses the single scale "
                             f"anchor_scales[0]; got {self.scales}")
        self.base_model = build_base_model(base_model, num_feature, num_head,
                                           use_pallas, orientation)
        self.layer_norm = LayerNorm(num_feature)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth,
                              tie_fc_blocks)
        if pooling_type != "roi":
            self.pooling = Pooling(self.scales, pooling_type, num_hidden,
                                   num_hidden, emit_coarse=False)
        self.heads = _AnchorHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, N, F], mask [B, N] bool -> (cls [B, N, S], loc
        [B, N, S, 2])."""
        out = self.base_model(x, mask) + x
        out = self.trunk(self.layer_norm(out))
        out = apply_mask(out, mask)
        if self.pooling_type == "roi":
            return self.heads.fused_roi(out, self.scales)
        (fine,) = self.pooling(out)
        if self.pooling_type == "flat-pooling":
            return self.heads.fused_roi(out, self.scales, fine_loc=fine)
        return self.heads.fused_linear_coarse(out, self.pooling.coarse, fine)


class DSNetOriginal(_AnchorBased):
    """The reference's DSNet: attention + residual, LayerNorm, the mask,
    ROI pooling of the F-wide features, then fc1 -> tanh -> Dropout(0.5)
    -> fc1_norm -> fc_cls / fc_loc.  Only the attention backbone, as in
    JAX (whose reference asserts it)."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 anchor_scales: Sequence[int], num_head: int,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        if base_model != "attention":
            raise ValueError(f"Original model works best in attention base "
                             f"model (--base-model attention), not "
                             f"{base_model}")
        self.scales = anchor_scales_list(anchor_scales)
        self.base_model = build_base_model(base_model, num_feature, num_head,
                                           use_pallas)
        self.layer_norm = LayerNorm(num_feature)
        self.fc1 = Linear(num_feature, num_hidden)
        self.dropout = Dropout(0.5)
        self.fc1_norm = LayerNorm(num_hidden)
        self.fc_cls = Linear(num_hidden, 1)
        self.fc_loc = Linear(num_hidden, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.layer_norm(self.base_model(x, mask) + x)
        pooled = roi_multi_scale(apply_mask(out, mask), self.scales)
        h = self.fc1_norm(self.dropout(torch.tanh(self.fc1(pooled))))
        return torch.sigmoid(self.fc_cls(h)[..., 0]), self.fc_loc(h)


class DSNetDeepAttention(_AnchorBased):
    """``base_model1`` applied ``attention_depth`` times with shared
    weights, residual around the first and every even layer after it (the
    reference also runs the odd layers and drops their output; that dead
    forward is skipped, as in JAX), no LayerNorm, then the trunk, the mask
    and the ROI heads."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 anchor_scales: Sequence[int], num_head: int, fc_depth: int,
                 attention_depth: int, use_pallas: Optional[bool] = None,
                 orientation: str = "paper", tie_fc_blocks: bool = True):
        super().__init__()
        self.scales = anchor_scales_list(anchor_scales)
        self.attention_depth = attention_depth
        self.base_model1 = build_base_model(base_model, num_feature, num_head,
                                            use_pallas, orientation)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth,
                              tie_fc_blocks)
        self.heads = _AnchorHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x + self.base_model1(x, mask)
        for i in range(self.attention_depth - 1):
            if i % 2 == 0:
                x = x + self.base_model1(x, mask)
        out = apply_mask(self.trunk(x), mask)
        return self.heads.fused_roi(out, self.scales)


class DSNetMultiAttention(_AnchorBased):
    """The local-global encoder (``multiattentionblock``: 4 segments, 2
    local heads) + residual, no LayerNorm, then the trunk, the mask and
    the ROI heads."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 anchor_scales: Sequence[int], num_head: int, fc_depth: int,
                 use_pallas: Optional[bool] = None,
                 orientation: str = "paper", tie_fc_blocks: bool = True):
        super().__init__()
        self.scales = anchor_scales_list(anchor_scales)
        self.multiattentionblock = LocalGlobalEncoder(
            base_model, orientation, num_feature, num_head, num_segments=4,
            local_attention_head=2, use_pallas=use_pallas)
        self.trunk = _FcTrunk(num_feature, num_hidden, fc_depth,
                              tie_fc_blocks)
        self.heads = _AnchorHeads(num_hidden)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out = x + self.multiattentionblock(x, mask)
        out = apply_mask(self.trunk(out), mask)
        return self.heads.fused_roi(out, self.scales)


class _CrossAttentionDecoderLayer(nn.Module):
    """torch's post-norm ``TransformerDecoderLayer`` as JAX writes it:
    self-attention, cross-attention over the memory, a ReLU feed-forward,
    each added back and normalised (``norm1``..``norm3``), with dropout on
    each branch and inside the feed-forward.  ``memory_features`` is the
    memory's width, which the cross-attention's key and value read."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 memory_features: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadDotProductAttention(nhead, d_model)
        self.cross_attn = MultiHeadDotProductAttention(nhead, d_model,
                                                       memory_features)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.ff1 = Linear(d_model, dim_feedforward)
        self.ff2 = Linear(dim_feedforward, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        sa = self.self_attn(tgt, tgt, tgt_mask)
        tgt = self.norm1(tgt + self.dropout(sa))
        ca = self.cross_attn(tgt, memory, memory_mask)
        tgt = self.norm2(tgt + self.dropout(ca))
        ff = self.ff2(self.dropout(torch.relu(self.ff1(tgt))))
        return self.norm3(tgt + self.dropout(ff))


class DSNetMotionFeatures(_AnchorBased):
    """The appearance encoder (``classic``: backbone, residual, fc1;
    ``local-global``: 4 segments, 2 local heads), ``attention_depth``
    decoder layers (8 heads, d_model and the feed-forward both F) that
    cross-attend to the motion features, added to the encoder's output,
    LayerNorm, fcb1 -> fcb2 -> ReLU -> Dropout(0.5) -> fcb_norm, the mask,
    and the ROI heads.  ``fc_cls`` and ``fc_loc`` sit at the top level, as
    flax's ``nn.share_scope`` puts them; ``fused_roi_head=False`` runs the
    reference's pool-then-project oracle.  ``motion_width`` is the motion
    features' width (F when None), which torch needs at build time."""

    def __init__(self, base_model: str, num_feature: int, num_hidden: int,
                 anchor_scales: Sequence[int], num_head: int,
                 attention_depth: int, encoder_type: str = "classic",
                 use_pallas: Optional[bool] = None,
                 orientation: str = "paper", fused_roi_head: bool = True,
                 motion_width: Optional[int] = None):
        super().__init__()
        self.scales = anchor_scales_list(anchor_scales)
        self.fused_roi_head = fused_roi_head
        if encoder_type == "classic":
            self.encoder = ClassicEncoder(base_model, num_feature, num_head,
                                          orientation, use_pallas)
        else:
            self.encoder = LocalGlobalEncoder(
                base_model, orientation, num_feature, num_head,
                num_segments=4, local_attention_head=2,
                use_pallas=use_pallas)
        width = num_feature if motion_width is None else motion_width
        self.decoders = [_CrossAttentionDecoderLayer(
            num_feature, 8, num_feature, width)
            for _ in range(attention_depth)]
        for i, layer in enumerate(self.decoders):
            self.add_module(f"decoder_{i}", layer)
        self.layer_norm = LayerNorm(num_feature)
        self.fcb1 = Linear(num_feature, num_hidden)
        self.fcb2 = Linear(num_hidden, num_hidden)
        self.dropout = Dropout(0.5)
        self.fcb_norm = LayerNorm(num_hidden)
        self.fc_cls = Linear(num_hidden, 1)
        self.fc_loc = Linear(num_hidden, 2)

    @property
    def motion_width(self) -> int:
        """The motion width the cross-attentions read (the input width of
        their key projection)."""
        return self.decoders[0].cross_attn.key.in_shape[0] if self.decoders \
            else 0

    def set_motion_width(self, width: int) -> None:
        """Rebuild every cross-attention's key and value projection at
        motion width ``width`` (undrawn; a checkpoint load fills them), on
        the parameters' device."""
        if width == self.motion_width:
            return
        device = self.fcb1.weight.device
        for layer in self.decoders:
            heads = layer.cross_attn.key.out_shape
            layer.cross_attn.key = DenseGeneral((width,), heads).to(device)
            layer.cross_attn.value = DenseGeneral((width,), heads).to(device)

    def forward(self, x: torch.Tensor, motion: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                motion_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, N, F], motion [B, M, Fm], mask [B, N] and motion_mask
        [B, M] bool -> (cls [B, N, S], loc [B, N, S, 2])."""
        out = self.encoder(x, mask)
        dec = out
        for layer in self.decoders:
            dec = layer(dec, motion, mask, motion_mask)
        out = self.layer_norm(out + dec)
        h = torch.relu(self.fcb2(self.fcb1(out)))
        h = apply_mask(self.fcb_norm(self.dropout(h)), mask)
        if self.fused_roi_head:
            # fc_cls / fc_loc are this module's own, as share_scope makes
            # them in flax: _AnchorHeads' fused formulation reads only those
            return _AnchorHeads.fused_roi(self, h, self.scales)
        pooled = roi_multi_scale(h, self.scales)             # [B, N, S, H]
        return torch.sigmoid(self.fc_cls(pooled)[..., 0]), self.fc_loc(pooled)

    def predict(self, x: torch.Tensor, motion: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                motion_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deterministic forward + anchor decode, JAX's argument order;
        needs eval mode."""
        if self.training:
            raise RuntimeError("DSNetMotionFeatures.predict is the "
                               "deterministic pass: call model.eval() first")
        pred_cls, pred_loc = self(x, motion, mask, motion_mask)
        return _decode_predictions(pred_cls, pred_loc, self.scales)
