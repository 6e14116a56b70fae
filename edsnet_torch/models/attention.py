"""Vanilla multi-head self-attention backbone.

Counterpart of edsnet_tpu/models/attention.py:AttentionExtractor (without
its ring-attention route): bias-free Q/K/V/fc projections, padded keys
excluded from the softmax, dropout 0.5 on the attention map and on the
output in training.  Each pass asks ``flash_route``, from its device,
mode and shapes, whether to take the flash kernel
(kernels/flash_attention.py) and at which precision: ``use_flash`` is the
--use-pallas tri-state.  The flash route is differentiable, but training
keeps the dense path, because its dropout acts on the attention map
itself.

``flash_route`` decides from the shapes alone and before any launch (as
JAX's length threshold does):
- training passes always take the dense path;
- None (auto): the flash kernel at precision "highest" on a CUDA device
  when the head dim D is one the forward kernel takes (``HEAD_DIMS``:
  32, 64, 128, 256 and 512; 256 for the deep anchor-free model's
  ``base_model1`` at F 1024, 512 for the local attentions of the
  local-global heads, 2 heads at F 1024) and N >= ``FLASH_MIN_LEN``;
  otherwise the dense path.  On the CPU the dense path runs, as JAX's auto
  rule keeps the kernel off away from its accelerator, and e.g.
  ``--num-feature 32 --num-head 2`` (D = 16) runs dense on the card;
- True (--use-pallas): the flash route on any device at N >=
  ``FLASH_MIN_LEN``, precision "default" (on the CPU that is the kernel's
  plain twin, which takes any D); on a CUDA device a head dim outside
  ``HEAD_DIMS`` raises, since the user asked for the kernel;
- False (--no-pallas): always the dense path.
The backward kernels take D up to 128 (``BWD_HEAD_DIMS``): the flash route
is differentiated only by callers of ``flash_attention``, never by a
training pass here, and at D = 256 or 512 its backward raises.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edsnet_torch.kernels.flash_attention import HEAD_DIMS
from edsnet_torch.models.common import Dropout, Linear, masked_softmax

# Shortest sequence the flash route takes.  0 routes every deterministic
# attention pass through the kernel: the JAX thresholds (1024 / 2048) come
# from TPU timings and would leave it off for every eval bucket of a real
# video.  A later PR sets this from the card's times in PERF.md.
FLASH_MIN_LEN = 0


def flash_route(on_cuda: bool, training: bool, n: int, head_dim: int,
                use_pallas: Optional[bool]) -> Optional[str]:
    """The flash route's precision ("highest" or "default") for one
    attention pass of N positions and head dim ``head_dim``, or None for
    the dense path (the rule in the module docstring)."""
    if training or use_pallas is False or n < FLASH_MIN_LEN:
        return None
    if use_pallas is None:
        return "highest" if on_cuda and head_dim in HEAD_DIMS else None
    if on_cuda and head_dim not in HEAD_DIMS:
        raise ValueError(f"--use-pallas: head dim {head_dim} not in "
                         f"HEAD_DIMS {HEAD_DIMS}, the head dims the CUDA "
                         f"flash forward kernel takes; pick --num-feature / "
                         f"--num-head to give one, or drop --use-pallas")
    return "default"


class AttentionExtractor(nn.Module):
    """(B, N, F) -> (B, N, F) self-attention mixing."""

    def __init__(self, num_head: int = 8, num_feature: int = 1024,
                 attn_dropout: float = 0.5, out_dropout: float = 0.5,
                 use_flash: Optional[bool] = None):
        super().__init__()
        if num_feature % num_head:
            raise ValueError(f"num_feature {num_feature} must be divisible "
                             f"by num_head {num_head} (head split)")
        self.num_head = num_head
        self.use_flash = use_flash
        self.Q = Linear(num_feature, num_feature, bias=False)
        self.K = Linear(num_feature, num_feature, bias=False)
        self.V = Linear(num_feature, num_feature, bias=False)
        self.fc = Linear(num_feature, num_feature, bias=False)
        self.attn_dropout = Dropout(attn_dropout)
        self.out_dropout = Dropout(out_dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, f = x.shape
        h = self.num_head
        d_k = f // h

        def heads(proj):
            return proj(x).reshape(b, n, h, d_k).transpose(1, 2)

        q, k, v = heads(self.Q), heads(self.K), heads(self.V)
        precision = flash_route(x.is_cuda, self.training, n, d_k,
                                self.use_flash)
        if precision is not None:
            from edsnet_torch.kernels.flash_attention import flash_attention
            y = flash_attention(q, k, v, mask, precision=precision)
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm", q, k) / (d_k ** 0.5)
            key_mask = None if mask is None else mask[:, None, None, :]
            attn = self.attn_dropout(masked_softmax(attn, key_mask, dim=-1))
            y = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        y = y.transpose(1, 2).reshape(b, n, f)
        return self.out_dropout(self.fc(y))
