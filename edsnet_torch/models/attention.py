"""Vanilla multi-head self-attention backbone.

Counterpart of edsnet_tpu/models/attention.py:AttentionExtractor (without
its ring-attention route): bias-free Q/K/V/fc projections, padded keys
excluded from the softmax, dropout 0.5 on the attention map and on the
output in training.  A deterministic pass of N >= ``flash_min_len``
positions routes through the flash kernel (kernels/flash_attention.py)
when ``use_flash`` is True (precision "default"), or when it is None (auto)
and the input lies on a CUDA device (precision "highest").  Training keeps
the dense path, because its dropout acts on the attention map itself.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.common import masked_softmax


class AttentionExtractor(nn.Module):
    """(B, N, F) -> (B, N, F) self-attention mixing."""

    def __init__(self, num_head: int = 8, num_feature: int = 1024,
                 attn_dropout: float = 0.5, out_dropout: float = 0.5,
                 use_flash: Optional[bool] = None, flash_min_len: int = 0):
        super().__init__()
        if num_feature % num_head:
            raise ValueError(f"num_feature {num_feature} must be divisible "
                             f"by num_head {num_head} (head split)")
        self.num_head = num_head
        self.use_flash = use_flash
        self.flash_min_len = flash_min_len
        self.Q = nn.Linear(num_feature, num_feature, bias=False)
        self.K = nn.Linear(num_feature, num_feature, bias=False)
        self.V = nn.Linear(num_feature, num_feature, bias=False)
        self.fc = nn.Linear(num_feature, num_feature, bias=False)
        self.attn_dropout = nn.Dropout(attn_dropout)
        self.out_dropout = nn.Dropout(out_dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, f = x.shape
        h = self.num_head
        d_k = f // h

        def heads(proj):
            return proj(x).reshape(b, n, h, d_k).transpose(1, 2)

        q, k, v = heads(self.Q), heads(self.K), heads(self.V)
        if self.use_flash is None:
            use_flash, precision = x.is_cuda, "highest"
        else:
            use_flash, precision = self.use_flash, "default"
        if use_flash and not self.training and n >= self.flash_min_len:
            from edsnet_torch.kernels.flash_attention import flash_attention
            y = flash_attention(q, k, v, mask, precision=precision)
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm", q, k) / (d_k ** 0.5)
            key_mask = None if mask is None else mask[:, None, None, :]
            attn = self.attn_dropout(masked_softmax(attn, key_mask, dim=-1))
            y = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        y = y.transpose(1, 2).reshape(b, n, f)
        return self.out_dropout(self.fc(y))
