"""Shared model utilities: init scheme, masked primitives, the fc block.

Init matches edsnet_tpu/models/common.py (the reference trainer's re-init):
xavier-uniform with gain sqrt(2) on every Linear weight, constant 0.1 bias,
LayerNorm weight 1 and bias 0 with eps 1e-5.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LN_EPS = 1e-5


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every Linear and LayerNorm under ``module`` in place,
    drawing from ``generator`` in module order."""
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            fan_out, fan_in = sub.weight.shape
            limit = math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))
            with torch.no_grad():
                sub.weight.uniform_(-limit, limit, generator=generator)
                if sub.bias is not None:
                    sub.bias.fill_(0.1)
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax with an optional boolean mask (False = excluded, scored at
    the dtype's most negative finite value)."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=dim)


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Zero features at invalid positions. x: [..., N, F]; mask: [..., N]."""
    if mask is None:
        return x
    return x * mask[..., None].to(x.dtype)


class FcBlock(nn.Module):
    """Linear -> ReLU -> Dropout(0.5) -> LayerNorm (the reference fc_block).

    Submodule names follow the flax param tree (``Dense_0``,
    ``LayerNorm_0``) so the weight bridge maps names one to one."""

    def __init__(self, in_features: int, num_hidden: int,
                 dropout: float = 0.5):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_hidden)
        self.dropout = nn.Dropout(dropout)
        self.LayerNorm_0 = nn.LayerNorm(num_hidden, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(self.dropout(torch.relu(self.Dense_0(x))))
