"""Linformer backbone: learned low-rank projection of K/V along time.

Counterpart of edsnet_tpu/models/linformer.py (``LinformerSelfAttention``,
``Linformer``).  Factory config: depth 1, k 1000, seq_len 5000, dim_head
64, dropout 0.5 (attention map and feed-forward), mlp_dim 1024.

The intended computation pads the sequence to ``seq_len`` with zeros;
zero rows contribute nothing to the bias-free K/V projections, so the
first n rows with ``proj_k[:n]`` / ``proj_v[:n]`` give the same result.
The input is masked first, so padded bucket rows are zero rows too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.common import (Dropout, Linear, PreNormStack,
                                        apply_mask)


class LinformerSelfAttention(nn.Module):
    def __init__(self, dim: int, seq_len: int = 5000, k: int = 1000,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.5):
        super().__init__()
        self.seq_len, self.k = seq_len, k
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.proj_k = nn.Parameter(torch.empty(seq_len, k))
        self.proj_v = nn.Parameter(torch.empty(seq_len, k))
        self.to_out = Linear(inner, dim)
        self.dropout = Dropout(dropout)
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        """proj_k, proj_v ~ U(+-1/sqrt(k))."""
        limit = 1.0 / math.sqrt(self.k)
        with torch.no_grad():
            for proj in (self.proj_k, self.proj_v):
                proj.uniform_(-limit, limit, generator=generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh, kk = self.heads, self.dim_head, self.k
        if n > self.seq_len:
            raise ValueError(f"sequence {n} exceeds seq_len {self.seq_len}")
        x = apply_mask(x, mask)
        q = self.to_q(x).reshape(b, n, h, dh).transpose(1, 2)
        keys = torch.einsum("bnd,nk->bkd", self.to_k(x), self.proj_k[:n])
        values = torch.einsum("bnd,nk->bkd", self.to_v(x), self.proj_v[:n])
        keys = keys.reshape(b, kk, h, dh).transpose(1, 2)
        values = values.reshape(b, kk, h, dh).transpose(1, 2)

        dots = (q @ keys.transpose(-1, -2)) * (dh ** -0.5)
        attn = self.dropout(torch.softmax(dots, dim=-1))
        out = (attn @ values).transpose(1, 2).reshape(b, n, h * dh)
        return self.to_out(out)


class Linformer(PreNormStack):
    """PreNorm(LinformerSelfAttention) + PreNorm(feed-forward) blocks."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 1024,
                 seq_len: int = 5000, k: int = 1000, dropout: float = 0.5):
        super().__init__(dim, depth, mlp_dim, dropout,
                         lambda: LinformerSelfAttention(
                             dim, seq_len, k, heads, dim_head, dropout))
