"""flax's ``nn.MultiHeadDotProductAttention`` at its defaults, the motion
head's self- and cross-attention.

Counterpart of the flax module as edsnet_tpu/models/dsnet.py's
``_CrossAttentionDecoderLayer`` builds it (no attention dropout, no qk
norm, every width from the query's).  Its projections are flax
``DenseGeneral`` layers whose kernels keep flax's layout (``query`` /
``key`` / ``value`` [in, H, D] with bias [H, D], ``out`` [H, D, F] with
bias [F]), so the weight bridge maps them untransposed (convert.py).

The attention is JAX's ``dot_product_attention`` in plain products, not
``scaled_dot_product_attention``: q is divided by sqrt(D) (rounded to the
dtype) before the product, masked logits are set to the dtype's most
negative finite value, not -inf, and the softmax runs in the logits'
dtype.  A row whose keys are all masked (a padding row of the batch, whose
motion mask is all False) so gets uniform weights over its keys, as in
flax, where SDPA with a boolean mask gives NaN.  JAX computes this outside
any Pallas kernel, so no kernel of the port runs here.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from edsnet_torch.models.common import lecun_normal_flat_, promote


class DenseGeneral(nn.Module):
    """A product over the last ``len(in_shape)`` axes of the input with a
    ``weight`` of shape in_shape + out_shape, plus a ``bias`` of
    out_shape (flax's ``DenseGeneral``); drawn by ``init_leaves`` with
    flax's default init, lecun normal on the flat kernel and zero bias."""

    def __init__(self, in_shape: Sequence[int], out_shape: Sequence[int]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.empty(self.in_shape
                                               + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def init_leaves(self, generator: torch.Generator) -> None:
        lecun_normal_flat_(self.weight, generator, len(self.in_shape))
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        y = x.reshape(*lead, math.prod(self.in_shape)) @ w.reshape(
            math.prod(self.in_shape), math.prod(self.out_shape))
        return y.reshape(*lead, *self.out_shape) + b


class MultiHeadDotProductAttention(nn.Module):
    """``num_heads`` heads of width ``q_features // num_heads``; ``query``
    reads the query's width, ``key`` and ``value`` ``kv_features`` (the
    motion width in the cross-attention), ``out`` writes the query's."""

    def __init__(self, num_heads: int, q_features: int,
                 kv_features: Optional[int] = None):
        super().__init__()
        if q_features % num_heads:
            raise ValueError(f"Memory dimension ({q_features}) must be "
                             f"divisible by number of heads ({num_heads}).")
        kv_features = q_features if kv_features is None else kv_features
        heads = (num_heads, q_features // num_heads)
        self.query = DenseGeneral((q_features,), heads)
        self.key = DenseGeneral((kv_features,), heads)
        self.value = DenseGeneral((kv_features,), heads)
        self.out = DenseGeneral(heads, (q_features,))

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs_q [B, Nq, Fq], inputs_kv [B, Nk, Fkv], mask [B, Nk] bool
        (False = the key is left out) -> [B, Nq, Fq]."""
        q, k, v = promote(self.query(inputs_q), self.key(inputs_kv),
                          self.value(inputs_kv))
        # sqrt(D) rounded to q's dtype, as jnp.sqrt(depth).astype(dtype)
        q = q / torch.tensor(math.sqrt(q.shape[-1]),
                             dtype=torch.float64).to(q.dtype).item()
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(mask[:, None, None, :], logits,
                                 torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", weights, v))
