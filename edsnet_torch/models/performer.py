"""Performer (FAVOR+) backbone: O(N) softmax-kernel linear attention.

Counterpart of edsnet_tpu/models/performer.py (``orthogonal_gaussian``,
``softmax_kernel``, ``linear_attention``, ``FastSelfAttention``,
``Performer``).  Factory config: depth 1, dim_head 64, mlp_dim 1024,
feed-forward dropout 0.5, attention dropout 0, qkv bias 0.1.

The orthogonal gaussian feature matrix ``projection`` is a buffer, the
flax ``constants`` collection: drawn at init, saved with the checkpoint,
and never trained (it is not in ``parameters()``, so neither Adam nor
weight decay touches it).

Masking: the key stabilizer is the max over each video's valid (head,
position, feature) entries, and feature-mapped keys and values are zeroed
at invalid positions, so a padded bucket equals the unpadded computation.

Dtypes as in JAX: ``projection`` stays float32 under ``--compute-dtype
bfloat16`` (it is a constant, not a parameter), so the feature maps and
everything after them run in float32 and the block returns float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.common import Linear, PreNormStack, promote


def orthogonal_gaussian(generator: torch.Generator, nb_rows: int,
                        nb_cols: int) -> torch.Tensor:
    """Gaussian orthogonal random features [nb_rows, nb_cols] from blocks
    of QR factors, drawn from ``generator``, each row scaled to the norm of
    a gaussian row (the reference's scaling 0)."""
    def gaussian(*shape):
        return torch.randn(*shape, generator=generator, dtype=torch.float32)

    blocks = []
    n_full = nb_rows // nb_cols
    for _ in range(n_full):
        q, _ = torch.linalg.qr(gaussian(nb_cols, nb_cols))
        blocks.append(q.T)
    rem = nb_rows - n_full * nb_cols
    if rem > 0:
        q, _ = torch.linalg.qr(gaussian(nb_cols, nb_cols))
        blocks.append(q.T[:rem])
    mult = torch.linalg.norm(gaussian(nb_rows, nb_cols), dim=1)
    return mult[:, None] * torch.cat(blocks, dim=0)


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor,
                   is_query: bool, eps: float = 1e-4,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FAVOR+ positive softmax features of data [B, H, N, D] -> [B, H, N,
    M].  Queries are stabilised by their own row max; keys by the max over
    the video's valid (h, n, feature) entries, 0 for an all-padding row."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.matmul(*promote(normalizer * data, projection.T))
    diag = (data ** 2).sum(dim=-1, keepdim=True) * 0.5 * normalizer ** 2
    if is_query:
        stab = data_dash.amax(dim=-1, keepdim=True)
    else:
        masked = data_dash if mask is None else torch.where(
            mask[:, None, :, None], data_dash, -torch.inf)
        stab = masked.amax(dim=tuple(range(1, data_dash.ndim)),
                           keepdim=True)
        stab = torch.where(torch.isfinite(stab), stab, 0.0)
    return ratio * (torch.exp(data_dash - diag - stab) + eps)


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Non-causal O(N) attention over feature maps, keys and values
    zeroed at masked positions; in the operands' common dtype."""
    q, k, v = promote(q, k, v)
    if mask is not None:
        mf = mask[:, None, :, None].to(q.dtype)
        k, v = k * mf, v * mf
    k_cumsum = k.sum(dim=-2)
    d_inv = 1.0 / torch.clamp(
        torch.einsum("...nd,...d->...n", q, k_cumsum), min=1e-12)
    context = torch.einsum("...nd,...ne->...de", k, v)
    return torch.einsum("...de,...nd,...n->...ne", context, q, d_inv)


class FastSelfAttention(nn.Module):
    """FAVOR+ self-attention with dim_head * ln(dim_head) random features
    (266 at dim_head 64) and no dropout."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.nb_features = int(dim_head * math.log(dim_head))
        inner = heads * dim_head
        self.to_q = Linear(dim, inner)
        self.to_k = Linear(dim, inner)
        self.to_v = Linear(dim, inner)
        self.to_out = Linear(inner, dim)
        self.register_buffer("projection",
                             torch.empty(self.nb_features, dim_head))
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.projection.copy_(orthogonal_gaussian(
                generator, self.nb_features, self.dim_head))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head

        def heads(proj):
            return proj(x).reshape(b, n, h, dh).transpose(1, 2)

        q, k, v = heads(self.to_q), heads(self.to_k), heads(self.to_v)
        q = softmax_kernel(q, self.projection, is_query=True)
        k = softmax_kernel(k, self.projection, is_query=False, mask=mask)
        out = linear_attention(q, k, v, mask)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class Performer(PreNormStack):
    """PreNorm(FastSelfAttention) + PreNorm(feed-forward) blocks."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 1024,
                 dropout: float = 0.5):
        super().__init__(dim, depth, mlp_dim, dropout,
                         lambda: FastSelfAttention(dim, heads, dim_head))
