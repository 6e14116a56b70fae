"""GCN backbone over a top-similarity frame graph, as dense masked products.

Counterpart of edsnet_tpu/models/gcn.py (``_monotonic_bits``,
``GCNExtractor``): sim = x x^T - I over valid pairs (-inf elsewhere); the
top int(0.3 len^2) entries of each video's sim are its edges, with
weight-1 self loops on valid nodes and the GCN normalisation D^-1/2 (A + I)
D^-1/2; then the bias-free ``lin`` and the raw ``bias`` leaf.  A row of
length 0 has no edges and outputs ``bias``.

The selection (``top_similarity_keep``) keeps the entries of rank < k in a
stable descending sort of the float32 value's monotonic uint32 image,
widened to int64 so that torch sorts it: ties break by flat index,
ascending, and -0.0 ranks below +0.0, the set JAX's radix select keeps.
Under bfloat16 it ranks float32(bfloat16 sim), where ties are common.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.common import Linear


def monotonic_bits(x: torch.Tensor) -> torch.Tensor:
    """float32(x) -> int64 in [0, 2^32) with the same total order (the
    IEEE-754 sign-flip trick)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) \
        & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u + 2 ** 31)


def top_similarity_keep(sim: torch.Tensor, lengths: torch.Tensor,
                        keep_ratio: float) -> torch.Tensor:
    """sim [B, N, N] (-inf where invalid), lengths [B] -> the kept entries
    [B, N, N] bool: the int(keep_ratio * len^2) largest of each video, ties
    by flat index ascending."""
    b, n, _ = sim.shape
    k = (keep_ratio * lengths.to(torch.float32) ** 2).to(torch.int64)
    mono = monotonic_bits(sim.detach().reshape(b, n * n))
    order = torch.sort(mono, dim=1, descending=True, stable=True).indices
    ranked = torch.arange(n * n, device=sim.device)[None, :] < k[:, None]
    keep = torch.zeros_like(ranked).scatter_(1, order, ranked)
    return keep.reshape(b, n, n)


class GCNExtractor(nn.Module):
    """(B, N, F) -> (B, N, F) one GCNConv layer over a kNN-style graph."""

    def __init__(self, num_feature: int, keep_ratio: float = 0.3):
        super().__init__()
        self.keep_ratio = keep_ratio
        self.lin = Linear(num_feature, num_feature, bias=False)
        self.bias = nn.Parameter(torch.empty(num_feature))
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.fill_(0.1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=x.device)
        valid2d = mask[:, :, None] & mask[:, None, :]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)

        sim = torch.einsum("bnf,bmf->bnm", x, x) - eye
        sim = torch.where(valid2d, sim, -torch.inf)
        keep = top_similarity_keep(sim, mask.sum(dim=-1), self.keep_ratio)

        adj = torch.where(keep & valid2d, sim, 0.0)
        adj = torch.where(torch.isfinite(adj), adj, 0.0)
        m = mask.to(x.dtype)
        adj = adj + eye * m[:, None, :] * m[:, :, None]     # self loops

        deg = adj.sum(dim=-1)
        # double where: sqrt never sees deg <= 0, so no NaN reaches the
        # gradient of the untaken branch
        safe_deg = torch.where(deg > 0, deg, 1.0)
        dinv = torch.where(deg > 0, 1.0 / torch.sqrt(safe_deg), 0.0)
        norm_adj = adj * dinv[:, :, None] * dinv[:, None, :]

        out = torch.einsum("bnm,bmf->bnf", norm_adj, self.lin(x))
        return out + self.bias
