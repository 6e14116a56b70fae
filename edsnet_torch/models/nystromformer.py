"""Nystromformer attention backbone (the paper's headline encoder).

Counterpart of edsnet_tpu/models/nystromformer.py: landmark mean pooling,
three softmax similarities, a 6-step Newton-Schulz pseudo-inverse of the
(m x m) landmark kernel, and a depthwise conv residual over values.  The
factory config: dim_head 64, 64 landmarks, 6 iterations, residual conv
kernel 33; its dropout is 0, so there is none here.

Length semantics follow the JAX module exactly:
- without a mask the input is front-padded with zeros to a multiple of m
  and the output cropped to its last n rows;
- with a mask nothing is padded: each video's landmark groups are the
  reference's front-pad grouping at its true length (l_v = ceil(len / m)
  positions a group, pad_v = l_v * m - len phantom zero rows in front),
  taken as prefix-sum differences, and attn3's softmax counts the pad_v
  phantom zero logits.  Every real position equals the unpadded result.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.common import Linear, xavier2_flax_
from edsnet_torch.ops.depthwise_conv import depthwise_time_conv

NEG = -1e30


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Newton-Schulz iterative pseudo-inverse of x [B, H, m, m].

    z0 = x^T / (max col sum * max row sum), each max taken per video over
    heads and landmarks together (not per head)."""
    abs_x = x.abs()
    col = abs_x.sum(dim=-1).amax(dim=(-2, -1), keepdim=True)
    row = abs_x.sum(dim=-2).amax(dim=(-2, -1), keepdim=True)
    z = x.transpose(-1, -2) / (col * row)[..., None]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


def _group_means(t: torch.Tensor, bounds: torch.Tensor, l_v: torch.Tensor
                 ) -> torch.Tensor:
    """Means of t [B, H, L, D] over the time ranges [bounds[g],
    bounds[g + 1]) per video (bounds [B, m + 1]), divided by l_v [B], as
    differences of a prefix sum accumulated in at least f32."""
    acc = torch.promote_types(t.dtype, torch.float32)
    b, h, _, d = t.shape
    cs = torch.nn.functional.pad(torch.cumsum(t.to(acc), dim=2),
                                 (0, 0, 1, 0))                 # [B,H,L+1,D]
    idx = bounds[:, None, :, None].expand(b, h, bounds.shape[1], d)
    picked = torch.gather(cs, 2, idx)                          # [B,H,m+1,D]
    inv_l = (1.0 / l_v.to(acc))[:, None, None, None]
    return ((picked[:, :, 1:] - picked[:, :, :-1]) * inv_l).to(t.dtype)


def nystrom_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], num_landmarks: int,
                 pinv_iterations: int, eps: float = 1e-8) -> torch.Tensor:
    """Landmark attention core. q/k/v: [B, H, L, D] (masked, q scaled);
    mask: [B, L] bool or None (then L is a multiple of m).
    Returns [B, H, L, D]; rows past a video's length are garbage."""
    b, h, L, d = q.shape
    m = num_landmarks

    if mask is None:
        l = L // m
        q_l = q.reshape(b, h, m, l, d).sum(dim=3) / float(l)
        k_l = k.reshape(b, h, m, l, d).sum(dim=3) / float(l)
        attn1 = torch.softmax(q @ k_l.transpose(-1, -2), dim=-1)
        attn2 = torch.softmax(q_l @ k_l.transpose(-1, -2), dim=-1)
        attn3 = torch.softmax(q_l @ k.transpose(-1, -2), dim=-1)
    else:
        lengths = mask.to(torch.int64).sum(dim=-1)                 # [B]
        l_v = torch.clamp(-(-lengths // m), min=1)                 # [B]
        pad_v = l_v * m - lengths                                  # [B]
        g_ax = torch.arange(m + 1, device=q.device)
        bounds = torch.clamp(g_ax[None, :] * l_v[:, None] - pad_v[:, None],
                             0, L)                                 # [B, m+1]
        q_l = _group_means(q, bounds, l_v)
        k_l = _group_means(k, bounds, l_v)

        attn1 = torch.softmax(q @ k_l.transpose(-1, -2), dim=-1)  # [B,H,L,m]
        attn2 = torch.softmax(q_l @ k_l.transpose(-1, -2), dim=-1)
        sim3 = q_l @ k.transpose(-1, -2)                           # [B,H,m,L]
        # softmax over n real logits plus pad_v phantom zeros; bucket-pad
        # positions are excluded
        pm = mask[:, None, None, :]
        s3 = torch.where(pm, sim3, NEG)
        max_real = s3.amax(dim=-1, keepdim=True)
        phantom = (pad_v > 0)[:, None, None, None]
        m3 = torch.maximum(max_real, torch.where(
            phantom, torch.zeros((), dtype=q.dtype, device=q.device), NEG))
        num = torch.where(pm, torch.exp(s3 - m3), 0.0)
        denom = num.sum(dim=-1, keepdim=True) \
            + pad_v.to(q.dtype)[:, None, None, None] * torch.exp(-m3)
        attn3 = num / torch.clamp(denom, min=eps)

    attn2_inv = moore_penrose_pinv(attn2, pinv_iterations)
    return (attn1 @ attn2_inv) @ (attn3 @ v)


class NystromAttention(nn.Module):
    """(B, N, F) -> (B, N, F) Nystrom landmark attention with the depthwise
    conv residual.  Submodule and param names follow the flax tree
    (``to_qkv``, ``res_conv`` of shape (heads, 1, K, 1), ``to_out``)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 num_landmarks: int = 64, pinv_iterations: int = 6,
                 residual_conv_kernel: int = 33):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        inner = heads * dim_head
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.res_conv = nn.Parameter(
            torch.empty(heads, 1, residual_conv_kernel, 1))
        self.to_out = Linear(inner, dim)
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        xavier2_flax_(self.res_conv, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        h, m, dh = self.heads, self.num_landmarks, self.dim_head
        remainder = n % m
        pad = (m - remainder) if (remainder > 0 and mask is None) else 0
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, pad, 0))
        n_p = n + pad

        qkv = self.to_qkv(x).reshape(b, n_p, 3, h, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                   # [B, H, Np, D]
        if mask is not None:
            mf = mask[:, None, :, None].to(x.dtype)
            q, k, v = q * mf, k * mf, v * mf
        q = q * (dh ** -0.5)

        out = nystrom_core(q, k, v, mask, m, self.pinv_iterations)
        out = out + depthwise_time_conv(v, self.res_conv[:, 0, :, 0])
        out = self.to_out(out.transpose(1, 2).reshape(b, n_p, h * dh))
        return out[:, -n:]
