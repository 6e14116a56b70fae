"""Swin-V2-B frame features (pooled 1024-d, before the head).

Counterpart of edsnet_tpu/models/swin.py.  The reference's second
frame-feature option (`--feature-extractor swin-transformer`,
video_helper.py:36-46) is torchvision's swin_v2_b with the head stripped:
the features, the final LayerNorm, the global average pool, flattened.
This module is that network in eval mode (stochastic depth and dropout
off) with torchvision's structure and ``state_dict`` names
(``features.0.{0,2}``, ``features.{1,3,5,7}.{j}``, ``features.{2,4,6}.
{reduction,norm}``, ``norm``), including the attention's persistent
buffers ``relative_coords_table`` and ``relative_position_index``, so the
released checkpoint loads with ``strict=True`` once its ``head.*`` entries
are dropped.  The buffers are computed as JAX's ``_relative_coords_table``
and ``_relative_position_index`` compute them.

- patch embedding: 4x4 / 4 conv, LayerNorm (eps 1e-5), channels last;
- res-post-norm blocks: x += norm1(attn(x)); x += norm2(mlp(x)), the mlp
  Linear 4C, exact GELU, Linear C;
- shifted-window attention: 8x8 windows, the shift 4 on odd blocks and 0
  on an axis whose padded side the window covers; maps padded to window
  multiples, and the pad rows attend; cosine attention times
  exp(min(logit_scale, ln 100)); the relative bias 16 sigmoid(cpb_mlp(
  table)); the K third of the fused qkv bias zeroed at use; the shift mask
  additive (0 / -100); plain products and softmax;
- PatchMergingV2: 2x2 concat, Linear(4C, 2C, no bias), LayerNorm;
- embed 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32), final LayerNorm
  over 1024, then the mean over H and W.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

EMBED = 128
DEPTHS = (2, 2, 18, 2)
HEADS = (4, 8, 16, 32)
WINDOW = 8
LN_EPS = 1e-5
HEAD_PREFIXES = ("head",)


def relative_coords_table(ws: int) -> np.ndarray:
    """V2 log-spaced CPB input coordinates: [(2w-1)^2, 2] float32."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    table = table / (ws - 1) * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / 3.0
    return table.reshape(-1, 2)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] indices into the (2w-1)^2 CPB table rows."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))           # [2, w, w]
    flat = coords.reshape(2, -1)                             # [2, w*w]
    rel = flat[:, :, None] - flat[:, None, :]                # [2, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)                                       # [N, N]


@functools.lru_cache(maxsize=16)
def shift_attn_mask(pad_h: int, pad_w: int, ws: int, shift_h: int,
                    shift_w: int) -> np.ndarray:
    """[num_windows, ws*ws, ws*ws] additive mask (0 or -100) separating the
    wrapped regions after the cyclic shift (torchvision's
    shifted_window_attention; the shift may be zero on one axis only).
    Cached: read-only."""
    region = np.zeros((pad_h, pad_w), np.float32)
    cnt = 0
    for hs in ((0, pad_h - ws), (pad_h - ws, pad_h - shift_h),
               (pad_h - shift_h, pad_h)):
        for ws_ in ((0, pad_w - ws), (pad_w - ws, pad_w - shift_w),
                    (pad_w - shift_w, pad_w)):
            region[hs[0]:hs[1], ws_[0]:ws_[1]] = cnt
            cnt += 1
    region = region.reshape(pad_h // ws, ws, pad_w // ws, ws)
    region = region.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = region[:, None, :] - region[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class ShiftedWindowAttentionV2(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: int):
        super().__init__()
        self.num_heads = num_heads
        self.shift = shift
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.register_buffer("relative_coords_table", torch.from_numpy(
            relative_coords_table(WINDOW)).view(
                1, 2 * WINDOW - 1, 2 * WINDOW - 1, 2))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(WINDOW)).reshape(-1))

    def position_bias(self) -> torch.Tensor:
        """[H, n, n] continuous relative position bias."""
        n = WINDOW * WINDOW
        cpb = self.cpb_mlp(self.relative_coords_table).view(
            -1, self.num_heads)
        bias = cpb[self.relative_position_index].view(n, n, -1)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, heads = WINDOW, self.num_heads
        pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        ph, pw = h + pad_b, w + pad_r
        # the shift is clamped per axis where the window covers the
        # padded side
        shift_h = 0 if ws >= ph else self.shift
        shift_w = 0 if ws >= pw else self.shift
        shifted = shift_h + shift_w > 0
        if shifted:
            x = torch.roll(x, (-shift_h, -shift_w), dims=(1, 2))

        nh, nw = ph // ws, pw // ws
        nwin, n = nh * nw, ws * ws
        xw = x.view(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(b * nwin, n, c)

        qkv_bias = self.qkv.bias
        qkv_bias = torch.cat([qkv_bias[:c], torch.zeros_like(qkv_bias[:c]),
                              qkv_bias[2 * c:]])     # K bias zeroed at use
        qkv = F.linear(xw, self.qkv.weight, qkv_bias)
        qkv = qkv.view(b * nwin, n, 3, heads, c // heads).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                       # [B*, H, n, d]

        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(
            -2, -1)
        attn = attn * torch.clamp(self.logit_scale,
                                  max=math.log(100.0)).exp()
        attn = attn + self.position_bias()
        if shifted:
            mask = torch.as_tensor(
                shift_attn_mask(ph, pw, ws, shift_h, shift_w),
                dtype=attn.dtype, device=attn.device)
            attn = attn.view(b, nwin, heads, n, n) + mask[None, :, None]
            attn = attn.view(b * nwin, heads, n, n)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b * nwin, n, c)
        out = self.proj(out)

        out = out.view(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(b, ph, pw, c)
        if shifted:
            out = torch.roll(out, (shift_h, shift_w), dims=(1, 2))
        return out[:, :h, :w]


class SwinTransformerBlockV2(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ShiftedWindowAttentionV2(dim, num_heads, shift)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        # torchvision's MLP: Linear, GELU, Dropout, Linear, Dropout
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim),
                                 nn.GELU(approximate="none"),
                                 nn.Dropout(0.0),
                                 nn.Linear(4 * dim, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.norm1(self.attn(x))
        return x + self.norm2(self.mlp(x))


class PatchMergingV2(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(x))


class ChannelsLast(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1)


class SwinV2BFeatures(nn.Module):
    """[B, 3, H, W] normalised NCHW -> [B, 1024] pooled features."""

    def __init__(self):
        super().__init__()
        layers = [nn.Sequential(nn.Conv2d(3, EMBED, 4, stride=4),
                                ChannelsLast(),
                                nn.LayerNorm(EMBED, eps=LN_EPS))]
        dim = EMBED
        for s, depth in enumerate(DEPTHS):
            if s > 0:
                layers.append(PatchMergingV2(dim))
                dim *= 2
            layers.append(nn.Sequential(*[
                SwinTransformerBlockV2(dim, HEADS[s],
                                       0 if b % 2 == 0 else WINDOW // 2)
                for b in range(depth)]))
        self.features = nn.Sequential(*layers)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.features(x)).mean(dim=(1, 2))
