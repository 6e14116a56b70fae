"""ConvNeXt-Base frame features (pooled 1024-d, before the classifier).

Counterpart of edsnet_tpu/models/convnext.py.  The reference's third
frame-feature option (`--feature-extractor convnext`, video_helper.py:
36-48) is torchvision's convnext_base with the classifier stripped: the
features, then the global average pool, flattened, WITHOUT the
classifier's LayerNorm.  This module is that network in eval mode
(stochastic depth is the identity) with torchvision's structure and
``state_dict`` names (``features.{0..7}``), so the released checkpoint
loads with ``strict=True`` once its ``classifier.*`` entries are dropped.

Stem: 4x4 / 4 conv, LayerNorm over channels (eps 1e-6).  Stages of
``CNBlock``s: depthwise 7x7 conv (``groups=C``), channels-last LayerNorm,
Linear 4C, exact (erf) GELU, Linear C, times ``layer_scale``, added to the
residual.  Between stages: LayerNorm, 2x2 / 2 conv.  Depths (3, 3, 27, 3),
widths (128, 256, 512, 1024).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

DEPTHS = (3, 3, 27, 3)
DIMS = (128, 256, 512, 1024)
LN_EPS = 1e-6
HEAD_PREFIXES = ("classifier",)


class Permute(nn.Module):
    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class LayerNorm2d(nn.LayerNorm):
    """torchvision's LayerNorm2d: LayerNorm over the channels of NCHW."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.layer_norm(x.permute(0, 2, 3, 1), self.normalized_shape,
                         self.weight, self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


class CNBlock(nn.Module):
    """One ConvNeXt block, eval mode (torchvision CNBlock)."""

    def __init__(self, dim: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            Permute(0, 2, 3, 1),
            nn.LayerNorm(dim, eps=LN_EPS),
            nn.Linear(dim, 4 * dim),
            nn.GELU(approximate="none"),
            nn.Linear(4 * dim, dim),
            Permute(0, 3, 1, 2))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer_scale * self.block(x)


class ConvNeXtBaseFeatures(nn.Module):
    """[B, 3, H, W] normalised NCHW -> [B, 1024] pooled features."""

    def __init__(self):
        super().__init__()
        layers = [nn.Sequential(nn.Conv2d(3, DIMS[0], 4, stride=4),
                                LayerNorm2d(DIMS[0], eps=LN_EPS))]
        for s, (depth, dim) in enumerate(zip(DEPTHS, DIMS)):
            if s > 0:
                layers.append(nn.Sequential(
                    LayerNorm2d(DIMS[s - 1], eps=LN_EPS),
                    nn.Conv2d(DIMS[s - 1], dim, 2, stride=2)))
            layers.append(nn.Sequential(*[CNBlock(dim)
                                          for _ in range(depth)]))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x).mean(dim=(2, 3))
