"""DWT token-mixing backbone: a differentiable Haar transform over time.

Counterpart of edsnet_tpu/models/dwt_net.py:DwtNet.  cA, cD = DWT(x);
h = LN(fc_block(cA) + cD); a learned 2-tap stride-2 transposed conv (one
shared (w0, w1, bias), in and out channels 1) upsamples time 2x; crop to
n; fc_block again with the same ``fc`` weights and a fresh dropout draw.
fc_block is fc -> exact-erf GELU -> dropout 0.5.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from edsnet_torch.models.common import (Dropout, LayerNorm, Linear,
                                        apply_mask, xavier2_flax_)
from edsnet_torch.ops.dwt import haar_dwt


class DwtNet(nn.Module):
    def __init__(self, num_feature: int, dropout: float = 0.5):
        super().__init__()
        self.fc = Linear(num_feature, num_feature)
        self.dropout = Dropout(dropout)
        self.norm = LayerNorm(num_feature)
        self.transconv_kernel = nn.Parameter(torch.empty(2, 1, 1))
        self.transconv_bias = nn.Parameter(torch.empty(1))
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        xavier2_flax_(self.transconv_kernel, generator)
        with torch.no_grad():
            self.transconv_bias.fill_(0.1)

    def _fc_block(self, t: torch.Tensor) -> torch.Tensor:
        return self.dropout(F.gelu(self.fc(t)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, f = x.shape
        x = apply_mask(x, mask)
        ca, cd = haar_dwt(x, dim=1)                     # [B, ceil(N/2), F]
        if mask is not None:
            # pywt's symmetric boundary at each video's true odd length n:
            # the last real pair is (x[n-1], x[n-1]), so cA = sqrt(2) x[n-1]
            # and cD = 0 where the zero-padded bucket paired x[n-1] with 0
            lengths = mask.to(torch.int64).sum(dim=-1)
            even_pos = torch.arange(ca.shape[1], device=x.device) * 2
            boundary = (even_pos[None, :] == lengths[:, None] - 1)[..., None]
            ca = torch.where(boundary, x[:, 0::2] * 2.0 ** 0.5, ca)
            cd = torch.where(boundary, 0.0, cd)
        h = self.norm(self._fc_block(ca) + cd)
        w = self.transconv_kernel[:, 0, 0]
        up = torch.stack([h * w[0], h * w[1]], dim=2).reshape(b, -1, f)
        up = up[:, :n] + self.transconv_bias[0]
        return self._fc_block(up)
