"""Base-model (token-mixing backbone) factory.

Counterpart of edsnet_tpu/models/base.py:build_base_model and
``LinearExtractor``: all 10 ``--base-model`` choices, with the JAX
factory's configurations.

The attention backbone's ``--use-pallas`` tri-state is passed in as
``use_pallas`` instead of set globally.  Each attention pass decides its
route from its shapes alone, before any launch
(``models/attention.py:flash_route``):
- training passes always take the dense path;
- None (auto): the flash kernel at precision "highest" on a CUDA device
  when the head dim is one the forward kernel takes (32, 64, 128, 256,
  512), else the dense path (so ``--num-feature 32 --num-head 2``, head
  dim 16, runs dense on the card);
- True (--use-pallas): the flash route at precision "default"; on a CUDA
  device a head dim the kernels do not take raises;
- False (--no-pallas): always the dense path.
The other backbones run no kernel of the port.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.attention import AttentionExtractor
from edsnet_torch.models.common import Linear
from edsnet_torch.models.dwt_net import DwtNet
from edsnet_torch.models.fnet import FNetLayer
from edsnet_torch.models.gcn import GCNExtractor
from edsnet_torch.models.linformer import Linformer
from edsnet_torch.models.lstm import BiLSTMExtractor, LSTMExtractor
from edsnet_torch.models.nystromformer import NystromAttention
from edsnet_torch.models.performer import Performer


class LinearExtractor(nn.Module):
    """Position-wise linear mixing: one Linear named ``linear``."""

    def __init__(self, num_feature: int):
        super().__init__()
        self.linear = Linear(num_feature, num_feature)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self.linear(x)


def build_base_model(base_type: str, num_feature: int, num_head: int,
                     use_pallas: Optional[bool] = None,
                     orientation: str = "paper") -> nn.Module:
    """(B, N, F) -> (B, N, F) mixing module by name; ``orientation`` is
    the fourier backbone's (--fft-attention-orientation)."""
    if base_type == "nystromformer":
        return NystromAttention(dim=num_feature, dim_head=64, heads=num_head,
                                num_landmarks=64, pinv_iterations=6,
                                residual_conv_kernel=33)
    if base_type == "fourier":
        return FNetLayer(num_feature, dropout=0.5, orientation=orientation)
    if base_type == "performer":
        return Performer(dim=num_feature, depth=1, heads=num_head,
                         mlp_dim=1024, dim_head=64, dropout=0.5)
    if base_type == "linformer":
        return Linformer(dim=num_feature, depth=1, heads=num_head,
                         dim_head=64, seq_len=5000, k=1000, dropout=0.5,
                         mlp_dim=1024)
    if base_type == "dwt":
        return DwtNet(num_feature=num_feature, dropout=0.5)
    if base_type == "linear":
        return LinearExtractor(num_feature)
    if base_type == "attention":
        return AttentionExtractor(num_head, num_feature, use_flash=use_pallas)
    if base_type == "lstm":
        return LSTMExtractor(num_feature)
    if base_type == "bilstm":
        return BiLSTMExtractor(num_feature)
    if base_type == "gcn":
        return GCNExtractor(num_feature)
    raise ValueError(f"Invalid base model {base_type}")
