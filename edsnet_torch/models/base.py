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

``--context-parallel`` is process state, as in JAX: ``set_context_parallel``
(or ``configure_context_parallel``, which also registers the ring mesh)
before the model is built bakes it into each attention module, and
``set_ring_mesh`` / ``disable_ring_attention`` say which mesh the ring
rides, or that it stays off.
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


_CONTEXT_PARALLEL = 0
_CP_MIN_LEN = 1024
# (mesh, seq_axis, batch_axis, head_axis) registered by the trainer or the
# evaluate CLI, RING_DISABLED, or None (unset: the ring stays off)
_RING_MESH = None
# forces the flash / dense rule even on modules built with
# context_parallel; the trainer registers it when its mesh cannot hold a
# ring (one rank, or tp takes every rank)
RING_DISABLED = object()


def set_context_parallel(num_devices: int, min_len: int = 1024) -> None:
    """--context-parallel: 0 = off, -1 = every rank, > 0 = that many;
    applies to the attention modules built afterwards, on deterministic
    passes of sequences >= ``min_len`` that divide the ring's seq axis.
    Clears any registered ring mesh."""
    global _CONTEXT_PARALLEL, _CP_MIN_LEN, _RING_MESH
    _CONTEXT_PARALLEL = int(num_devices)
    _CP_MIN_LEN = int(min_len)
    _RING_MESH = None


def set_ring_mesh(mesh, seq_axis: str = "seq", batch_axis=None,
                  head_axis=None) -> None:
    """Register the mesh the ring rides (None clears); ``batch_axis`` /
    ``head_axis`` name its axes that also split the rows and heads."""
    global _RING_MESH
    _RING_MESH = None if mesh is None else (mesh, seq_axis, batch_axis,
                                            head_axis)


def disable_ring_attention() -> None:
    """Keep the flash / dense rule from now on, even on modules built
    with ``context_parallel``; cleared by ``set_ring_mesh`` and
    ``set_context_parallel``."""
    global _RING_MESH
    _RING_MESH = RING_DISABLED


def get_ring_mesh():
    return _RING_MESH


def configure_context_parallel(num_devices: int,
                               min_len: int = 1024) -> None:
    """CLI start-up: ``set_context_parallel`` and, where the world's ranks
    allow one, the ring mesh over all of them, ('data', 'seq') with the
    ranks the ring leaves on the batch axis.  Skipped on a world of 1 or
    when the ring does not divide it (the ring then stays off).  The
    trainer registers its own, tp-aware, mesh."""
    set_context_parallel(num_devices, min_len)
    if not num_devices:
        return
    from edsnet_torch.parallel.mesh import make_ring_mesh, world
    total = world()[1]
    cp_eff = min(num_devices, total) if num_devices > 0 else total
    if total >= 2 and cp_eff >= 2 and total % cp_eff == 0:
        set_ring_mesh(make_ring_mesh(cp_eff), "seq", batch_axis="data")


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
        return AttentionExtractor(num_head, num_feature, use_flash=use_pallas,
                                  context_parallel=_CONTEXT_PARALLEL,
                                  cp_min_len=_CP_MIN_LEN)
    if base_type == "lstm":
        return LSTMExtractor(num_feature)
    if base_type == "bilstm":
        return BiLSTMExtractor(num_feature)
    if base_type == "gcn":
        return GCNExtractor(num_feature)
    raise ValueError(f"Invalid base model {base_type}")
