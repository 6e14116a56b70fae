"""Base-model (token-mixing backbone) factory: the attention backbone and
its flash-kernel routing.

Counterpart of edsnet_tpu/models/base.py:build_base_model (``attention``
branch) and its ``--use-pallas`` tri-state, passed in as ``use_pallas``
instead of set globally.  Each attention pass decides its route from its
shapes alone, before any launch (``models/attention.py:flash_route``):
- training passes always take the dense path;
- None (auto): the flash kernel at precision "highest" on a CUDA device
  when the head dim is one the kernels take, else the dense path (so
  ``--num-head 4`` at F 1024, head dim 256, runs dense on the card);
- True (--use-pallas): the flash route at precision "default"; on a CUDA
  device a head dim the kernels do not take raises;
- False (--no-pallas): always the dense path.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from edsnet_torch.models.attention import AttentionExtractor


def build_base_model(base_type: str, num_feature: int, num_head: int,
                     use_pallas: Optional[bool] = None) -> nn.Module:
    """(B, N, F) -> (B, N, F) mixing module by name."""
    if base_type == "attention":
        return AttentionExtractor(num_head, num_feature, use_flash=use_pallas)
    raise NotImplementedError(
        f"--base-model {base_type} is not ported yet (ROADMAP.md Queue A "
        f"items 3 and 11); this slice serves --base-model attention")
