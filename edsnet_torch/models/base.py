"""Base-model (token-mixing backbone) factory: the attention backbone and
its flash-kernel routing.

Counterpart of edsnet_tpu/models/base.py:build_base_model (``attention``
branch) and its ``--use-pallas`` tri-state, passed in as ``use_pallas``
instead of set globally:
- None (auto): deterministic passes on a CUDA device take the flash kernel
  at precision "highest"; on the CPU the dense path runs, as JAX's auto
  rule keeps the kernel off away from its accelerator;
- True (--use-pallas): the flash route on any device, precision "default"
  (on the CPU that is the kernel's plain twin);
- False (--no-pallas): always the dense path.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from edsnet_torch.models.attention import AttentionExtractor

# Shortest sequence the flash route takes.  0 routes every deterministic
# attention pass through the kernel: the JAX thresholds (1024 / 2048) come
# from TPU timings and would leave it off for every eval bucket of a real
# video.  A later PR sets this from the card's times in PERF.md.
FLASH_MIN_LEN = 0


def build_base_model(base_type: str, num_feature: int, num_head: int,
                     use_pallas: Optional[bool] = None) -> nn.Module:
    """(B, N, F) -> (B, N, F) mixing module by name."""
    if base_type == "attention":
        return AttentionExtractor(num_head, num_feature,
                                  use_flash=use_pallas,
                                  flash_min_len=FLASH_MIN_LEN)
    raise NotImplementedError(
        f"--base-model {base_type} is not ported yet (ROADMAP.md Queue A "
        f"items 3 and 11); this slice serves --base-model attention")
