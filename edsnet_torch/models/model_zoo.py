"""Model registry: name + depth -> head module.

Counterpart of edsnet_tpu/models/model_zoo.py:get_model /
get_anchor_based.  This slice serves the anchor-based shallow head.

``--untie-fc-blocks`` does not reach the model, as in the reference, whose
``get_anchor_based`` never passes ``tie_fc_blocks`` to ``DSNet``: the CLIs
build the tied trunk whatever the flag says, and say so in the log.
Untied blocks exist at the module level (``DSNet(tie_fc_blocks=False)``).
"""
from __future__ import annotations

import logging
from typing import Optional

from torch import nn

from edsnet_torch.models.dsnet import DSNet

logger = logging.getLogger(__name__)

MODEL_DEPTHS = ("shallow", "deep", "local-global-attention", "original",
                "cross-attention")


def get_anchor_based(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, model_depth="shallow",
                     use_pallas: Optional[bool] = None,
                     orientation: str = "paper", untie_fc_blocks=False,
                     **kwargs) -> nn.Module:
    """``use_pallas``: the --use-pallas / --no-pallas tri-state (None =
    auto), see models/base.py; ``orientation``: the fourier backbone's
    --fft-attention-orientation; ``untie_fc_blocks`` is only logged."""
    if untie_fc_blocks:
        logger.warning("--untie-fc-blocks: the trunk stays tied; the flag "
                       "does not reach the model in edsnet_tpu either "
                       "(its get_anchor_based never passes tie_fc_blocks)")
    if model_depth == "shallow":
        return DSNet(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, use_pallas,
                     orientation)
    if model_depth in MODEL_DEPTHS:
        raise NotImplementedError(
            f"--model-depth {model_depth} is not ported yet (ROADMAP.md "
            f"Queue A item 10); this slice serves the shallow head")
    raise ValueError(f"Invalid model depth {model_depth}")


def get_model(model_type: str, **kwargs) -> nn.Module:
    """Build a head module from CLI-style keyword arguments."""
    if model_type == "anchor-based":
        return get_anchor_based(**kwargs)
    if model_type == "anchor-free":
        raise NotImplementedError(
            "anchor-free models are not ported yet (ROADMAP.md Queue A "
            "item 9); this slice serves anchor-based")
    raise ValueError(f"Invalid model type {model_type}")
