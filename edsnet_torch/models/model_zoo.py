"""Model registry: name + depth -> head module.

Counterpart of edsnet_tpu/models/model_zoo.py:get_model /
get_anchor_based.  This slice serves the anchor-based shallow head.
"""
from __future__ import annotations

from typing import Optional

from torch import nn

from edsnet_torch.models.dsnet import DSNet

MODEL_DEPTHS = ("shallow", "deep", "local-global-attention", "original",
                "cross-attention")


def get_anchor_based(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, model_depth="shallow",
                     use_pallas: Optional[bool] = None,
                     **kwargs) -> nn.Module:
    """``use_pallas``: the --use-pallas / --no-pallas tri-state (None =
    auto), see models/base.py."""
    if model_depth == "shallow":
        return DSNet(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, use_pallas)
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
