"""Model registry: name + depth -> head module.

Counterpart of edsnet_tpu/models/model_zoo.py:get_model, get_anchor_based
and get_anchor_free.  Both factories build every depth of JAX's: the
anchor-based one also ``cross-attention`` (the motion head, built at
``motion_width``, the motion features' width, which torch needs at build
time and flax read at init; F when None), the anchor-free one has no such
depth, as in JAX.

``--untie-fc-blocks`` does not reach the model, as in the reference, whose
factories never pass ``tie_fc_blocks`` to a head: the CLIs build the tied
trunk whatever the flag says, and say so in the log.  Untied blocks exist
at the module level (``DSNet(tie_fc_blocks=False)``, likewise the other
heads with a trunk).  ``--pooling-type`` reaches only the anchor-based
shallow head, ``--attention-depth`` only the anchor-based deep and motion
heads and ``--encoder-type`` only the motion head, as in JAX; the
anchor-free factory takes none of them, nor ``--anchor-scales``.
"""
from __future__ import annotations

import logging
from typing import Optional

from torch import nn

from edsnet_torch.models.dsnet import (DSNet, DSNetDeepAttention,
                                       DSNetMotionFeatures,
                                       DSNetMultiAttention, DSNetOriginal)
from edsnet_torch.models.dsnet_af import (DSNetAF, DSNetAFDeepAttention,
                                          DSNetAFMultiAttention,
                                          DSNetAFOriginal)

logger = logging.getLogger(__name__)

MODEL_DEPTHS = ("shallow", "deep", "local-global-attention", "original",
                "cross-attention")


def _log_untie(untie_fc_blocks: bool) -> None:
    if untie_fc_blocks:
        logger.warning("--untie-fc-blocks: the trunk stays tied; the flag "
                       "does not reach the model in edsnet_tpu either "
                       "(its model factories never pass tie_fc_blocks)")


def get_anchor_based(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, model_depth="shallow",
                     attention_depth: int = 2, encoder_type: str = "classic",
                     use_pallas: Optional[bool] = None,
                     orientation: str = "paper", untie_fc_blocks=False,
                     motion_width: Optional[int] = None,
                     **kwargs) -> nn.Module:
    """``use_pallas``: the --use-pallas / --no-pallas tri-state (None =
    auto), see models/base.py; ``orientation``: the fourier backbone's
    --fft-attention-orientation; ``untie_fc_blocks`` is only logged;
    ``motion_width``: the motion head's motion width (F when None)."""
    _log_untie(untie_fc_blocks)
    if model_depth == "shallow":
        return DSNet(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, use_pallas,
                     orientation)
    if model_depth == "deep":
        return DSNetDeepAttention(base_model, num_feature, num_hidden,
                                  anchor_scales, num_head, fc_depth,
                                  attention_depth, use_pallas, orientation)
    if model_depth == "local-global-attention":
        return DSNetMultiAttention(base_model, num_feature, num_hidden,
                                   anchor_scales, num_head, fc_depth,
                                   use_pallas, orientation)
    if model_depth == "original":
        return DSNetOriginal(base_model, num_feature, num_hidden,
                             anchor_scales, num_head, use_pallas)
    if model_depth == "cross-attention":
        return DSNetMotionFeatures(base_model, num_feature, num_hidden,
                                   anchor_scales, num_head, attention_depth,
                                   encoder_type, use_pallas, orientation,
                                   motion_width=motion_width)
    raise ValueError(f"Invalid model depth {model_depth}")


def get_anchor_free(base_model, num_feature, num_hidden, num_head, fc_depth,
                    model_depth="shallow", use_pallas: Optional[bool] = None,
                    orientation: str = "paper", untie_fc_blocks=False,
                    **kwargs) -> nn.Module:
    """The anchor-free head of ``model_depth``; the other arguments as
    ``get_anchor_based``'s."""
    _log_untie(untie_fc_blocks)
    if model_depth == "shallow":
        return DSNetAF(base_model, num_feature, num_hidden, num_head,
                       fc_depth, use_pallas, orientation)
    if model_depth == "deep":
        return DSNetAFDeepAttention(base_model, num_feature, num_hidden,
                                    num_head, fc_depth, use_pallas,
                                    orientation)
    if model_depth == "original":
        return DSNetAFOriginal(base_model, num_feature, num_hidden, num_head,
                               use_pallas)
    if model_depth == "local-global-attention":
        return DSNetAFMultiAttention(base_model, num_feature, num_hidden,
                                     num_head, fc_depth, use_pallas,
                                     orientation)
    # JAX's get_anchor_free has no cross-attention branch: its ValueError
    raise ValueError(f"Invalid model depth {model_depth}")


def get_model(model_type: str, **kwargs) -> nn.Module:
    """Build a head module from CLI-style keyword arguments."""
    if model_type == "anchor-based":
        return get_anchor_based(**kwargs)
    if model_type == "anchor-free":
        return get_anchor_free(**kwargs)
    raise ValueError(f"Invalid model type {model_type}")
