"""Model registry: name + depth -> head module.

Counterpart of edsnet_tpu/models/model_zoo.py:get_model, get_anchor_based
and get_anchor_free.  This port serves the anchor-based shallow head and
the anchor-free shallow, deep and original heads.

``--untie-fc-blocks`` does not reach the model, as in the reference, whose
factories never pass ``tie_fc_blocks`` to a head: the CLIs build the tied
trunk whatever the flag says, and say so in the log.  Untied blocks exist
at the module level (``DSNet(tie_fc_blocks=False)``, likewise ``DSNetAF``).
``--pooling-type`` does not reach an anchor-free head either: JAX's
``get_anchor_free`` takes none.
"""
from __future__ import annotations

import logging
from typing import Optional

from torch import nn

from edsnet_torch.models.dsnet import DSNet
from edsnet_torch.models.dsnet_af import (DSNetAF, DSNetAFDeepAttention,
                                          DSNetAFOriginal)

logger = logging.getLogger(__name__)

MODEL_DEPTHS = ("shallow", "deep", "local-global-attention", "original",
                "cross-attention")


def _log_untie(untie_fc_blocks: bool) -> None:
    if untie_fc_blocks:
        logger.warning("--untie-fc-blocks: the trunk stays tied; the flag "
                       "does not reach the model in edsnet_tpu either "
                       "(its model factories never pass tie_fc_blocks)")


def _unported_depth(model_depth: str, served: str):
    return NotImplementedError(
        f"--model-depth {model_depth} is not ported yet (ROADMAP.md Queue A "
        f"item 10); this port serves {served}")


def get_anchor_based(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, model_depth="shallow",
                     use_pallas: Optional[bool] = None,
                     orientation: str = "paper", untie_fc_blocks=False,
                     **kwargs) -> nn.Module:
    """``use_pallas``: the --use-pallas / --no-pallas tri-state (None =
    auto), see models/base.py; ``orientation``: the fourier backbone's
    --fft-attention-orientation; ``untie_fc_blocks`` is only logged."""
    _log_untie(untie_fc_blocks)
    if model_depth == "shallow":
        return DSNet(base_model, num_feature, num_hidden, anchor_scales,
                     num_head, fc_depth, pooling_type, use_pallas,
                     orientation)
    if model_depth in MODEL_DEPTHS:
        raise _unported_depth(model_depth, "the shallow anchor-based head")
    raise ValueError(f"Invalid model depth {model_depth}")


def get_anchor_free(base_model, num_feature, num_hidden, num_head, fc_depth,
                    model_depth="shallow", use_pallas: Optional[bool] = None,
                    orientation: str = "paper", untie_fc_blocks=False,
                    **kwargs) -> nn.Module:
    """The anchor-free head of ``model_depth``; the other arguments as
    ``get_anchor_based``'s (``--pooling-type`` and ``--anchor-scales`` are
    ignored, as in JAX)."""
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
        raise _unported_depth(model_depth, "the shallow, deep and original "
                                           "anchor-free heads")
    raise ValueError(f"Invalid model depth {model_depth}")


def get_model(model_type: str, **kwargs) -> nn.Module:
    """Build a head module from CLI-style keyword arguments."""
    if model_type == "anchor-based":
        return get_anchor_based(**kwargs)
    if model_type == "anchor-free":
        return get_anchor_free(**kwargs)
    raise ValueError(f"Invalid model type {model_type}")
