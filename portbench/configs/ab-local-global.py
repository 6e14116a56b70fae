"""The plain reference of ``ab-local-global``: EDSNet's local-global
anchor-based head (``HEAD``, ``reference/local_global.py``, what the
harness judges the cell by), its weights' shapes and its forward
operation count.

The weights carry the port's names: the local-global encoder under
``multiattentionblock`` (a global attention and four local ones, each
bias-free Q, K, V and fc; the shared ``fc``; ``layer_norm``; ``fc``, the
block's fc2), then the trunk and heads of ``reference/model.py:
trunk_spec`` without its top-level LayerNorm, which this head lacks.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.reference.local_global import (BLOCK, MULTI, SEGMENTS,
                                              AnchorBasedLocalGlobal)
from portbench.reference.model import trunk_spec


def weight_spec(cfg: Dict) -> List[Tuple]:
    f = cfg["num_feature"]
    attentions = ["global_attention"] + [f"local_attention_{s}"
                                         for s in range(SEGMENTS)]
    spec = [(f"{MULTI}.{a}.{p}.weight", (f, f), ("xavier2", f, f))
            for a in attentions for p in ("Q", "K", "V", "fc")]
    for name in (MULTI + ".fc", BLOCK + ".fc"):
        spec += [(name + ".weight", (f, f), ("xavier2", f, f)),
                 (name + ".bias", (f,), ("const", 0.1))]
    spec += [(BLOCK + ".layer_norm.weight", (f,), ("const", 1.0)),
             (BLOCK + ".layer_norm.bias", (f,), ("const", 0.0))]
    return spec + [s for s in trunk_spec(f, cfg["num_hidden"])
                   if not s[0].startswith("layer_norm.")]


def forward_flops(cfg: Dict, n: int) -> float:
    """Multiply-add operations x 2 of one forward at n positions (the
    softmaxes, norms and pools not counted): the global attention over n,
    the four local ones over ceil(n / 4) positions each and the last
    segment's true remainder, the shared fc over the global path and the
    segments (n rows each), fc2, then the trunk and the heads as
    ``ab-attention`` counts them."""
    f, hid = cfg["num_feature"], cfg["num_hidden"]
    s = len(cfg["anchor_scales"])
    size = -(-n // SEGMENTS)
    segs = [max(0, min(size, n - i * size)) for i in range(SEGMENTS)]
    glob = 2 * n * f * f * 4 + 2 * 2 * n * n * f
    local = sum(2 * m * f * f * 4 + 2 * 2 * m * m * f for m in segs)
    fcs = 2 * n * f * f * 3
    trunk = 2 * n * (f * hid + cfg["fc_depth"] * hid * hid + s * hid * 3)
    return float(glob + local + fcs + trunk)


HEAD = AnchorBasedLocalGlobal()
