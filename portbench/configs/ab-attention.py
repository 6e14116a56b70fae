"""The plain reference of ``ab-attention``: its token mixer inside the
anchor-based head (``HEAD``, what the harness judges the cell by), its
weights' shapes and its forward operation count.

The mixer is DSNet's multi-head self-attention: bias-free Q, K, V and
output projections, 8 heads of F / 8, softmax of q k^T / sqrt(D), dropout
0.5 on the attention map and on the output in training.  One video
without a mask: its positions are all real.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.model import AnchorBased, trunk_spec


def weight_spec(cfg: Dict) -> List[Tuple]:
    f = cfg["num_feature"]
    return [(f"base_model.{p}.weight", (f, f), ("xavier2", f, f))
            for p in ("Q", "K", "V", "fc")] + trunk_spec(f, cfg["num_hidden"])


def mixer(cfg: Dict, W: Dict[str, torch.Tensor], x: torch.Tensor, drop
          ) -> torch.Tensor:
    """x [n, F] -> [n, F]."""
    n, f = x.shape
    h = cfg["num_head"]
    d = f // h
    nb = drop.bucket
    q, k, v = ((x @ W[f"base_model.{p}.weight"].T).reshape(n, h, d)
               .transpose(0, 1) for p in ("Q", "K", "V"))
    attn = torch.softmax(q @ k.transpose(-1, -2) / d ** 0.5, -1)
    attn = drop(attn[None], (2, 3), (1, h, nb, nb))[0]
    y = (attn @ v).transpose(0, 1).reshape(n, f)
    y = y @ W["base_model.fc.weight"].T
    return drop(y, (0,), (nb, f))


def forward_flops(cfg: Dict, n: int) -> float:
    """Multiply-add operations x 2 of one forward at n positions (the
    softmax, norms and pools not counted)."""
    f, hid = cfg["num_feature"], cfg["num_hidden"]
    s = len(cfg["anchor_scales"])
    mix = 2 * n * f * f * 4 + 2 * 2 * n * n * f
    trunk = 2 * n * (f * hid + cfg["fc_depth"] * hid * hid + s * hid * 3)
    return float(mix + trunk)


HEAD = AnchorBased(mixer)
