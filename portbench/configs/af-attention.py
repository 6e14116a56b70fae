"""The plain reference of ``af-attention``: ``ab-attention``'s token mixer
inside the anchor-free head (``HEAD``, what the harness judges the cell
by), its weights' shapes and its forward operation count.

The mixer is ``ab-attention``'s own function (DSNet's multi-head
self-attention), loaded under the harness's module name for that
configuration, so both configurations are judged by one mixer.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.lib.cell import BENCH_DIR, load_module
from portbench.reference.anchor_free import AnchorFree

_AB = load_module(BENCH_DIR / "configs" / "ab-attention.py",
                  "portbench_config_ab-attention")

mixer = _AB.mixer


def weight_spec(cfg: Dict) -> List[Tuple]:
    h = cfg["num_hidden"]
    return _AB.weight_spec(cfg) + [
        ("heads.fc_ctr.weight", (1, h), ("xavier2", h, 1)),
        ("heads.fc_ctr.bias", (1,), ("const", 0.1))]


def forward_flops(cfg: Dict, n: int) -> float:
    """Multiply-add operations x 2 of one forward at n positions (the
    softmax, norms and decode not counted): the mixer, the trunk and the
    heads' 4 outputs a position (cls, l, r, ctr)."""
    f, hid = cfg["num_feature"], cfg["num_hidden"]
    mix = 2 * n * f * f * 4 + 2 * 2 * n * n * f
    trunk = 2 * n * (f * hid + cfg["fc_depth"] * hid * hid + hid * 4)
    return float(mix + trunk)


HEAD = AnchorFree(mixer)
