"""EDSNet's local-global anchor-based head (``DSNet_MultiAttention``,
``--model-depth local-global-attention``) in plain PyTorch, one video at
a time at its true length n: the published description, written from it
(Prasad et al., EDSNet, arXiv 2409.14724; the authors' code release,
``src/modules/encoder.py``: ``MultiAttention``, ``LocalGlobalEncoder``,
and ``src/anchor_based/dsnet.py``: ``DSNet_MultiAttention``).

    g = relu(fc(GlobalAttention(x)))                8 heads of F / 8
    the video cut into 4 contiguous segments of ceil(n / 4) positions,
    the last one shorter (or empty)
    on segment s:  out_s = l2n(g_s) + l2n(relu(fc(LocalAttention_s(x_s))))
                                                    2 heads of F / 2 each
    enc = relu(fc2(LayerNorm(out)));  h = x + enc   (no LayerNorm after)
    h = fc1(h);  7 x [h = LayerNorm(ReLU(fc_block(h)))]  (one fc_block,
        shared: the reference's tied trunk; no dropout in evaluation)
    ROI pooling at each anchor scale, cls = sigmoid(fc_cls), loc = fc_loc,
    and the anchor decode, as ``reference/model.py`` has them.

An attention is DSNet's: bias-free Q, K, V and output projections (``fc``),
softmax of q k^T / sqrt(d).  One ``fc`` (with a bias) serves the global
path and every local one; ``l2n`` is x over max(|x|, 1e-12); the
LayerNorm's eps is 1e-5.  Each segment is sliced from the n rows of the
video itself: no buffer, no padding, no mask.

Departures from the code release: none in evaluation, where its dropout is
off.  The weights' names are the port's (the release's module names under
``multiattentionblock``), so the benchmark hands both one set.

Only evaluation is written: training waits for a train cell of this head
(``TRAIN_CELL``).  The reference is computed in float64; its control in
float32 with TF32 on.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from portbench.reference.model import (decode, layer_norm, linear,
                                       roi_pool)

Weights = Dict[str, torch.Tensor]

TRAIN_CELL = "ab-local-global.train-tvsum"
BLOCK = "multiattentionblock"
MULTI = BLOCK + ".multi_attention"
SEGMENTS = 4
LOCAL_HEADS = 2


def attention(W: Weights, prefix: str, x: torch.Tensor, heads: int
              ) -> torch.Tensor:
    """DSNet's multi-head self-attention of ``heads`` heads with the
    weights under ``prefix``: x [m, F] -> [m, F]."""
    m, f = x.shape
    d = f // heads
    q, k, v = ((x @ W[f"{prefix}.{p}.weight"].T).reshape(m, heads, d)
               .transpose(0, 1) for p in ("Q", "K", "V"))
    attn = torch.softmax(q @ k.transpose(-1, -2) / d ** 0.5, -1)
    y = (attn @ v).transpose(0, 1).reshape(m, f)
    return y @ W[f"{prefix}.fc.weight"].T


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.sqrt((x * x).sum(-1, keepdim=True)),
                           min=1e-12)


def encoder(cfg: Dict, W: Weights, x: torch.Tensor) -> torch.Tensor:
    """The local-global encoder: x [n, F] -> enc [n, F]."""
    n = x.shape[0]
    g = torch.relu(linear(attention(W, MULTI + ".global_attention", x,
                                    cfg["num_head"]), W, MULTI + ".fc"))
    size = -(-n // SEGMENTS)
    parts = []
    for s in range(SEGMENTS):
        lo, hi = s * size, min((s + 1) * size, n)
        if lo >= hi:
            continue
        local = attention(W, f"{MULTI}.local_attention_{s}", x[lo:hi],
                          LOCAL_HEADS)
        local = torch.relu(linear(local, W, MULTI + ".fc"))
        parts.append(l2n(g[lo:hi]) + l2n(local))
    out = torch.cat(parts)
    out = layer_norm(out, W[BLOCK + ".layer_norm.weight"],
                     W[BLOCK + ".layer_norm.bias"])
    return torch.relu(linear(out, W, BLOCK + ".fc"))


class AnchorBasedLocalGlobal:
    """The anchor-based local-global head, with the methods the harness
    reads of a head (``reference/model.py:AnchorBased``): the reference's
    predict, one box a position and anchor scale, and the program's names
    that the benchmark wraps (``targets``)."""

    targets = {"predict": "edsnet_torch.models.dsnet:_AnchorBased.predict",
               "train_step": "edsnet_torch.trainer:ab_train_step"}

    def boxes_per_position(self, cfg: Dict) -> int:
        return len(cfg["anchor_scales"])

    def predict(self, cfg: Dict, W: Weights, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [n, F] -> (scores [n S], boxes [n S, 2])."""
        h = x + encoder(cfg, W, x)
        h = linear(h, W, "trunk.fc1")
        for _ in range(cfg["fc_depth"]):
            h = torch.relu(linear(h, W, "trunk.fc_block.Dense_0"))
            h = layer_norm(h, W["trunk.fc_block.LayerNorm_0.weight"],
                           W["trunk.fc_block.LayerNorm_0.bias"])
        scales = cfg["anchor_scales"]
        pooled = torch.stack([roi_pool(h, s) for s in scales], 1)
        cls = torch.sigmoid(linear(pooled, W, "heads.fc_cls")[..., 0])
        loc = linear(pooled, W, "heads.fc_loc")
        return decode(cls, loc, scales)

    def labels(self, cfg: Dict, video, program: Dict):
        raise NotImplementedError(
            f"the local-global reference has no training labels: they come "
            f"with the train cell {TRAIN_CELL}")

    def step_loss(self, cfg: Dict, W: Weights, video, lab: Dict,
                  program: Dict, drop_gen: torch.Generator,
                  label_gen: torch.Generator) -> torch.Tensor:
        raise NotImplementedError(
            f"the local-global reference has no train step: it comes with "
            f"the train cell {TRAIN_CELL}")
