"""The anchor-free shallow DSNet head (DSNet-AF) in plain PyTorch, one
video at a time at its true length: the published description, written
from it (Zhu et al., DSNet, IEEE TIP 30, 2021, the anchor-free variant).

    h = mixer(x) + x;  h = LayerNorm(h)
    h = fc1(h);  7 x [h = LayerNorm(ReLU(fc_block(h)))]  (one fc_block,
        shared: the reference's tied trunk; no dropout in evaluation)
    cls = sigmoid(fc_cls(h)),  (l, r) = exp(fc_loc(h)),
    ctr = sigmoid(fc_ctr(h))
    score_i = cls_i ctr_i / (max_j cls_j ctr_j + 1e-8)
    box_i = (i - l_i, i + r_i + 1)

Departures from the paper, each as the program has it: the fc layers
after the LayerNorm are EDSNet's tied trunk (one block applied
``fc_depth`` times) where the paper has one fc layer; the box score
cls x ctr is divided by its maximum over the video's positions, so the
best box scores 1; the extents (l, r) are ``exp`` of a linear output,
which the paper's regression of distances leaves unstated.

Only evaluation is written: training (FCOS labels, the focal, IoU and
centerness losses) waits for a train cell of this head.  A mixer is a
function of its configuration's file (``portbench/configs/<config>.py``),
which hands the harness this head around it (``AnchorFree``, its
``HEAD``).  The reference is computed in float64; its control in float32
with TF32 on.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from portbench.reference.model import Draws, layer_norm, linear

Weights = Dict[str, torch.Tensor]

TRAIN_CELL = "af-attention.train-tvsum"


class AnchorFree:
    """The anchor-free shallow head around a configuration's mixer, with
    the methods the harness reads of a head (``reference/model.py:
    AnchorBased``): the reference's predict, one box a position, and the
    program's names that the benchmark wraps (``targets``)."""

    targets = {"predict": "edsnet_torch.models.dsnet_af:_AnchorFree.predict",
               "train_step": "edsnet_torch.trainer:af_train_step"}

    def __init__(self, mixer: Callable):
        self.mixer = mixer          # mixer(cfg, W, x, drop) -> [n, F]

    def boxes_per_position(self, cfg: Dict) -> int:
        return 1

    def predict(self, cfg: Dict, W: Weights, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [n, F] -> (scores [n], boxes [n, 2]), no dropout."""
        n = x.shape[0]
        h = self.mixer(cfg, W, x, Draws(None, n)) + x
        h = layer_norm(h, W["layer_norm.weight"], W["layer_norm.bias"])
        h = linear(h, W, "trunk.fc1")
        for _ in range(cfg["fc_depth"]):
            h = torch.relu(linear(h, W, "trunk.fc_block.Dense_0"))
            h = layer_norm(h, W["trunk.fc_block.LayerNorm_0.weight"],
                           W["trunk.fc_block.LayerNorm_0.bias"])
        cls = torch.sigmoid(linear(h, W, "heads.fc_cls")[:, 0])
        loc = torch.exp(linear(h, W, "heads.fc_loc"))
        ctr = torch.sigmoid(linear(h, W, "heads.fc_ctr")[:, 0])
        score = cls * ctr
        score = score / (score.max() + 1e-8)
        i = torch.arange(n, dtype=loc.dtype, device=loc.device)
        boxes = torch.stack([i - loc[:, 0], i + loc[:, 1] + 1], -1)
        return score, boxes

    def labels(self, cfg: Dict, video, program: Dict):
        raise NotImplementedError(
            f"the anchor-free reference has no training labels: they come "
            f"with the train cell {TRAIN_CELL}")

    def step_loss(self, cfg: Dict, W: Weights, video, lab: Dict,
                  program: Dict, drop_gen: torch.Generator,
                  label_gen: torch.Generator) -> torch.Tensor:
        raise NotImplementedError(
            f"the anchor-free reference has no train step: it comes with "
            f"the train cell {TRAIN_CELL}")
