"""The anchor-based shallow DSNet head in plain PyTorch, one video at a
time at its true length: the published description, written from it.

    h = mixer(x) + x;  h = LayerNorm(h)
    h = fc1(h);  7 x [h = LayerNorm(Dropout(ReLU(fc_block(h))))]  (one
        fc_block, shared: the reference's tied trunk)
    for each anchor scale s: p_s = AvgPool1d(s, stride 1, padding s // 2,
        count_include_pad)(h)[:n]
    cls = sigmoid(fc_cls(p_s)),  loc = fc_loc(p_s)
    box = (c + loc_0 * s - w / 2, c + loc_0 * s + w / 2), w = s exp(loc_1)

Training adds the published losses (0.5 x the mean -log p over the
positive anchors plus the mean -log(1 - p) over the sampled negatives and
incompletes, eps 1e-8; smooth-L1 over the positives' offsets) and Adam
with its L2 term added to the gradient.  A mixer is a function of its
configuration's file (``portbench/configs/<config>.py``), which hands the
harness this head around it (``AnchorBased``, its ``HEAD``).

Dropout draws: a ``Draws`` hands each dropout site a keep mask drawn
from a generator at the padded batch's shape, in the order the sites run,
and cut to the video's positions, so that the reference sees the masks
the training run's generator gives when it replays that generator.  The
reference is computed in float64; its control in float32 with TF32 on.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import labels as ref_labels

Weights = Dict[str, torch.Tensor]


class Draws:
    """Keep masks from ``generator``, drawn at the padded shape of each
    site in the order asked, cut to the leading ``n`` positions of every
    position axis; None: no dropout (evaluation)."""

    def __init__(self, generator: Optional[torch.Generator], bucket: int,
                 p: float = 0.5):
        self.generator = generator
        self.bucket = bucket
        self.p = p

    def __call__(self, x: torch.Tensor, position_axes: Sequence[int],
                 padded_shape: Sequence[int]) -> torch.Tensor:
        if self.generator is None:
            return x
        u = torch.rand(tuple(padded_shape), generator=self.generator,
                       device=x.device)
        for ax in position_axes:
            u = u.narrow(ax, 0, x.shape[ax])
        keep = (u >= self.p).to(x.dtype)
        return x * keep / (1.0 - self.p)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * w + b


def linear(x: torch.Tensor, W: Weights, name: str) -> torch.Tensor:
    y = x @ W[name + ".weight"].T
    bias = W.get(name + ".bias")
    return y if bias is None else y + bias


def trunk_spec(num_feature: int, num_hidden: int) -> List[Tuple]:
    """(name, shape, init) of the LayerNorm, trunk and heads; init is
    ("xavier2", fan_in, fan_out), ("const", value)."""
    f, h = num_feature, num_hidden

    def lin(name, fin, fout):
        return [(name + ".weight", (fout, fin), ("xavier2", fin, fout)),
                (name + ".bias", (fout,), ("const", 0.1))]

    def ln(name, dim):
        return [(name + ".weight", (dim,), ("const", 1.0)),
                (name + ".bias", (dim,), ("const", 0.0))]

    return (ln("layer_norm", f) + lin("trunk.fc1", f, h)
            + lin("trunk.fc_block.Dense_0", h, h)
            + ln("trunk.fc_block.LayerNorm_0", h)
            + lin("heads.fc_cls", h, 1) + lin("heads.fc_loc", h, 2))


def roi_pool(h: torch.Tensor, scale: int) -> torch.Tensor:
    """[n, H] -> [n, H]: AvgPool1d(scale, 1, scale // 2), zeros outside,
    divisor ``scale``, the first n outputs."""
    n = h.shape[0]
    out = F.avg_pool1d(h.T[None], scale, stride=1, padding=scale // 2,
                       count_include_pad=True)[0].T
    return out[:n]


def forward(W: Weights, x: torch.Tensor, mixer: Callable,
            scales: Sequence[int], fc_depth: int, drop: Draws
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, F] -> (cls [n, S], loc [n, S, 2])."""
    n = x.shape[0]
    nb = drop.bucket
    h = mixer(W, x, drop) + x
    h = layer_norm(h, W["layer_norm.weight"], W["layer_norm.bias"])
    h = linear(h, W, "trunk.fc1")
    for _ in range(fc_depth):
        h = torch.relu(linear(h, W, "trunk.fc_block.Dense_0"))
        h = drop(h, (0,), (nb, h.shape[1]))
        h = layer_norm(h, W["trunk.fc_block.LayerNorm_0.weight"],
                       W["trunk.fc_block.LayerNorm_0.bias"])
    pooled = torch.stack([roi_pool(h, s) for s in scales], 1)  # [n, S, H]
    cls = torch.sigmoid(linear(pooled, W, "heads.fc_cls")[..., 0])
    loc = linear(pooled, W, "heads.fc_loc")
    assert cls.shape == (n, len(scales))
    return cls, loc


def decode(cls: torch.Tensor, loc: torch.Tensor, scales: Sequence[int]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [n S], LR boxes [n S, 2]), position-major."""
    n, s = cls.shape
    sc = torch.as_tensor(list(scales), dtype=loc.dtype, device=loc.device)
    center = torch.arange(n, dtype=loc.dtype, device=loc.device)[:, None]
    bc = loc[..., 0] * sc + center
    bw = torch.exp(loc[..., 1]) * sc
    boxes = torch.stack([bc - bw / 2, bc + bw / 2], -1)
    return cls.reshape(-1), boxes.reshape(-1, 2)


def losses(cls: torch.Tensor, loc: torch.Tensor, label: torch.Tensor,
           loc_label: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cls loss, loc loss) of one video; label [n, S] in {-1, 0, 1}."""
    eps = 1e-8
    pos, neg = label == 1, label == -1

    def mean(v, m):
        return (v * m).sum() / max(float(m.sum()), 1.0)

    lp = mean(-torch.log(torch.clamp(cls, min=eps)), pos)
    ln_ = mean(-torch.log(torch.clamp(1 - cls, min=eps)), neg)
    d = torch.abs(loc - loc_label)
    sl1 = torch.where(d < 1, 0.5 * d * d, d - 0.5)
    return 0.5 * (lp + ln_), mean(sl1, pos[..., None].expand_as(sl1))


class Adam:
    """Adam (beta 0.9, 0.999, eps 1e-8) with ``weight_decay`` x p added to
    the gradient before the moments."""

    def __init__(self, lr: float, weight_decay: float):
        self.lr, self.wd = lr, weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Weights, grads: Weights) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + self.wd * p
                self.m[k] = b1 * self.m.get(k, torch.zeros_like(p)) \
                    + (1 - b1) * g
                self.v[k] = b2 * self.v.get(k, torch.zeros_like(p)) \
                    + (1 - b2) * g * g
                denom = torch.sqrt(self.v[k]) / math.sqrt(1 - b2 ** self.t) \
                    + 1e-8
                p -= self.lr / (1 - b1 ** self.t) * self.m[k] / denom


class AnchorBased:
    """The anchor-based shallow head around a configuration's mixer, as a
    configuration file hands it to the harness (its ``HEAD``): the
    reference's predict, its training labels and one train step's loss
    with its draws, and the program's names (``targets``) that the
    benchmark wraps to keep predict's outputs and the train step's.  A
    head of another kind is another class with the same methods, in a
    file of its own."""

    targets = {"predict": "edsnet_torch.models.dsnet:_AnchorBased.predict",
               "train_step": "edsnet_torch.trainer:ab_train_step"}

    def __init__(self, mixer: Callable):
        self.mixer = mixer          # mixer(cfg, W, x, drop) -> [n, F]

    def boxes_per_position(self, cfg: Dict) -> int:
        return len(cfg["anchor_scales"])

    def _forward(self, cfg: Dict, W: Weights, x: torch.Tensor, drop: Draws
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(W, x, functools.partial(self.mixer, cfg),
                       cfg["anchor_scales"], cfg["fc_depth"], drop)

    def predict(self, cfg: Dict, W: Weights, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [n, F] -> (scores [n S], boxes [n S, 2]), no dropout."""
        cls, loc = self._forward(cfg, W, x, Draws(None, x.shape[0]))
        return decode(cls, loc, cfg["anchor_scales"])

    def labels(self, cfg: Dict, video, program: Dict) -> Optional[Dict]:
        """The video's fixed labels; None: the trainer skips it."""
        return ref_labels.ab_labels(
            video, cfg["anchor_scales"], int(program["bucket_size"]),
            float(program["pos_iou_thresh"]),
            float(program["neg_iou_thresh"]),
            float(program["incomplete_iou_thresh"]))

    def step_loss(self, cfg: Dict, W: Weights, video, lab: Dict,
                  program: Dict, drop_gen: torch.Generator,
                  label_gen: torch.Generator) -> torch.Tensor:
        """One batch-1 step's loss: the random negatives and incompletes
        from ``label_gen``, then the forward with its dropout masks from
        ``drop_gen``, each drawn at the padded shapes as the program
        draws them."""
        some = next(iter(W.values()))
        device, dtype = some.device, some.dtype
        scales = cfg["anchor_scales"]
        n = len(video.seq)
        nb = ref_labels.bucket_len(n, int(program["bucket_size"]))

        def padded(a):
            return torch.from_numpy(np.pad(
                a, [(0, nb - n)] + [(0, 0)] * (a.ndim - 1))).to(device)

        shape = (1, nb, len(scales))
        u_neg = torch.rand(shape, generator=label_gen, device=device)
        u_inc = torch.rand(shape, generator=label_gen, device=device)
        num = lab["num_pos"]
        neg = ref_labels.sample_marks(
            padded(lab["neg_eligible"]),
            int(program["neg_sample_ratio"] * num), u_neg)
        inc = ref_labels.sample_marks(
            padded(lab["inc_eligible"]),
            int(program["incomplete_sample_ratio"] * num), u_inc)
        label = torch.where(neg | inc, -1, padded(lab["cls_pos"]))[:n]
        x = torch.from_numpy(video.seq).to(device, dtype)
        cls, loc = self._forward(cfg, W, x, Draws(drop_gen, nb))
        lc, ll = losses(cls, loc, label,
                        torch.from_numpy(lab["loc_label"]).to(device, dtype))
        return (lc + float(program["lambda_reg"]) * ll) * float(num > 0)
