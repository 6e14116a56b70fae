"""The anchor-based training labels and the epoch plan, worked out again
from the raw videos, in plain numpy and torch.

Frozen copies of the published DSNet label rules (and of the order in
which a training run visits its videos), kept here so that the reference
depends on nothing of the program:
- the keyshot target: per-shot means of the position scores upsampled to
  frames, ``int(1000 * mean)``, the 0/1 knapsack at 15 % of the frames
  (a dense DP, reverse backtrack), the target at the picks;
- the anchors (position, scale) and the positive labels by IoU with the
  target's segments (hull-span denominator), the offsets to the last
  matching segment, and the negative and incomplete candidates;
- each step's random negatives and incompletes: the ``num`` eligible
  entries with the smallest uniform draws, ties by index;
- the epoch plan: the trainable videos grouped by length bucket in
  ascending order, each group permuted by a ``RandomState`` of the fold's
  seed, and the batches shuffled by it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def knapsack_dp(values: Sequence[int], weights: Sequence[int],
                capacity: int) -> List[int]:
    """Exact 0/1 knapsack, dense DP, reverse backtrack; items of value 0
    or weight above the capacity are never taken; a tie keeps the item
    out -> the packed indices, ascending."""
    values = np.asarray(values, np.int64)
    weights = np.asarray(weights, np.int64)
    n, cap = len(values), int(capacity)
    if n == 0 or cap <= 0:
        return []
    dp = np.zeros(cap + 1, np.int64)
    take = np.zeros((n, cap + 1), bool)
    for i in range(n):
        w, v = int(weights[i]), int(values[i])
        if w <= cap and v > 0:
            cand = dp[:cap + 1 - w] + v
            better = cand > dp[w:]
            take[i, w:] = better
            dp[w:] = np.where(better, cand, dp[w:])
    packed, c = [], cap
    for i in range(n - 1, -1, -1):
        if take[i, c]:
            packed.append(i)
            c -= int(weights[i])
    return packed[::-1]


def keyshot_target(video) -> Optional[np.ndarray]:
    """The 0/1 keyshot target at each position, or None when empty."""
    n_frames = int(video.n_frames)
    frame_scores = np.zeros(n_frames, np.float32)
    picks = np.asarray(video.picks, np.int64)
    for i in range(len(picks)):
        hi = picks[i + 1] if i + 1 < len(picks) else n_frames
        frame_scores[picks[i]:hi] = video.gtscore[i]
    seg = np.zeros(len(video.cps), np.int32)
    for s, (first, last) in enumerate(video.cps):
        seg[s] = int(np.float32(1000) * frame_scores[first:last + 1].mean())
    summary = np.zeros(n_frames, bool)
    for s in knapsack_dp(seg, video.nfps, int(n_frames * 0.15)):
        summary[video.cps[s, 0]:video.cps[s, 1] + 1] = True
    target = summary[np.clip(picks, 0, n_frames - 1)]
    return target.astype(np.int32) if target.any() else None


def _runs(mask: np.ndarray) -> np.ndarray:
    """[K, 2] (start, end) of the runs of ones."""
    m = mask.astype(np.int32)
    starts = np.where(np.diff(np.concatenate([[0], m])) == 1)[0]
    ends = np.where(np.diff(np.concatenate([m, [0]])) == -1)[0] + 1
    return np.stack([starts, ends], -1).astype(np.int32)


def _iou_cw(a: np.ndarray, t: np.ndarray) -> np.ndarray:
    a_l, a_r = a[..., 0] - a[..., 1] * 0.5, a[..., 0] + a[..., 1] * 0.5
    t_l, t_r = t[..., 0] - t[..., 1] * 0.5, t[..., 0] + t[..., 1] * 0.5
    inter = np.maximum(np.minimum(a_r, t_r) - np.maximum(a_l, t_l), 0.0)
    union = np.maximum(a_r, t_r) - np.minimum(a_l, t_l)
    return inter / np.where(union <= 0.0, 1e-6, union)


def _positives(anchors: np.ndarray, targets: np.ndarray, thresh: float):
    """(label [A] 0/1, offsets [A, 2]) of CW anchors against CW targets."""
    iou = _iou_cw(anchors[None], targets[:, None])            # [T, A]
    pos = iou > thresh
    label = pos.any(0).astype(np.int32)
    last = np.max(np.where(pos, np.arange(len(targets))[:, None], -1), 0)
    chosen = targets[np.clip(last, 0, max(len(targets) - 1, 0))]
    oc = (chosen[:, 0] - anchors[:, 0]) / anchors[:, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        ow = np.log(chosen[:, 1] / anchors[:, 1])
    off = np.where((last >= 0)[:, None], np.stack([oc, ow], -1), 0.0)
    return label, off.astype(np.float32)


def bucket_len(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def ab_labels(video, scales: Sequence[int], bucket: int,
              pos_iou: float = 0.6, neg_iou: float = 0.0,
              inc_iou: float = 0.3) -> Optional[Dict[str, np.ndarray]]:
    """A video's fixed labels at its length: cls_pos, loc_label,
    neg_eligible, inc_eligible [n, S(, 2)] and num_pos; None to skip it."""
    target = keyshot_target(video)
    if target is None:
        return None
    n = len(target)
    n_pad = bucket_len(n, bucket)
    segs = _runs(target).astype(np.float32)
    tcw = np.stack([(segs[:, 0] + segs[:, 1]) * 0.5, segs[:, 1] - segs[:, 0]],
                   -1)
    s = len(scales)
    anchors = np.stack(np.broadcast_arrays(
        np.arange(n_pad)[:, None], np.asarray(scales)[None]), -1)
    anchors = anchors.reshape(-1, 2).astype(np.float32)
    cls_pos, loc = _positives(anchors, tcw, pos_iou)
    at_neg, _ = _positives(anchors, tcw, neg_iou)
    at_inc, _ = _positives(anchors, tcw, inc_iou)
    cls_pos = cls_pos.reshape(n_pad, s)[:n]
    neg = at_neg.reshape(n_pad, s)[:n] == 0
    inc = (at_inc.reshape(n_pad, s)[:n] == 0) & ~neg
    return {"cls_pos": cls_pos, "loc_label": loc.reshape(n_pad, s, 2)[:n],
            "neg_eligible": neg, "inc_eligible": inc,
            "num_pos": int(cls_pos.sum())}


def epoch_plan(train_videos: Sequence, labels: Sequence, bucket: int,
               seed: int) -> List[int]:
    """The first epoch's order of the trainable videos (batch size 1), as
    indices into ``train_videos``."""
    groups: Dict[int, List[int]] = {}
    for i, (video, lab) in enumerate(zip(train_videos, labels)):
        if lab is not None:
            groups.setdefault(bucket_len(len(video.seq), bucket),
                              []).append(i)
    rng = np.random.RandomState(seed)
    plan = []
    for blen in sorted(groups):
        members = groups[blen]
        plan += [members[j] for j in rng.permutation(len(members))]
    order = list(range(len(plan)))
    rng.shuffle(order)
    return [plan[j] for j in order]


def sample_marks(eligible: torch.Tensor, num: int, u: torch.Tensor
                 ) -> torch.Tensor:
    """The ``num`` eligible entries with the smallest draws ``u`` (ties by
    flat index): [N, S] bool."""
    flat = eligible.reshape(-1)
    draws = torch.where(flat, u.reshape(-1), torch.inf)
    order = torch.argsort(draws, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    return (flat & (rank < num)).reshape(eligible.shape)
