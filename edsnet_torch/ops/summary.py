"""Keyshot summary assembly, F1 and diversity.

Counterpart of edsnet_tpu/ops/summary.py: ``f1_score_jax`` ->
``f1_score``, ``keyshot_summ_jax`` -> ``keyshot_summ`` (batched over videos),
``get_summ_diversity`` (host numpy) and ``SAMPLE_RATE``.  Shot scores keep
the reference's ``int(1000 * mean)`` truncation over masked per-segment
sums.
"""
from __future__ import annotations

import numpy as np
import torch

from edsnet_torch.ops.knapsack import knapsack

SAMPLE_RATE = 15


def f1_score(pred: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Binary F1 over the trailing axis; leading batch dims broadcast."""
    pred = pred.to(torch.bool)
    test = test.to(torch.bool)
    overlap = (pred & test).sum(dim=-1).to(torch.float32)
    p = overlap / torch.clamp(pred.sum(dim=-1), min=1)
    r = overlap / torch.clamp(test.sum(dim=-1), min=1)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-12)
    return torch.where(overlap > 0, f1, 0.0)


def keyshot_summ(pred: torch.Tensor, picks: torch.Tensor, cps: torch.Tensor,
                 nfps: torch.Tensor, seg_valid: torch.Tensor,
                 n_frames: torch.Tensor, max_frames: int,
                 proportion: float = 0.15,
                 uniform_sample_rate: int = 0) -> torch.Tensor:
    """Keyshot summaries at a fixed frame bucket, one per batch row.

    :param pred: [B, N] scores at pick positions.
    :param picks: [B, N] int frame positions; padding picks point past
        n_frames (n_frames + 1).
    :param cps: [B, S, 2] int shots (first, last), inclusive.
    :param nfps: [B, S] frames per shot.
    :param seg_valid: [B, S] bool shot mask.
    :param n_frames: [B] int frame counts (<= max_frames).
    :param uniform_sample_rate: when > 0 the caller guarantees
        picks == arange(N) * rate and n_frames <= N * rate, so frame
        scores are a repeat instead of a search.
    :return: [B, max_frames] bool summaries (frames >= n_frames False).
    """
    pred = pred.to(torch.float32)
    picks = picks.to(torch.int32).contiguous()
    cps = cps.to(torch.int32)
    nfps = nfps.to(torch.int32)
    seg_valid = seg_valid.to(torch.bool)
    n_frames = n_frames.to(torch.int32)
    b, n = pred.shape
    device = pred.device

    frames = torch.arange(max_frames, dtype=torch.int32, device=device)
    if uniform_sample_rate > 0:
        frame_scores = torch.repeat_interleave(pred, uniform_sample_rate,
                                               dim=1)[:, :max_frames]
        short = max_frames - frame_scores.shape[1]
        if short > 0:  # the fill value is masked below
            frame_scores = torch.cat(
                [frame_scores, pred[:, -1:].expand(b, short)], dim=1)
    else:
        # frame f takes the score of the last pick <= f; frames before the
        # first pick score 0
        pick_idx = torch.searchsorted(
            picks, frames[None, :].expand(b, max_frames).contiguous(),
            right=True) - 1
        gathered = torch.gather(pred, 1, torch.clamp(pick_idx, 0, n - 1))
        frame_scores = torch.where(pick_idx >= 0, gathered, 0.0)
    in_video = frames[None, :] < n_frames[:, None]
    frame_scores = torch.where(in_video, frame_scores, 0.0)

    first, last = cps[..., 0], cps[..., 1]
    inside = ((frames[None, None, :] >= first[..., None])
              & (frames[None, None, :] <= last[..., None]))    # [B, S, F]
    # masked per-segment sums, not one prefix sum over max_frames: a prefix
    # of ~1e4 carries f32 cancellation error large enough to flip the
    # int(1000 * mean) truncation on long videos
    seg_sum = torch.einsum("bsf,bf->bs", inside.to(torch.float32),
                           frame_scores)
    seg_len = torch.clamp(last + 1 - first, min=1).to(torch.float32)
    seg_scores = (1000.0 * seg_sum / seg_len).to(torch.int32)
    seg_scores = torch.where(seg_valid, torch.clamp(seg_scores, min=0), 0)

    limits = (n_frames.to(torch.float32) * proportion).to(torch.int32)
    weights = torch.where(seg_valid, nfps, 0)
    packed = knapsack(seg_scores, weights, limits,
                      max_capacity=int(max_frames * proportion) + 1)

    chosen = (packed & seg_valid)[..., None]
    return torch.any(inside & chosen, dim=1) & in_video


def get_summ_diversity(pred_summ: np.ndarray, features: np.ndarray) -> float:
    """Pairwise-similarity diversity of the selected frames (host)."""
    assert len(pred_summ) == len(features)
    pred_summ = np.asarray(pred_summ, dtype=bool)
    pos_features = features[pred_summ]
    k = len(pos_features)
    if k < 2:
        return 0.0
    gram = pos_features @ pos_features.T
    diversity = gram.sum() - np.trace(gram)
    return float(diversity / (k * (k - 1)))
