"""The evaluation chain after predict, in plain numpy, to judge what the
program's evaluator produced for one video stage by stage.

Each stage is worked out again from the program's output of the stage
before it, which the program's predict is itself judged against the
float64 reference forward; so a stage is judged on its own inputs, and a
rounding of the float32 predict can never make a later stage read wrong:
- the boxes clipped to [0, n] and rounded, and the greedy NMS (scores in
  descending order, ties by the larger index first, suppress at IoU >=
  the threshold, IoU of 1-D boxes over their hull span): the keep set;
- the max-score rasterisation of the kept boxes over the positions, the
  frames' scores (each pick's score up to the next pick), each shot's
  ``1000 x mean``: the knapsack's values, which may fall on either side
  of an integer within ``VALUE_ROUNDING`` (float32 sums), its weights
  (the shots' frames) and its capacity (15 % of the frames);
- the knapsack (``labels.knapsack_dp``) on those values: the shots picked;
- the summary: the frames of the picked shots;
- the F-score of that summary against each user's, in float64, averaged
  over users (TVSum) or their best (SumMe).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.labels import knapsack_dp

# shot values are int(1000 x mean) of float32 sums of up to a few hundred
# frames; within this many units of an integer either side is right
VALUE_ROUNDING = 1e-2


def nms(scores: np.ndarray, boxes: np.ndarray, alive: np.ndarray,
        thresh: float) -> np.ndarray:
    """Greedy NMS -> keep [T] bool."""
    order = np.argsort(scores, kind="stable")[::-1]
    b = boxes[order].astype(np.float64)
    removed = ~alive[order]
    keep = np.zeros(len(scores), bool)
    left, right = b[:, 0], b[:, 1]
    for i in range(len(order)):
        if removed[i]:
            continue
        keep[order[i]] = True
        inter = np.clip(np.minimum(right[i], right)
                        - np.maximum(left[i], left), 0, None)
        union = np.maximum(right[i], right) - np.minimum(left[i], left)
        sup = inter / np.where(union <= 0, 1e-6, union) >= thresh
        sup[i] = False
        removed |= sup
    return keep


def f_score(summary: np.ndarray, users: np.ndarray, metric: str) -> float:
    """F of a frame summary against [U, n_frames] user summaries."""
    f1s = []
    for user in users.astype(bool):
        overlap = float((summary & user).sum())
        if overlap == 0:
            f1s.append(0.0)
            continue
        p, r = overlap / summary.sum(), overlap / user.sum()
        f1s.append(2 * p * r / (p + r))
    return float(np.mean(f1s) if metric == "avg" else np.max(f1s))


def f_score_in(summary: np.ndarray, users: np.ndarray, metric: str,
               dtype: torch.dtype) -> float:
    """``f_score`` with every count and ratio held in ``dtype`` (torch):
    the control of a float32 F."""
    s = torch.from_numpy(summary.astype(bool))
    u = torch.from_numpy(users.astype(bool))
    overlap = (s[None] & u).to(dtype).sum(-1)
    p = overlap / s.to(dtype).sum()
    r = overlap / u.to(dtype).sum(-1)
    f1 = torch.where(overlap > 0, 2 * p * r / (p + r),
                     torch.zeros((), dtype=dtype))
    return float(f1.mean() if metric == "avg" else f1.max())


def judge_video(video, n_scales: int, nms_thresh: float, metric: str,
                got: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Counts of the program's stage outputs that differ from what the
    stage gives on its inputs, and the F gap.

    ``got`` holds one video's row: ``scores`` [T] and ``boxes`` [T, 2]
    (predict, T = bucket x scales), ``boxes_c`` [T, 2] and ``keep`` [T]
    (NMS), ``values``, ``weights`` [S_pad] and ``capacity`` (the knapsack's
    inputs), ``picked`` [S_pad] (its output), ``summary`` [frames] and
    ``fscore``."""
    n = len(video.seq)
    n_frames = int(video.n_frames)
    scores = got["scores"].astype(np.float32)
    boxes = got["boxes"].astype(np.float32)
    t = len(scores)
    clipped = np.round(np.minimum(np.maximum(boxes, np.float32(0)),
                                  np.float32(n)))
    valid = np.arange(t) // n_scales < n
    keep = nms(scores, clipped, (clipped[:, 0] < clipped[:, 1]) & valid,
               nms_thresh)
    keep_diff = int((clipped != got["boxes_c"]).any(-1).sum()
                    + (keep != got["keep"]).sum())

    # stage 3 on the program's keep set
    left = clipped[:, 0].astype(np.int64)
    right = clipped[:, 1].astype(np.int64)
    pos_score = np.zeros(n, np.float32)
    for j in np.flatnonzero(got["keep"]):
        lo, hi = left[j], min(right[j], n)
        pos_score[lo:hi] = np.maximum(pos_score[lo:hi], scores[j])
    frame = np.zeros(n_frames, np.float64)
    picks = np.asarray(video.picks, np.int64)
    for i in range(n):
        hi = picks[i + 1] if i + 1 < n else n_frames
        frame[picks[i]:hi] = pos_score[i]
    n_shots = len(video.nfps)
    means = np.array([1000.0 * frame[a:b + 1].mean() for a, b in video.cps])
    vals = got["values"].astype(np.int64)
    lo_ok = np.floor(means - VALUE_ROUNDING)
    hi_ok = np.floor(means + VALUE_ROUNDING)
    value_bad = (vals[:n_shots] < lo_ok) | (vals[:n_shots] > hi_ok)
    capacity = int(np.float32(n_frames) * np.float32(0.15))
    shot_diff = int(value_bad.sum()
                    + (got["weights"][:n_shots] != video.nfps).sum()
                    + (vals[n_shots:] != 0).sum()
                    + (got["weights"][n_shots:] != 0).sum()
                    + (int(got["capacity"]) != capacity))

    picked = np.zeros(len(vals), bool)
    picked[knapsack_dp(vals[:n_shots], video.nfps, capacity)] = True
    pick_diff = int((picked != got["picked"].astype(bool)).sum())

    summary = np.zeros(len(got["summary"]), bool)
    for s in np.flatnonzero(got["picked"][:n_shots]):
        summary[video.cps[s, 0]:video.cps[s, 1] + 1] = True
    summary[n_frames:] = False
    summary_diff = int((summary != got["summary"].astype(bool)).sum())

    f_ref = f_score(got["summary"][:n_frames].astype(bool),
                    video.user_summary, metric)
    return {"keep_diff": keep_diff, "shot_diff": shot_diff,
            "pick_diff": pick_diff, "summary_diff": summary_diff,
            "f_gap": abs(float(got["fscore"]) - f_ref), "f_ref": f_ref}
