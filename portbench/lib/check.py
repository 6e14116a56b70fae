"""The comparison that decides ``correct``: the program's outputs, as
``capture`` kept them, against the plain reference (``portbench/
reference`` and the configuration's head, ``configs/<config>.py``'s
``HEAD``), and each number against its limit (``limits/<cell>.json``).

The reference runs in float64 on the run's device after the window has
closed and the peak memory has been read, one video at a time.  Its
control, the same reference in float32 with TF32 on (the nearest
precision below the configuration's float32), and the F-scores in
bfloat16 for ``f_gap`` (``f_control``), are computed by
``portbench/calibrate.py`` and never by a run.

Numbers (each ``max`` over what a run judged):
- ``cls_gap``: |score - reference| of every box; ``box_gap``: |box end -
  reference| over max(1, |reference|);
- ``keep_diff``, ``shot_diff``, ``pick_diff``, ``summary_diff``: entries
  that differ from what the evaluation chain's stage gives on the
  program's own inputs to it (``reference/evalchain.py``); exact, limit 0;
- ``f_gap``: |F - the F of the program's summary in float64|, over every
  answer of the window, each held to its pass's judged summary;
- training: ``loss_gap`` (the first step's loss, relative; the first
  step with a loss, where a video without positives weighs 0),
  ``grad_gap`` (the first gradient as Adam received it, L2 term added,
  from its first moment after step 1) and ``change_gap`` (the
  parameters' change over steps 1-3): per leaf |norm - reference norm| over max(reference norm,
  the median leaf's), the median leaf, and with ``_leaf`` the worst
  leaf; leaves whose reference gradient is under a thousandth of the
  median leaf's are left out (their Adam step is rounding's sign).  The
  first step's loss and the median leaf, not the worst leaf or the later
  steps' losses: a trunk ReLU whose input lies within float32's rounding
  of 0 takes the other side in one run in a few, which moves the worst
  leaf's first gradient by up to 1e-3 and, through Adam's normalised
  steps, the later losses; the worst leaf stays compared at a limit that
  a leaf not moved or moved twice (reading 1) still fails.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import evalchain, labels as ref_labels
from portbench.reference import model as ref_model

MOMENT_DECAY = 0.9     # Adam's beta1: exp_avg after step 1 = 0.1 x grad


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS's and cuDNN's TF32 switches set for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def ref_predict(cell, weights: Dict[str, torch.Tensor], seq: np.ndarray,
                device: torch.device, dtype=torch.float64
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's (scores [n S], boxes [n S, 2]) of one video, by
    the configuration's head."""
    W = {k: v.detach().to(device, dtype) for k, v in weights.items()}
    x = torch.from_numpy(np.asarray(seq)).to(device, dtype)
    with torch.no_grad():
        scores, boxes = cell.model.HEAD.predict(cell.config, W, x)
    return (scores.cpu().numpy().astype(np.float64),
            boxes.cpu().numpy().astype(np.float64))


def predict_gaps(scores: np.ndarray, boxes: np.ndarray, want_scores,
                 want_boxes) -> Dict[str, float]:
    t = len(want_scores)
    return {"cls_gap": float(np.abs(scores[:t] - want_scores).max()),
            "box_gap": float((np.abs(boxes[:t] - want_boxes)
                              / np.maximum(1.0, np.abs(want_boxes))).max())}


def _row(rec: Dict, key: str, row: int) -> np.ndarray:
    return rec[key][row].detach().cpu().numpy()


def _rows(records: Iterable[Dict], videos_of: Dict[int, list]):
    """(record, row, video) of every real video of the judged batches: a
    batch's rows past its videos are padding."""
    for rec in records:
        for row, video in enumerate(videos_of[rec["batch"]]):
            yield rec, row, video


def judge_batches(cell, records: Iterable[Dict], videos_of: Dict[int, list],
                  weights: Dict[str, torch.Tensor], device: torch.device,
                  nms_thresh: float) -> Dict[str, float]:
    """Every number of the evaluator's stages over every video of the
    judged batches, and the reference F of each video by key
    (``f_ref``)."""
    out: Dict[str, float] = {}
    f_ref: Dict[str, float] = {}
    metric = cell.traffic["f_metric"]
    n_boxes = cell.model.HEAD.boxes_per_position(cell.config)
    for rec, row, video in _rows(records, videos_of):
        want_s, want_b = ref_predict(cell, weights, video.seq, device)
        got = {name: _row(rec, key, row) for name, key in (
            ("scores", "scores"), ("boxes", "boxes"),
            ("boxes_c", "boxes_c"), ("keep", "keep"), ("values", "values"),
            ("weights", "weights"), ("capacity", "capacity"),
            ("picked", "picked"), ("summary", "summaries"),
            ("fscore", "fscores"))}
        numbers = predict_gaps(got["scores"].astype(np.float64),
                               got["boxes"].astype(np.float64),
                               want_s, want_b)
        numbers.update(evalchain.judge_video(video, n_boxes, nms_thresh,
                                             metric, got))
        f_ref[video.key] = numbers.pop("f_ref")
        for k, v in numbers.items():
            out[k] = max(out.get(k, 0), v)
    out["f_ref"] = f_ref
    return out


def f_control(cell, records: Iterable[Dict], videos_of: Dict[int, list],
              dtype=torch.bfloat16) -> Dict[str, float]:
    """``f_gap``'s control: the F-score of each of the program's judged
    summaries worked out in ``dtype`` (the precision below the program's
    float32) against the same in float64 -> the widest gap of a video
    (``video``) and the gap of their means (``mean``, a validation's)."""
    metric = cell.traffic["f_metric"]
    low, high = [], []
    for rec, row, video in _rows(records, videos_of):
        summary = _row(rec, "summaries", row)[:int(video.n_frames)]
        summary = summary.astype(bool)
        low.append(evalchain.f_score_in(summary, video.user_summary, metric,
                                        dtype))
        high.append(evalchain.f_score(summary, video.user_summary, metric))
    if not low:
        return {"video": float("nan"), "mean": float("nan")}
    mean = float(torch.tensor(low, dtype=dtype).mean())
    return {"video": max(abs(a - b) for a, b in zip(low, high)),
            "mean": abs(mean - float(np.mean(high)))}


# ---------------------------------------------------------------- training

def follow_steps(cell, weights: Dict[str, torch.Tensor], videos: Sequence,
                 fold_seed: int, device: torch.device, steps: int,
                 dtype=torch.float64, tf32: bool = False) -> Dict:
    """The reference's first ``steps`` train steps of a fold from the
    benchmark's weights: the plan, and by the configuration's head the
    labels and their draws, the forward with its dropout draws and the
    losses; the backward and Adam ->
    {"losses", "grad" (step 1, as Adam received it), "params" (after the
    last step), "p0"}."""
    cfg, program = cell.config, cell.traffic["program"]
    head = cell.model.HEAD
    if int(program.get("batch_size", 1)) != 1:
        raise ValueError("the reference follows batch-1 training only")
    labs = [head.labels(cfg, v, program) for v in videos]
    plan = ref_labels.epoch_plan(videos, labs, int(program["bucket_size"]),
                                 fold_seed)
    drop_gen = torch.Generator(device=device).manual_seed(fold_seed + 1)
    label_gen = torch.Generator(device=device).manual_seed(fold_seed + 2)
    params = {k: v.detach().to(device, dtype).clone().requires_grad_(True)
              for k, v in weights.items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    adam = ref_model.Adam(float(program["lr"]),
                          float(program["weight_decay"]))
    out = {"losses": [], "p0": p0}
    with precision(tf32):
        for t in range(steps):
            i = plan[t]
            loss = head.step_loss(cfg, params, videos[i], labs[i], program,
                                  drop_gen, label_gen)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), grads)}
            if t == 0:
                out["grad"] = {k: g.detach().clone() for k, g in grads.items()}
            adam.step(params, grads)
            out["losses"].append(float(loss.detach()))
    out["params"] = {k: v.detach() for k, v in params.items()}
    return out


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keep: Sequence[str]) -> List[float]:
    """Per leaf |norm - reference norm| over max(reference norm, the
    median leaf's reference norm)."""
    g = {k: float(got[k].double().norm()) for k in keep}
    w = {k: float(want[k].double().norm()) for k in keep}
    med = float(np.median(list(w.values())))
    return [abs(g[k] - w[k]) / max(w[k], med, 1e-300) for k in keep]


def train_numbers(prog: Dict, ref: Dict, weight_decay: float) -> Dict:
    """The program's captured steps against the reference's: the first
    step's loss that is not 0 (``loss_gap``, relative), the first
    gradient as Adam received it (its L2 term added) and the change over
    the steps, each by its median leaf (``grad_gap``, ``change_gap``) and
    its worst leaf (``*_leaf``); the
    losses of all steps (``loss_gap_steps``, not compared) and the leaves
    left out."""
    p0 = {k: v.double() for k, v in prog["p0"].items()}
    # the gradient as Adam gets it: its L2 term added (a video without a
    # positive anchor has a zero loss and gives Adam that term alone)
    want_grad = {k: g + weight_decay * ref["p0"][k]
                 for k, g in ref["grad"].items()}
    norms = {k: float(g.norm()) for k, g in want_grad.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]
    grad = {k: prog["exp_avg"][k].double() / (1 - MOMENT_DECAY)
            for k in keep}
    change = {k: prog["p_end"][k].double() - p0[k] for k in keep}
    want_change = {k: ref["params"][k] - ref["p0"][k] for k in keep}
    losses = [float(x) for x in prog["losses"]]
    loss = [abs(a - b) / max(abs(b), 1e-12)
            for a, b in zip(losses, ref["losses"])]
    if len(losses) != len(ref["losses"]):
        loss = [float("inf")]
    # the first step with a loss: a video without positives weighs 0
    first = next((g for g, b in zip(loss, ref["losses"]) if b != 0), 0.0)
    grads = _leaf_gaps(grad, want_grad, keep)
    changes = _leaf_gaps(change, want_change, keep)
    return {"loss_gap": first, "loss_gap_steps": max(loss),
            "grad_gap": float(np.median(grads)), "grad_gap_leaf": max(grads),
            "change_gap": float(np.median(changes)),
            "change_gap_leaf": max(changes),
            "left_out": sorted(set(norms) - set(keep))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number within its limit, [(name, number, limit)]); a
    number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        value = float("nan") if value is None else float(value)
        rows.append((name, value, float(limit)))
        ok = ok and np.isfinite(value) and value <= limit
    return ok, rows
