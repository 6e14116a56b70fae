"""On-device evaluation: predict -> NMS -> max-score rasterisation ->
keyshot summary (knapsack DP) -> F1, one batch of videos at a time.

Counterpart of edsnet_tpu/parallel/eval_device.py: ``batch_eval_device``
(the same padding rules), ``_eval_batch_device`` (batched instead of
vmapped), ``eval_fscore_device`` and ``evaluate_on_device``, on one device
and without a mesh.  Diversity is computed on the host from the returned
summaries.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.ops import summary as summ_ops
from edsnet_torch.ops.bbox import nms_masked


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_eval_device(records: List[VideoRecord], batch_size: int,
                      bucket_size: int) -> Iterator[Dict]:
    """Pad records into eval batches of numpy arrays.

    Per batch: seq [B,L,F], mask [B,L], lens [B], picks [B,L],
    cps [B,S,2], nfps [B,S], seg_valid [B,S], n_frames [B],
    user_summary [B,U,Fr], user_valid [B,U], is_avg [B] (tvsum metric).
    Sequences bucket to multiples of max(bucket_size, 256), shots to 16,
    frames to 4096 and users to 4; a ragged final chunk pads with empty
    rows (``records`` keeps the real ones).
    """
    seq_gran = max(bucket_size, 256)
    buckets: Dict[int, List[VideoRecord]] = {}
    for r in records:
        blen = _round_up(max(r.seq.shape[0], 1), seq_gran)
        buckets.setdefault(blen, []).append(r)

    for blen, group in buckets.items():
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            b = batch_size
            s_max = _round_up(max(len(r.cps) for r in chunk), 16)
            fr_max = _round_up(max(int(r.n_frames) for r in chunk), 4096)
            u_max = max((0 if r.user_summary is None
                         else r.user_summary.shape[0]) for r in chunk)
            u_max = _round_up(max(u_max, 1), 4)
            feat = chunk[0].seq.shape[1]

            def zeros(shape, dtype=np.float32):
                return np.zeros((b,) + shape, dtype)

            # uniform-picks fast path: picks == arange(n) * rate with
            # n_frames <= n * rate for every video of the chunk
            rates = set()
            for r in chunk:
                d = np.diff(r.picks)
                if (d.size and (d == d[0]).all() and r.picks[0] == 0
                        and int(r.n_frames) <= r.picks.size * int(d[0])):
                    rates.add(int(d[0]))
                else:
                    rates.add(0)
            uniform_rate = rates.pop() if len(rates) == 1 else 0

            out = {
                "uniform_rate": uniform_rate,
                "seq": zeros((blen, feat)),
                "mask": zeros((blen,), bool),
                "lens": np.zeros(b, np.int32),
                "picks": zeros((blen,), np.int32),
                "cps": zeros((s_max, 2), np.int32),
                "nfps": zeros((s_max,), np.int32),
                "seg_valid": zeros((s_max,), bool),
                "n_frames": np.zeros(b, np.int32),
                "user_summary": zeros((u_max, fr_max), bool),
                "user_valid": zeros((u_max,), bool),
                "is_avg": np.zeros(b, bool),
                "records": chunk,
                "frame_bucket": fr_max,
            }
            for j, r in enumerate(chunk):
                n = r.seq.shape[0]
                out["seq"][j, :n] = r.seq
                out["mask"][j, :n] = True
                out["lens"][j] = n
                out["picks"][j, :n] = r.picks
                # padding picks point past the video so the search maps
                # trailing frames to the last real pick
                out["picks"][j, n:] = int(r.n_frames) + 1
                ns = len(r.cps)
                out["cps"][j, :ns] = r.cps
                out["nfps"][j, :ns] = r.nfps
                out["seg_valid"][j, :ns] = True
                out["n_frames"][j] = int(r.n_frames)
                if r.user_summary is not None:
                    u, fr = r.user_summary.shape
                    out["user_summary"][j, :u, :min(fr, fr_max)] = \
                        r.user_summary[:, :fr_max] > 0.5
                    out["user_valid"][j, :u] = True
                out["is_avg"][j] = "tvsum" in r.key
            yield out


@torch.inference_mode()
def _eval_batch_device(model, batch: Dict[str, torch.Tensor],
                       num_scales: int, nms_thresh: float, frame_bucket: int,
                       uniform_rate: int = 0):
    """One padded batch -> (fscores [B], summaries [B, frame_bucket])."""
    pred_cls, boxes = model.predict(batch["seq"], batch["mask"])
    b, total = pred_cls.shape
    n = total // num_scales
    device = pred_cls.device
    lens = batch["lens"]
    positions = torch.arange(total, device=device) // num_scales
    valid = positions[None, :] < lens[:, None]
    len_f = lens.to(torch.float32)[:, None, None]
    boxes_c = torch.round(torch.minimum(torch.clamp(boxes, min=0.0), len_f))
    keep = nms_masked(pred_cls, boxes_c, nms_thresh, valid)

    # max-score rasterisation over pick positions
    pos = torch.arange(n, device=device)
    boxes_int = boxes_c.to(torch.int32)
    inside = ((pos >= boxes_int[..., :1]) & (pos < boxes_int[..., 1:2])
              & keep[..., None])                             # [B, total, n]
    score = torch.where(inside, pred_cls[..., None], 0.0).amax(dim=1)

    summ = summ_ops.keyshot_summ(
        score, batch["picks"], batch["cps"], batch["nfps"],
        batch["seg_valid"], batch["n_frames"], max_frames=frame_bucket,
        uniform_sample_rate=uniform_rate)

    user_summary = batch["user_summary"]
    user_valid = batch["user_valid"]
    is_avg = batch["is_avg"]
    f1s = summ_ops.f1_score(user_summary,
                            summ[:, None, :].expand_as(user_summary))
    f1s = torch.where(user_valid, f1s,
                      torch.where(is_avg[:, None], 0.0, -1.0))
    n_users = torch.clamp(user_valid.sum(dim=-1), min=1)
    avg = torch.where(user_valid, f1s, 0.0).sum(dim=-1) / n_users
    mx = f1s.amax(dim=-1)
    return torch.where(is_avg, avg, mx), summ


def prepare_eval_batches(records: List[VideoRecord], batch_size: int,
                         bucket_size: int,
                         device: torch.device | str) -> List[Dict]:
    """Pad and upload eval batches once, for reuse across evaluations."""
    prepared = []
    for batch in batch_eval_device(records, batch_size, bucket_size):
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
        prepared.append({"tb": tb, "frame_bucket": batch["frame_bucket"],
                         "uniform_rate": batch["uniform_rate"],
                         "records": batch["records"]})
    return prepared


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def eval_fscore_device(model, prepared: List[Dict],
                       nms_thresh: float) -> torch.Tensor:
    """Mean validation F-score as a device scalar (no host sync)."""
    num_scales = len(model.scales)
    total = torch.zeros((), dtype=torch.float32, device=_device_of(model))
    count = 0
    for entry in prepared:
        fs, _ = _eval_batch_device(model, entry["tb"], num_scales,
                                   nms_thresh, entry["frame_bucket"],
                                   uniform_rate=entry["uniform_rate"])
        n_real = len(entry["records"])
        total = total + fs[:n_real].sum()
        count += n_real
    return total / max(count, 1)


def evaluate_on_device(model, records: List[VideoRecord], nms_thresh: float,
                       batch_size: int = 4, bucket_size: int = 64,
                       prepared: Optional[List[Dict]] = None,
                       per_video: Optional[List[Dict]] = None):
    """F-score evaluation on the model's device -> (mean F, mean diversity).

    Pass ``prepared`` (prepare_eval_batches) when evaluating the same
    records repeatedly.  A list given as ``per_video`` receives one dict
    per video: key, fscore, diversity and the frame summary.
    """
    num_scales = len(model.scales)
    if prepared is None:
        prepared = prepare_eval_batches(records, batch_size, bucket_size,
                                        _device_of(model))

    # launch every batch first and fetch once
    pending = []
    for entry in prepared:
        fs, summs = _eval_batch_device(
            model, entry["tb"], num_scales, nms_thresh,
            entry["frame_bucket"], uniform_rate=entry["uniform_rate"])
        pending.append((fs, summs, entry["records"]))

    fscores, diversities = [], []
    for fs, summs, recs in pending:
        fs, summs = fs.cpu().numpy(), summs.cpu().numpy()
        for j, r in enumerate(recs):
            fscores.append(float(fs[j]))
            seq_len = r.seq.shape[0]
            down = summs[j][:int(r.n_frames)][::summ_ops.SAMPLE_RATE]
            down = down[:seq_len]
            if down.size < seq_len:
                down = np.pad(down, (0, seq_len - down.size))
            diversities.append(summ_ops.get_summ_diversity(down, r.seq))
            if per_video is not None:
                per_video.append({"key": r.key, "fscore": fscores[-1],
                                  "diversity": diversities[-1],
                                  "summary": summs[j][:int(r.n_frames)]})
    return float(np.mean(fscores)), float(np.mean(diversities))
