"""On-device evaluation: predict -> NMS -> max-score rasterisation ->
keyshot summary (knapsack DP) -> F1, one batch of videos at a time.

Counterpart of edsnet_tpu/parallel/eval_device.py: ``batch_eval_device``
(the same padding rules), ``_eval_batch_device`` (batched instead of
vmapped; its predict, clip, round and NMS are ``predict_nms``, which the
host evaluator in evaluate.py shares), ``_num_scales_of``,
``eval_fscore_device`` and ``evaluate_on_device``, for both heads, and
``model_needs_motion`` and ``checkpoint_motion_width`` for the motion
head, whose eval batches carry the videos' motion features.  Diversity is
computed on the host from the returned summaries.

Under a mesh (``prepare_eval_batches(mesh=)``), the batch size rounds up
to a multiple of the ``data`` axis and each rank evaluates its block of
every batch's rows; the per-video F-scores and summaries are gathered over
``data`` in row order, so every rank sums the same numbers in the same
order and takes the same best-F decision.  Padding rows are dropped as
before, so the F-scores are the unsharded ones.

The tracer (utils/profiling.py) sees a pass as the span ``eval/pass``
over ``eval/predict``, ``eval/nms``, ``eval/raster``, ``eval/summary``
(the knapsack's loops within it), ``eval/f1``, ``eval/fetch`` (the host's
wait for the device) and ``eval/diversity``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from edsnet_torch.data.batching import _stack_motion, resolve_build_motion
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.ops import summary as summ_ops
from edsnet_torch.ops.bbox import nms_masked
from edsnet_torch.parallel.mesh import Mesh, all_gather, shard_rows
from edsnet_torch.utils.profiling import span


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def batch_eval_device(records: List[VideoRecord], batch_size: int,
                      bucket_size: int, need_motion: Optional[bool] = None
                      ) -> Iterator[Dict]:
    """Pad records into eval batches of numpy arrays.

    Per batch: seq [B,L,F], mask [B,L], lens [B], picks [B,L],
    cps [B,S,2], nfps [B,S], seg_valid [B,S], n_frames [B],
    user_summary [B,U,Fr], user_valid [B,U], is_avg [B] (tvsum metric),
    and motion [B,M,Fm] with motion_mask [B,M] where
    ``data/batching.py:resolve_build_motion`` says (``need_motion``: what
    the model reads, None to follow the data).  Sequences bucket to
    multiples of max(bucket_size, 256), shots to 16, frames to 4096, users
    to 4 and motion rows to 16; a ragged final chunk pads with empty rows
    (``records`` keeps the real ones).
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
            if resolve_build_motion(chunk, need_motion):
                out["motion"], out["motion_mask"] = _stack_motion(
                    [r.motion_features for r in chunk], b)
            yield out


@torch.inference_mode()
def predict_nms(model, seq: torch.Tensor, mask: torch.Tensor,
                lens: torch.Tensor, num_scales: int, nms_thresh: float,
                motion: Optional[torch.Tensor] = None,
                motion_mask: Optional[torch.Tensor] = None):
    """Predict a padded batch (the motion head with its ``motion`` and
    ``motion_mask``), clip each box to its video's length, round it, and
    run the masked NMS per row -> (pred_cls [B, T], boxes [B, T, 2]
    float32, keep [B, T] bool), T = positions x scales.  The host evaluator
    and ``_eval_batch_device`` share it."""
    with span("eval/predict"):
        if motion is None:
            pred_cls, boxes = model.predict(seq, mask)
        else:
            pred_cls, boxes = model.predict(seq, motion, mask, motion_mask)
    total = pred_cls.shape[1]
    positions = torch.arange(total, device=pred_cls.device) // num_scales
    valid = positions[None, :] < lens[:, None]
    len_f = lens.to(torch.float32)[:, None, None]
    boxes_c = torch.round(torch.minimum(torch.clamp(boxes, min=0.0), len_f))
    return pred_cls, boxes_c, nms_masked(pred_cls, boxes_c, nms_thresh, valid)


@torch.inference_mode()
def _eval_batch_device(model, batch: Dict[str, torch.Tensor],
                       num_scales: int, nms_thresh: float, frame_bucket: int,
                       uniform_rate: int = 0):
    """One padded batch -> (fscores [B], summaries [B, frame_bucket])."""
    pred_cls, boxes_c, keep = predict_nms(
        model, batch["seq"], batch["mask"], batch["lens"], num_scales,
        nms_thresh, batch.get("motion"), batch.get("motion_mask"))
    n = pred_cls.shape[1] // num_scales
    device = pred_cls.device

    with span("eval/raster"):    # max-score rasterisation over picks
        pos = torch.arange(n, device=device)
        boxes_int = boxes_c.to(torch.int32)
        inside = ((pos >= boxes_int[..., :1]) & (pos < boxes_int[..., 1:2])
                  & keep[..., None])                         # [B, total, n]
        score = torch.where(inside, pred_cls[..., None], 0.0).amax(dim=1)

    summ = summ_ops.keyshot_summ(
        score, batch["picks"], batch["cps"], batch["nfps"],
        batch["seg_valid"], batch["n_frames"], max_frames=frame_bucket,
        uniform_sample_rate=uniform_rate)

    user_summary = batch["user_summary"]
    user_valid = batch["user_valid"]
    is_avg = batch["is_avg"]
    with span("eval/f1"):
        f1s = summ_ops.f1_score(user_summary,
                                summ[:, None, :].expand_as(user_summary))
    f1s = torch.where(user_valid, f1s,
                      torch.where(is_avg[:, None], 0.0, -1.0))
    n_users = torch.clamp(user_valid.sum(dim=-1), min=1)
    avg = torch.where(user_valid, f1s, 0.0).sum(dim=-1) / n_users
    mx = f1s.amax(dim=-1)
    return torch.where(is_avg, avg, mx), summ


def summary_diversity(summary: np.ndarray, seq: np.ndarray) -> float:
    """Diversity of a frame summary over the video's features: the summary
    down-sampled to positions, cut or zero-padded to their count."""
    seq_len = seq.shape[0]
    down = summ_ops.downsample_summ(summary)[:seq_len]
    if down.size < seq_len:
        down = np.pad(down, (0, seq_len - down.size))
    return summ_ops.get_summ_diversity(down, seq)


def prepare_eval_batches(records: List[VideoRecord], batch_size: int,
                         bucket_size: int, device: torch.device | str,
                         need_motion: Optional[bool] = None,
                         mesh: Optional[Mesh] = None) -> List[Dict]:
    """Pad and upload eval batches once, for reuse across evaluations;
    ``need_motion`` as ``batch_eval_device``'s.  With ``mesh``, the batch
    size rounds up to a multiple of its ``data`` axis and each entry holds
    this rank's rows (``records`` keeps the batch's real videos)."""
    if mesh is not None:
        data = mesh.shape["data"]
        batch_size = -(-max(batch_size, 1) // data) * data
    prepared = []
    for batch in batch_eval_device(records, batch_size, bucket_size,
                                   need_motion):
        tb = {k: shard_rows(torch.from_numpy(v), mesh).to(device)
              for k, v in batch.items() if isinstance(v, np.ndarray)}
        prepared.append({"tb": tb, "frame_bucket": batch["frame_bucket"],
                         "uniform_rate": batch["uniform_rate"],
                         "records": batch["records"], "mesh": mesh})
    return prepared


def gather_rows(entry: Dict, *tensors: torch.Tensor):
    """The batch's rows of each of ``tensors`` from every rank of the
    entry's ``data`` axis, in row order (as is without a mesh)."""
    mesh = entry.get("mesh")
    if mesh is None:
        return tensors
    return tuple(all_gather(t, mesh, "data") for t in tensors)


def model_needs_motion(model) -> bool:
    """Whether ``model`` reads motion features (the motion head): what
    the trainer and the evaluators gate the motion batching on."""
    from edsnet_torch.models.dsnet import DSNetMotionFeatures
    return isinstance(model, DSNetMotionFeatures)


def checkpoint_motion_width(state_dict: Mapping[str, torch.Tensor]) -> int:
    """The motion width a motion checkpoint's state_dict was trained at:
    the input width of its cross-attention key projection, whose weight
    keeps flax's [in, H, D] layout."""
    for key, tensor in state_dict.items():
        if key.endswith("cross_attn.key.weight"):
            return int(tensor.shape[0])
    raise ValueError("no cross_attn projection in the checkpoint — not a "
                     "motion (cross-attention) model?")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _num_scales_of(model) -> int:
    """Boxes per position: the anchor-based head's scales, 1 for an
    anchor-free head."""
    scales = getattr(model, "scales", None)
    return 1 if scales is None else len(scales)


def eval_fscore_device(model, prepared: List[Dict],
                       nms_thresh: float) -> torch.Tensor:
    """Mean validation F-score as a device scalar (no host sync)."""
    num_scales = _num_scales_of(model)
    total = torch.zeros((), dtype=torch.float32, device=_device_of(model))
    count = 0
    for entry in prepared:
        fs, _ = _eval_batch_device(model, entry["tb"], num_scales,
                                   nms_thresh, entry["frame_bucket"],
                                   uniform_rate=entry["uniform_rate"])
        fs, = gather_rows(entry, fs)
        n_real = len(entry["records"])
        total = total + fs[:n_real].sum()
        count += n_real
    return total / max(count, 1)


def evaluate_on_device(model, records: List[VideoRecord], nms_thresh: float,
                       batch_size: int = 4, bucket_size: int = 64,
                       prepared: Optional[List[Dict]] = None,
                       per_video: Optional[List[Dict]] = None,
                       mesh: Optional[Mesh] = None):
    """F-score evaluation on the model's device -> (mean F, mean diversity).

    Pass ``prepared`` (prepare_eval_batches) when evaluating the same
    records repeatedly; else the batches are made here, their rows split
    over ``mesh``'s ``data`` axis when one is given.  A list given as
    ``per_video`` receives one dict per video: key, fscore, diversity and
    the frame summary.
    """
    with span("eval/pass"):
        num_scales = _num_scales_of(model)
        if prepared is None:
            prepared = prepare_eval_batches(records, batch_size, bucket_size,
                                            _device_of(model),
                                            model_needs_motion(model), mesh)

        # launch every batch first and fetch once
        pending = []
        for entry in prepared:
            fs, summs = _eval_batch_device(
                model, entry["tb"], num_scales, nms_thresh,
                entry["frame_bucket"], uniform_rate=entry["uniform_rate"])
            pending.append(gather_rows(entry, fs, summs) + (entry["records"],))

        fscores, diversities = [], []
        for fs, summs, recs in pending:
            with span("eval/fetch"):       # the host waits for the device
                fs, summs = fs.cpu().numpy(), summs.cpu().numpy()
            with span("eval/diversity"):
                for j, r in enumerate(recs):
                    fscores.append(float(fs[j]))
                    diversities.append(summary_diversity(
                        summs[j][:int(r.n_frames)], r.seq))
                    if per_video is not None:
                        per_video.append({
                            "key": r.key, "fscore": fscores[-1],
                            "diversity": diversities[-1],
                            "summary": summs[j][:int(r.n_frames)]})
        return float(np.mean(fscores)), float(np.mean(diversities))
