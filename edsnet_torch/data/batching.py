"""Training-label preparation and length-bucketed padded batching
(anchor-based).

Counterpart of edsnet_tpu/data/batching.py.  The deterministic labels of a
video (keyshot target, positive anchors and their offsets, the negative and
incomplete candidates) are computed once, on the host, in numpy; only the
random negative and incomplete sampling runs per step, on the device
(parallel/steps.py).  Batches are videos of one length bucket (a multiple
of ``bucket_size``) padded to a common length, with masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.ops import anchors as anchor_ops
from edsnet_torch.ops import bbox as bbox_ops
from edsnet_torch.ops import summary as summ_ops


def _round8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


@dataclass
class TrainItem:
    """One video with its precomputed anchor-based labels."""
    key: str
    seq: np.ndarray                 # [N, F]
    target: np.ndarray              # [N] keyshot summary at the picks (0/1)
    cls_pos: np.ndarray             # [N, S] int32
    loc_label: np.ndarray           # [N, S, 2] float32
    neg_eligible: np.ndarray        # [N, S] bool
    inc_eligible: np.ndarray        # [N, S] bool
    num_pos: int = 0


def make_target(record: VideoRecord) -> Optional[np.ndarray]:
    """gtscore -> keyshot summary -> 0/1 target at each pick, or None to
    skip the video (a NaN shot score, or an empty target)."""
    try:
        keyshot = summ_ops.get_keyshot_summ(
            record.gtscore, record.cps, record.n_frames, record.nfps,
            record.picks)
    except ValueError as e:
        if "NaN" in str(e):
            return None
        raise
    picks = np.clip(np.asarray(record.picks, np.int64), 0,
                    max(int(record.n_frames) - 1, 0))
    target = keyshot[picks]
    if not target.any():
        return None
    return target.astype(np.int32)


def prepare_ab_item(record: VideoRecord, anchor_scales: Sequence[int],
                    pos_iou: float, neg_iou: float, inc_iou: float,
                    bucket_size: int = 64) -> Optional[TrainItem]:
    """Anchor-based labels for one video, or None to skip it."""
    target = make_target(record)
    if target is None:
        return None
    n = target.shape[0]
    n_pad = _bucket_len(n, bucket_size)
    target_bboxes = bbox_ops.seq2bbox(target)
    t = target_bboxes.shape[0]
    target_cw = np.stack(
        [(target_bboxes[:, 0] + target_bboxes[:, 1]) * 0.5,
         (target_bboxes[:, 1] - target_bboxes[:, 0]).astype(np.float32)],
        axis=-1) if t else np.zeros((0, 2), np.float32)
    t_pad = _round8(t)
    target_cw_pad = np.zeros((t_pad, 2), np.float32)
    target_cw_pad[:t] = target_cw
    target_cw_pad[t:, 1] = 1.0  # nonzero width keeps the iou finite
    t_valid = np.arange(t_pad) < t

    anchors = anchor_ops.get_anchors_np(n_pad, anchor_scales)

    def labels(thresh):
        return anchor_ops.get_pos_label_np(anchors, target_cw_pad, thresh,
                                           target_valid=t_valid)

    cls_pos, loc_label = labels(pos_iou)
    cls_at_neg, _ = labels(neg_iou)
    cls_at_inc, _ = labels(inc_iou)

    cls_pos = cls_pos[:n]
    neg_eligible = cls_at_neg[:n] == 0
    # entries with iou <= neg_iou are negatives; only the band between the
    # two thresholds stays eligible as incomplete
    inc_eligible = (cls_at_inc[:n] == 0) & ~neg_eligible
    return TrainItem(key=record.key, seq=record.seq, target=target,
                     cls_pos=cls_pos.astype(np.int32),
                     loc_label=loc_label[:n], neg_eligible=neg_eligible,
                     inc_eligible=inc_eligible, num_pos=int(cls_pos.sum()))


def prepare_af_item(record: VideoRecord) -> Optional[TrainItem]:
    raise NotImplementedError("anchor-free labels are not ported yet "
                              "(ROADMAP.md Queue A item 9)")


def prepare_items(records: Sequence[VideoRecord], kind: str,
                  anchor_scales: Sequence[int] = (), pos_iou: float = 0.6,
                  neg_iou: float = 0.0, inc_iou: float = 0.3,
                  bucket_size: int = 64) -> List[TrainItem]:
    """Labels for every record (a list or a ``VideoDataset``); skipped
    videos are left out."""
    items = []
    for i in range(len(records)):
        record = records[i]
        if kind == "anchor-based":
            item = prepare_ab_item(record, anchor_scales, pos_iou, neg_iou,
                                   inc_iou, bucket_size)
        else:
            item = prepare_af_item(record)
        if item is not None:
            items.append(item)
    return items


def _bucket_len(n: int, bucket_size: int) -> int:
    return max(bucket_size, ((n + bucket_size - 1) // bucket_size)
               * bucket_size)


def _pad_to(x: np.ndarray, length: int) -> np.ndarray:
    pad = [(0, length - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)


def batch_items(items: List[TrainItem], batch_size: int, bucket_size: int,
                shuffle: bool, rng: Optional[np.random.RandomState] = None,
                pad_batch_to: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    """Yield padded, masked batches grouped by length bucket.

    Each batch has seq [B,L,F], mask [B,L], video_valid [B], target,
    cls_pos, loc_label, neg_eligible, inc_eligible, num_pos and keys.  B is
    padded up to a multiple of ``pad_batch_to`` with rows whose video_valid
    is False.
    """
    order = np.arange(len(items))
    if shuffle:
        (rng or np.random).shuffle(order)

    buckets: Dict[int, List[TrainItem]] = {}
    for idx in order:
        item = items[idx]
        blen = _bucket_len(item.seq.shape[0], bucket_size)
        buckets.setdefault(blen, []).append(item)

    bucket_keys = list(buckets)
    if shuffle:
        (rng or np.random).shuffle(bucket_keys)

    for blen in bucket_keys:
        group = buckets[blen]
        for i in range(0, len(group), batch_size):
            yield _stack_chunk(group[i:i + batch_size], blen, pad_batch_to)


def _stack_chunk(chunk: List[TrainItem], blen: int,
                 pad_batch_to: int) -> Dict[str, np.ndarray]:
    b = len(chunk)
    b_pad = ((b + pad_batch_to - 1) // pad_batch_to) * pad_batch_to

    def stack(get, dtype):
        arrs = [_pad_to(np.asarray(get(it)), blen) for it in chunk]
        arrs += [np.zeros_like(arrs[0])] * (b_pad - b)
        return np.stack(arrs).astype(dtype)

    return {
        "seq": stack(lambda it: it.seq, np.float32),
        "mask": np.stack(
            [np.arange(blen) < it.seq.shape[0] for it in chunk]
            + [np.zeros(blen, bool)] * (b_pad - b)),
        "video_valid": np.asarray([True] * b + [False] * (b_pad - b)),
        "target": stack(lambda it: it.target, np.int32),
        "keys": [it.key for it in chunk],
        "cls_pos": stack(lambda it: it.cls_pos, np.int32),
        "loc_label": stack(lambda it: it.loc_label, np.float32),
        "neg_eligible": stack(lambda it: it.neg_eligible, bool),
        "inc_eligible": stack(lambda it: it.inc_eligible, bool),
        "num_pos": np.asarray([it.num_pos for it in chunk]
                              + [0] * (b_pad - b), np.int32),
    }


def pool_items(items: List[TrainItem], bucket_size: int
               ) -> List[Dict[str, np.ndarray]]:
    """Stack all of each length bucket's videos into one pool (no batch
    padding), in ascending bucket order.  Uploaded once, a pool lets every
    epoch compose new batches by a gather on the device."""
    buckets: Dict[int, List[TrainItem]] = {}
    for item in items:
        blen = _bucket_len(item.seq.shape[0], bucket_size)
        buckets.setdefault(blen, []).append(item)
    return [_stack_chunk(group, blen, pad_batch_to=1)
            for blen, group in sorted(buckets.items())]
