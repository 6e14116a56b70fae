"""Training-label preparation and length-bucketed padded batching.

Counterpart of edsnet_tpu/data/batching.py.  The deterministic labels of a
video are computed once, on the host, in numpy: the keyshot target, and
for the anchor-based head the positive anchors and their offsets and the
negative and incomplete candidates, for the anchor-free head the distances
to the segment's ends and their centerness.  Only the anchor-based random
negative and incomplete sampling runs per step, on the device
(parallel/steps.py).  Batches are videos of one length bucket (a multiple
of ``bucket_size``) padded to a common length, with masks, and, for the
motion head, the videos' motion features padded to a multiple of 16 rows
with their own mask.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.ops import anchor_free as af_ops
from edsnet_torch.ops import anchors as anchor_ops
from edsnet_torch.ops import bbox as bbox_ops
from edsnet_torch.ops import summary as summ_ops


def _round8(x: int) -> int:
    return max(8, ((x + 7) // 8) * 8)


@dataclass
class TrainItem:
    """One video with its precomputed labels, anchor-based or anchor-free."""
    key: str
    seq: np.ndarray                 # [N, F]
    target: np.ndarray              # [N] keyshot summary at the picks (0/1)
    # anchor-based labels
    cls_pos: Optional[np.ndarray] = None        # [N, S] int32
    loc_label: Optional[np.ndarray] = None      # [N, S, 2] float32
    neg_eligible: Optional[np.ndarray] = None   # [N, S] bool
    inc_eligible: Optional[np.ndarray] = None   # [N, S] bool
    num_pos: int = 0
    # anchor-free labels
    af_loc: Optional[np.ndarray] = None         # [N, 2] float32
    af_ctr: Optional[np.ndarray] = None         # [N] float32
    # motion features, for the cross-attention head
    motion: Optional[np.ndarray] = None         # [M, Fm]


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
                     inc_eligible=inc_eligible, num_pos=int(cls_pos.sum()),
                     motion=record.motion_features)


def prepare_af_item(record: VideoRecord) -> Optional[TrainItem]:
    """Anchor-free labels for one video, or None to skip it."""
    target = make_target(record)
    if target is None:
        return None
    loc = af_ops.get_loc_label_np(target)
    return TrainItem(key=record.key, seq=record.seq, target=target,
                     af_loc=loc, af_ctr=af_ops.get_ctr_label_np(target, loc),
                     motion=record.motion_features)


def prepare_items(records: Sequence[VideoRecord], kind: str,
                  anchor_scales: Sequence[int] = (), pos_iou: float = 0.6,
                  neg_iou: float = 0.0, inc_iou: float = 0.3,
                  bucket_size: int = 64,
                  need_motion: bool = True) -> List[TrainItem]:
    """Labels for every record (a list or a ``VideoDataset``); skipped
    videos are left out.  ``need_motion`` is whether the model reads
    motion: False drops the records' motion features, so that a model
    without motion trains on an h5 that has them."""
    items = []
    for i in range(len(records)):
        record = records[i]
        if kind == "anchor-based":
            item = prepare_ab_item(record, anchor_scales, pos_iou, neg_iou,
                                   inc_iou, bucket_size)
        else:
            item = prepare_af_item(record)
        if item is not None:
            if not need_motion:
                item.motion = None
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

    Each batch has seq [B,L,F], mask [B,L], video_valid [B], target and
    keys, plus the labels the items carry: cls_pos, loc_label,
    neg_eligible, inc_eligible and num_pos (anchor-based), af_loc and
    af_ctr (anchor-free).  B is padded up to a multiple of
    ``pad_batch_to`` with rows whose video_valid is False.
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


def _stack_motion(motions: List[np.ndarray], b_pad: int):
    """(motion [b_pad, M, Fm] float32, motion_mask [b_pad, M]): M is the
    longest rounded up to 16, and the rows past the videos are empty; the
    train and the eval batches share it."""
    m_len = -(-max(m.shape[0] for m in motions) // 16) * 16
    arrs = [_pad_to(np.asarray(m, np.float32), m_len) for m in motions]
    arrs += [np.zeros_like(arrs[0])] * (b_pad - len(motions))
    mmask = [np.arange(m_len) < m.shape[0] for m in motions]
    mmask += [np.zeros(m_len, bool)] * (b_pad - len(motions))
    return np.stack(arrs), np.stack(mmask)


def _missing_motion(keys: List[str]) -> ValueError:
    return ValueError(f"motion_features missing for {keys[:3]} — a "
                      f"cross-attention model needs motion for every video")


def _stack_chunk(chunk: List[TrainItem], blen: int,
                 pad_batch_to: int) -> Dict[str, np.ndarray]:
    b = len(chunk)
    b_pad = ((b + pad_batch_to - 1) // pad_batch_to) * pad_batch_to

    def stack(get, dtype):
        arrs = [_pad_to(np.asarray(get(it)), blen) for it in chunk]
        arrs += [np.zeros_like(arrs[0])] * (b_pad - b)
        return np.stack(arrs).astype(dtype)

    batch = {
        "seq": stack(lambda it: it.seq, np.float32),
        "mask": np.stack(
            [np.arange(blen) < it.seq.shape[0] for it in chunk]
            + [np.zeros(blen, bool)] * (b_pad - b)),
        "video_valid": np.asarray([True] * b + [False] * (b_pad - b)),
        "target": stack(lambda it: it.target, np.int32),
        "keys": [it.key for it in chunk],
    }
    if chunk[0].cls_pos is not None:
        batch["cls_pos"] = stack(lambda it: it.cls_pos, np.int32)
        batch["loc_label"] = stack(lambda it: it.loc_label, np.float32)
        batch["neg_eligible"] = stack(lambda it: it.neg_eligible, bool)
        batch["inc_eligible"] = stack(lambda it: it.inc_eligible, bool)
        batch["num_pos"] = np.asarray([it.num_pos for it in chunk]
                                      + [0] * (b_pad - b), np.int32)
    if chunk[0].af_loc is not None:
        batch["af_loc"] = stack(lambda it: it.af_loc, np.float32)
        batch["af_ctr"] = stack(lambda it: it.af_ctr, np.float32)
    motions = [it.motion for it in chunk]
    if any(m is not None for m in motions):
        # all or nothing per chunk, as resolve_build_motion on the eval
        # side: which videos share a chunk depends on the epoch's shuffle
        missing = [it.key for it, m in zip(chunk, motions) if m is None]
        if missing:
            raise _missing_motion(missing)
        batch["motion"], batch["motion_mask"] = _stack_motion(motions, b_pad)
    return batch


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


def resolve_build_motion(chunk: List[VideoRecord],
                         need_motion: Optional[bool]) -> bool:
    """Whether to build motion arrays for an eval chunk: never when
    ``need_motion`` is False (the model reads no motion), always when True
    (raising unless every record has motion), and when None as the data
    say, all or nothing."""
    has_motion = [r.motion_features is not None for r in chunk]
    if need_motion is False:
        return False
    if not all(has_motion) and (need_motion or any(has_motion)):
        raise _missing_motion([r.key for r, h in zip(chunk, has_motion)
                               if not h])
    return has_motion[0]
