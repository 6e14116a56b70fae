"""NMS inputs shared by the CPU tests (plain twin against the JAX package)
and the card tests (kernel against the twin): boxes as the evaluators'
``predict_nms`` hands them over (clipped to the video, rounded), at the
shapes the benchmark's cells sweep, and the edge cases.  Imports neither
JAX nor edsnet_tpu."""
import numpy as np
import torch

ATTENTION = (4, 8, 16, 32)     # ab-attention's anchor scales
NYSTROM = (12,)                # ab-nystromformer's


def predicted(seed, lengths, scales, bucket):
    """(scores [B, T], boxes [B, T, 2], valid [B, T]) for videos of
    ``lengths`` positions padded to ``bucket``, T = bucket x scales: boxes
    around each position at each anchor scale, clipped to [0, length] and
    rounded as ``predict_nms`` does, valid at real positions."""
    rng = np.random.RandomState(seed)
    b, s = len(lengths), len(scales)
    t = bucket * s
    positions = np.arange(t) // s
    scale = np.asarray(scales, np.float64)[np.arange(t) % s]
    center = positions + 0.5 + rng.normal(0.0, 1.5, (b, t))
    width = scale * np.exp(rng.normal(0.0, 0.4, (b, t)))
    boxes = torch.from_numpy(np.stack([center - width / 2,
                                       center + width / 2], -1)
                             .astype(np.float32))
    lens = torch.tensor(lengths)
    len_f = lens.to(torch.float32)[:, None, None]
    boxes = torch.round(torch.minimum(torch.clamp(boxes, min=0.0), len_f))
    scores = torch.sigmoid(torch.from_numpy(
        rng.normal(0.0, 2.0, (b, t)).astype(np.float32)))
    valid = torch.from_numpy(positions)[None, :] < lens[:, None]
    return scores, boxes, valid


def scattered(seed, b, n, ties=False, identical=False, dead=False):
    """(scores, boxes, valid) of random rounded boxes on a 60-position
    line, some of them empty or invalid; ``ties`` draws scores from six
    levels, ``identical`` makes every box of a row the same, ``dead``
    marks every entry invalid."""
    rng = np.random.RandomState(seed)
    scores = (rng.randint(0, 6, (b, n)) / 5.0 if ties
              else rng.rand(b, n)).astype(np.float32)
    left = np.round(rng.uniform(0, 60, (b, n)))
    width = np.round(rng.uniform(-3, 14, (b, n)))   # width <= 0: dropped
    if identical:
        left[:], width[:] = left[:, :1], 7.0
    boxes = np.stack([left, left + width], -1).astype(np.float32)
    valid = rng.rand(b, n) > 0.15
    if dead:
        valid[:] = False
    return (torch.from_numpy(scores), torch.from_numpy(boxes),
            torch.from_numpy(valid))


# name -> (scores, boxes, valid): the cells' buckets of 256 positions at
# SumMe's lengths, then the edge cases
CASES = {
    "attention-120": lambda: predicted(0, [120], ATTENTION, 256),
    "attention-300-b4": lambda: predicted(1, [300, 257, 180, 120],
                                          ATTENTION, 512),
    "attention-780": lambda: predicted(2, [780], ATTENTION, 1024),
    "nystrom-120-b4": lambda: predicted(3, [120, 100, 64, 30], NYSTROM, 256),
    "nystrom-300": lambda: predicted(4, [300], NYSTROM, 512),
    "nystrom-780-b4": lambda: predicted(5, [780, 700, 600, 513], NYSTROM,
                                        1024),
    "ragged-77-b4": lambda: scattered(6, 4, 77),
    "single-box": lambda: scattered(7, 1, 1),
    "single-box-b4": lambda: scattered(8, 4, 1),
    "all-dead-b4": lambda: scattered(9, 4, 64, dead=True),
    "identical-b4": lambda: scattered(10, 4, 50, identical=True),
    "score-ties-b4": lambda: scattered(11, 4, 96, ties=True),
}

# rows longer than the cells', for the card only: one 4-scale row at bucket
# 576 (2304 boxes), a 4-scale bucket at 4096 boxes, infer.py's
# 2100-position video (2304 padded, 4 scales) and a row past the kernel's
# shared-memory tile
LONG_CASES = {
    "attention-2304": lambda: predicted(15, [576], ATTENTION, 576),
    "attention-4096-b4": lambda: predicted(12, [1024, 1000, 900, 800],
                                           ATTENTION, 1024),
    "infer-9216": lambda: predicted(13, [2100], ATTENTION, 2304),
    "infer-30000": lambda: predicted(14, [7500], ATTENTION, 7500),
}

THRESHOLDS = (0.5, 0.4)
