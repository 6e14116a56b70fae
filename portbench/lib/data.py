"""The one data maker: eccv16-shaped videos in memory, drawn from a seed
by the parameters of a traffic file.

A traffic file fixes the dataset's shape: the number of videos, the
range of their lengths in positions (one position per
``frames_per_position`` frames), the shot lengths in seconds, the users
and their summary proportion, and the fold layout.  Every seed gets the
same set of lengths, evenly spaced over the range, the same shot
lengths in each video and the same folds (fold f holds the sorted videos
f, f + folds, f + 2 folds, ...); the seed draws the features, the order
of the shots, the importance scores, the users' summaries and the order
of the videos within a fold.  So two seeds do the
same amount of work, in another order, on other data.

Features are unit-norm Gaussian vectors of the configuration's width,
drawn on the device in one call (GoogLeNet pool5's shape).  Nothing is
read from disk.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class Video(NamedTuple):
    """One video, the fields of an eccv16 h5 group."""
    key: str
    seq: np.ndarray           # [N, F] float32
    gtscore: np.ndarray       # [N] float32
    cps: np.ndarray           # [S, 2] int32 (first, last) inclusive
    n_frames: int
    nfps: np.ndarray          # [S] int32
    picks: np.ndarray         # [N] int32
    user_summary: np.ndarray  # [U, n_frames] float32 0/1
    motion_features: Optional[np.ndarray] = None


class Fold(NamedTuple):
    train: List[Video]
    test: List[Video]


def lengths(traffic: Dict) -> np.ndarray:
    """The positions of every video, ascending: the same for every seed."""
    lo, hi = traffic["positions"]
    return np.round(np.linspace(lo, hi, traffic["videos"])).astype(np.int64)


def stream(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one purpose, from the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64)] + list(tags))


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit torch seed for one purpose, from the run's seed."""
    return int(stream(seed, *tags).integers(0, 1 << 62))


def _shots(rng: np.random.Generator, n_frames: int, lo: int, hi: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Shots of lo..hi frames: as many as the mean length fits, their
    lengths spread evenly over the range and stretched to fill the video,
    in an order drawn by ``rng``.  The count and the lengths depend on
    the video's length alone, so the knapsack's work does too."""
    count = max(1, int(np.ceil(n_frames / ((lo + hi) / 2))))
    spread = np.linspace(0, hi - lo, count)
    spread *= (n_frames - count * lo) / spread.sum()
    lengths = (lo + np.floor(spread)).astype(np.int64)
    lengths[:n_frames - int(lengths.sum())] += 1
    bounds = np.concatenate([[0], np.cumsum(rng.permutation(lengths))])
    cps = np.stack([bounds[:-1], bounds[1:] - 1], 1).astype(np.int32)
    return cps, (bounds[1:] - bounds[:-1]).astype(np.int32)


def _user_summaries(rng: np.random.Generator, cps: np.ndarray,
                    nfps: np.ndarray, n_frames: int, users: int,
                    proportion: float) -> np.ndarray:
    """Each user takes shots in a random order while they fit the budget."""
    summ = np.zeros((users, n_frames), np.float32)
    budget0 = int(proportion * n_frames)
    for u in range(users):
        budget = budget0
        for s in rng.permutation(len(nfps)):
            if nfps[s] <= budget:
                summ[u, cps[s, 0]:cps[s, 1] + 1] = 1
                budget -= nfps[s]
    return summ


def make_videos(traffic: Dict, seed: int, num_feature: int,
                device: torch.device) -> List[Video]:
    """Every video of the traffic file, in ascending length."""
    ns = lengths(traffic)
    rng = stream(seed, 1)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 2))
    feats = torch.randn(int(ns.sum()), num_feature, generator=gen,
                        device=device)
    feats = torch.nn.functional.normalize(feats, dim=-1).cpu().numpy()
    rate = int(traffic["frames_per_position"])
    fps = float(traffic["fps"])
    lo, hi = (int(round(s * fps)) for s in traffic["shot_seconds"])
    videos, offset = [], 0
    for i, n in enumerate(ns):
        n = int(n)
        n_frames = n * rate
        cps, nfps = _shots(rng, n_frames, lo, hi)
        videos.append(Video(
            key=f"{traffic['dataset']}/video_{i}",
            seq=feats[offset:offset + n],
            gtscore=rng.random(n, dtype=np.float32),
            cps=cps, n_frames=n_frames, nfps=nfps,
            picks=(np.arange(n) * rate).astype(np.int32),
            user_summary=_user_summaries(rng, cps, nfps, n_frames,
                                         int(traffic["users"]),
                                         float(traffic["user_proportion"]))))
        offset += n
    return videos


def make_folds(traffic: Dict, videos: Sequence[Video], seed: int
               ) -> List[Fold]:
    """The traffic's folds: fold f tests on the sorted videos f, f + k,
    ... (k folds) and trains on the rest; the seed orders each list."""
    k = int(traffic["folds"])
    rng = stream(seed, 3)
    folds = []
    for f in range(k):
        test = [v for i, v in enumerate(videos) if i % k == f]
        train = [v for i, v in enumerate(videos) if i % k != f]
        if len(test) != int(traffic["held_out"]):
            raise ValueError(f"fold {f} holds {len(test)} test videos, the "
                             f"traffic file says {traffic['held_out']}")
        folds.append(Fold([train[j] for j in rng.permutation(len(train))],
                          [test[j] for j in rng.permutation(len(test))]))
    return folds
