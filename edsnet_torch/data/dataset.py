"""h5 dataset layer (eccv16 schema), splits yaml, run utilities.

Counterpart of edsnet_tpu/data/dataset.py, kept as the port's own copy.
``h5py`` and ``yaml`` are imported inside the functions that read an h5
file or a split, so the package imports without them.  Split keys
``<dir>/<file.h5>/<video>`` resolve against the key's own path, then
data_root/<relative>, then data_root/<file.h5>.
"""
from __future__ import annotations

from os import PathLike
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np


class VideoRecord(NamedTuple):
    key: str
    seq: np.ndarray          # [N, F] float32
    gtscore: np.ndarray      # [N] float32, min-max normalized
    cps: np.ndarray          # [S, 2] int32 (first, last) inclusive
    n_frames: int
    nfps: np.ndarray         # [S] int32
    picks: np.ndarray        # [N] int32
    user_summary: Optional[np.ndarray]  # [U, n_frames] float32 or None
    motion_features: Optional[np.ndarray] = None


def _resolve_h5(key: str, data_root: Optional[str]) -> Path:
    p = Path(key).parent
    candidates = [p]
    if data_root is not None:
        root = Path(data_root)
        candidates += [root / p, root / p.name]
        parts = [q for q in p.parts if q not in ("..", ".")]
        if parts:
            candidates.append(root.joinpath(*parts))
    for c in candidates:
        if c.is_file():
            return c
    raise FileNotFoundError(
        f"Cannot resolve dataset file for key {key!r}; tried {candidates}. "
        f"Pass --data-root pointing at the directory with the .h5 files.")


class VideoDataset:
    """Reads per-video groups from eccv16-format h5 files: features (N, F),
    gtscore (N), change_points (S, 2), n_frames, n_frame_per_seg (S),
    picks (N), optional user_summary (U, n_frames), optional
    motion_features."""

    def __init__(self, keys: List[str], data_root: Optional[str] = None):
        import h5py

        self.keys = keys
        self.data_root = data_root
        self._files: Dict[str, Any] = {}
        for key in keys:
            parent = str(Path(key).parent)
            if parent not in self._files:
                self._files[parent] = h5py.File(
                    str(_resolve_h5(key, data_root)), "r")

    def __len__(self) -> int:
        return len(self.keys)

    def __getitem__(self, index: int) -> VideoRecord:
        key = self.keys[index]
        video_path = Path(key)
        video_file = self._files[str(video_path.parent)][video_path.name]

        seq = video_file["features"][...].astype(np.float32)
        gtscore = video_file["gtscore"][...].astype(np.float32)
        cps = video_file["change_points"][...].astype(np.int32)
        n_frames = int(np.asarray(video_file["n_frames"][...]))
        nfps = video_file["n_frame_per_seg"][...].astype(np.int32)
        picks = video_file["picks"][...].astype(np.int32)
        user_summary = None
        if "user_summary" in video_file:
            user_summary = video_file["user_summary"][...].astype(np.float32)
        motion = None
        if "motion_features" in video_file:
            motion = video_file["motion_features"][...].astype(np.float32)

        gtscore = gtscore - gtscore.min()
        maxv = gtscore.max()
        gtscore = gtscore / maxv if maxv > 0 else gtscore

        return VideoRecord(key, seq, gtscore, cps, n_frames, nfps, picks,
                           user_summary, motion)

    def close(self):
        for f in self._files.values():
            f.close()


class AverageMeter:
    """Named running means."""

    def __init__(self, *keys: str):
        self.totals = {key: 0.0 for key in keys}
        self.counts = {key: 0 for key in keys}

    def update(self, **kwargs: float) -> None:
        for key, value in kwargs.items():
            self._check_attr(key)
            self.totals[key] += value
            self.counts[key] += 1

    def __getattr__(self, attr: str) -> float:
        if attr in ("totals", "counts"):
            raise AttributeError(attr)
        self._check_attr(attr)
        total = self.totals[attr]
        count = self.counts[attr]
        return total / count if count else 0.0

    def _check_attr(self, attr: str) -> None:
        if attr not in self.totals or attr not in self.counts:
            raise AttributeError(attr)


def get_ckpt_path(model_dir: PathLike, split_path: PathLike,
                  split_index: int) -> Path:
    """{model_dir}/checkpoint/{split_file}.{idx}.pt"""
    return (Path(model_dir) / "checkpoint"
            / f"{Path(split_path).name}.{split_index}.pt")


def load_yaml(path: PathLike) -> Any:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
