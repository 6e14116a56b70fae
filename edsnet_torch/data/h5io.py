"""Shared h5 and shot-table helpers of the dataset tools.

Counterpart of edsnet_tpu/data/h5io.py: the h5 key enumeration, the group
writer, the KTS boundary -> shot-table conversion (eccv16 convention) and
``segment_features``, which runs KTS on the host (float64, the native DP)
or, given a ``device``, on it (ops/kts.py:cpd_auto_device).  ``h5py`` is
imported inside the functions that open a file.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def dataset_keys(h5_path) -> List[str]:
    """Split-file keys for every video group: '<h5 path>/<video name>'."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        return [str(Path(h5_path) / name) for name in f.keys()]


def write_group(h5file, key: str, fields: Dict[str, np.ndarray]) -> None:
    """Write one video group; skips None values."""
    for name, value in fields.items():
        if value is not None:
            h5file.create_dataset(f"{key}/{name}", data=value)


def shot_table(boundaries: np.ndarray, sample_rate: int,
               n_frames: int) -> Tuple[np.ndarray, np.ndarray]:
    """KTS boundary indices (subsampled domain) -> (change_points [S, 2] as
    inclusive (begin, end - 1) frame pairs, n_frame_per_seg [S])."""
    edges = np.hstack((0, np.asarray(boundaries) * sample_rate, n_frames))
    spans = np.stack((edges[:-1], edges[1:] - 1), axis=1)
    return spans, edges[1:] - edges[:-1]


def segment_features(features: np.ndarray, sample_rate: int,
                     n_frames: Optional[int] = None,
                     device: Optional[torch.device | str] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linear-kernel KTS over frame features -> (cps, nfps, picks), on the
    host, or on ``device`` when one is given; both give the same shots
    within the device path's float32 bound."""
    from edsnet_torch.ops import kts

    seq_len = len(features)
    if n_frames is None:
        n_frames = seq_len * sample_rate - 1
    picks = np.arange(seq_len) * sample_rate
    gram = features @ features.T
    if device is None:
        boundaries, _ = kts.cpd_auto(gram, seq_len - 1, 1)
    else:
        boundaries, _ = kts.cpd_auto_device(gram, seq_len - 1, 1,
                                            device=device)
    cps, nfps = shot_table(boundaries, sample_rate, n_frames)
    return cps, nfps, picks


def copy_optional(src_group, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """Fetch optional float datasets from an h5 group (absent -> skipped)."""
    out = {}
    for name in names:
        if name in src_group:
            out[name] = src_group[name][...].astype(np.float32)
    return out
