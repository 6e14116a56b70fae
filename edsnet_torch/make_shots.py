"""Shot regeneration tool: recompute the KTS segmentation of an h5 dataset.

Counterpart of edsnet_tpu/make_shots.py: the output file is
``<dataset>.custom``, n_frames is ``seq_len * rate - 1``, and gtsummary /
user_summary are carried over when present.  ``--device-kts`` runs the
segmentation (scatter matrix, DP, model selection, backtrack) on the CUDA
card, and raises without one.

    python -m edsnet_torch.make_shots --dataset DATA.h5 [--device-kts]
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from edsnet_torch.data import h5io


def regenerate_shots(in_path: str, out_path: str, sample_rate: int,
                     device: Optional[torch.device | str] = None) -> int:
    """Rewrite every video group with freshly computed shots (KTS on
    ``device``, or on the host when None) -> the number of videos."""
    import h5py

    count = 0
    with h5py.File(in_path, "r") as src, h5py.File(out_path, "w") as dst:
        for name, group in src.items():
            features = group["features"][...].astype(np.float32)
            gtscore = group["gtscore"][...].astype(np.float32)
            n_frames = gtscore.size * sample_rate - 1
            cps, nfps, picks = h5io.segment_features(
                features, sample_rate, n_frames, device=device)

            fields = {
                "features": features,
                "gtscore": gtscore,
                "change_points": cps,
                "n_frame_per_seg": nfps,
                "n_frames": n_frames,
                "picks": picks,
            }
            fields.update(h5io.copy_optional(
                group, ("gtsummary", "user_summary")))
            h5io.write_group(dst, name, fields)
            count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Recompute KTS shots for every video in an h5 dataset")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--sample-rate", type=int, default=15)
    parser.add_argument("--device-kts", action="store_true",
                        help="run the KTS DP on the CUDA card")
    args = parser.parse_args(argv)

    device = None
    if args.device_kts:
        from edsnet_torch.evaluate import resolve_device
        device = resolve_device("gpu")
    out_path = args.dataset + ".custom"
    n = regenerate_shots(args.dataset, out_path, args.sample_rate,
                         device=device)
    print(f"Re-segmented {n} videos -> {out_path}")


if __name__ == "__main__":
    main()
