"""Custom-dataset tool: mp4 videos + user-summary JSONs -> eccv16 h5.

Counterpart of edsnet_tpu/make_dataset.py (reference: `src/make_dataset.py`),
with its flags plus ``--device``: per video, decode, frame features and KTS
(data/video.py:VideoPreprocessor, the CNN on the device), paired with
``<name>.json {"user_summary": UxF}``; a length mismatch under
``TRIM_TOLERANCE`` frames is trimmed and the video kept; gtscore is the
users' mean at every sample-rate-th frame; a ``<name>.npy`` motion dump of
``--motion-feature`` is merged as ``motion_features``.  h5py is imported
inside ``build_dataset``.

    python -m edsnet_torch.make_dataset --video-dir VIDEOS --label-dir LABELS \
        --save-path OUT.h5 [--feature-extractor google-net] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from edsnet_torch.data import h5io
from edsnet_torch.data.video import VideoPreprocessor

TRIM_TOLERANCE = 5  # frames (make_dataset.py:63-74)


def find_sources(video_dir: str, motion_dir: Optional[str]
                 ) -> List[Tuple[Path, Optional[Path]]]:
    """Pair each .mp4 with its .npy motion dump by file stem, so that one
    missing dump stays local to its video."""
    videos = sorted(Path(video_dir).glob("*.mp4"))
    if motion_dir is None:
        return [(v, None) for v in videos]
    paired: List[Tuple[Path, Optional[Path]]] = []
    for v in videos:
        m = Path(motion_dir) / f"{v.stem}.npy"
        if not m.exists():
            print(f"{v.name}: no motion features at {m}; "
                  f"writing without motion_features")
            paired.append((v, None))
        else:
            paired.append((v, m))
    return paired


def load_user_summary(label_dir: str, video_name: str
                      ) -> Optional[np.ndarray]:
    label_path = Path(label_dir) / f"{video_name}.json"
    if not label_path.exists():
        print(f"{video_name}: no label json at {label_path}; skipping")
        return None
    with open(label_path) as f:
        payload = json.load(f)
    return np.asarray(payload["user_summary"], dtype=np.float32)


def reconcile(n_frames, features, picks, cps, nfps, user_summary):
    """Align the decoded frame count with the label's -> the adjusted
    tuple, or None when the gap reaches the tolerance."""
    label_frames = user_summary.shape[1]
    gap = n_frames - label_frames
    if gap == 0:
        return n_frames, features, picks, cps, nfps, user_summary
    if abs(gap) >= TRIM_TOLERANCE:
        print(f"label has {label_frames} frames but video has {n_frames} "
              f"(gap {gap}); skipping")
        return None

    print(f"trimming to min({n_frames}, {label_frames}) frames")
    if gap > 0:          # video longer: drop trailing features / shots
        n_frames = label_frames
        keep = picks < n_frames
        features, picks = features[keep], picks[keep]
        cps = np.clip(cps, 0, n_frames - 1)
        nfps = cps[:, 1] - cps[:, 0] + 1
    else:                # label longer: crop the annotation
        user_summary = user_summary[:, :n_frames]
    return n_frames, features, picks, cps, nfps, user_summary


def build_dataset(args) -> int:
    import h5py

    preproc = VideoPreprocessor(args.sample_rate, args.feature_extractor,
                                device_kts=getattr(args, "device_kts",
                                                   False),
                                device=getattr(args, "device", "auto"))
    sources = find_sources(args.video_dir, args.motion_feature)
    print(f"Building {args.save_path} from {len(sources)} videos")

    written = 0
    Path(args.save_path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(args.save_path, "w") as out:
        for video_path, motion_path in sources:
            name = video_path.stem
            print(f"[{written + 1}/{len(sources)}] {name}")
            user_summary = load_user_summary(args.label_dir, name)
            if user_summary is None:
                continue

            n_frames, features, cps, nfps, picks = preproc.run(video_path)
            adjusted = reconcile(n_frames, features, picks, cps, nfps,
                                 user_summary)
            if adjusted is None:
                continue
            n_frames, features, picks, cps, nfps, user_summary = adjusted

            gtscore = user_summary[:, ::args.sample_rate].mean(axis=0)
            fields = {
                "features": features,
                "gtscore": gtscore[:len(picks)],
                "user_summary": user_summary,
                "change_points": cps,
                "n_frame_per_seg": nfps,
                "n_frames": n_frames,
                "picks": picks,
                "video_name": name,
            }
            if motion_path is not None:
                motion = np.load(motion_path)
                # two dump conventions: data/motion.py writes one row per
                # sampled frame (len == picks), the reference's I3D dumps
                # one per frame, which takes the stride; dispatched on the
                # length, since striding a sampled dump would misalign it
                if len(motion) >= n_frames:
                    motion = motion[::args.sample_rate]
                elif len(motion) < len(picks):
                    raise ValueError(
                        f"{name}: motion dump has {len(motion)} rows for "
                        f"{len(picks)} sampled frames of a {n_frames}-"
                        f"frame video — wrong --sample-rate?")
                fields["motion_features"] = motion[:len(picks)]
            h5io.write_group(out, name, fields)
            written += 1

    print(f"Wrote {written} videos -> {args.save_path}")
    return written


def main(argv=None):
    from edsnet_torch.evaluate import set_tf32

    parser = argparse.ArgumentParser(
        description="Build an eccv16-format h5 from videos + labels")
    parser.add_argument("--video-dir", type=str,
                        default="../custom_data/videos/")
    parser.add_argument("--label-dir", type=str,
                        default="../custom_data/labels/")
    parser.add_argument("--sample-rate", type=int, default=15)
    parser.add_argument("--save-path", type=str,
                        default="../custom_data/custom_dataset.h5")
    parser.add_argument("--feature-extractor", type=str,
                        default="google-net",
                        choices=["google-net", "swin-transformer",
                                 "convnext", "random"])
    parser.add_argument("--motion-feature", type=str, default=None)
    parser.add_argument("--device-kts", action="store_true",
                        help="run the KTS DP on the device")
    parser.add_argument("--device", type=str, default="auto",
                        choices=("auto", "gpu", "cpu"),
                        help="the frame CNN's and the KTS DP's device "
                             "(auto and gpu: the CUDA card, raising "
                             "without one)")
    args = parser.parse_args(argv)
    set_tf32(False)
    build_dataset(args)


if __name__ == "__main__":
    main()
