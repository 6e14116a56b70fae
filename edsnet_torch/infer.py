"""Inference CLI: raw MP4 -> features -> KTS -> predict -> summary video.

Counterpart of edsnet_tpu/infer.py (reference: `src/infer.py`, whose HEAD
misses the feature_extractor argument, given here by
``--feature-extractor``).  The frame CNN, KTS under ``--device-kts`` and
the model run on ``--device``; decode and the mp4 write are host code
(cv2).  The checkpoint is a port ``.pt`` or a flax msgpack written by
edsnet_tpu (utils/checkpoint.py).  A motion model (``--model-depth
cross-attention``) reads ``--motion-feature`` (.npy, one row per sampled
frame) or extracts with ``--motion-backend``.

    python -m edsnet_torch.infer anchor-based --ckpt-path CKPT \
        --source VIDEO.mp4 --save-path SUMMARY.mp4 [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from edsnet_torch import config as config_lib
from edsnet_torch.data.video import VideoPreprocessor
from edsnet_torch.evaluate import setup
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.ops import summary as summ_ops
from edsnet_torch.parallel.eval_device import (_device_of, _num_scales_of,
                                               checkpoint_motion_width,
                                               model_needs_motion,
                                               predict_nms)
from edsnet_torch.utils import checkpoint as ckpt_lib


def kept_boxes(model, seq: np.ndarray, nms_thresh: float,
               bucket_size: int = 64, motion: np.ndarray | None = None):
    """Predict and NMS one video on the model's device -> its kept
    (scores [K], int boxes [K, 2]) on the host, highest score first.

    The sequence is padded to max(bucket, ceil(n / bucket) * bucket)
    positions and goes through the evaluators' ``predict_nms``;
    ``motion`` (aligned [seq_len, D] rows) is required iff the model reads
    motion features.  The order is JAX's, ``argsort(kind="stable")[::-1]``,
    which puts tied scores in reverse index order.
    """
    device = _device_of(model)
    seq_len = len(seq)
    blen = max(bucket_size, -(-seq_len // bucket_size) * bucket_size)
    x = np.zeros((1, blen, seq.shape[-1]), np.float32)
    x[0, :seq_len] = seq
    mask = torch.from_numpy(np.arange(blen) < seq_len)[None].to(device)

    motion_t = motion_mask = None
    if motion is not None:
        m = np.zeros((1, blen, motion.shape[-1]), np.float32)
        m[0, :seq_len] = motion[:seq_len]
        motion_t, motion_mask = torch.from_numpy(m).to(device), mask

    pred_cls, boxes, keeps = predict_nms(
        model, torch.from_numpy(x).to(device), mask,
        torch.tensor([seq_len], dtype=torch.int32, device=device),
        _num_scales_of(model), nms_thresh, motion_t, motion_mask)
    pred_cls = pred_cls.cpu().numpy()[0]
    boxes = boxes.cpu().numpy()[0]
    keep_idx = np.where(keeps.cpu().numpy()[0])[0]
    keep_idx = keep_idx[np.argsort(pred_cls[keep_idx], kind="stable")[::-1]]
    return pred_cls[keep_idx], boxes[keep_idx].round().astype(np.int32)


def summarize_video(model, seq: np.ndarray, cps, n_frames, nfps, picks,
                    nms_thresh: float, bucket_size: int = 64,
                    motion: np.ndarray | None = None) -> np.ndarray:
    """features -> binary frame summary (infer and the tests share it):
    ``kept_boxes``, then ``bbox2summary`` on the host."""
    scores, boxes = kept_boxes(model, seq, nms_thresh, bucket_size, motion)
    return summ_ops.bbox2summary(len(seq), scores, boxes, cps, n_frames,
                                 nfps, picks)


def _load_motion(args, seq_len: int, width: int) -> np.ndarray:
    """Load (``--motion-feature`` .npy) or extract (``--motion-backend``,
    the conv3d net on ``--device``) motion features and check them against
    the loaded checkpoint: its width, and one row per sampled frame, with
    a surplus of up to 2 rows tolerated (codecs can report a few more
    frames than cv2 decodes)."""
    if args.motion_feature:
        motion = np.load(args.motion_feature).astype(np.float32)
        source = args.motion_feature
    else:
        from edsnet_torch.data.motion import extract_motion_features
        if width != 1024:
            raise ValueError(
                f"the checkpoint's cross-attention expects {width}-wide "
                f"motion features but the on-the-fly "
                f"{args.motion_backend} extractor emits 1024 — pass a "
                f"--motion-feature .npy of the right width")
        print(f"Extracting motion features ({args.motion_backend}) ...")
        motion = extract_motion_features(
            args.source, sample_rate=args.sample_rate,
            backend=args.motion_backend,
            device=getattr(args, "device", "auto"))
        source = f"--motion-backend {args.motion_backend}"
    if motion.ndim != 2 or motion.shape[-1] != width:
        raise ValueError(
            f"motion features from {source} have shape "
            f"{tuple(motion.shape)} but the checkpoint's cross-attention "
            f"expects width {width}")
    if not seq_len <= len(motion) <= seq_len + 2:
        raise ValueError(
            f"motion features cover {len(motion)} sampled frames but the "
            f"video has {seq_len} — regenerate the .npy at "
            f"--sample-rate {args.sample_rate}")
    return motion[:seq_len]


def write_summary_video(source: str, save_path: str,
                        pred_summ: np.ndarray) -> None:
    """Copy the frames the summary keeps into an mp4v file at the
    source's size and frame rate."""
    import cv2

    cap = cv2.VideoCapture(source)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps = cap.get(cv2.CAP_PROP_FPS)

    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    out = cv2.VideoWriter(save_path, fourcc, fps, (width, height))
    frame_idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if frame_idx < len(pred_summ) and pred_summ[frame_idx]:
            out.write(frame)
        frame_idx += 1
    out.release()
    cap.release()


def main(argv=None):
    args = config_lib.get_arguments(argv)
    device = setup(args)

    print("Loading model ...")
    model = get_model(args.model, **vars(args)).to(device).eval()
    needs_motion = model_needs_motion(model)
    if args.motion_feature and not needs_motion:
        raise ValueError(
            "--motion-feature given but the model is not a motion "
            "(cross-attention) model — did you forget "
            "--model-depth cross-attention?")

    print("Preprocessing source video ...")
    video_proc = VideoPreprocessor(args.sample_rate, args.feature_extractor,
                                   device_kts=args.device_kts, device=device)
    n_frames, seq, cps, nfps, picks = video_proc.run(args.source)

    # a motion head takes the checkpoint's motion width
    ckpt_lib.load_checkpoint(model, args.ckpt_path)
    model.eval()
    motion = None
    if needs_motion:
        motion = _load_motion(args, len(seq),
                              checkpoint_motion_width(model.state_dict()))

    print("Predicting summary ...")
    pred_summ = summarize_video(model, seq, cps, n_frames, nfps, picks,
                                args.nms_thresh,
                                bucket_size=args.bucket_size, motion=motion)

    print("Writing summary video ...")
    write_summary_video(args.source, args.save_path, pred_summ)


if __name__ == "__main__":
    main()
