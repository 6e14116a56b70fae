"""Motion-feature extraction for the cross-attention head.

Counterpart of edsnet_tpu/data/motion.py (reference:
`src/motion_feature_extractor/feature_extractor.py`, a TF1 I3D dumper
whose .npy outputs feed the optional ``motion_features`` h5 key of the
motion head).  Two backends, one 1024-d feature per sampled frame over
the clip around it:

- 'conv3d':   ``Conv3DMotionNet``, an inflated 3-D conv stack (the
              structural stand-in for I3D) on a device, with the weights
              of a flax msgpack written by edsnet_tpu (``--weights``) or a
              seeded init of the port's own;
- 'flowdiff': a training-free descriptor (pooled frame-difference
              energy pyramid) on the host, JAX's line for line.

    python -m edsnet_torch.data.motion --video-dir VIDEOS --save-dir OUT \
        [--backend conv3d [--weights NET.msgpack]] [--device cpu]
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edsnet_torch.convert import flax_to_torch_cnn
from edsnet_torch.evaluate import as_device
from edsnet_torch.utils.checkpoint import read_flax_msgpack

WIDTHS = (64, 128, 256, 512)


def _same_pad(x: torch.Tensor, strides) -> torch.Tensor:
    """flax's "SAME" padding of a 3x3x3 conv over the T, H, W of an NCDHW
    ``x``: out = ceil(n / s), total = (out - 1) s + 3 - n, the smaller half
    before (a stride-2 conv on an even side pads 0 before, 1 after)."""
    pads = []
    for n, s in zip(reversed(x.shape[2:]), reversed(strides)):
        total = max((-(-n // s) - 1) * s + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _Conv3DNet(nn.Module):
    """[B, T, H, W, 3] clips -> [B, 1024]: four 3x3x3 convs (widths 64 to
    512, strides (1, 2, 2) then (2, 2, 2)) with ReLU, the mean over T, H
    and W, a Dense head; names and shapes of JAX's flax net (``conv0`` ..
    ``conv3``, ``head``)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, width in enumerate(WIDTHS):
            self.add_module(f"conv{i}", nn.Conv3d(
                cin, width, 3, stride=(1 if i == 0 else 2, 2, 2)))
            cin = width
        self.head = nn.Linear(cin, 1024)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default init, drawn from ``generator``: kernels
        truncated normal (cut at 2 sigma) of variance 1 / fan_in, zero
        biases."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                    continue
                std = (math.sqrt(1.0 / math.prod(p.shape[1:]))
                       / 0.87962566103423978)
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)
        for i in range(len(WIDTHS)):
            conv = getattr(self, f"conv{i}")
            x = F.relu(conv(_same_pad(x, conv.stride)))
        return self.head(x.mean(dim=(2, 3, 4)))


class Conv3DMotionNet:
    """(T, H, W, 3) clip in [0, 1] -> 1024-d L2-normalised feature, on
    ``device`` (None: the card, and a raise without one).

    ``weights``: a flax msgpack of JAX's net (its ``--weights``), read
    through the weight bridge.  Without it the net draws flax's default
    init from a torch generator seeded with ``seed``: JAX's PRNG stream
    cannot be reproduced, so the features differ from JAX's weightless
    net (the weights, not the arithmetic)."""

    def __init__(self, weights: Optional[str] = None, seed: int = 0,
                 device=None):
        self.device = as_device(device)
        net = _Conv3DNet()
        if weights:
            net.load_state_dict(flax_to_torch_cnn(
                "conv3d", read_flax_msgpack(Path(weights).read_bytes())),
                strict=True)
        else:
            net.init_weights(torch.Generator().manual_seed(seed))
        self.net = net.to(self.device).eval()

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(clip[None], np.float32))
        with torch.inference_mode():
            feat = self.net(x.to(self.device))[0].cpu().numpy()
        return feat / (np.linalg.norm(feat) + 1e-10)


class FlowDiffMotion:
    """Training-free motion descriptor: multi-scale pooled |frame diff|."""

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        import cv2
        diffs = np.abs(np.diff(clip.astype(np.float32), axis=0)).mean(-1)
        feats = []
        for scale in (4, 8, 16):
            pooled = np.stack([
                cv2.resize(d, (scale, scale)) for d in diffs]).mean(0)
            feats.append(pooled.reshape(-1))
        feat = np.concatenate(feats)
        out = np.zeros(1024, np.float32)
        out[:feat.size] = feat[:1024]
        return out / (np.linalg.norm(out) + 1e-10)


def make_motion_net(backend: str = "flowdiff",
                    weights: Optional[str] = None, device=None):
    """Construct the backend once and reuse it across videos; ``device``
    is the conv3d net's."""
    return (Conv3DMotionNet(weights, device=device) if backend == "conv3d"
            else FlowDiffMotion())


def extract_motion_features(video_path, clip_len: int = 8,
                            sample_rate: int = 15, backend: str = "flowdiff",
                            weights: Optional[str] = None,
                            net=None, device=None) -> np.ndarray:
    """mp4 -> [num_picks, 1024] motion features, one per sampled frame,
    computed over the clip around it.

    Streams the decode: only a clip-sized window of frames is resident.
    ``net`` reuses a ``make_motion_net`` instance across videos.
    """
    import cv2

    if net is None:
        net = make_motion_net(backend, weights, device)

    cap = cv2.VideoCapture(str(video_path))
    assert cap.isOpened(), f"Cannot open video: {video_path}"

    # window[i] holds frame base + i; a clip centred at c covers
    # [max(0, c - clip_len//2), ...clip_len frames), so a centre becomes
    # safe to featurise once its whole clip has been read (or at EOF)
    lo_keep = clip_len // 2           # frames kept behind the next centre
    window: list = []
    base = 0                          # absolute index of window[0]
    feats = []
    next_center = 0

    def emit(center):
        lo = max(0, center - clip_len // 2)
        clip = np.asarray(window[lo - base:lo - base + clip_len])
        if len(clip) < clip_len:
            clip = np.concatenate(
                [clip, np.repeat(clip[-1:], clip_len - len(clip), axis=0)])
        feats.append(net(clip / 255.0))

    read = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        window.append(cv2.resize(frame, (112, 112)))
        read += 1
        while next_center < read and \
                max(0, next_center - clip_len // 2) + clip_len <= read:
            emit(next_center)
            next_center += sample_rate
        # drop frames no future clip reaches (the keep boundary clamped to
        # the frames read: the next centre can lie past the stream
        # position when sample_rate > clip_len)
        keep_from = min(max(0, next_center - lo_keep), read)
        drop = keep_from - base
        if drop > 0:
            del window[:drop]
            base = keep_from
    cap.release()
    # tail centres (clips cut at EOF, padded with the last frame)
    while next_center < read:
        emit(next_center)
        next_center += sample_rate
    return np.asarray(feats, dtype=np.float32)


def main(argv=None):
    import argparse
    import os

    from edsnet_torch.evaluate import set_tf32

    parser = argparse.ArgumentParser()
    parser.add_argument("--video-dir", type=str, required=True)
    parser.add_argument("--save-dir", type=str, required=True)
    parser.add_argument("--sample-rate", type=int, default=15)
    parser.add_argument("--backend", type=str, default="flowdiff",
                        choices=["flowdiff", "conv3d"])
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--device", type=str, default="auto",
                        choices=("auto", "gpu", "cpu"),
                        help="the conv3d net's device (auto and gpu: the "
                             "CUDA card, raising without one)")
    args = parser.parse_args(argv)

    set_tf32(False)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    net = make_motion_net(args.backend, args.weights, args.device)
    for name in sorted(os.listdir(args.video_dir)):
        if not name.endswith(".mp4"):
            continue
        feats = extract_motion_features(
            Path(args.video_dir) / name, sample_rate=args.sample_rate,
            net=net)
        out = save_dir / (name.rsplit(".", 1)[0] + ".npy")
        np.save(out, feats)
        print(f"{name}: {feats.shape} -> {out}")


if __name__ == "__main__":
    main()
