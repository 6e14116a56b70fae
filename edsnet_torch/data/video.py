"""Video preprocessing: frame decode (host), CNN features (device), KTS shots.

Counterpart of edsnet_tpu/data/video.py (reference:
`src/helpers/video_helper.py`).  Decode stays on the host (cv2, imported
inside the functions that read a video).  The frame features are 1024-d
and L2-normalised per frame (video_helper.py:27-73): GoogLeNet pool5 (the
default), Swin-V2-B or ConvNeXt-Base, each the port's own module
(models/googlenet.py, swin.py, convnext.py) on an explicit device, with
torchvision's checkpoint read from the torch hub cache
(``fetch_weights.cached_path``); without a cached file, torchvision's own
network if torchvision imports, else a ``RuntimeError`` naming
``python -m edsnet_torch.fetch_weights``.  ``random`` is the deterministic
test extractor (a seeded projection of downsampled pixels).

Where JAX runs the CNN once per sampled frame, ``get_features`` hands it
the sampled frames in chunks of ``CHUNK`` (at most that many frames
resident), preprocessed on the host by ``preprocess_frame``; the features
equal the per-frame route's within float32 rounding.  KTS runs through
``h5io.segment_features``, on the host or, with ``device_kts``, on the
device.
"""
from __future__ import annotations

from os import PathLike
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from edsnet_torch.evaluate import as_device

CHUNK = 32            # sampled frames per CNN batch
FRAME_CNNS = ("google-net", "convnext", "swin-transformer")


def ends_with_mp4(path: PathLike) -> bool:
    return str(path).endswith(".mp4")


def frame_cnn(kind: str) -> Tuple[nn.Module, Tuple[str, ...]]:
    """A frame CNN of ``FRAME_CNNS`` (default init) and the prefixes of its
    torchvision checkpoint's entries outside the features."""
    if kind == "google-net":
        from edsnet_torch.models import googlenet as m
        return m.GoogLeNetPool5(), m.HEAD_PREFIXES
    if kind == "convnext":
        from edsnet_torch.models import convnext as m
        return m.ConvNeXtBaseFeatures(), m.HEAD_PREFIXES
    if kind == "swin-transformer":
        from edsnet_torch.models import swin as m
        return m.SwinV2BFeatures(), m.HEAD_PREFIXES
    raise ValueError(f"Invalid feature extractor {kind}")


def l2_normalize_rows(feat: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm + 1e-10 (video_helper.py:70-73)."""
    return feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
                   + 1e-10)


class _TorchvisionExtractor:
    """torchvision's pretrained network, on ``device``, one frame a call
    (JAX's fallback, unchanged but for the device)."""

    def __init__(self, kind: str, device: torch.device):
        from torchvision import models, transforms

        self.preprocess = transforms.Compose([
            transforms.Resize(256),
            transforms.CenterCrop(224),
            transforms.ToTensor(),
            transforms.Normalize(mean=[0.485, 0.456, 0.406],
                                 std=[0.229, 0.224, 0.225]),
        ])
        if kind == "google-net":
            m = models.googlenet(weights="DEFAULT")
            m = nn.Sequential(*list(m.children())[:-2])
        elif kind == "swin-transformer":
            m = models.swin_v2_b(weights="DEFAULT")
            m = nn.Sequential(*list(m.children())[:-1])
        elif kind == "convnext":
            m = models.convnext_base(weights="DEFAULT")
            m = nn.Sequential(*list(m.children())[:-1])
        else:
            raise ValueError(f"Invalid feature extractor {kind}")
        self.model = m.eval().to(device)
        self.device = device

    def run(self, img: np.ndarray) -> np.ndarray:
        from PIL import Image

        batch = self.preprocess(Image.fromarray(img)).unsqueeze(0)
        with torch.no_grad():
            feat = self.model(batch.to(self.device)).view(-1).cpu().numpy()
        assert feat.shape == (1024,), \
            f"Invalid feature shape {feat.shape}: expected 1024"
        return feat / (np.linalg.norm(feat) + 1e-10)

    def run_batch(self, imgs: List[np.ndarray]) -> np.ndarray:
        return np.stack([self.run(img) for img in imgs])


class FrameCNNExtractor:
    """A frame CNN in eval mode on ``device``: ``preprocess_frame`` on the
    host, the network and the L2 normalisation on the device."""

    def __init__(self, model: nn.Module, device: torch.device):
        self.model = model.to(device).eval()
        self.device = device

    @classmethod
    def from_cache(cls, kind: str, device: torch.device
                   ) -> "FrameCNNExtractor":
        """The network of ``kind`` with torchvision's cached checkpoint,
        read with ``weights_only=True`` and loaded strictly once the
        entries outside the features are dropped; FileNotFoundError when
        nothing is cached."""
        from edsnet_torch.fetch_weights import cached_path

        path = cached_path(kind)
        if not path.exists():
            raise FileNotFoundError(
                f"no cached {kind} weights at {path}; run "
                f"`python -m edsnet_torch.fetch_weights --models {kind}` "
                f"first")
        state = torch.load(path, map_location="cpu", weights_only=True)
        model, head = frame_cnn(kind)
        model.load_state_dict({k: v for k, v in state.items()
                               if k.split(".", 1)[0] not in head},
                              strict=True)
        return cls(model, device)

    @torch.inference_mode()
    def features(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] preprocessed frames (any device) -> [N, 1024]
        L2-normalised features on the device, ``CHUNK`` frames a
        forward."""
        out = [self.model(frames[i:i + CHUNK].to(self.device))
               for i in range(0, len(frames), CHUNK)]
        return l2_normalize_rows(torch.cat(out))

    def run_batch(self, imgs: List[np.ndarray]) -> np.ndarray:
        """RGB uint8 HWC frames -> [N, 1024] float32."""
        from edsnet_torch.models.googlenet import preprocess_frame

        x = np.stack([preprocess_frame(img) for img in imgs])
        frames = torch.from_numpy(x).permute(0, 3, 1, 2)
        return self.features(frames).cpu().numpy()

    def run(self, img: np.ndarray) -> np.ndarray:
        return self.run_batch([img])[0]


class _RandomProjectionExtractor:
    """Deterministic test extractor: 1024-d projection of 32x32 grayscale."""

    def __init__(self, dim: int = 1024, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.proj = rng.randn(32 * 32, dim).astype(np.float32) / 32.0
        self.dim = dim

    def run(self, img: np.ndarray) -> np.ndarray:
        import cv2
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        small = cv2.resize(gray, (32, 32)).astype(np.float32) / 255.0
        feat = small.reshape(-1) @ self.proj
        return feat / (np.linalg.norm(feat) + 1e-10)

    def run_batch(self, imgs: List[np.ndarray]) -> np.ndarray:
        return np.stack([self.run(img) for img in imgs])


class FeatureExtractor:
    """1024-d per-frame features, L2-normalised (video_helper.py:27-73), on
    ``device`` (None: the card, and a raise without one)."""

    def __init__(self, feature_extractor: str = "google-net",
                 device=None):
        if feature_extractor == "random":
            self._impl = _RandomProjectionExtractor()
            return
        device = as_device(device)
        if feature_extractor in FRAME_CNNS:
            # the port's network from the cached checkpoint; without one,
            # torchvision or the RuntimeError below
            try:
                self._impl = FrameCNNExtractor.from_cache(feature_extractor,
                                                          device)
                return
            except FileNotFoundError:
                pass
        try:
            self._impl = _TorchvisionExtractor(feature_extractor, device)
        except ImportError as e:
            raise RuntimeError(
                "torchvision is required for pretrained frame-feature "
                "extraction but is not installed in this environment. "
                "Either run `python -m edsnet_torch.fetch_weights` to cache "
                "GoogLeNet weights for the device-side extractor, use "
                "pre-extracted features (the eccv16 h5 datasets), or pass "
                "feature_extractor='random' for plumbing tests.") from e

    def run(self, img: np.ndarray) -> np.ndarray:
        return self._impl.run(img)

    def run_batch(self, imgs: List[np.ndarray]) -> np.ndarray:
        return self._impl.run_batch(imgs)


class VideoPreprocessor:
    """mp4 -> (n_frames, features, change_points, nfps, picks)
    (video_helper.py:76-131), the CNN and, with ``device_kts``, the KTS DP
    on ``device`` (None: the card, and a raise without one)."""

    def __init__(self, sample_rate: int,
                 feature_extractor: str = "google-net",
                 device_kts: bool = False, device=None):
        self.device = as_device(device)
        self.model = FeatureExtractor(feature_extractor, self.device)
        self.sample_rate = sample_rate
        self.device_kts = device_kts

    def get_features(self, video_path: PathLike) -> Tuple[int, np.ndarray]:
        import cv2
        video_path = Path(video_path)
        cap = cv2.VideoCapture(str(video_path))
        assert cap is not None and cap.isOpened(), \
            f"Cannot open video: {video_path}"

        features, chunk = [], []
        n_frames = 0
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            if n_frames % self.sample_rate == 0:
                chunk.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                if len(chunk) == CHUNK:
                    features.append(self.model.run_batch(chunk))
                    chunk = []
            n_frames += 1
        cap.release()
        if chunk:
            features.append(self.model.run_batch(chunk))
        if not features:
            return n_frames, np.zeros((0,), np.float32)
        return n_frames, np.concatenate(features).astype(np.float32)

    def kts(self, n_frames: int, features: np.ndarray):
        """Linear-kernel KTS segmentation (video_helper.py:109-126)."""
        from edsnet_torch.data import h5io
        return h5io.segment_features(
            features, self.sample_rate, n_frames,
            device=self.device if self.device_kts else None)

    def run(self, video_path: PathLike):
        n_frames, features = self.get_features(video_path)
        cps, nfps, picks = self.kts(n_frames, features)
        return n_frames, features, cps, nfps, picks
