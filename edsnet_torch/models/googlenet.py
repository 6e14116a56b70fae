"""GoogLeNet pool5, the default frame-feature CNN.

Counterpart of edsnet_tpu/models/googlenet.py.  The reference extracts
1024-d pool5 features with torchvision's GoogLeNet minus its last two
children, dropout and fc (`src/helpers/video_helper.py:36-45`), which also
skips torchvision's ``transform_input``.  This module is that network in
NCHW with torchvision's structure and ``state_dict`` names
(``conv1.conv.weight``, ``inception3a.branch2.0.bn.running_mean``, ...), so
the released checkpoint loads with ``strict=True`` once its ``aux1.*``,
``aux2.*`` and ``fc.*`` entries (``HEAD_PREFIXES``) are dropped.

torchvision's choices, which its weights assume: every conv is
``Conv2d(bias=False)``, ``BatchNorm2d(eps=1e-3)`` (eval mode), ReLU; the
"5x5" inception branch uses a 3x3 kernel; the max pools use
``ceil_mode=True`` (what JAX's ``_max_pool_ceil`` emulates); the output is
the mean over H and W -> [B, 1024].

``preprocess_frame`` is JAX's, line for line (PIL imported inside it).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (in, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) per block,
# torchvision's GoogLeNet constructor arguments
INCEPTION_CFG = {
    "inception3a": (192, 64, 96, 128, 16, 32, 32),
    "inception3b": (256, 128, 128, 192, 32, 96, 64),
    "inception4a": (480, 192, 96, 208, 16, 48, 64),
    "inception4b": (512, 160, 112, 224, 24, 64, 64),
    "inception4c": (512, 128, 128, 256, 24, 64, 64),
    "inception4d": (512, 112, 144, 288, 32, 64, 64),
    "inception4e": (528, 256, 160, 320, 32, 128, 128),
    "inception5a": (832, 256, 160, 320, 32, 128, 128),
    "inception5b": (832, 384, 192, 384, 48, 128, 128),
}
# checkpoint entries outside pool5 (the auxiliary classifiers, the fc)
HEAD_PREFIXES = ("aux1", "aux2", "fc")

# torchvision's ImageNet preprocessing constants (video_helper.py:29-34)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class BasicConv2d(nn.Module):
    """torchvision BasicConv2d: conv (no bias), BN (eps 1e-3), ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class Inception(nn.Module):
    """torchvision Inception block (the "5x5" branch is 3x3)."""

    def __init__(self, cin, c1, c3r, c3, c5r, c5, pool_proj):
        super().__init__()
        self.branch1 = BasicConv2d(cin, c1)
        self.branch2 = nn.Sequential(BasicConv2d(cin, c3r),
                                     BasicConv2d(c3r, c3, 3, padding=1))
        self.branch3 = nn.Sequential(BasicConv2d(cin, c5r),
                                     BasicConv2d(c5r, c5, 3, padding=1))
        self.branch4 = nn.Sequential(
            nn.MaxPool2d(3, stride=1, padding=1, ceil_mode=True),
            BasicConv2d(cin, pool_proj))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4(x)], dim=1)


class GoogLeNetPool5(nn.Module):
    """[B, 3, H, W] normalised NCHW -> [B, 1024] pool5 features."""

    def __init__(self):
        super().__init__()
        self.conv1 = BasicConv2d(3, 64, 7, stride=2, padding=3)
        self.maxpool1 = nn.MaxPool2d(3, stride=2, ceil_mode=True)
        self.conv2 = BasicConv2d(64, 64)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        self.maxpool2 = nn.MaxPool2d(3, stride=2, ceil_mode=True)
        self.inception3a = Inception(*INCEPTION_CFG["inception3a"])
        self.inception3b = Inception(*INCEPTION_CFG["inception3b"])
        self.maxpool3 = nn.MaxPool2d(3, stride=2, ceil_mode=True)
        self.inception4a = Inception(*INCEPTION_CFG["inception4a"])
        self.inception4b = Inception(*INCEPTION_CFG["inception4b"])
        self.inception4c = Inception(*INCEPTION_CFG["inception4c"])
        self.inception4d = Inception(*INCEPTION_CFG["inception4d"])
        self.inception4e = Inception(*INCEPTION_CFG["inception4e"])
        self.maxpool4 = nn.MaxPool2d(2, stride=2, ceil_mode=True)
        self.inception5a = Inception(*INCEPTION_CFG["inception5a"])
        self.inception5b = Inception(*INCEPTION_CFG["inception5b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x.mean(dim=(2, 3))   # adaptive average pool to 1x1


def preprocess_frame(img: np.ndarray) -> np.ndarray:
    """RGB uint8 HWC frame -> (224, 224, 3) normalised float32 (HWC).

    The reference's transform stack (video_helper.py:29-34): PIL bilinear
    resize of the short edge to 256, centre crop 224, scale to [0, 1],
    ImageNet mean / std.
    """
    from PIL import Image

    pil = Image.fromarray(img)
    w, h = pil.size
    # torchvision semantics: short edge -> 256, long edge truncated
    if w < h:
        nw, nh = 256, int(h * 256 / w)
    else:
        nw, nh = int(w * 256 / h), 256
    pil = pil.resize((nw, nh), Image.BILINEAR)
    # torchvision's centre crop rounds the offsets
    left = int(round((nw - 224) / 2.0))
    top = int(round((nh - 224) / 2.0))
    arr = np.asarray(pil.crop((left, top, left + 224, top + 224)),
                     dtype=np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD
