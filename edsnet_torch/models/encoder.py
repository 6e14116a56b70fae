"""The motion head's encoders: the classic one (backbone, residual, fc)
and the local-global one (a global attention plus one local attention per
contiguous segment of each video).

Counterpart of edsnet_tpu/models/encoder.py:ClassicEncoder, MultiAttention
and LocalGlobalEncoder.  Submodule names follow the flax param tree so the
weight bridge (convert.py) maps names one to one.

The tracer (utils/profiling.py) sees ``MultiAttention.forward`` as the
span ``lg/encoder`` and its segment loop as ``lg/local``, with the
counters ``MultiAttention`` describes, in every head built on it: the
anchor-based and anchor-free local-global heads and the motion head's
local-global encoder.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.base import build_base_model
from edsnet_torch.models.common import LayerNorm, Linear, l2_normalize
from edsnet_torch.utils.profiling import count, count_nonzero, span


class ClassicEncoder(nn.Module):
    """fc1(x + base_model(x)): the reference's intent (its forward reads
    ``out`` before assigning it), as in JAX."""

    def __init__(self, base_model: str, num_feature: int, num_head: int,
                 orientation: str = "paper",
                 use_pallas: Optional[bool] = None):
        super().__init__()
        self.base_model = build_base_model(base_model, num_feature, num_head,
                                           use_pallas, orientation)
        self.fc1 = Linear(num_feature, num_feature)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self.fc1(x + self.base_model(x, mask))


def _true_lengths(x: torch.Tensor, mask: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """Each video's length [B] int64: its mask's count, or N without a
    mask."""
    if mask is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                          device=x.device)
    return mask.to(torch.int64).sum(dim=-1)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, F] at per-row positions idx [B, M] -> [B, M, F]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class MultiAttention(nn.Module):
    """relu(fc(global_attention(x))), and inside each of ``num_segments``
    contiguous segments of each video the sum of its L2-normalised rows
    and the L2-normalised relu(fc(local_attention_{s}(segment))).  One
    ``fc`` serves the global path and every local one.

    The segments follow each video's true length, ceil(n / num_segments)
    positions each (the last shorter or empty), not the bucket's.  Each
    video's segment s is gathered into a buffer of ceil(N / num_segments)
    positions starting at 0 (zero past the segment, masked), run through
    ``local_attention_{s}``, and scattered back, so every backbone sees
    the slice the reference gives it.  A buffer with no real position (an
    all-padding row, or a segment past a short video's end) has every key
    masked; its output is finite and never scattered back.

    With the tracer on, a forward adds B x ``num_segments`` to
    ``lg.segments``, B x ``num_segments`` x the buffer's length to
    ``lg.slots``, and the device count of the real positions in the
    buffers to ``lg.valid``.  A forward replayed from CUDA graphs
    (``models/graphed.py``) runs no Python here: its capture notes the
    three counts, tracer on or off, and each replay adds them (the last
    a count over the buffers' masks the replay recomputed), so the three
    count every forward, replayed or not."""

    def __init__(self, num_feature: int, base_model: str,
                 orientation: str = "paper", num_segments: int = 5,
                 num_head: int = 8, local_attention_head: int = 4,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        if num_segments < 2:
            raise ValueError(f"num_segments must be >= 2, not {num_segments}")
        self.num_segments = num_segments
        self.fc = Linear(num_feature, num_feature)
        self.global_attention = build_base_model(
            base_model, num_feature, num_head, use_pallas, orientation)
        for seg in range(num_segments):
            self.add_module(f"local_attention_{seg}", build_base_model(
                base_model, num_feature, local_attention_head, use_pallas,
                orientation))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        with span("lg/encoder"):
            return self._forward(x, mask)

    def _forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
        weighted = torch.relu(self.fc(self.global_attention(x, mask)))
        b, n, _ = x.shape
        n_seg = self.num_segments
        lengths = _true_lengths(x, mask)
        seg_size = -torch.div(-lengths, n_seg, rounding_mode="floor")
        buf = -(-n // n_seg)                  # the buffer, the same for all
        count("lg.segments", b * n_seg)
        count("lg.slots", b * n_seg * buf)
        t = torch.arange(buf, device=x.device)
        pos = torch.arange(n, device=x.device)
        normed = l2_normalize(weighted)
        out = weighted
        with span("lg/local"):
            for seg in range(n_seg):
                start = seg * seg_size                               # [B]
                end = torch.minimum((seg + 1) * seg_size, lengths)
                idx = start[:, None] + t[None, :]                    # [B, buf]
                seg_valid = idx < end[:, None]
                count_nonzero("lg.valid", seg_valid)
                seg_x = _take_rows(x, torch.clamp(idx, 0, n - 1))
                seg_x = seg_x * seg_valid[..., None].to(x.dtype)
                local = getattr(self, f"local_attention_{seg}")(seg_x,
                                                                seg_valid)
                local_w = torch.relu(self.fc(local))
                # scatter back: position j of the video is slot j - start
                rel = pos[None, :] - start[:, None]                  # [B, n]
                in_seg = (rel >= 0) & (pos[None, :] < end[:, None])
                back = _take_rows(local_w, torch.clamp(rel, 0, buf - 1))
                out = torch.where(in_seg[..., None],
                                  normed + l2_normalize(back), out)
        return out


class LocalGlobalEncoder(nn.Module):
    """relu(fc(LayerNorm(MultiAttention(x))))."""

    def __init__(self, base_model: str, orientation: str, num_feature: int,
                 num_head: int, num_segments: int, local_attention_head: int,
                 use_pallas: Optional[bool] = None):
        super().__init__()
        self.multi_attention = MultiAttention(
            num_feature, base_model, orientation, num_segments, num_head,
            local_attention_head, use_pallas)
        self.layer_norm = LayerNorm(num_feature)
        self.fc = Linear(num_feature, num_feature)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = self.layer_norm(self.multi_attention(x, mask))
        return torch.relu(self.fc(h))
