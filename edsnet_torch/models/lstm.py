"""LSTM / BiLSTM backbones.

Counterpart of edsnet_tpu/models/lstm.py (``LSTMExtractor``,
``BiLSTMExtractor``): lstm maps F -> F, bilstm runs F/2 per direction and
concatenates [forward, backward].  Each direction is one unidirectional
``nn.LSTM`` named after the flax cell it holds (``OptimizedLSTMCell_0``,
``OptimizedLSTMCell_1`` for bilstm's backward direction).

Masking, without packing and without a host sync: the forward direction
runs over the padded rows as they are, since its outputs at real positions
depend on earlier positions only; the backward direction reverses each row
within its true length with a gather (index len-1-t for t < len, else t),
runs forward and gathers back.  Outputs at padded steps are zeroed, so a
row of length 0 gives zeros.

Weights: torch stacks the gates i, f, g, o, so ``weight_ih_l0`` is the
flax input kernels [ii; if; ig; io] transposed, ``weight_hh_l0`` the hidden
kernels likewise and ``bias_hh_l0`` their biases.  The flax cell has no
input bias: ``bias_ih_l0`` is held at zero and frozen (``requires_grad``
off), so the optimizer never moves it.

Dtypes as in JAX, where the carry starts in float32 whatever the
parameters' dtype: the recurrence runs in at least float32 on the
parameters as given (bfloat16-rounded under ``--compute-dtype
bfloat16``), and the block returns float32 there.  On a CUDA device cuDNN
runs it, with TF32 as ``torch.backends.cudnn.allow_tf32`` says (the CLIs
set it from ``--matmul-precision``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from edsnet_torch.models.common import apply_mask

_WEIGHTS = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def _cell(num_feature: int, hidden: int) -> nn.LSTM:
    cell = nn.LSTM(num_feature, hidden, batch_first=True)
    cell.bias_ih_l0.requires_grad_(False)
    return cell


def init_cell(cell: nn.LSTM, generator: torch.Generator) -> None:
    """flax's OptimizedLSTMCell initializers, drawn from ``generator``:
    lecun-normal (normal truncated at 2 stddev, variance 1 / fan_in) input
    kernels, an orthogonal hidden kernel per gate, zero biases."""
    h = cell.hidden_size
    std = math.sqrt(1.0 / cell.input_size) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(cell.weight_ih_l0, std=std, a=-2 * std,
                              b=2 * std, generator=generator)
        for gate in range(4):
            nn.init.orthogonal_(cell.weight_hh_l0[gate * h:(gate + 1) * h],
                                generator=generator)
        cell.bias_ih_l0.zero_()
        cell.bias_hh_l0.zero_()


def run_cell(cell: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """One direction over x [B, N, F] from a zero carry -> [B, N, H], in
    at least float32."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    weights = [getattr(cell, name).to(dtype) for name in _WEIGHTS]
    h0 = x.new_zeros((1, x.shape[0], cell.hidden_size), dtype=dtype)
    out, _, _ = torch.lstm(x.to(dtype), (h0, h0), weights, True, 1, 0.0,
                           cell.training, False, True)
    return out


def reverse_within(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row b of x [B, N, F] reversed within its first lengths[b]
    positions, the rest in place (its own inverse)."""
    t = torch.arange(x.shape[1], device=x.device)[None, :]
    lens = lengths[:, None]
    idx = torch.where(t < lens, lens - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand_as(x))


class LSTMExtractor(nn.Module):
    """(B, N, F) -> (B, N, hidden) unidirectional LSTM."""

    def __init__(self, num_feature: int, hidden: Optional[int] = None):
        super().__init__()
        self.OptimizedLSTMCell_0 = _cell(num_feature, hidden or num_feature)
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        init_cell(self.OptimizedLSTMCell_0, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return apply_mask(run_cell(self.OptimizedLSTMCell_0, x), mask)


class BiLSTMExtractor(nn.Module):
    """(B, N, F) -> (B, N, F): F/2 per direction, concatenated."""

    def __init__(self, num_feature: int):
        super().__init__()
        if num_feature % 2:
            raise ValueError(f"bilstm needs an even num_feature, got "
                             f"{num_feature} (F/2 per direction "
                             f"concatenated back to F)")
        self.OptimizedLSTMCell_0 = _cell(num_feature, num_feature // 2)
        self.OptimizedLSTMCell_1 = _cell(num_feature, num_feature // 2)
        self.init_leaves(torch.Generator().manual_seed(0))

    def init_leaves(self, generator: torch.Generator) -> None:
        init_cell(self.OptimizedLSTMCell_0, generator)
        init_cell(self.OptimizedLSTMCell_1, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        lengths = (torch.full((b,), n, device=x.device) if mask is None
                   else mask.to(torch.int64).sum(dim=-1))
        fwd = run_cell(self.OptimizedLSTMCell_0, x)
        bwd = reverse_within(run_cell(self.OptimizedLSTMCell_1,
                                      reverse_within(x, lengths)), lengths)
        return apply_mask(torch.cat([fwd, bwd], dim=-1), mask)
