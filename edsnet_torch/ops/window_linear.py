"""Windowed linear pooling, the core of the flat / FFT / DWT poolings.

Counterpart of edsnet_tpu/ops/window_linear.py.  Every such pooling is a
linear functional of the sliding window slots w_j(i) = x[r_ij], with
r_ij = max(0, i - s//2 + 1) + j and the slots past min(i + s//2, N - 1)
zero (the reference's windows, clamped to start at 0 and zero-padded at
their end):

- flat fine:   fc(flatten(w))          = sum_j W_j^T w_j
- fft fine:    fc(flatten(Re(FFT(w)))) = sum_j (sum_k cos(2 pi k j / s) W_k)^T w_j
- fft coarse:  mean_k Re(FFT(w))_k     = w_0          (the DC identity)
- dwt fine:    fc(flatten(cA(w)))      = sum_j (W_{j//2} / sqrt(2))^T w_j
- dwt coarse:  mean_k cA_k             = sum_j w_j / (sqrt(2) * s/2)

so each is out[i] = sum_j A_j^T x[r_ij] + b with a fold of the fc weights
per variant: one contraction over the interior, where JAX runs a size-s
1-D convolution (``lax.conv_general_dilated``), and an exact fix-up of the
first s//2 - 1 rows, whose windows the clamp shifts.  Here the contraction
is one matrix product of the s shifted copies of x, side by side ([B, N,
s*H], 57 MB at bucket 2304, s 12, H 128), with the folded [s*H, O]
weights: cuBLAS's product is deterministic, where cuDNN's convolution
weight gradient adds in a varying order (a --remat step then differs from
the plain one in the last bit), and it follows
``torch.backends.cuda.matmul.allow_tf32``, which ``evaluate.setup`` sets
from ``--matmul-precision``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from edsnet_torch.models.common import promote


def fft_weight_fold(w_flat: torch.Tensor, scale: int) -> torch.Tensor:
    """The window FFT folded into the fc weights: W~_j = sum_k
    cos(2 pi k j / s) W_k, the cosine table in the weight's dtype, as JAX
    casts it.  [s*H, O] -> [s, H, O].  The table is made in float64 on the
    weight's device, with no copy from the host: a forward may be captured
    into a CUDA graph (models/graphed.py), where a pageable copy is
    refused."""
    sh, o = w_flat.shape
    w = w_flat.reshape(scale, sh // scale, o)
    k = torch.arange(scale, dtype=torch.float64, device=w.device)
    cos = torch.cos(2 * math.pi * k[:, None] * k[None, :] / scale)
    return torch.einsum("kj,kho->jho", cos.to(w.dtype), w)


def dwt_weight_fold(w_flat: torch.Tensor, scale: int) -> torch.Tensor:
    """The window's Haar cA folded into the fc weights: W~_j = W_{j//2} /
    sqrt(2).  [(s//2)*H, O] -> [s, H, O]."""
    half = scale // 2
    sh, o = w_flat.shape
    w = w_flat.reshape(half, sh // half, o) / math.sqrt(2.0)
    return torch.repeat_interleave(w, 2, dim=0)


def flat_weight_fold(w_flat: torch.Tensor, scale: int) -> torch.Tensor:
    """[s*H, O] -> [s, H, O], slot by slot."""
    sh, o = w_flat.shape
    return w_flat.reshape(scale, sh // scale, o)


def _left_edge(prefix: torch.Tensor, off: int, s: int, n: int
               ) -> torch.Tensor:
    """The first min(off, n) rows of the clamped windows from the prefix
    sums P_m of slot terms m < min(s, n): row i sums the slots up to
    i + s//2, clamped to the sequence (a sequence shorter than the left
    reach, n < off, has only n rows to fix)."""
    last = torch.arange(min(off, n), device=prefix.device) + s // 2
    last = torch.clamp(last, max=min(n, prefix.shape[1]) - 1)
    return prefix[:, last, :]


def windowed_linear(x: torch.Tensor, slot_weights: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = sum_j slot_weights[j]^T x[r_ij] (+ bias) over the
    reference's windows.  x [B, N, H] (padded positions zero),
    slot_weights [s, H, O] -> [B, N, O].

    The interior is one cross-correlation over x padded by s//2 - 1 on the
    left and s - s//2 on the right, as a product of the padded x's s
    shifted copies with the slots' weights; the first s//2 - 1 rows are
    then replaced by their clamped windows."""
    b, n, h = x.shape
    s, _, o = slot_weights.shape
    off = s // 2 - 1          # left reach of the interior window
    x, slot_weights = promote(x, slot_weights)
    xp = F.pad(x, (0, 0, max(off, 0), s - 1 - off))
    rows = xp.shape[1] - s + 1      # n, as JAX's convolution gives it
    windows = torch.cat([xp[:, j:j + rows, :] for j in range(s)], dim=-1)
    y = windows @ slot_weights.reshape(s * h, o)
    if off > 0:
        head = x[:, :min(s, n), :]
        terms = torch.einsum("bjh,jho->bjo", head,
                             slot_weights[:head.shape[1]])
        fix = _left_edge(torch.cumsum(terms, dim=1), off, s, n)
        y = torch.cat([fix, y[:, fix.shape[1]:]], dim=1)
    if bias is not None:
        y, bias = promote(y, bias)
        y = y + bias
    return y


def fft_coarse(x: torch.Tensor, scale: int) -> torch.Tensor:
    """The mean over the window of Re(FFT(window)), which is the window's
    first slot: x[max(0, i - s//2 + 1)]."""
    n = x.shape[1]
    start = torch.clamp(torch.arange(n, device=x.device) - scale // 2 + 1,
                        min=0)
    return x[:, start, :]


def windowed_sum(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j coeffs[j] * x[r_ij]: ``windowed_linear``'s windows
    without the feature contraction.  coeffs [s] in x's dtype."""
    n = x.shape[1]
    s = coeffs.shape[0]
    off = s // 2 - 1
    xp = F.pad(x, (0, 0, max(off, 0), s - 1 - off))
    y = sum(coeffs[j] * xp[:, j:j + n, :] for j in range(s))
    if off > 0:
        head = x[:, :min(s, n), :]
        terms = coeffs[:head.shape[1], None] * head
        fix = _left_edge(torch.cumsum(terms, dim=1), off, s, n)
        y = torch.cat([fix, y[:, fix.shape[1]:]], dim=1)
    return y


def dwt_coarse(x: torch.Tensor, scale: int) -> torch.Tensor:
    """The mean over the window's Haar cA: sum_j w_j / (sqrt(2) * s/2)."""
    c = torch.full((scale,), 1.0 / (math.sqrt(2.0) * (scale // 2)),
                   dtype=x.dtype, device=x.device)
    return windowed_sum(x, c)
