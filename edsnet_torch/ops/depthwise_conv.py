"""Depthwise time-axis convolution: the nystromformer's residual branch.

Counterpart of edsnet_tpu/ops/depthwise_conv.py:depthwise_time_conv and
its custom VJP.  out[b,h,t,d] = sum_j w[h,j] * vpad[b,h,t+j,d], a
cross-correlation with zero padding K//2 on both sides of the time axis.
On [B, H, T, D] that is ``F.conv2d`` with H groups and the (H, 1, K, 1)
weight, the layout of the flax ``res_conv`` param.  The backward is
written out as JAX's is: dv the same conv with the kernel flipped, dw the
filter gradient.

Every conv here, forward and backward, follows ``--matmul-precision`` as
the products around it do: it runs with cuDNN's TF32 switch set to
cuBLAS's, ``torch.backends.cuda.matmul.allow_tf32`` (off unless the flag
asks for TF32; JAX's matmul precision reaches its convs too), whatever
``torch.backends.cudnn.allow_tf32`` says (it defaults to on outside the
CLIs): TF32 operands would carry ~1e-3 relative error into a residual the
port otherwise holds to f32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _cudnn_as_matmul():
    """cuDNN's TF32 switch set to cuBLAS's inside the block, restored
    after."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _correlate(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    h, k = w.shape
    return F.conv2d(v, w[:, None, :, None], padding=(k // 2, 0), groups=h)


class _DepthwiseTimeConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, w):
        ctx.save_for_backward(v, w)
        with _cudnn_as_matmul():
            return _correlate(v, w)

    @staticmethod
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        h, k = w.shape
        dv = dw = None
        with _cudnn_as_matmul():
            if ctx.needs_input_grad[0]:
                dv = _correlate(g, w.flip(1))
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(
                    v, (h, 1, k, 1), g, padding=(k // 2, 0),
                    groups=h)[:, 0, :, 0]
        return dv, dw


def depthwise_time_conv(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """v: [B, H, T, D], w: [H, K] (K odd) -> [B, H, T, D]."""
    if w.shape[1] % 2 == 0:
        raise ValueError(f"kernel size {w.shape[1]} must be odd")
    return _DepthwiseTimeConv.apply(v.contiguous(), w.contiguous())
