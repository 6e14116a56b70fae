"""Masked flash attention, forward: a hand-written Hopper kernel and its
plain PyTorch twin.

Replaces ``_flash_kernel`` / ``_flash_forward`` of
``edsnet_tpu/kernels/flash_attention.py`` (the Pallas TPU kernel).  The
CUDA source is ``csrc/flash_attention_fwd.cu``; its header notes the bound
on the card (f32 operations at the main path's shapes) and the design.

Semantics, shared by kernel and twin: scores ``(q * D^-1/2) k^T``; key mask
levels 1 = attend, 0 = real but masked (scored -1e30), -1 = time-axis pad
(scored -2e30); outputs ``out``, the row max ``m`` and the denominator ``l``
(floored at 1e-30) as a pair.  A fully-masked row (m = -1e30) therefore
averages uniformly over its real keys, while pad keys get exp(-1e30) = 0.

``flash_attention_fwd`` takes the twin only for CPU tensors (the tests); a
CUDA tensor launches the kernel or raises.  ``flash_attention_fwd.launches``
counts kernel launches.  The backward kernels (``_dq_kernel``,
``_dkv_kernel``) come with the training slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG = -1e30
BLOCK = 64
HEAD_DIMS = (32, 64, 128)
PRECISIONS = ("default", "highest")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: [BH, N, D] q/k/v, [BH, N] int32
    mask -> (out [BH, N, D], m [BH, N, 1], l [BH, N, 1])."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bnd,bmd->bnm", q * scale, k)
    km = mask[:, None, :]
    s = torch.where(km > 0, s, torch.where(km == 0, NEG, 2 * NEG))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.bmm(p, v) / l, m, l


def _library():
    from edsnet_torch.kernels import build
    lib = build.load("flash_attention_fwd")
    fn = lib.edsnet_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper: [BH, N, D] f32 q/k/v with N a multiple of 64 and D in
    (32, 64, 128), [BH, N] int32 mask -> (out, m [BH, N, 1], l [BH, N, 1])."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    bh, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in "
                         f"{HEAD_DIMS}")
    if n % BLOCK:
        raise ValueError(f"flash_attention_fwd: N={n} is not a multiple of "
                         f"{BLOCK}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"flash_attention_fwd: {name} must be a "
                             f"contiguous float32 {tuple(q.shape)} tensor on "
                             f"{q.device}")
    if (mask.shape != (bh, n) or mask.dtype != torch.int32
            or mask.device != q.device or not mask.is_contiguous()):
        raise ValueError("flash_attention_fwd: mask must be a contiguous "
                         f"int32 {(bh, n)} tensor on {q.device}")
    fn = _library()
    out = torch.empty_like(q)
    m = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):  # the launch targets the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), m.data_ptr(), l.data_ptr(), bh, n, d,
                 d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_fwd.launches += 1
    return out, m, l


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    precision: str = "default") -> torch.Tensor:
    """Masked multi-head attention: q/k/v [B, H, N, D] f32, mask [B, N]
    bool or None -> [B, H, N, D].

    Pads N to a multiple of 64 with pad keys at mask level -1, broadcasts
    the mask over heads and crops the output.  Both ``precision`` values
    run the same f32 FMA kernel."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    b, h, n, d = q.shape
    if mask is None:
        m32 = torch.ones((b, n), dtype=torch.int32, device=q.device)
    else:
        m32 = mask.to(torch.int32)
    n_pad = -(-n // BLOCK) * BLOCK
    if n_pad != n:
        pad = (0, 0, 0, n_pad - n)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
        m32 = torch.nn.functional.pad(m32, (0, n_pad - n), value=-1)
    m32 = m32[:, None, :].expand(b, h, n_pad).reshape(b * h, n_pad)

    def flat(t):
        return t.reshape(b * h, n_pad, d).to(torch.float32).contiguous()

    out, _, _ = flash_attention_fwd(flat(q), flat(k), flat(v),
                                    m32.contiguous())
    return out.reshape(b, h, n_pad, d)[:, :, :n]
