"""Masked flash attention, forward and backward: hand-written Hopper
kernels, their plain PyTorch twins and the autograd Function that joins
them.

Replaces the Pallas TPU kernels of ``edsnet_tpu/kernels/flash_attention.py``:
``_flash_kernel`` (``_flash_forward``) with ``csrc/flash_attention_fwd.cu``,
and ``_dq_kernel`` / ``_dkv_kernel`` (``_flash_backward``) with the two
kernels of ``csrc/flash_attention_bwd.cu``.  Each source's header notes its
bound on the card (f32 operations at the main path's shapes) and its design.

Semantics, shared by kernel and twin: scores ``(q * D^-1/2) k^T``; key mask
levels 1 = attend, 0 = real but masked (scored -1e30), -1 = time-axis pad
(scored -2e30); outputs ``out``, the row max ``m`` and the denominator ``l``
(floored at 1e-30) as a pair.  A fully-masked row (m = -1e30) therefore
averages uniformly over its real keys, while pad keys get exp(-1e30) = 0.

The backward recomputes ``P = exp(s - m) / l`` from that pair (never a
logsumexp), gives masked keys no dS, and keeps P on them for dv: a
fully-masked row contributes to dv and not to dk.

Each kernel wrapper (``flash_attention_fwd``, ``flash_attention_dq``,
``flash_attention_dkv``) takes the twin only for CPU tensors (the tests); a
CUDA tensor launches the kernel or raises.  Its ``.launches`` counts kernel
launches.  ``flash_attention`` is differentiable through ``_FlashAttention``,
whose backward runs the two backward kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG = -1e30
BLOCK = 64
HEAD_DIMS = (32, 64, 128)
PRECISIONS = ("default", "highest")


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """(q * D^-1/2) k^T under the three-level key mask: [BH, N, N]."""
    s = torch.einsum("bnd,bmd->bnm", q * q.shape[-1] ** -0.5, k)
    km = mask[:, None, :]
    return torch.where(km > 0, s, torch.where(km == 0, NEG, 2 * NEG))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the forward kernel: [BH, N, D] q/k/v, [BH, N]
    int32 mask -> (out [BH, N, D], m [BH, N, 1], l [BH, N, 1])."""
    s = _scores(q, k, mask)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.bmm(p, v) / l, m, l


def _probs_and_ds(q, k, v, mask, g, m, l, dd):
    """The backward's recomputed P and dS = where(mask > 0, P (dP - dd), 0),
    both [BH, N, N]."""
    p = torch.exp(_scores(q, k, mask) - m) / l
    dp = torch.einsum("bnd,bmd->bnm", g, v)
    ds = torch.where(mask[:, None, :] > 0, p * (dp - dd), 0.0)
    return p, ds


def flash_attention_dq_plain(q, k, v, mask, g, m, l, dd) -> torch.Tensor:
    """Plain twin of the dq kernel: dq = dS k * scale, [BH, N, D]."""
    _, ds = _probs_and_ds(q, k, v, mask, g, m, l, dd)
    return torch.bmm(ds, k) * q.shape[-1] ** -0.5


def flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the dk/dv kernel: (dk = dS^T (q * scale), dv = P^T g)."""
    p, ds = _probs_and_ds(q, k, v, mask, g, m, l, dd)
    dk = torch.bmm(ds.transpose(1, 2), q * q.shape[-1] ** -0.5)
    return dk, torch.bmm(p.transpose(1, 2), g)


def _rowsum_go(g: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """dd = rowsum(g * o), [BH, N, 1]: computed outside the kernels, as
    the TPU version does."""
    return (g * o).sum(dim=-1, keepdim=True)


def flash_attention_bwd_plain(q, k, v, mask, o, m, l, g
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain twin of the whole backward: the forward's saved q/k/v, mask,
    out and (m, l), and the output gradient g -> (dq, dk, dv)."""
    dd = _rowsum_go(g, o)
    dq = flash_attention_dq_plain(q, k, v, mask, g, m, l, dd)
    return (dq, *flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd))


def _check(name: str, q: torch.Tensor, mask: torch.Tensor,
           like_q: dict, rows: dict) -> None:
    """Raise unless the tensors are what the CUDA kernels take."""
    bh, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if n % BLOCK:
        raise ValueError(f"{name}: N={n} is not a multiple of {BLOCK}")
    for shape, tensors in (((bh, n, d), like_q), ((bh, n, 1), rows)):
        for arg, t in tensors.items():
            if (t.shape != shape or t.dtype != torch.float32
                    or t.device != q.device or not t.is_contiguous()):
                raise ValueError(f"{name}: {arg} must be a contiguous "
                                 f"float32 {shape} tensor on {q.device}")
    if (mask.shape != (bh, n) or mask.dtype != torch.int32
            or mask.device != q.device or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be a contiguous int32 "
                         f"{(bh, n)} tensor on {q.device}")


def _library(symbol: str, n_pointers: int):
    from edsnet_torch.kernels import build
    source = ("flash_attention_fwd" if symbol.endswith("_fwd")
              else "flash_attention_bwd")
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, symbol: str, q: torch.Tensor, *tensors: torch.Tensor
            ) -> None:
    """Launch ``symbol`` on q's current stream; q and ``tensors`` are its
    pointer arguments in order (outputs last)."""
    fn = _library(symbol, 1 + len(tensors))
    bh, n, d = q.shape
    with torch.cuda.device(q.device):  # the launch targets the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), *(t.data_ptr() for t in tensors), bh, n, d,
                 d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _cuda_only(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper: [BH, N, D] f32 q/k/v with N a multiple of 64 and D in
    (32, 64, 128), [BH, N] int32 mask -> (out, m [BH, N, 1], l [BH, N, 1])."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask)
    name = "flash_attention_fwd"
    _cuda_only(name, q)
    _check(name, q, mask, {"q": q, "k": k, "v": v}, {})
    bh, n, _ = q.shape
    out = torch.empty_like(q)
    m = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch(name, "edsnet_flash_attention_fwd", q, k, v, mask, out, m, l)
    flash_attention_fwd.launches += 1
    return out, m, l


flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, mask, g, m, l, dd) -> torch.Tensor:
    """dq kernel wrapper: q/k/v/g [BH, N, D] f32, mask [BH, N] int32, the
    forward's m, l and dd = rowsum(g * out), each [BH, N, 1] f32 -> dq."""
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, mask, g, m, l, dd)
    name = "flash_attention_dq"
    _cuda_only(name, q)
    _check(name, q, mask, {"q": q, "k": k, "v": v, "g": g},
           {"m": m, "l": l, "dd": dd})
    dq = torch.empty_like(q)
    _launch(name, "edsnet_flash_attention_dq", q, k, v, mask, g, m, l, dd, dq)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, mask, g, m, l, dd
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel wrapper: the arguments of ``flash_attention_dq`` ->
    (dk, dv), each [BH, N, D] f32."""
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd)
    name = "flash_attention_dkv"
    _cuda_only(name, q)
    _check(name, q, mask, {"q": q, "k": k, "v": v, "g": g},
           {"m": m, "l": l, "dd": dd})
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    _launch(name, "edsnet_flash_attention_dkv", q, k, v, mask, g, m, l, dd,
            dk, dv)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, mask, o, m, l, g
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward: dd = rowsum(g * o) as a torch op, then the dq kernel
    and the dk/dv kernel (their twins for CPU tensors)."""
    dd = _rowsum_go(g, o)
    dq = flash_attention_dq(q, k, v, mask, g, m, l, dd)
    return (dq, *flash_attention_dkv(q, k, v, mask, g, m, l, dd))


class _FlashAttention(torch.autograd.Function):
    """Flat [BH, N_pad, D] attention whose forward is the forward kernel and
    whose backward is the two backward kernels; the mask gets no gradient.
    (The TPU package's ``_flash`` custom_vjp.)"""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        out, m, l = flash_attention_fwd(q, k, v, mask)
        ctx.save_for_backward(q, k, v, mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, m, l,
                                         g.contiguous())
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    precision: str = "default") -> torch.Tensor:
    """Masked multi-head attention: q/k/v [B, H, N, D] f32, mask [B, N]
    bool or None -> [B, H, N, D], differentiable in q, k and v.

    Pads N to a multiple of 64 with pad keys at mask level -1, broadcasts
    the mask over heads and crops the output; autograd differentiates the
    pad and the crop around ``_FlashAttention``.  Both ``precision`` values
    run the same f32 FMA kernels."""
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

    out = _FlashAttention.apply(flat(q), flat(k), flat(v), m32.contiguous())
    return out.reshape(b, h, n_pad, d)[:, :, :n]
