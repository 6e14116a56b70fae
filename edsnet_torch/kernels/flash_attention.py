"""Masked flash attention, forward and backward: hand-written Hopper
kernels, their plain PyTorch twins and the autograd Function that joins
them.

Replaces the Pallas TPU kernels of ``edsnet_tpu/kernels/flash_attention.py``:
``_flash_kernel`` (``_flash_forward``) with ``csrc/flash_attention_fwd.cu``,
and ``_dq_kernel`` / ``_dkv_kernel`` (``_flash_backward``) with the two
kernels of ``csrc/flash_attention_bwd.cu``.  Each source's header notes its
bound on the card (operations at the main path's shapes) and its design.

Precision.  The forward and dk/dv kernels multiply on the TF32 tensor
cores.  ``precision="highest"`` runs each product as three TF32 passes
(3xTF32: every f32 operand split into a TF32 ``big`` part and a TF32
``small`` remainder, summing small*big + big*small + big*big), which keeps
an error near f32's; ``"default"`` runs one TF32 pass (operands rounded to
10 mantissa bits).  ``tf32_round``, ``tf32_matmul`` and the two kernels'
computations built on them (``flash_attention_tf32``,
``flash_attention_dkv_tf32``) repeat that arithmetic in plain PyTorch for
the tests and ``chip_smoke.py``; the port's paths never call them.  The
dq kernel uses f32 FMAs at
either precision, and the twins are exact f32 and ignore ``precision``, as
JAX's interpret mode does on the CPU.

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
PASSES = {"default": 1, "highest": 3}   # TF32 products per matrix product


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: what ``cvt.rna.tf32.f32`` gives, on the int32 view of the bits,
    with NaN kept as the TF32 NaN 0x7fffe000 (as the kernels keep it)."""
    x = x.to(torch.float32).contiguous()
    bits = (x.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(x == x, bits, 0x7FFFE000).view(torch.float32)


def _f32_toward_zero(s: torch.Tensor) -> torch.Tensor:
    """f64 -> f32, rounded toward zero."""
    r = s.to(torch.float32)
    return torch.where(r.double().abs() > s.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int,
                toward_zero: bool = False) -> torch.Tensor:
    """a @ b in TF32 products, as the kernels issue them: 1 pass multiplies
    the TF32-rounded operands; 3 passes add the products of each operand's
    TF32 remainder with the other's rounded part, small terms first.
    Products of TF32 values are exact in f32, so f32 matmuls emulate them,
    summing as an f32 matmul does (rounded to nearest).  ``toward_zero``
    sums as the card's ``mma.sync`` does instead: 8 terms of the inner
    dimension per step, each pass a step, the f32 sum rounded toward zero
    after every step (a model of the card's accumulator that reproduces its
    readings, PERF.md)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")
    a_big, b_big = tf32_round(a), tf32_round(b)
    terms = [(a_big, b_big)]
    if passes == 3:
        terms = [(tf32_round(a - a_big), b_big),
                 (a_big, tf32_round(b - b_big))] + terms
    if not toward_zero:
        return sum(x @ y for x, y in terms)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device)
    for c in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = _f32_toward_zero(acc.double() + x[..., c:c + 8].double()
                                   @ y[..., c:c + 8, :].double())
    return acc


def flash_attention_tf32(q, k, v, mask, passes: int,
                         toward_zero: bool = False):
    """The forward kernel's arithmetic in plain PyTorch, for the tests:
    S = q k^T in TF32 passes, then the scale, the mask, the softmax and P v
    in TF32 passes -> (out, m, l) as ``flash_attention_plain`` returns."""
    s = tf32_matmul(q, k.transpose(1, 2), passes, toward_zero)
    km = mask[:, None, :]
    s = torch.where(km > 0, s * q.shape[-1] ** -0.5,
                    torch.where(km == 0, NEG, 2 * NEG))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG)
    p = torch.exp(s - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return tf32_matmul(p, v, passes, toward_zero) / l, m, l


def flash_attention_dkv_tf32(q, k, v, mask, g, m, l, dd, passes: int,
                             toward_zero: bool = False):
    """The dk/dv kernel's arithmetic in plain PyTorch, for the tests:
    S^T = k q^T and dP^T = v g^T, then dv = P^T g and dk = dS^T q * scale,
    all four in TF32 passes -> (dk, dv)."""
    st = tf32_matmul(k, q.transpose(1, 2), passes, toward_zero)
    km = mask[:, :, None]
    st = torch.where(km > 0, st * q.shape[-1] ** -0.5,
                     torch.where(km == 0, NEG, 2 * NEG))
    pt = torch.exp(st - m.transpose(1, 2)) / l.transpose(1, 2)
    dpt = tf32_matmul(v, g.transpose(1, 2), passes, toward_zero)
    dst = torch.where(km > 0, pt * (dpt - dd.transpose(1, 2)), 0.0)
    dk = tf32_matmul(dst, q, passes, toward_zero) * q.shape[-1] ** -0.5
    return dk, tf32_matmul(pt, g, passes, toward_zero)


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
    """Raise unless the tensors are what the CUDA kernels take (their
    16-byte asynchronous copies need 16-byte aligned rows)."""
    bh, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if n % BLOCK:
        raise ValueError(f"{name}: N={n} is not a multiple of {BLOCK}")
    for shape, tensors in (((bh, n, d), like_q), ((bh, n, 1), rows)):
        for arg, t in tensors.items():
            if (t.shape != shape or t.dtype != torch.float32
                    or t.device != q.device or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"{name}: {arg} must be a contiguous, "
                                 f"16-byte aligned float32 {shape} tensor on "
                                 f"{q.device}")
    if (mask.shape != (bh, n) or mask.dtype != torch.int32
            or mask.device != q.device or not mask.is_contiguous()
            or mask.data_ptr() % 16):
        raise ValueError(f"{name}: mask must be a contiguous, 16-byte "
                         f"aligned int32 {(bh, n)} tensor on {q.device}")


def _passes(name: str, precision: str) -> int:
    if precision not in PRECISIONS:
        raise ValueError(f"{name}: precision must be one of {PRECISIONS}, "
                         f"not {precision!r}")
    return PASSES[precision]


# C entry point -> (source in csrc/, pointer arguments, takes a pass count)
_ENTRY_POINTS = {
    "edsnet_flash_attention_fwd": ("flash_attention_fwd", 7, True),
    "edsnet_flash_attention_dq": ("flash_attention_bwd", 9, False),
    "edsnet_flash_attention_dkv": ("flash_attention_bwd", 10, True),
}


def _library(symbol: str):
    """The C entry point, with its ctypes signature: the pointers, then
    bh, n, d (and the pass count) as ints, the scale, the stream."""
    from edsnet_torch.kernels import build
    source, n_pointers, with_passes = _ENTRY_POINTS[symbol]
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_pointers
                       + [ctypes.c_int] * (4 if with_passes else 3)
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, symbol: str, tensors, passes: Optional[int] = None
            ) -> None:
    """Launch ``symbol`` on q's current stream; ``tensors`` (q first) are
    its pointer arguments in order (outputs last)."""
    fn = _library(symbol)
    q = tensors[0]
    bh, n, d = q.shape
    ints = (bh, n, d) if passes is None else (bh, n, d, passes)
    with torch.cuda.device(q.device):  # the launch targets the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), *ints, d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _cuda_only(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, *, precision: str = "highest"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper: [BH, N, D] f32 q/k/v with N a multiple of 64 and D in
    (32, 64, 128), [BH, N] int32 mask -> (out, m [BH, N, 1], l [BH, N, 1]),
    at 3 TF32 passes (``precision="highest"``) or 1 (``"default"``)."""
    name = "flash_attention_fwd"
    passes = _passes(name, precision)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask)
    _cuda_only(name, q)
    _check(name, q, mask, {"q": q, "k": k, "v": v}, {})
    bh, n, _ = q.shape
    out = torch.empty_like(q)
    m = torch.empty((bh, n, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _launch(name, "edsnet_flash_attention_fwd", (q, k, v, mask, out, m, l),
            passes)
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
    _launch(name, "edsnet_flash_attention_dq", (q, k, v, mask, g, m, l, dd, dq))
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, mask, g, m, l, dd, *,
                        precision: str = "highest"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel wrapper: the arguments of ``flash_attention_dq`` ->
    (dk, dv), each [BH, N, D] f32, at 3 TF32 passes (``"highest"``) or 1
    (``"default"``)."""
    name = "flash_attention_dkv"
    passes = _passes(name, precision)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd)
    _cuda_only(name, q)
    _check(name, q, mask, {"q": q, "k": k, "v": v, "g": g},
           {"m": m, "l": l, "dd": dd})
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    _launch(name, "edsnet_flash_attention_dkv",
            (q, k, v, mask, g, m, l, dd, dk, dv), passes)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, mask, o, m, l, g, *,
                        precision: str = "highest"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward: dd = rowsum(g * o) as a torch op, then the dq kernel
    and the dk/dv kernel at ``precision`` (their twins for CPU tensors)."""
    dd = _rowsum_go(g, o)
    dq = flash_attention_dq(q, k, v, mask, g, m, l, dd)
    return (dq, *flash_attention_dkv(q, k, v, mask, g, m, l, dd,
                                     precision=precision))


class _FlashAttention(torch.autograd.Function):
    """Flat [BH, N_pad, D] attention whose forward is the forward kernel and
    whose backward is the two backward kernels; the mask gets no gradient.
    (The TPU package's ``_flash`` custom_vjp.)"""

    @staticmethod
    def forward(ctx, q, k, v, mask, precision):
        out, m, l = flash_attention_fwd(q, k, v, mask, precision=precision)
        ctx.save_for_backward(q, k, v, mask, out, m, l)
        ctx.precision = precision
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, m, l,
                                         g.contiguous(),
                                         precision=ctx.precision)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    precision: str = "default") -> torch.Tensor:
    """Masked multi-head attention: q/k/v [B, H, N, D] f32, mask [B, N]
    bool or None -> [B, H, N, D], differentiable in q, k and v.

    Pads N to a multiple of 64 with pad keys at mask level -1, broadcasts
    the mask over heads and crops the output; autograd differentiates the
    pad and the crop around ``_FlashAttention``.  ``precision`` sets the
    TF32 passes of the forward and dk/dv kernels: 3 at "highest", 1 at
    "default" (JAX's default, one native pass)."""
    _passes("flash_attention", precision)
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

    out = _FlashAttention.apply(flat(q), flat(k), flat(v), m32.contiguous(),
                                precision)
    return out.reshape(b, h, n_pad, d)[:, :, :n]
