"""Vanilla multi-head self-attention backbone.

Counterpart of edsnet_tpu/models/attention.py:AttentionExtractor:
bias-free Q/K/V/fc projections, padded keys excluded from the softmax,
dropout 0.5 on the attention map and on the output in training.  Each
pass asks ``flash_route``, from its device, mode and shapes, whether to
take the flash kernel (kernels/flash_attention.py) and at which
precision: ``use_flash`` is the --use-pallas tri-state.  The flash route
is differentiable, but training keeps the dense path, because its dropout
acts on the attention map itself.

``flash_route`` decides from the shapes alone and before any launch (as
JAX's length threshold does):
- training passes always take the dense path;
- None (auto): the flash kernel at precision "highest" on a CUDA device
  when the head dim D is one the forward kernel takes (``HEAD_DIMS``:
  32, 64, 128, 256 and 512; 256 for the deep anchor-free model's
  ``base_model1`` at F 1024, 512 for the local attentions of the
  local-global heads, 2 heads at F 1024) and N >= ``FLASH_MIN_LEN``;
  otherwise the dense path.  On the CPU the dense path runs, as JAX's auto
  rule keeps the kernel off away from its accelerator, and e.g.
  ``--num-feature 32 --num-head 2`` (D = 16) runs dense on the card;
- True (--use-pallas): the flash route on any device at N >=
  ``FLASH_MIN_LEN``, precision "default" (on the CPU that is the kernel's
  plain twin, which takes any D); on a CUDA device a head dim outside
  ``HEAD_DIMS`` raises, since the user asked for the kernel;
- False (--no-pallas): always the dense path.
The backward kernels take D up to 128 (``BWD_HEAD_DIMS``): the flash route
is differentiated only by callers of ``flash_attention``, never by a
training pass here, and at D = 256 or 512 its backward raises.

Two routes of the parallel slice come before that rule:
- the ring (``_ring_plan``, JAX's): on deterministic passes of a module
  built under ``--context-parallel`` (models/base.py), at N >=
  ``cp_min_len`` and N divisible by the seq axis of the ring mesh the
  trainer or evaluate registered (``set_ring_mesh``), this rank's chunk
  of the positions goes through parallel/ring_attention.py;
- tensor parallelism: after ``parallel/tensor_parallel.py:
  shard_params_tp`` the module holds H/tp heads, its ``fc`` partial is
  summed over the ``model`` ranks, and its attention-map dropout keeps
  its heads of the whole draw; under ``emulate_tp`` the module runs every
  rank's heads itself and sums their partials.
Each rank's heads go through ``attend``, whatever the route.

``attend`` looks ``flash_attention`` up on its module at each call, so a
wrapper put there sees every call.  While ``models/graphed.py`` captures a
forward in pieces, it hands the call to the capture instead
(``flash_steps``): a graph cannot hold the wrapper's Python, which then
runs eagerly between the pieces' replays.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edsnet_torch.kernels.flash_attention import HEAD_DIMS
from edsnet_torch.models.common import (Dropout, Linear, masked_softmax,
                                        promote)

# Shortest sequence the flash route takes.  0 routes every deterministic
# attention pass through the kernel: the JAX thresholds (1024 / 2048) come
# from TPU timings and would leave it off for every eval bucket of a real
# video.  A later PR sets this from the card's times in PERF.md.
FLASH_MIN_LEN = 0

# (q, k, v, mask, precision) -> the flash output, set by ``flash_steps``
_flash_step: ContextVar[Optional[Callable]] = ContextVar("flash_step",
                                                         default=None)


@contextlib.contextmanager
def flash_steps(step: Callable) -> Iterator[None]:
    """Inside the block every flash-route pass of ``attend`` calls
    ``step(q, k, v, mask, precision)`` in place of ``flash_attention``."""
    token = _flash_step.set(step)
    try:
        yield
    finally:
        _flash_step.reset(token)


def flash_route(on_cuda: bool, training: bool, n: int, head_dim: int,
                use_pallas: Optional[bool]) -> Optional[str]:
    """The flash route's precision ("highest" or "default") for one
    attention pass of N positions and head dim ``head_dim``, or None for
    the dense path (the rule in the module docstring)."""
    if training or use_pallas is False or n < FLASH_MIN_LEN:
        return None
    if use_pallas is None:
        return "highest" if on_cuda and head_dim in HEAD_DIMS else None
    if on_cuda and head_dim not in HEAD_DIMS:
        raise ValueError(f"--use-pallas: head dim {head_dim} not in "
                         f"HEAD_DIMS {HEAD_DIMS}, the head dims the CUDA "
                         f"flash forward kernel takes; pick --num-feature / "
                         f"--num-head to give one, or drop --use-pallas")
    return "default"


class AttentionExtractor(nn.Module):
    """(B, N, F) -> (B, N, F) self-attention mixing.

    ``context_parallel`` (-1 or > 1: the ring route may run) and
    ``cp_min_len`` are baked in at construction from ``--context-parallel``
    and ``--cp-min-len``, as JAX's module fields are."""

    def __init__(self, num_head: int = 8, num_feature: int = 1024,
                 attn_dropout: float = 0.5, out_dropout: float = 0.5,
                 use_flash: Optional[bool] = None, context_parallel: int = 0,
                 cp_min_len: int = 1024):
        super().__init__()
        if num_feature % num_head:
            raise ValueError(f"num_feature {num_feature} must be divisible "
                             f"by num_head {num_head} (head split)")
        self.num_head = num_head
        self.use_flash = use_flash
        self.context_parallel = context_parallel
        self.cp_min_len = cp_min_len
        self.Q = Linear(num_feature, num_feature, bias=False)
        self.K = Linear(num_feature, num_feature, bias=False)
        self.V = Linear(num_feature, num_feature, bias=False)
        self.fc = Linear(num_feature, num_feature, bias=False)
        self.attn_dropout = Dropout(attn_dropout)
        self.out_dropout = Dropout(out_dropout)
        self.tp = None          # the mesh whose "model" axis splits the heads
        self.tp_emulate = 0     # > 0: that many model ranks in this process

    def _ring_plan(self, n: int):
        """(mesh, seq_axis, batch_axis, head_axis) of the registered ring
        mesh, or None for the flash / dense rule.  Unlike JAX's, no
        standalone mesh: without a registered one (a world of 1, or a
        count the ring does not divide) the ring stays off, since this
        rank's rows need not be its seq peers'."""
        if not self.context_parallel or self.training or n < self.cp_min_len:
            return None
        from edsnet_torch.models.base import RING_DISABLED, get_ring_mesh
        reg = get_ring_mesh()
        if reg is None or reg is RING_DISABLED:
            return None
        mesh, seq_ax = reg[0], reg[1]
        p = mesh.shape[seq_ax]
        if p < 2 or n % p:
            return None
        return reg

    def attend(self, x: torch.Tensor, mask: Optional[torch.Tensor],
               weights: Sequence[torch.Tensor], heads: int) -> torch.Tensor:
        """The attention of ``heads`` heads of head dim F / num_head, with
        the Q / K / V weights ``weights`` ([heads * D, F] each) ->
        [B, N, heads * D], before ``fc``: one rank's part."""
        b, n, f = x.shape
        d_k = f // self.num_head

        def split(w):
            return F.linear(*promote(x, w)).reshape(
                b, n, heads, d_k).transpose(1, 2)

        q, k, v = (split(w) for w in weights)
        plan = self._ring_plan(n)
        precision = None if plan is not None else flash_route(
            x.is_cuda, self.training, n, d_k, self.use_flash)
        if plan is not None:
            from edsnet_torch.parallel.ring_attention import ring_attention
            mesh, seq_ax, b_ax, h_ax = plan
            p = mesh.shape[seq_ax]
            lo = mesh.axis_rank(seq_ax) * (n // p)
            hi = lo + n // p
            y = ring_attention(
                q[:, :, lo:hi], k[:, :, lo:hi], v[:, :, lo:hi],
                None if mask is None else mask[:, lo:hi], mesh=mesh,
                axis_name=seq_ax, batch_axis=b_ax, head_axis=h_ax
            ).to(x.dtype)
        elif precision is not None:
            step = _flash_step.get()
            if step is not None:
                y = step(q, k, v, mask, precision)
            else:
                from edsnet_torch.kernels.flash_attention import (
                    flash_attention)
                y = flash_attention(q, k, v, mask, precision=precision)
        else:
            attn = torch.einsum("bhnd,bhmd->bhnm", q, k) / (d_k ** 0.5)
            key_mask = None if mask is None else mask[:, None, None, :]
            attn = self.attn_dropout(masked_softmax(attn, key_mask, dim=-1))
            y = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        return y.transpose(1, 2).reshape(b, n, heads * d_k)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qkv = (self.Q.weight, self.K.weight, self.V.weight)
        if self.tp_emulate:
            from edsnet_torch.parallel.tensor_parallel import head_slices
            p, y = self.tp_emulate, None
            for r in range(p):
                ws, fc_w = head_slices(self, r, p)
                part = F.linear(*promote(
                    self.attend(x, mask, ws, self.num_head // p), fc_w))
                y = part if y is None else y + part
        elif self.tp is not None:
            from edsnet_torch.parallel.tensor_parallel import (
                copy_to_model_region, reduce_from_model_region)
            heads = self.num_head // self.tp.shape["model"]
            y = self.fc(self.attend(copy_to_model_region(x, self.tp), mask,
                                    qkv, heads))
            y = reduce_from_model_region(y, self.tp)
        else:
            y = self.fc(self.attend(x, mask, qkv, self.num_head))
        return self.out_dropout(y)
