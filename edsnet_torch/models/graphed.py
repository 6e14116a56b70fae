"""The heads' eval forward, replayed from CUDA graphs per padded shape.

``eval_forward(model, x, mask)`` is what the anchor-based and anchor-free
heads' ``predict`` run in place of ``model(x, mask)``; the decode after it
stays eager.  A forward at batch 1 issues a few hundred small launches
(the Nystromformer's landmark means, softmaxes and Newton-Schulz steps,
the local-global encoder's segment gathers and scatters, the trunk, the
ROI heads), so the host, not the card, sets its pace; a graph replays
them in one launch.

A forward is graphed when ``graphable`` says so, from the model and the
input alone and before any launch: a CUDA input, eval mode, no autograd
recording, no tensor-parallel mesh in any module (its all-reduce is a
collective across processes), and no ``AttentionExtractor`` that could
take the ring at this length.  Other forwards run eagerly, as before.

A forward is captured as an ordered list of pieces, split at each call of
the hand-written flash kernel's wrapper (``models/attention.py:attend``
hands it to the capture, ``flash_steps``): the wrapper stays a Python
call, so that its argument checks, its launch counters and any wrapper
put on the module attribute ``flash_attention`` keep running.  A replay
replays each piece, then calls ``flash_attention`` (looked up on its
module) on the static q, k and v the piece wrote, with a fresh clone of
the static mask (a caller may keep the arguments), and copies its output
into the buffer the next piece reads; then the last piece.  A forward
with no flash call is one piece.  The pieces of a forward share one
memory pool and replay in the order they were captured.

The graphs live on the model instance (``model._eval_graphs``, no
parameter or buffer, so not in the ``state_dict``), and go with it.  One
entry per key: the input's shape, dtype and device, whether a mask is
given, the TF32 switches, the float32 matmul precision and the inference
mode.  A graph reads the parameters by address: ``load_state_dict`` and
Adam write in place and the next replay reads the new values; when an
address or shape changes (``.to()``, a rebuilt projection), every graph of
the model is dropped.  A key's first forward runs eagerly, its second
captures (an eager warm-up on the capture stream, then the capture into
static input buffers) and replays, so a one-off shape never pays for a
capture; every call launches the flash kernel once per attention, as an
eager forward does.

Each replay copies ``x`` and ``mask`` into the static buffers on the
current stream, and returns copies of the static outputs: a caller may
keep ``predict``'s results while later replays write the buffers.

The tracer (utils/profiling.py) counts ``predict.calls`` (every call),
``predict.graph_replays``, ``predict.graph_pieces`` (the pieces a replay
ran) and ``predict.graph_captures``, and sees each capture as the span
``predict/capture``.  The capture notes the tracer's spans and counters
inside the forward (``recording``), tracer on or off; a replay runs each
piece and each flash call inside the spans open where that piece's
capture ended, and adds the forward's counts after the last piece, with
the tracer on.  A piece is one launch, so a replayed span starts and ends
at piece boundaries: the piece in which a span closed while capturing
replays outside it (in the local-global head the last piece, which holds
the last segment's fc and scatter and the encoder's tail, replays outside
``lg/local`` and ``lg/encoder``); on the host that is one graph launch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from edsnet_torch.models.attention import AttentionExtractor, flash_steps
from edsnet_torch.models.base import RING_DISABLED, get_ring_mesh
from edsnet_torch.utils.profiling import (count, count_nonzero, enabled,
                                          recording, span)

_SEEN = object()          # a key's first forward ran eagerly


def _takes_ring(module: AttentionExtractor, n: int) -> bool:
    """Whether the ring could run in ``module`` at some length up to ``n``
    (a local attention sees a segment of the length; the ring's
    divisibility is not asked, so the answer errs toward yes)."""
    reg = get_ring_mesh()
    return bool(module.context_parallel) and n >= module.cp_min_len \
        and reg is not None and reg is not RING_DISABLED


def graphable(model: nn.Module, on_cuda: bool, n: int) -> bool:
    """Whether ``model``'s deterministic forward over ``n`` positions on a
    CUDA device (``on_cuda``) may be replayed from graphs (the rule in the
    module docstring; the autograd mode is ``eval_forward``'s test)."""
    if not on_cuda or model.training:
        return False
    for module in model.modules():
        if getattr(module, "tp", None) is not None \
                or getattr(module, "tp_emulate", 0):
            return False
        if isinstance(module, AttentionExtractor) and _takes_ring(module, n):
            return False
    return True


class _Step:
    """A flash call between two pieces: its static arguments, and the
    buffer the next piece reads its output from."""

    def __init__(self, q, k, v, mask, precision):
        self.q, self.k, self.v, self.mask = q, k, v, mask
        self.precision = precision
        self.out = torch.empty(q.shape, dtype=torch.float32,
                               device=q.device)


class _Graph:
    """One captured forward: its pieces, the flash steps between them, the
    static inputs and outputs, and the spans and counts it records."""

    def __init__(self, model: nn.Module, x: torch.Tensor,
                 mask: Optional[torch.Tensor]):
        self.x = x.clone(memory_format=torch.contiguous_format)
        self.mask = None if mask is None else mask.clone()
        self.pieces: List[torch.cuda.CUDAGraph] = []
        self.steps: List[_Step] = []
        # per piece, the (name, fence) of the spans open where it ended
        self.spans: List[List[Tuple]] = []
        self._pool = torch.cuda.graph_pool_handle()
        self._capture = self._begin()
        # the warm-up runs on the process's one capture stream too: cuBLAS
        # keeps a workspace for each stream it meets, for good; it calls no
        # flash kernel, and the tracer counts nothing of it, so the call
        # counts and launches what an eager forward would, in its replay
        side = self._capture.capture_stream
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side), recording(), \
                flash_steps(_no_flash):
            model(self.x, self.mask)
        with recording() as self._recording, \
                flash_steps(self._flash_step):
            self._capture.__enter__()
            try:
                self.outputs = model(self.x, self.mask)
            finally:
                self._end()
        self.counts = self._recording.counts
        del self._capture, self._recording

    def _begin(self):
        """A capture of the next piece into the pool (not yet entered)."""
        self.pieces.append(torch.cuda.CUDAGraph())
        return torch.cuda.graph(self.pieces[-1], pool=self._pool)

    def _end(self) -> None:
        if self._capture is not None:
            capture, self._capture = self._capture, None
            capture.__exit__(None, None, None)
            self.spans.append(list(self._recording.open))

    def _flash_step(self, q, k, v, mask, precision) -> torch.Tensor:
        """What the capture does at a flash call: end this piece, note the
        step, start the next, whose first act is to hold the output."""
        self._end()
        self._capture = self._begin()
        self._capture.__enter__()
        step = _Step(q, k, v, mask, precision)
        self.steps.append(step)
        return step.out

    def replay(self, x: torch.Tensor, mask: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, ...]:
        from edsnet_torch.kernels import flash_attention as flash
        self.x.copy_(x)
        if mask is not None:
            self.mask.copy_(mask)
        traced = enabled()
        opened: List[Tuple[Tuple, object]] = []   # ((name, fence), span)
        try:
            for i, piece in enumerate(self.pieces):
                if traced:
                    _reopen(opened, self.spans[i])
                piece.replay()
                if i < len(self.steps):
                    step = self.steps[i]
                    m = None if step.mask is None else step.mask.clone()
                    step.out.copy_(flash.flash_attention(
                        step.q, step.k, step.v, m,
                        precision=step.precision))
        finally:
            _reopen(opened, [])
        if traced:
            for name, n in self.counts:
                if isinstance(n, torch.Tensor):
                    count_nonzero(name, n)
                else:
                    count(name, n)
        return tuple(t.clone() for t in self.outputs)


def _no_flash(q, k, v, mask, precision) -> torch.Tensor:
    """The warm-up's flash step: zeros of the output's shape."""
    return torch.zeros(q.shape, dtype=torch.float32, device=q.device)


def _reopen(opened: List[Tuple[Tuple, object]], want: List[Tuple]) -> None:
    """Close and open spans so that those open, outermost first, are
    ``want`` (a list of (name, fence))."""
    keep = 0
    while keep < min(len(opened), len(want)) \
            and opened[keep][0] == want[keep]:
        keep += 1
    while len(opened) > keep:
        opened.pop()[1].__exit__(None, None, None)
    for name, fence in want[keep:]:
        s = span(name, fence)
        s.__enter__()
        opened.append(((name, fence), s))


class _Graphs:
    """A model's graphs, valid for one set of parameter addresses."""

    def __init__(self, params: Tuple):
        self.params = params
        self.entries: Dict[Tuple, object] = {}


def _params_key(model: nn.Module) -> Tuple:
    return tuple((t.data_ptr(), t.shape) for t in model.parameters()) \
        + tuple((t.data_ptr(), t.shape) for t in model.buffers())


def eval_forward(model: nn.Module, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> Tuple:
    """``model(x, mask)`` for a head's ``predict``: from a graph where
    ``graphable`` allows it and autograd records nothing, else eagerly."""
    count("predict.calls", 1)
    if torch.is_grad_enabled() or not graphable(model, x.is_cuda,
                                                x.shape[1]):
        return model(x, mask)
    params = _params_key(model)
    graphs = model.__dict__.get("_eval_graphs")
    if graphs is None or graphs.params != params:
        graphs = model._eval_graphs = _Graphs(params)
    key = (tuple(x.shape), x.dtype, x.device,
           None if mask is None else (mask.dtype, tuple(mask.shape)),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision(),
           torch.is_inference_mode_enabled())
    entry = graphs.entries.get(key)
    if entry is None:
        graphs.entries[key] = _SEEN
        return model(x, mask)
    if entry is _SEEN:
        with span("predict/capture"):
            entry = graphs.entries[key] = _Graph(model, x, mask)
        count("predict.graph_captures", 1)
    count("predict.graph_replays", 1)
    count("predict.graph_pieces", len(entry.pieces))
    return entry.replay(x, mask)
