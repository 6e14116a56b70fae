"""The heads' eval forward, replayed from one CUDA graph per padded shape.

``eval_forward(model, x, mask)`` is what the anchor-based and anchor-free
heads' ``predict`` run in place of ``model(x, mask)``; the decode after it
stays eager.  A forward at batch 1 issues a few hundred small launches
(the Nystromformer's landmark means, softmaxes and Newton-Schulz steps,
the trunk, the ROI heads), so the host, not the card, sets its pace; a
graph replays them in one launch.

A forward is graphed when ``graphable`` says so, from the model and the
input alone and before any launch: a CUDA input, eval mode, no autograd
recording, no tensor-parallel mesh in any module (its all-reduce is a
collective across processes), and no ``AttentionExtractor`` that would take
the ring or the flash kernel at this length.  A hand-written kernel's
wrapper has to stay a Python call, so that its argument checks and its
launch counters keep running, and a graph would replay the launch without
them.  Other forwards run eagerly, as before.

The graphs live on the model instance (``model._eval_graphs``, no
parameter or buffer, so not in the ``state_dict``), and go with it.  One
graph per key: the input's shape, dtype and device, whether a mask is
given, the TF32 switches, the float32 matmul precision and the inference
mode.  A graph reads the parameters by address: ``load_state_dict`` and
Adam write in place and the next replay reads the new values; when an
address or shape changes (``.to()``, a rebuilt projection), every graph of
the model is dropped.  A key's first forward runs eagerly, its second
captures (an eager warm-up on a side stream, then the capture into static
input buffers) and replays, so a one-off shape never pays for a capture.

Each replay copies ``x`` and ``mask`` into the static buffers on the
current stream, and returns copies of the static outputs: a caller may
keep ``predict``'s results while later replays write the buffers.

The tracer (utils/profiling.py) counts ``predict.calls`` (every call),
``predict.graph_replays`` and ``predict.graph_captures``, and sees each
capture as the span ``predict/capture``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from edsnet_torch.models.attention import AttentionExtractor, flash_route
from edsnet_torch.models.base import RING_DISABLED, get_ring_mesh
from edsnet_torch.utils.profiling import count, span

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
    CUDA device (``on_cuda``) may be replayed from a graph (the rule in the
    module docstring; the autograd mode is ``eval_forward``'s test)."""
    if not on_cuda or model.training:
        return False
    for module in model.modules():
        if getattr(module, "tp", None) is not None \
                or getattr(module, "tp_emulate", 0):
            return False
        if isinstance(module, AttentionExtractor):
            head_dim = module.Q.in_features // module.num_head
            # the flash route turns on from a length up, so a segment
            # shorter than n takes it only if n does
            if _takes_ring(module, n) or flash_route(
                    True, False, n, head_dim, module.use_flash) is not None:
                return False
    return True


class _Graph:
    """One captured forward: the graph, its static inputs and outputs."""

    def __init__(self, model: nn.Module, x: torch.Tensor,
                 mask: Optional[torch.Tensor]):
        self.x = x.clone(memory_format=torch.contiguous_format)
        self.mask = None if mask is None else mask.clone()
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)
        # the warm-up runs on the process's one capture stream too: cuBLAS
        # keeps a workspace for each stream it meets, for good
        side = capture.capture_stream
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            model(self.x, self.mask)
        with capture:
            self.outputs = model(self.x, self.mask)

    def replay(self, x: torch.Tensor, mask: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, ...]:
        self.x.copy_(x)
        if mask is not None:
            self.mask.copy_(mask)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)


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
    return entry.replay(x, mask)
