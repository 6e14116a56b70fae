"""Megatron-style tensor parallelism for the attention backbone: the heads
of every attention module split over the ``model`` ranks of a mesh.

Counterpart of edsnet_tpu/parallel/tensor_parallel.py.  An attention module
is found by its structure, as in JAX: any module with ``Q``, ``K``, ``V``
and ``fc`` children (every ``AttentionExtractor`` inside any head).  In
torch's ``[out, in]`` layout the Q / K / V weights are ROW-sliced by head
(flax's column spec ``P(None, 'model')``), so each rank holds H/P whole
heads and its softmax and value product stay local; ``fc`` is
COLUMN-sliced (flax's row spec), so each rank's product is a partial sum
of the output, which one all-reduce per layer completes.  Every other
leaf, rank-1 leaves under those names included, stays replicated.

Two autograd functions carry the collectives: ``copy_to_model_region``
(identity forward, gradient summed over ``model`` backward) where the
replicated input enters the heads, and ``reduce_from_model_region``
(sum over ``model`` forward, identity backward) on the ``fc`` partials.
They are written out here because
``torch.distributed.nn.functional.all_reduce`` multiplies its gradient by
the group size.

Checkpoints stay the full ``state_dict`` whatever the mesh
(``TPLayout.gather`` / ``scatter``).  ``emulate_tp`` runs P ranks' heads in
one process, the all-reduce replaced by a sum.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from edsnet_torch.parallel.mesh import Mesh, all_gather

_ATTN_KEYS = ("Q", "K", "V", "fc")
# the dim of a weight's [out, in] layout that each attention leaf splits
_SLICED_DIM = {"Q": 0, "K": 0, "V": 0, "fc": 1}


class _CopyToModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity; the gradient is summed over the ``model`` group."""
    return _CopyToModelRegion.apply(x, mesh.group("model"))


def reduce_from_model_region(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ``model`` group; the gradient passes as is."""
    return _ReduceFromModelRegion.apply(x, mesh.group("model"))


def attention_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """(name, module) of every module holding Q, K, V and fc children."""
    for name, module in model.named_modules():
        children = dict(module.named_children())
        if all(k in children for k in _ATTN_KEYS):
            yield name, module


def tp_shardings(state: nn.Module | Mapping[str, torch.Tensor], mesh: Mesh,
                 num_heads: int) -> Dict[str, Optional[int]]:
    """Per ``state_dict`` key, the dim its tensor splits along over the
    mesh's ``model`` axis (0: the Q / K / V weights' head rows, 1: the
    ``fc`` weight's columns), or None (replicated).  ``num_heads`` must be
    a multiple of the axis size, so that each rank holds whole heads."""
    p = mesh.shape["model"]
    if num_heads % p != 0:
        raise ValueError(
            f"num_heads={num_heads} must be a multiple of the model-mesh "
            f"size {p} so each device holds whole heads")
    keys = list((state.state_dict() if isinstance(state, nn.Module)
                 else state).keys())
    present = set(keys)
    prefixes = set()
    for key in keys:
        head, _, leaf = key.rpartition(".")
        prefix, _, name = head.rpartition(".")
        prefix = prefix + "." if prefix else ""
        if name == "Q" and all(f"{prefix}{k}.weight" in present
                               for k in _ATTN_KEYS):
            prefixes.add(prefix)
    specs: Dict[str, Optional[int]] = {}
    for key in keys:
        specs[key] = None
        for prefix in prefixes:
            for k in _ATTN_KEYS:
                if key == f"{prefix}{k}.weight":
                    specs[key] = _SLICED_DIM[k]
    return specs


class TPLayout:
    """Which ``state_dict`` entries of a model are split over a mesh's
    ``model`` axis, and the gathers and slices between its local and full
    ``state_dict``s (and Adam's moments)."""

    def __init__(self, mesh: Mesh, specs: Dict[str, Optional[int]]):
        self.mesh = mesh
        self.specs = {k: d for k, d in specs.items() if d is not None}

    def slice(self, key: str, full: torch.Tensor) -> torch.Tensor:
        dim = self.specs.get(key)
        if dim is None:
            return full
        p, r = self.mesh.shape["model"], self.mesh.axis_rank("model")
        width = full.shape[dim] // p
        return full.narrow(dim, r * width, width).clone()

    def gather_state(self, state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The full ``state_dict`` from every model rank's local one."""
        return {k: (all_gather(v, self.mesh, "model", dim=self.specs[k])
                    if k in self.specs else v) for k, v in state.items()}

    def slice_state(self, state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's local ``state_dict`` from the full one."""
        return {k: self.slice(k, v) for k, v in state.items()}

    def _moments(self, model: nn.Module, opt_state: Dict, fn) -> Dict:
        """Adam's state_dict with ``fn(key, tensor)`` applied to the
        moments of the split parameters (indexed in ``parameters()``
        order, as ``make_optimizer`` registers them)."""
        names = [n for n, _ in model.named_parameters()]
        state = {}
        for idx, entry in opt_state["state"].items():
            name = names[idx]
            state[idx] = {
                k: (fn(name, v) if name in self.specs and k != "step"
                    else v) for k, v in entry.items()}
        return {**opt_state, "state": state}

    def gather_optimizer(self, model: nn.Module, opt_state: Dict) -> Dict:
        return self._moments(model, opt_state, lambda k, v: all_gather(
            v, self.mesh, "model", dim=self.specs[k]))

    def slice_optimizer(self, model: nn.Module, opt_state: Dict) -> Dict:
        return self._moments(model, opt_state, self.slice)


def shard_params_tp(model: nn.Module, mesh: Mesh, num_heads: int
                    ) -> TPLayout:
    """In place: each attention module keeps its rank's heads (Q / K / V
    rows, fc columns) and sums its ``fc`` partials over the mesh's
    ``model`` group; its attention-map dropout draws the whole head axis
    and keeps its heads.  Call before the optimizer is made, so that
    Adam's moments take the local shapes.  -> the layout."""
    specs = tp_shardings(model, mesh, num_heads)
    layout = TPLayout(mesh, specs)
    p, r = mesh.shape["model"], mesh.axis_rank("model")
    for prefix, module in attention_modules(model):
        for name in _ATTN_KEYS:
            linear = getattr(module, name)
            key = f"{prefix}.{name}.weight" if prefix else f"{name}.weight"
            with torch.no_grad():
                linear.weight = nn.Parameter(layout.slice(
                    key, linear.weight.detach()))
        module.tp = mesh
        module.attn_dropout.shard(1, r, p)
    return layout


@contextlib.contextmanager
def emulate_tp(model: nn.Module, p: int):
    """Inside: every attention module of ``model`` (full weights) runs as
    ``p`` model ranks in this process, each rank's heads through its
    slice of ``fc``, the partials summed in rank order."""
    modules = [m for _, m in attention_modules(model)]
    for module in modules:
        if module.num_head % p:
            raise ValueError(
                f"num_heads={module.num_head} must be a multiple of the "
                f"model-mesh size {p} so each device holds whole heads")
        module.tp_emulate = p
    try:
        yield modules
    finally:
        for module in modules:
            module.tp_emulate = 0


def head_slices(module: nn.Module, r: int, p: int
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Rank ``r`` of ``p``'s Q / K / V rows and fc columns of a module
    holding the full weights."""
    out = module.Q.weight.shape[0]
    w = out // p
    qkv = [getattr(module, k).weight[r * w:(r + 1) * w] for k in "QKV"]
    return qkv, module.fc.weight[:, r * w:(r + 1) * w]
