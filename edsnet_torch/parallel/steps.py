"""The train steps: (anchor-based) label sampling, forward, masked losses,
backward and the Adam update over one padded batch of videos.

Counterpart of edsnet_tpu/parallel/steps.py (``make_optimizer``,
``resolve_batch``, ``_sample_marks``, ``build_ab_cls_labels``,
``ab_train_step``, ``af_train_step``).  The step queues its work on the
device and returns its losses as device tensors: nothing in it waits for
the device.  The model runs in training mode, so the attention backbone
takes its dense path with dropout on the attention map, as the TPU
package's step does.

Under a ``mesh`` (parallel/mesh.py) each rank steps on its rows of the
global batch: the weight sum of the denominator and the losses are summed
over the ``data`` ranks, and so are the gradients before Adam, so that the
update is the one-device update on the global batch (an explicit sum, not
DDP, whose mean would need the loss scaled by the data size).  With more
than one data rank, the label draws are made at the global batch's shape
and cut to the rank's rows, as the dropout masks are
(models/common.py:Dropout), so every rank's generators stay in step.

``compute_dtype="bfloat16"`` is JAX's mixed precision: the forward runs
on a bfloat16 copy of the float parameters (buffers, like Performer's
``projection``, stay float32, as JAX's ``constants`` do) and on the input
(and the motion head's motion features) cast to bfloat16, its outputs are
cast to float32, and the gradients reach the float32 masters through the
cast; losses and Adam stay float32.
Products whose operands end up mixed run in float32, as in JAX
(models/common.py:promote).  ``remat`` recomputes the forward in the
backward (``torch.utils.checkpoint``), replaying the dropout generators'
states so that the recomputation draws the same masks.

The tracer (utils/profiling.py) sees a step as the span
``steps/train_step``, fenced on the model's device, over ``steps/labels``,
``steps/forward``, ``steps/loss``, ``steps/backward`` and ``steps/adam``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from edsnet_torch.models.common import Dropout
from edsnet_torch.ops import losses as L
from edsnet_torch.parallel.mesh import Mesh, all_reduce_sum
from edsnet_torch.utils.profiling import span


def make_optimizer(params, lr: float, weight_decay: float
                   ) -> torch.optim.Optimizer:
    """Adam whose L2 term is added to the gradient before the moments
    (torch's ``weight_decay``; optax ``add_decayed_weights`` then
    ``adam`` in the TPU package)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def resolve_batch(batch: Dict) -> Dict:
    """A batch is either explicit tensors, or a length-bucket ``pool``
    resident on the device plus this step's row indices (``gather_idx``)
    and validity (``video_valid``), gathered here on the device."""
    if "pool" not in batch:
        return batch
    idx = batch["gather_idx"]
    out = {k: v[idx] for k, v in batch["pool"].items()}
    out["video_valid"] = batch["video_valid"]
    return out


def _sample_marks(eligible: torch.Tensor, num: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Mark the ``num[b]`` eligible entries of each row b with the smallest
    uniform draws ``u`` (ties broken by flat index), exactly ``min(num,
    eligible)`` of them.

    :param eligible: [B, ...] bool.
    :param num: [B] int.
    :param u: uniform draws, the shape of ``eligible``.
    :return: [B, ...] bool marks.
    """
    b = eligible.shape[0]
    flat = eligible.reshape(b, -1)
    draws = torch.where(flat, u.reshape(b, -1), torch.inf)
    order = torch.argsort(draws, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(flat.shape[1], device=flat.device)
        .expand_as(order))
    return (flat & (rank < num[:, None])).reshape(eligible.shape)


def build_ab_cls_labels(batch: Dict, generator: Optional[torch.Generator],
                        neg_ratio: float, inc_ratio: float,
                        rows: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """Per-video random negatives and incompletes -> -1/0/1 labels; the
    uniform draws come from ``generator``.  ``rows`` (index, count): the
    batch is block ``index`` of ``count`` of the global batch's rows, and
    each draw is made at the global shape and cut to the block."""
    num_pos = batch["num_pos"]
    num_neg = (neg_ratio * num_pos).to(torch.int32)
    num_inc = (inc_ratio * num_pos).to(torch.int32)
    device = num_pos.device

    def draws(shape):
        if rows is None:
            return torch.rand(shape, generator=generator, device=device)
        index, count = rows
        u = torch.rand((shape[0] * count,) + tuple(shape[1:]),
                       generator=generator, device=device)
        return u[index * shape[0]:(index + 1) * shape[0]]

    neg = _sample_marks(batch["neg_eligible"], num_neg,
                        draws(batch["neg_eligible"].shape))
    inc = _sample_marks(batch["inc_eligible"], num_inc,
                        draws(batch["inc_eligible"].shape))
    return torch.where(neg | inc, -1, batch["cls_pos"])


def _dropout_replay(model: nn.Module):
    """``checkpoint``'s ``context_fn``: the first pass saves the states of
    the model's dropout generators, the recomputation starts from them and
    leaves them as the first pass did."""
    gens = list({id(m.generator): m.generator for m in model.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 }.values())
    saved = []

    @contextlib.contextmanager
    def first_pass():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        after = [g.get_state() for g in gens]
        for g, state in zip(gens, saved):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, after):
                g.set_state(state)

    return lambda: (first_pass(), recompute())


def train_forward(model: nn.Module, x: torch.Tensor, mask: torch.Tensor,
                  remat: bool = False, compute_dtype: str = "float32",
                  motion: Optional[torch.Tensor] = None,
                  motion_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """The model's outputs on (x, mask), or on (x, motion, mask,
    motion_mask) for the motion head, in float32, computed in
    ``compute_dtype`` and recomputed in the backward if ``remat`` (the
    motion features are an input of the recomputed function, as in
    JAX's jax.checkpoint)."""
    dtype = getattr(torch, compute_dtype)

    def run(x, motion):
        if dtype != torch.float32:
            x = x.to(dtype)
            motion = None if motion is None else motion.to(dtype)
        inputs = (x, mask) if motion is None else (x, motion, mask,
                                                   motion_mask)
        if dtype == torch.float32:
            out = model(*inputs)
        else:
            params = {n: p.to(dtype) if p.is_floating_point() else p
                      for n, p in model.named_parameters()}
            out = torch.func.functional_call(model, params, inputs)
        return tuple(t.to(torch.float32) for t in out)

    if not remat:
        return run(x, motion)
    return checkpoint(run, x, motion, use_reentrant=False,
                      context_fn=_dropout_replay(model))


def data_rows(mesh: Optional[Mesh]) -> Optional[Tuple[int, int]]:
    """(this rank's index, count) on the mesh's ``data`` axis, or None
    without a process group or with one data rank (draws as one
    process)."""
    if mesh is None or not mesh.distributed or mesh.shape["data"] == 1:
        return None
    return mesh.axis_rank("data"), mesh.shape["data"]


def _sum_over_data(tensors: List[torch.Tensor], mesh: Optional[Mesh]
                   ) -> None:
    """In place: ``tensors`` summed over the ``data`` ranks, in one
    all-reduce of their concatenation."""
    if mesh is None or not mesh.distributed or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_sum(flat, mesh, "data")
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _update(model: nn.Module, optimizer: torch.optim.Optimizer,
            loss: torch.Tensor, mesh: Optional[Mesh]) -> None:
    """Backward, the gradients summed over the data ranks, Adam."""
    optimizer.zero_grad(set_to_none=True)
    with span("steps/backward"):
        loss.backward()
    _sum_over_data([p.grad for p in model.parameters()
                    if p.grad is not None], mesh)
    with span("steps/adam"):
        optimizer.step()


def _weight_sum(w: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """max(sum of the global batch's video weights, 1)."""
    total = w.sum()
    _sum_over_data([total], mesh)
    return torch.clamp(total, min=1.0)


def _global_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                    ) -> Dict[str, torch.Tensor]:
    """Each rank's share of the losses summed over the data ranks."""
    if mesh is None or not mesh.distributed:
        return metrics
    stacked = torch.stack(list(metrics.values()))
    _sum_over_data([stacked], mesh)
    return dict(zip(metrics, stacked.unbind()))


def ab_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  batch: Dict, generator: Optional[torch.Generator], *,
                  lambda_reg: float, neg_ratio: float, inc_ratio: float,
                  cls_label: Optional[torch.Tensor] = None,
                  remat: bool = False, compute_dtype: str = "float32",
                  mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One step over a padded batch -> {loss, cls_loss, loc_loss} as
    device scalars.

    Labels are sampled with ``generator`` unless ``cls_label`` [B, N, S]
    is given.  Per-video losses are weighted by ``video_valid & num_pos >
    0`` over ``max(sum of weights, 1)``.  Dropout draws from the model's
    own generators (models/common.py:set_dropout_generator).  ``remat``
    and ``compute_dtype`` as in the module docstring; ``batch`` holds this
    rank's rows of ``mesh``'s ``data`` axis."""
    with span("steps/train_step", fence=model):
        batch = resolve_batch(batch)
        if cls_label is None:
            with span("steps/labels"):
                cls_label = build_ab_cls_labels(batch, generator, neg_ratio,
                                                inc_ratio,
                                                rows=data_rows(mesh))
        w = (batch["video_valid"] & (batch["num_pos"] > 0)).to(torch.float32)
        denom = _weight_sum(w, mesh)

        model.train()
        with span("steps/forward"):
            pred_cls, pred_loc = train_forward(
                model, batch["seq"], batch["mask"], remat, compute_dtype,
                batch.get("motion"), batch.get("motion_mask"))
        with span("steps/loss"):
            loc = L.ab_loc_loss(pred_loc, batch["loc_label"], cls_label)
            cls = L.ab_cls_loss(pred_cls, cls_label)
            loss = ((cls + lambda_reg * loc) * w).sum() / denom

        _update(model, optimizer, loss, mesh)
        with torch.no_grad():
            return _global_metrics({
                "loss": loss.detach(), "cls_loss": (cls * w).sum() / denom,
                "loc_loss": (loc * w).sum() / denom}, mesh)


def af_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                  batch: Dict, *, lambda_reg: float, lambda_ctr: float,
                  cls_kind: str, reg_kind: str, remat: bool = False,
                  compute_dtype: str = "float32",
                  mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One anchor-free step over a padded batch -> {loss, cls_loss,
    loc_loss, ctr_loss} as device scalars.

    Per video: ``cls_kind`` (--cls-loss) over the mask + ``lambda_reg`` x
    ``reg_kind`` (--reg-loss) over the target's positions + ``lambda_ctr``
    x the centerness BCE there; videos are weighted by ``video_valid``
    alone (a video without positives still counts, unlike the anchor-based
    step) over ``max(sum of weights, 1)``.  The labels are the batch's, so
    nothing is drawn but dropout, from the model's own generators;
    ``remat`` and ``compute_dtype`` as in the module docstring; ``mesh``
    as ``ab_train_step``'s."""
    with span("steps/train_step", fence=model):
        batch = resolve_batch(batch)
        w = batch["video_valid"].to(torch.float32)
        denom = _weight_sum(w, mesh)
        target = batch["target"]

        model.train()
        with span("steps/forward"):
            pred_cls, pred_loc, pred_ctr = train_forward(
                model, batch["seq"], batch["mask"], remat, compute_dtype)
        with span("steps/loss"):
            cls = L.af_cls_loss(pred_cls, target, cls_kind, batch["mask"])
            loc = L.af_loc_loss(pred_loc, batch["af_loc"], target, reg_kind)
            ctr = L.af_ctr_loss(pred_ctr, batch["af_ctr"], target)
            loss = ((cls + lambda_reg * loc + lambda_ctr * ctr) * w).sum() \
                / denom

        _update(model, optimizer, loss, mesh)
        with torch.no_grad():
            return _global_metrics({
                "loss": loss.detach(), "cls_loss": (cls * w).sum() / denom,
                "loc_loss": (loc * w).sum() / denom,
                "ctr_loss": (ctr * w).sum() / denom}, mesh)
