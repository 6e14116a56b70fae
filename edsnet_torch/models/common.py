"""Shared model utilities: init scheme, dtype promotion, masked primitives,
dropout with an explicit generator, the fc block.

Init matches edsnet_tpu/models/common.py (the reference trainer's re-init):
xavier-uniform with gain sqrt(2) on every Linear weight, constant 0.1 bias,
LayerNorm weight 1 and bias 0 with eps 1e-5.  A module with raw parameters
or buffers of its own (the nystromformer's ``res_conv``, Linformer's
``proj_k`` / ``proj_v``, the DWT net's transposed conv, Performer's
``projection``, the LSTM cells, the GCN's ``bias``, the DenseGeneral
projections of the motion head's attentions) draws them in its
``init_leaves(generator)``.  Those projections keep flax MHA's own
defaults, not the trainer's re-init: ``lecun_normal_flat_`` and zero bias.

Dtypes follow JAX's promotion, not torch's refusals: a product or a norm
whose operands differ (float32 activations meeting bfloat16 weights under
``--compute-dtype bfloat16``, or a float32 constant meeting bfloat16 data)
runs in their common dtype, as flax's ``promote_dtype`` and jnp's binary
ops do.  ``Linear`` and ``LayerNorm`` do that for every layer of the port;
``promote`` does it at the other products.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def promote(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors cast to their common dtype (bfloat16 with float32 ->
    float32), as jnp promotes the operands of a product."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return tuple(t.to(dtype) for t in tensors)


class Linear(nn.Linear):
    """``nn.Linear`` on its input and parameters promoted to their common
    dtype, as flax's Dense computes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None:
            return F.linear(*promote(x, self.weight))
        return F.linear(*promote(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (eps 1e-5, the torch default the reference keeps)
    on its input and parameters promoted to their common dtype, as flax's
    LayerNorm computes."""

    def __init__(self, num_feature: int):
        super().__init__(num_feature, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = promote(x, self.weight, self.bias)
        return F.layer_norm(x, self.normalized_shape, w, b, self.eps)


def xavier2_(tensor: torch.Tensor, generator: torch.Generator,
             fan_in: int, fan_out: int) -> torch.Tensor:
    """In place U(+-sqrt(2) * sqrt(6 / (fan_in + fan_out))), flax's
    ``variance_scaling(2, fan_avg, uniform)``."""
    limit = math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return tensor.uniform_(-limit, limit, generator=generator)


def xavier2_flax_(param: torch.Tensor, generator: torch.Generator
                  ) -> torch.Tensor:
    """``xavier2_`` with flax's fan rule for a raw param of flax layout:
    fan_in = shape[-2] * r, fan_out = shape[-1] * r, r the product of the
    other dimensions (a (h, 1, 33, 1) ``res_conv`` has fan_in 33h and
    fan_out h, unlike torch's Conv2d rule)."""
    r = math.prod(param.shape[:-2])
    return xavier2_(param, generator, param.shape[-2] * r,
                    param.shape[-1] * r)


def lecun_normal_flat_(param: torch.Tensor, generator: torch.Generator,
                       n_in: int) -> torch.Tensor:
    """In place flax's ``lecun_normal`` (``variance_scaling(1, fan_in,
    truncated_normal)``) on a DenseGeneral kernel whose first ``n_in``
    dimensions are contracted: fan_in is their product, as flax draws the
    flat (prod(in), prod(out)) kernel and reshapes it.  The normal is cut
    at 2 of its own sigma, and sigma is sqrt(1 / fan_in) over the std of
    the unit normal cut there (0.8796...), so the draws' std is
    sqrt(1 / fan_in)."""
    std = math.sqrt(1.0 / math.prod(param.shape[:n_in])) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(param, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every Linear and LayerNorm under ``module``, and the
    raw leaves of every module with an ``init_leaves``, in place, drawing
    from ``generator`` in module order."""
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            fan_out, fan_in = sub.weight.shape
            xavier2_(sub.weight, generator, fan_in, fan_out)
            if sub.bias is not None:
                with torch.no_grad():
                    sub.bias.fill_(0.1)
        elif isinstance(sub, nn.LayerNorm):
            nn.init.ones_(sub.weight)
            nn.init.zeros_(sub.bias)
        elif hasattr(sub, "init_leaves"):
            sub.init_leaves(generator)


def randomize_cnn_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights, in place, for a frame CNN where no
    checkpoint exists (the tests, chip_smoke.py), drawn from ``generator``
    on the CPU in ``state_dict`` order: conv and Linear weights
    N(0, 1 / fan_in); 1-D weights (norms) 1 + N(0, 0.1^2); biases
    N(0, 0.05^2); BatchNorm running means N(0, 0.1^2) and running
    variances U[0.5, 1.5); ConvNeXt's ``layer_scale`` U[0.05, 0.15);
    Swin's ``logit_scale`` U[1.5, 3).  Swin's computed buffers and BN's
    ``num_batches_tracked`` are kept."""
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("num_batches_tracked", "relative_coords_table",
                        "relative_position_index"):
                continue
            shape = t.shape
            if leaf == "running_var":
                draw = torch.rand(shape, generator=generator) + 0.5
            elif leaf == "layer_scale":
                draw = 0.05 + 0.1 * torch.rand(shape, generator=generator)
            elif leaf == "logit_scale":
                draw = 1.5 + 1.5 * torch.rand(shape, generator=generator)
            elif leaf == "weight" and len(shape) >= 2:
                draw = torch.randn(shape, generator=generator) / math.sqrt(
                    math.prod(shape[1:]))
            elif leaf == "weight":
                draw = 1.0 + 0.1 * torch.randn(shape, generator=generator)
            elif leaf == "running_mean":
                draw = 0.1 * torch.randn(shape, generator=generator)
            else:
                draw = 0.05 * torch.randn(shape, generator=generator)
            t.copy_(draw)


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax with an optional boolean mask (False = excluded, scored at
    the dtype's most negative finite value)."""
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    return torch.softmax(logits, dim=dim)


def apply_mask(x: torch.Tensor, mask: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Zero features at invalid positions. x: [..., N, F]; mask: [..., N]."""
    if mask is None:
        return x
    return x * mask[..., None].to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12
                 ) -> torch.Tensor:
    """x over its L2 norm along ``dim``, floored at ``eps`` (torch's
    ``F.normalize``).  The double ``where`` keeps the gradient of an
    all-zero row finite (0): the norm's derivative at 0 is infinite, and
    even a zero cotangent through a plain floor makes it NaN."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    safe = torch.sqrt(torch.where(sq > 0, sq, 1.0))
    return x / torch.clamp(torch.where(sq > 0, safe, 0.0), min=eps)


class Dropout(nn.Module):
    """Inverted dropout that draws its keep mask from ``self.generator``
    (the trainer's dropout stream, see ``set_dropout_generator``), or from
    the global generator while that is None.  Identity in eval mode.

    Under a mesh, the input is one block of a larger tensor: ``shards``
    lists (dim, index, count), block ``index`` of ``count`` along ``dim``
    (the rank's rows of the batch, its heads of the attention map).  The
    keep mask is then drawn at the whole tensor's shape and cut to the
    block, so that every rank's generator draws the same numbers, as
    JAX's keys are the same under any sharding, and the mask equals one
    process's."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None
        self.shards: Tuple[Tuple[int, int, int], ...] = ()

    def shard(self, dim: int, index: int, count: int) -> None:
        """Draw as block ``index`` of ``count`` along ``dim`` (replacing
        an earlier rule for ``dim``; ``count`` 1 removes it)."""
        rest = tuple(s for s in self.shards if s[0] != dim)
        self.shards = rest + (((dim, index, count),) if count > 1 else ())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if not self.shards:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) >= self.p
        else:
            full = list(x.shape)
            for dim, _, count in self.shards:
                full[dim] *= count
            u = torch.rand(full, generator=self.generator, device=x.device)
            for dim, index, _ in self.shards:
                u = u.narrow(dim, index * x.shape[dim], x.shape[dim])
            keep = u >= self.p
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every ``Dropout`` under ``module`` at ``generator``."""
    for sub in module.modules():
        if isinstance(sub, Dropout):
            sub.generator = generator


def shard_dropout_rows(module: nn.Module, index: int, count: int) -> None:
    """Every ``Dropout`` under ``module`` draws as block ``index`` of
    ``count`` of the batch rows (``Dropout.shards``)."""
    for sub in module.modules():
        if isinstance(sub, Dropout):
            sub.shard(0, index, count)


class FcBlock(nn.Module):
    """Linear -> ReLU -> Dropout(0.5) -> LayerNorm (the reference fc_block).

    Submodule names follow the flax param tree (``Dense_0``,
    ``LayerNorm_0``) so the weight bridge maps names one to one."""

    def __init__(self, in_features: int, num_hidden: int,
                 dropout: float = 0.5):
        super().__init__()
        self.Dense_0 = Linear(in_features, num_hidden)
        self.dropout = Dropout(dropout)
        self.LayerNorm_0 = LayerNorm(num_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(self.dropout(torch.relu(self.Dense_0(x))))


class PreNormStack(nn.Module):
    """``depth`` blocks of x + attn(LN(x)) then x + FF(LN(x)), the FF being
    Linear -> exact-erf GELU -> Dropout -> Linear -> Dropout (Performer and
    Linformer).  Names follow the flax tree: ``attn_norm_{i}``,
    ``attn_{i}``, ``ff_norm_{i}``, ``ff1_{i}``, ``ff2_{i}``."""

    def __init__(self, dim: int, depth: int, mlp_dim: int, dropout: float,
                 make_attention: Callable[[], nn.Module]):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", LayerNorm(dim))
            self.add_module(f"attn_{i}", make_attention())
            self.add_module(f"ff_norm_{i}", LayerNorm(dim))
            self.add_module(f"ff1_{i}", Linear(dim, mlp_dim))
            self.add_module(f"ff2_{i}", Linear(mlp_dim, dim))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        for i in range(self.depth):
            attn_norm, attn, ff_norm, ff1, ff2 = (
                getattr(self, f"{name}_{i}")
                for name in ("attn_norm", "attn", "ff_norm", "ff1", "ff2"))
            x = attn(attn_norm(x), mask) + x
            f = self.dropout(F.gelu(ff1(ff_norm(x))))
            x = self.dropout(ff2(f)) + x
        return x
