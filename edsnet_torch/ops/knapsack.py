"""Exact 0/1 knapsack: on the host, and batched on the device.

Counterpart of edsnet_tpu/ops/knapsack.py: its host ``knapsack`` is
``knapsack_host`` here (the dense DP ``_knapsack_numpy`` or the native C++
branch and bound; it serves training-label preparation and the host
evaluator), and its ``knapsack_jax`` is the batched device ``knapsack``.
On a CUDA tensor that is one launch of the kernel ``csrc/knapsack.cu``
(``kernels/knapsack.py:knapsack_dp``), on a CPU tensor its plain twin
``knapsack_plain``, JAX's two scans written as two loops.  The DPs keep
the same reverse backtrack, so the selected set matches, not only the
value.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from edsnet_torch.kernels.knapsack import knapsack_dp
from edsnet_torch.native import load as _native_load
from edsnet_torch.utils.profiling import count, count_nonzero, span

_NEG_BIG = -(10 ** 9)


def _knapsack_numpy(values: np.ndarray, weights: np.ndarray,
                    capacity: int) -> List[int]:
    """Dense DP with a reverse backtrack; O(n * capacity) time and bits."""
    n = len(values)
    if n == 0 or capacity <= 0:
        return []
    cap = int(capacity)
    dp = np.zeros(cap + 1, dtype=np.int64)
    take = np.zeros((n, cap + 1), dtype=bool)
    for i in range(n):
        w, v = int(weights[i]), int(values[i])
        if w <= cap and v > 0:
            cand = dp[: cap + 1 - w] + v
            better = cand > dp[w:]
            take[i, w:] = better
            dp[w:] = np.where(better, cand, dp[w:])
    packed: List[int] = []
    c = cap
    for i in range(n - 1, -1, -1):
        if take[i, c]:
            packed.append(i)
            c -= int(weights[i])
    packed.reverse()
    return packed


def knapsack_host(values: Iterable[int], weights: Iterable[int],
                  capacity: int, solver: str = "auto") -> List[int]:
    """Exact 0/1 knapsack on the host -> packed item indices, ascending.

    ``solver="auto"`` runs the dense DP up to 5e7 table cells and the
    native branch and bound (``native.py``) above that, or the DP when the
    library is unavailable.  ``"dp"`` and ``"bnb"`` force one solver: both
    are exact on the value, but on tied optima they may pack different
    items (the knapsack audit measures that); ``"bnb"`` raises
    ``RuntimeError`` without the library."""
    values = np.asarray(list(values), dtype=np.int64)
    weights = np.asarray(list(weights), dtype=np.int64)
    capacity = int(capacity)
    if solver == "dp":
        return _knapsack_numpy(values, weights, capacity)
    if solver == "bnb":
        lib = _native_load()
        if lib is None:
            raise RuntimeError("native C++ knapsack unavailable")
        return lib.knapsack(values, weights, capacity)
    if solver != "auto":
        raise ValueError(f"unknown knapsack solver {solver!r}")
    if values.size * max(capacity, 1) <= 50_000_000:
        return _knapsack_numpy(values, weights, capacity)
    lib = _native_load()
    if lib is not None:
        return lib.knapsack(values, weights, capacity)
    return _knapsack_numpy(values, weights, capacity)


def knapsack_plain(values: torch.Tensor, weights: torch.Tensor,
                   capacity: torch.Tensor, max_capacity: int) -> torch.Tensor:
    """Plain PyTorch twin of the knapsack kernel (``csrc/knapsack.cu``),
    with the arguments and result of ``knapsack``: JAX's two scans as two
    loops, about 12 launches an item in the DP (the tracer's span
    ``knapsack/dp``) and 5 in the backtrack (``knapsack/backtrack``)."""
    values = values.to(torch.int32)
    weights = weights.to(torch.int32)
    capacity = capacity.to(torch.int32)
    b, n = values.shape
    device = values.device
    cap_axis = torch.arange(max_capacity + 1, dtype=torch.int32,
                            device=device)
    neg = torch.full((b, max_capacity), _NEG_BIG, dtype=torch.int32,
                     device=device)
    # capacities above the runtime capacity are poisoned so backtracking
    # from `capacity` never routes through them
    dp = torch.where(cap_axis[None, :] <= capacity[:, None], 0,
                     _NEG_BIG).to(torch.int32)
    takes = torch.zeros((b, n, max_capacity + 1), dtype=torch.bool,
                        device=device)
    with span("knapsack/dp"):
        for i in range(n):
            v, w = values[:, i], weights[:, i]
            # dp'[c] = max(dp[c], dp[c - w] + v) for c >= w
            padded = torch.cat([neg, dp], dim=1)
            # the start index is clamped like lax.dynamic_slice clamps it
            start = torch.clamp(max_capacity - w, 0, max_capacity)
            idx = start[:, None] + cap_axis[None]
            shifted = torch.gather(padded, 1, idx.to(torch.int64)) + v[:, None]
            usable = (w <= capacity) & (v > 0)
            cand = torch.where(usable[:, None], shifted, -1)
            took = cand > dp
            dp = torch.where(took, cand, dp)
            takes[:, i] = took

    c = capacity.to(torch.int64)
    rows = torch.arange(b, device=device)
    selected = torch.zeros((b, n), dtype=torch.bool, device=device)
    with span("knapsack/backtrack"):
        for j in range(n - 1, -1, -1):
            t = takes[rows, j, c]
            selected[:, j] = t
            c = torch.where(t, torch.clamp(c - weights[:, j], min=0), c)
    return selected


def knapsack(values: torch.Tensor, weights: torch.Tensor,
             capacity: torch.Tensor, max_capacity: int) -> torch.Tensor:
    """Per-row exact 0/1 knapsack.

    :param values: [B, N] int item values (padding items must have value 0).
    :param weights: [B, N] int item weights (>= 0).
    :param capacity: [B] int runtime capacities (0 <= capacity <=
        max_capacity).
    :param max_capacity: DP-table width.
    :return: [B, N] bool mask of selected items.

    CUDA tensors launch the kernel (``kernels/knapsack.py:knapsack_dp``)
    once, for the DP and backtrack of every row, inside the tracer's span
    ``knapsack/dp``; CPU tensors take the plain twin ``knapsack_plain``,
    whose two loops are the spans ``knapsack/dp`` and
    ``knapsack/backtrack``.  The tracer's counters add the rows
    (``knapsack.rows``), the two loops' trips, walked inside the kernel on
    the card (``knapsack.steps``, 2 N), the item slots (``knapsack.slots``)
    and the real items, of weight above 0 (``knapsack.live``).
    """
    values = values.to(torch.int32)
    weights = weights.to(torch.int32)
    capacity = capacity.to(torch.int32)
    b, n = values.shape
    if values.device.type == "cpu":
        selected = knapsack_plain(values, weights, capacity, max_capacity)
    else:
        with span("knapsack/dp"):
            selected = knapsack_dp(values, weights, capacity, max_capacity)
    count("knapsack.rows", b)
    count("knapsack.steps", 2 * n)
    count("knapsack.slots", b * n)
    count_nonzero("knapsack.live", weights)
    return selected
