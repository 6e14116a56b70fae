"""Exact 0/1 knapsack by dense DP: on the host, and batched on the device.

Counterpart of edsnet_tpu/ops/knapsack.py: its host ``knapsack`` is
``knapsack_host`` here (with ``_knapsack_numpy``; it serves training-label
preparation), and its ``knapsack_jax`` is the batched device ``knapsack``.
Both keep the same reverse backtrack, so the selected set matches, not only
the value.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

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
                  capacity: int) -> List[int]:
    """Exact 0/1 knapsack on the host -> packed item indices, ascending.

    The dense DP at every table size.  The TPU package hands tables above
    5e7 cells to its native C++ branch and bound; the port does not load
    that library, and a shot knapsack at the 15 % budget stays far below
    that size."""
    return _knapsack_numpy(np.asarray(list(values), dtype=np.int64),
                           np.asarray(list(weights), dtype=np.int64),
                           int(capacity))


def knapsack(values: torch.Tensor, weights: torch.Tensor,
             capacity: torch.Tensor, max_capacity: int) -> torch.Tensor:
    """Per-row exact 0/1 knapsack.

    :param values: [B, N] int item values (padding items must have value 0).
    :param weights: [B, N] int item weights (>= 0).
    :param capacity: [B] int runtime capacities (<= max_capacity).
    :param max_capacity: DP-table width.
    :return: [B, N] bool mask of selected items.
    """
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
    for j in range(n - 1, -1, -1):
        t = takes[rows, j, c]
        selected[:, j] = t
        c = torch.where(t, torch.clamp(c - weights[:, j], min=0), c)
    return selected
