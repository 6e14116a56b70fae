"""Exact 0/1 knapsack by dense DP, batched, on the device.

Counterpart of edsnet_tpu/ops/knapsack.py:knapsack_jax.  The same table,
the same poisoned capacities above each row's runtime capacity and the same
reverse backtrack, so the selected set matches, not only the value.
"""
from __future__ import annotations

import torch

_NEG_BIG = -(10 ** 9)


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
