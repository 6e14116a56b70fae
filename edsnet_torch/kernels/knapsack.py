"""The exact 0/1 knapsack on the card: the wrapper of ``csrc/knapsack.cu``.

``knapsack_dp`` takes int32 values, weights and capacities and launches
one kernel that runs the whole DP and backtrack of every row, one thread
block a row, writing the selection.  It takes CUDA tensors only and raises
on any other device; the plain twin is ``ops/knapsack.py:knapsack_plain``,
which ``ops/knapsack.py:knapsack`` runs for CPU tensors.
``knapsack_dp.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch


def _library():
    """The two C entry points, with their ctypes signatures: the scratch
    size (n and max_capacity as ints) and the launch (five pointers, b, n
    and max_capacity as ints, the stream)."""
    from edsnet_torch.kernels import build
    lib = build.load("knapsack")
    if lib.edsnet_knapsack.argtypes is None:
        lib.edsnet_knapsack_scratch_words.argtypes = [ctypes.c_int] * 2
        lib.edsnet_knapsack_scratch_words.restype = ctypes.c_longlong
        lib.edsnet_knapsack.argtypes = ([ctypes.c_void_p] * 5
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p])
        lib.edsnet_knapsack.restype = ctypes.c_int
    return lib


def knapsack_dp(values: torch.Tensor, weights: torch.Tensor,
                capacity: torch.Tensor, max_capacity: int) -> torch.Tensor:
    """Kernel wrapper: [B, N] int32 ``values`` and ``weights`` (>= 0) and
    [B] int32 ``capacity`` (0 <= capacity <= ``max_capacity``) -> [B, N]
    bool selection, equal to ``knapsack_plain``'s bit for bit.  Rows whose
    take bits (N x ceil((max_capacity + 1) / 32) words) do not fit in
    shared memory keep them in global scratch, allocated here."""
    name = "knapsack_dp"
    if values.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {values.device}")
    if values.dim() != 2 or max_capacity < 0:
        raise ValueError(f"{name}: values must be [B, N] and max_capacity "
                         f">= 0, got {tuple(values.shape)}, {max_capacity}")
    b, n = values.shape
    for arg, t, shape in (("values", values, (b, n)),
                          ("weights", weights, (b, n)),
                          ("capacity", capacity, (b,))):
        if (t.shape != shape or t.dtype != torch.int32
                or t.device != values.device):
            raise ValueError(f"{name}: {arg} must be a torch.int32 {shape} "
                             f"tensor on {values.device}")
    selected = torch.empty((b, n), dtype=torch.bool, device=values.device)
    if selected.numel() == 0:
        return selected
    values, weights, capacity = (t.contiguous()
                                 for t in (values, weights, capacity))
    lib = _library()
    with torch.cuda.device(values.device):
        words = lib.edsnet_knapsack_scratch_words(n, max_capacity)
        if words < 0:
            raise RuntimeError(f"{name}: cudaError reading the device's "
                               "shared-memory limit")
        scratch = torch.empty(b * words, dtype=torch.int32,
                              device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.edsnet_knapsack(values.data_ptr(), weights.data_ptr(),
                                  capacity.data_ptr(), selected.data_ptr(),
                                  scratch.data_ptr(), b, n, max_capacity,
                                  stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    knapsack_dp.launches += 1
    return selected


knapsack_dp.launches = 0
