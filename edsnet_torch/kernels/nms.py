"""The greedy NMS sweep on the card: the wrapper of ``csrc/nms.cu``.

``nms_sweep`` takes what ``ops/bbox.py:nms_masked`` prepares (the float32
boxes, the alive mask and the score order) and launches one kernel that
runs the whole greedy sweep of every row, one thread block a row, writing
keep in the original order.  It takes CUDA tensors only and raises on any
other device; the plain twin is ``ops/bbox.py:nms_masked_plain``, which
``nms_masked`` runs for CPU tensors.  ``nms_sweep.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes

import torch


def _library():
    """The C entry point, with its ctypes signature: five pointers, b and
    n as ints, thresh as a float32, the stream."""
    from edsnet_torch.kernels import build
    fn = build.load("nms").edsnet_nms_sweep
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def nms_sweep(bboxes: torch.Tensor, alive: torch.Tensor, order: torch.Tensor,
              thresh: float) -> torch.Tensor:
    """Kernel wrapper: [B, N, 2] float32 LR boxes, [B, N] bool ``alive`` and
    [B, N] int64 ``order`` (the sorted slot's original index) -> keep [B, N]
    bool over the original order, suppressing at IoU >= ``thresh`` (as a
    float32)."""
    name = "nms_sweep"
    if bboxes.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {bboxes.device}")
    b, n = alive.shape
    for arg, t, shape, dtype in (("bboxes", bboxes, (b, n, 2), torch.float32),
                                 ("alive", alive, (b, n), torch.bool),
                                 ("order", order, (b, n), torch.int64)):
        if (t.shape != shape or t.dtype != dtype
                or t.device != bboxes.device):
            raise ValueError(f"{name}: {arg} must be a {dtype} {shape} "
                             f"tensor on {bboxes.device}")
    keep = torch.empty((b, n), dtype=torch.bool, device=bboxes.device)
    if keep.numel() == 0:
        return keep
    bboxes, alive, order = (t.contiguous() for t in (bboxes, alive, order))
    kept_list = torch.empty((b, n, 2), dtype=torch.float32,
                            device=bboxes.device)
    fn = _library()
    with torch.cuda.device(bboxes.device):
        stream = torch.cuda.current_stream(bboxes.device).cuda_stream
        err = fn(bboxes.data_ptr(), alive.data_ptr(), order.data_ptr(),
                 keep.data_ptr(), kept_list.data_ptr(), b, n, thresh, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    nms_sweep.launches += 1
    return keep


nms_sweep.launches = 0
