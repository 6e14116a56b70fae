"""ctypes loader for the native C++ host library, ``csrc/edsnet_native.cpp``.

Counterpart of edsnet_tpu/native/__init__.py, built from the port's own
copy of the source.  ``g++`` compiles it at first use into
``kernels/_build/libedsnet_native-<hash>.so``, keyed by the source and the
flags as ``kernels/build.py`` keys the CUDA sources.  Two entry points:
``eds_knapsack`` (exact branch and bound, for ``ops/knapsack.py:
knapsack_host``'s ``bnb`` solver and the evaluator's knapsack audit) and
``eds_kts_dp`` (the KTS change-point DP, for ``ops/kts.py``).

``load()`` returns None when g++ or the build fails, or when
``EDSNET_NO_NATIVE`` is set; every caller then takes its numpy fallback,
as in the TPU package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from edsnet_torch.kernels.build import BUILD_DIR, SRC_DIR

SOURCE = SRC_DIR / "edsnet_native.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_cached: Optional["NativeLib"] = None
_failed = False


class NativeLib:
    """Typed wrappers around the library's two C entry points."""

    def __init__(self, lib: ctypes.CDLL, path: Path):
        self._lib = lib
        self.path = path
        lib.eds_knapsack.restype = ctypes.c_int64
        lib.eds_knapsack.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.eds_kts_dp.restype = None
        lib.eds_kts_dp.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ]

    def knapsack(self, values: np.ndarray, weights: np.ndarray,
                 capacity: int) -> List[int]:
        """Exact 0/1 knapsack by branch and bound -> packed item indices,
        ascending."""
        values = np.ascontiguousarray(values, dtype=np.int64)
        weights = np.ascontiguousarray(weights, dtype=np.int64)
        n = len(values)
        if values.shape != (n,) or weights.shape != (n,):
            raise ValueError(f"knapsack: values {values.shape} and weights "
                             f"{weights.shape} must be [n] each")
        out = np.zeros(n, dtype=np.uint8)
        self._lib.eds_knapsack(
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            weights.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int32(n), ctypes.c_int64(int(capacity)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return [int(i) for i in np.where(out == 1)[0]]

    def kts_dp(self, J: np.ndarray, m: int, lmin: int, lmax: int,
               backtrack: bool):
        """KTS DP over the [n, n] scatter matrix ``J`` -> (scores [m + 1],
        path [m + 1, n + 1] int32)."""
        J = np.ascontiguousarray(J, dtype=np.float64)
        n = J.shape[0]
        if J.shape != (n, n) or lmin < 1 or m < 0:
            raise ValueError(f"kts_dp: J must be square, got {J.shape}, "
                             f"with m >= 0 and lmin >= 1")
        scores = np.zeros(m + 1, dtype=np.float64)
        path = np.zeros((m + 1, n + 1), dtype=np.int32)
        self._lib.eds_kts_dp(
            J.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int32(n), ctypes.c_int32(m), ctypes.c_int32(lmin),
            ctypes.c_int32(min(lmax, 10 ** 9)), ctypes.c_int32(int(backtrack)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            path.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return scores, path


def lib_path() -> Path:
    """The library's path in the build cache, keyed by source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libedsnet_native-{digest[:16]}.so"


def _build() -> Optional[Path]:
    target = lib_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        tmp.replace(target)
    except (OSError, subprocess.SubprocessError):   # no g++, or it failed
        tmp.unlink(missing_ok=True)
        return None
    return target


def load() -> Optional[NativeLib]:
    """Build (once) and load the library; None if it is unavailable."""
    global _cached, _failed
    if _cached is not None:
        return _cached
    if _failed or os.environ.get("EDSNET_NO_NATIVE"):
        return None
    with _lock:
        if _cached is not None or _failed:
            return _cached
        path = _build()
        if path is None:
            _failed = True
            return None
        try:
            _cached = NativeLib(ctypes.CDLL(str(path)), path)
        except OSError:
            _failed = True
            return None
    return _cached
