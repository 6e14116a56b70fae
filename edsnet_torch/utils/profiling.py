"""Step timing and the ``--profile`` trace.

Counterpart of edsnet_tpu/utils/profiling.py: ``StepTimer`` counts frames
scored per second over training steps, and ``maybe_trace`` records a
``torch.profiler`` trace (CPU activity, and CUDA activity on a card) where
the TPU package records a ``jax.profiler`` one.  A step's work is queued on
the device asynchronously: without ``sync`` the timer measures the host's
enqueue time; ``stop(frames, sync=t)`` first waits for the stream that
produced ``t``, which ``--profile`` does on every step.  The TPU package's
``NaNGuard`` has no caller there and is not ported.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger()


@dataclass
class StepTimer:
    """Step timing and frames/sec accounting."""
    frames: int = 0
    seconds: float = 0.0
    steps: int = 0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, frames: int, sync: Optional[torch.Tensor] = None):
        if sync is not None and sync.is_cuda:
            torch.cuda.current_stream(sync.device).synchronize()
        self.seconds += time.perf_counter() - self._t0
        self.frames += frames
        self.steps += 1

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    def summary(self) -> Dict[str, float]:
        return {"frames": self.frames, "seconds": round(self.seconds, 4),
                "steps": self.steps,
                "frames_per_sec": round(self.frames_per_sec, 2)}


def top_device_ops(prof, limit: int = 10) -> List[Tuple[str, float, int]]:
    """The device-side events (kernels, copies) of a finished trace with the
    most time -> [(name, ms, calls)], largest first; none on a CPU-only
    trace."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])[:limit]


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``
    (a Chrome trace, ``trace_<pid>.json``) when ``enabled``, and log the
    ops with the most device time."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    logger.info(f"profile trace: {path}; top device ops (name, ms, calls): "
                f"{top_device_ops(prof)}")
