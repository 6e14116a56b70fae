"""Step timing: frames scored per second over training steps.

Counterpart of edsnet_tpu/utils/profiling.py:StepTimer.  A step's work is
queued on the device asynchronously and the timer does not wait for it, so
on a card it measures the host's enqueue time (the TPU package's
``--profile``, which waits per step, is not ported).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class StepTimer:
    """Step timing and frames/sec accounting."""
    frames: int = 0
    seconds: float = 0.0
    steps: int = 0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, frames: int):
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
