"""The traced run's two extra phases and what the per-layer metrics read.

- ``profile_phase``: ``torch.profiler`` (CPU and CUDA activity) over the
  driver's work, from a synchronise until ``seconds`` have passed, then a
  synchronise and stop (the unit running then finishes untraced; the calls
  whose arguments a metric reads are kept only while the profiler is on,
  so that they match the kernels in the trace).  Every
  name the cell's metrics read is labelled in the trace (no sync), so an
  idle gap of the device is put down to the layer the host was in.
  Reduced to the device's busy time (the union of its operations'
  intervals), the window, the device operations with the most time, and
  the idle gaps summed by label: a frozen copy of ``top_device_ops``'s
  arithmetic over the CUDA events, done on the trace's events.
- ``span_phase``: the driver's work with every span target wrapped in a
  synchronised host-clock span (``hooks.Spans``), for ``seconds`` (at
  least one unit).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from portbench.lib import hooks

OTHER = "outside the labelled layers"
NAME_CHARS = 120    # a kernel's name in the breakdown, cut (C++ templates)


@dataclass
class Trace:
    """What a per-layer metric's ``read`` gets."""
    cell: object
    window: Dict                                  # the measured window's
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    span_units: int = 0
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    calls: Dict[str, List] = field(default_factory=dict)
    breakdown: Dict = field(default_factory=dict)


def _union(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events, labels: Iterable[str], top: int = 10) -> Dict:
    """busy_s, window_s, kernels [(name, start_s, end_s)] and the
    breakdown from a finished profile's events."""
    from torch.autograd import DeviceType
    labels = set(labels)
    kernels, annotations, lo, hi = [], [], None, None
    for e in events:
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        lo = a if lo is None else min(lo, a)
        hi = b if hi is None else max(hi, b)
        if e.device_type == DeviceType.CUDA:
            # a label's range on the device's timeline is no operation
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, a, b))
        elif e.name in labels:
            annotations.append((a, b, e.name))
    busy = _union((a, b) for _, a, b in kernels)
    by_name: Dict[str, float] = {}
    for name, a, b in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    gaps = []
    edge = lo
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if hi is not None and hi > edge:
        gaps.append((edge, hi))
    # sweep: the labels open at each gap's start, innermost last
    bounds = sorted([(s, 1, i) for i, (s, _, _) in enumerate(annotations)]
                    + [(e, 0, i) for i, (_, e, _) in enumerate(annotations)])
    idle: Dict[str, float] = {}
    open_: List[int] = []
    j = 0
    for a, b in gaps:
        while j < len(bounds) and bounds[j][0] <= a:
            _, is_open, i = bounds[j]
            if is_open:
                open_.append(i)
            elif i in open_:
                open_.remove(i)
            j += 1
        name = annotations[open_[-1]][2] if open_ else OTHER
        idle[name] = idle.get(name, 0.0) + (b - a)
    return {
        "kernels": kernels,
        "busy_s": sum(b - a for a, b in busy),
        "window_s": (hi - lo) if lo is not None else 0.0,
        "breakdown": {
            "device_ops": sorted(([k[:NAME_CHARS], v]
                                  for k, v in by_name.items()),
                                 key=lambda r: -r[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda r: -r[1])[:top]}}


def profile_phase(trace: Trace, unit: Callable[[], object], seconds: float,
                  labels: Iterable[str], calls: Iterable[str],
                  device: torch.device) -> None:
    from torch.profiler import ProfilerActivity, profile
    labels, calls = list(labels), list(calls)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state = {"on": False, "t0": 0.0}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def maybe_stop():
        if state["on"] and time.perf_counter() - state["t0"] >= seconds:
            sync()
            prof.stop()
            state["on"] = False

    recorded = {target: [] for target in calls}
    wrappers = {t: hooks.labelled(t, maybe_stop) for t in labels}
    for t in calls:
        inner = wrappers.get(t)
        # a call is kept only while the profiler is on: a call that stops
        # it (its labelled wrapper's ``maybe_stop`` runs first) and the
        # rest of that unit leave no kernel in the trace
        rec = hooks.recorded(recorded[t], lambda: state["on"])
        wrappers[t] = (rec if inner is None
                       else (lambda fn, i=inner, r=rec: i(r(fn))))
    with hooks.patched(wrappers):
        sync()
        prof.start()
        state.update(on=True, t0=time.perf_counter())
        while state["on"]:
            unit()
            maybe_stop()
    out = reduce_events(prof.events(), labels)
    trace.kernels = out["kernels"]
    trace.busy_s, trace.window_s = out["busy_s"], out["window_s"]
    trace.breakdown = out["breakdown"]
    trace.calls = recorded


def span_phase(trace: Trace, unit: Callable[[], object], seconds: float,
               targets: Iterable[str], device: torch.device) -> None:
    spans = hooks.Spans(device)
    with hooks.patched({t: spans.wrapper(t) for t in targets}):
        t0 = time.perf_counter()
        while True:
            unit()
            trace.span_units += 1
            if time.perf_counter() - t0 >= seconds:
                break
    trace.spans = spans.events
