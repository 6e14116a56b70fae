"""The port's tracer: spans and counters inside the program, and the
``--profile`` trace.

The tracer is off unless an API call (``enable``) or ``--profile`` turns
it on; importing this module or setting an environment variable never
does.  Off, ``span`` returns one shared null context and ``count`` /
``count_nonzero`` return at once: a call site costs a context-variable
read and a flag test, with nothing allocated, launched or synchronised.  No call site sits inside a
per-box or per-item loop; a loop's counts are added once per call.

On, a span records its name, its parent (the innermost open span), its
start and end on the host clock anchored to ``time.time_ns()`` (one pair
of ``perf_counter_ns`` and ``time_ns`` taken at ``enable``: the clock of
``torch.profiler``'s traces, so a span lines up with the device
timeline), its self time (its time less its children's) and whether a
``torch.profiler`` was recording when it opened.  While one records, the
span also enters ``record_function(name)``, so the device trace holds the
program's spans and an idle gap of the device falls inside the span the
host was in.  A span fenced on a CUDA device (``fence=``: the device,
or a module on it) records a pair of CUDA events on the current stream
at entry and exit: its device time, taken without a host sync.  The
events are resolved when the tracer is read (``snapshot``), or, past
``PENDING`` unread pairs, those the device has already passed
(``Event.query``, which does not wait).  On the CPU a fenced span's
device time is its host time.

While ``models/graphed.py`` captures a forward into CUDA graphs, the
tracer records instead of measuring (``recording``, a context variable
set in the same ``with`` as ``models/attention.py:flash_steps``), on or
off: a span inside the forward only notes its name and fence while it is
open, and a counter notes its name and its int or tensor.  The capture
is no forward, so nothing is counted then; each replay opens the noted
spans around its pieces and adds the noted counts after them.

Per-name aggregates (count, total, self and fenced time) are always kept;
raw records up to ``CAP``, with a count of those dropped.  A counter adds
a host int (``count``), or the number of nonzero entries of a tensor
(``count_nonzero``) into an accumulator on its device: one reduction,
read only by ``snapshot``.  The tracer serves one thread.

``maybe_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
activity on a card) of a block, as the TPU package records a
``jax.profiler`` one, and logs its top device ops and, per program span,
its calls and the runtime's kernel launches inside them.  The TPU
package's ``NaNGuard`` has no caller there and is not ported.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import logging
import os
import time
from contextvars import ContextVar
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

logger = logging.getLogger()

CAP = 100_000       # raw records kept
PENDING = 4096      # unread event pairs before the passed ones are read

_on = False         # the flag every call site tests
# the capture's record, set by ``recording``
_recording: ContextVar[Optional["Recording"]] = ContextVar("recording",
                                                          default=None)
_NULL = contextlib.nullcontext()


def _fence_device(fence) -> Optional[torch.device]:
    """The device a span is fenced on: a device, or a module's (its
    parameters'); None for no fence."""
    if fence is None or fence is False:
        return None
    if isinstance(fence, torch.nn.Module):
        param = next(fence.parameters(), None)
        return param.device if param is not None else torch.device("cpu")
    return torch.device(fence)


class _Agg:
    __slots__ = ("count", "total_ns", "self_ns", "fenced_ms")

    def __init__(self):
        self.count, self.total_ns, self.self_ns, self.fenced_ms = 0, 0, 0, 0.0


class _Span:
    """An open span (``with span(...)``); it becomes its record on exit."""
    __slots__ = ("tracer", "name", "fence", "id", "parent", "profiled",
                 "rf", "events", "start", "end", "child_ns", "fenced_ms")

    def __init__(self, tracer: "Tracer", name: str, fence):
        self.tracer, self.name, self.fence = tracer, name, fence

    def __enter__(self):
        tracer = self.tracer
        self.profiled = torch.autograd._profiler_enabled()
        self.rf = None
        if self.profiled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.events = None
        self.fenced_ms = None
        device = _fence_device(self.fence)
        if device is not None and device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            self.events = (device, start)
        self.fence = device
        self.parent = tracer.stack[-1] if tracer.stack else None
        self.id = tracer.next_id
        tracer.next_id += 1
        self.child_ns = 0
        tracer.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        tracer = self.tracer
        if self.events is not None:
            device, start = self.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(device))
            self.events = (start, end)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        if tracer.stack and tracer.stack[-1] is self:
            tracer.stack.pop()
        elif self in tracer.stack:
            tracer.stack.remove(self)
        tracer.close(self)
        return False


class Tracer:
    """The tracer's state; the module's functions act on ``TRACER``."""

    def __init__(self):
        self.stack: List[_Span] = []
        self.next_id = 0
        self.anchor = (0, 0)
        self.reset()

    # control -----------------------------------------------------------
    def enable(self) -> None:
        """Turn the tracer on (a no-op when on): spans and counters record
        from here on, on a clock anchored now."""
        global _on
        if not _on:
            self.anchor = (time.perf_counter_ns(), time.time_ns())
            _on = True

    def disable(self) -> None:
        """Turn the tracer off; what it recorded stays until ``reset``."""
        global _on
        _on = False

    def reset(self) -> None:
        """Drop every record, aggregate and counter (open spans still
        record when they close)."""
        self.records: List[_Span] = []
        self.dropped = 0
        self.aggs: Dict[str, _Agg] = {}
        self.counters: Dict[str, int] = {}
        self.device_counters: Dict[Tuple[str, torch.device],
                                   torch.Tensor] = {}
        self.pending: collections.deque = collections.deque()

    # recording ---------------------------------------------------------
    def close(self, s: _Span) -> None:
        dur = s.end - s.start
        if s.parent is not None:
            s.parent.child_ns += dur
        agg = self.aggs.get(s.name)
        if agg is None:
            agg = self.aggs[s.name] = _Agg()
        agg.count += 1
        agg.total_ns += dur
        agg.self_ns += dur - s.child_ns
        if s.fence is not None and s.events is None:
            s.fenced_ms = dur / 1e6          # fenced on the CPU
            agg.fenced_ms += s.fenced_ms
        if len(self.records) < CAP:
            self.records.append(s)
        else:
            self.dropped += 1
        if s.events is not None:
            self.pending.append((agg, s))
            if len(self.pending) > PENDING:
                self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Read the pending event pairs, in order: all of them (waiting
        for the device) or those the device has passed."""
        while self.pending:
            agg, s = self.pending[0]
            start, end = s.events
            if wait:
                end.synchronize()
            elif not end.query():
                return
            self.pending.popleft()
            s.fenced_ms = start.elapsed_time(end)
            agg.fenced_ms += s.fenced_ms
            s.events = None

    def count(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def count_nonzero(self, name: str, t: torch.Tensor) -> None:
        key = (name, t.device)
        n = torch.count_nonzero(t)
        acc = self.device_counters.get(key)
        self.device_counters[key] = n if acc is None else acc + n

    # reading -----------------------------------------------------------
    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the ``time_ns`` clock."""
        return self.anchor[1] + perf_ns - self.anchor[0]

    def snapshot(self) -> Dict:
        """What the tracer holds, with every fenced time read (this waits
        for the device to pass the last fenced span):

        - ``spans``: name -> {count, total_ms, self_ms, fenced_ms};
        - ``counters``: name -> int, host and device counts summed;
        - ``records``: the raw records in the order they closed, each
          {id, name, parent, parent_id, start_ns, end_ns (``time_ns``
          clock), host_ms, self_ms, fenced_ms (None unless fenced),
          profiled};
        - ``dropped``: records past ``CAP``."""
        self._resolve(wait=True)
        counters = dict(self.counters)
        for (name, _), acc in self.device_counters.items():
            counters[name] = counters.get(name, 0) + int(acc)
        return {
            "spans": {name: {"count": a.count, "total_ms": a.total_ns / 1e6,
                             "self_ms": a.self_ns / 1e6,
                             "fenced_ms": a.fenced_ms}
                      for name, a in self.aggs.items()},
            "counters": counters,
            "records": [{"id": s.id, "name": s.name,
                         "parent": s.parent.name if s.parent else None,
                         "parent_id": s.parent.id if s.parent else None,
                         "start_ns": self.wall_ns(s.start),
                         "end_ns": self.wall_ns(s.end),
                         "host_ms": (s.end - s.start) / 1e6,
                         "self_ms": (s.end - s.start - s.child_ns) / 1e6,
                         "fenced_ms": s.fenced_ms, "profiled": s.profiled}
                        for s in self.records],
            "dropped": self.dropped}


class Recording:
    """What a capture noted of the tracer's calls inside it: ``open``, the
    (name, fence device) of each span open now, outermost first, and
    ``counts``, each counter's (name, int or tensor) in call order."""

    def __init__(self):
        self.open: List[Tuple[str, Optional[torch.device]]] = []
        self.counts: List[Tuple[str, object]] = []

    @contextlib.contextmanager
    def span(self, name: str, fence):
        self.open.append((name, _fence_device(fence)))
        try:
            yield
        finally:
            self.open.pop()


@contextlib.contextmanager
def recording():
    """Inside the block the tracer's calls are noted in the ``Recording``
    it yields, and nothing is measured or counted."""
    token = _recording.set(Recording())
    try:
        yield _recording.get()
    finally:
        _recording.reset(token)


TRACER = Tracer()
enable = TRACER.enable
disable = TRACER.disable
reset = TRACER.reset
snapshot = TRACER.snapshot


def enabled() -> bool:
    return _on


def span(name: str, fence=False):
    """A span named ``name`` around a block (``with span(...)``); fenced
    on the device ``fence`` names (module docstring)."""
    rec = _recording.get()
    if rec is not None:
        return rec.span(name, fence)
    if not _on:
        return _NULL
    return _Span(TRACER, name, fence)


def count(name: str, n: int) -> None:
    """Add the host int ``n`` to the counter ``name``."""
    rec = _recording.get()
    if rec is not None:
        rec.counts.append((name, int(n)))
    elif _on:
        TRACER.count(name, n)


def count_nonzero(name: str, t: torch.Tensor) -> None:
    """Add the number of nonzero entries of ``t`` to the counter ``name``,
    on ``t``'s device."""
    rec = _recording.get()
    if rec is not None:
        rec.counts.append((name, t))
    elif _on:
        TRACER.count_nonzero(name, t)


def summary(snap: Dict) -> str:
    """One log line of a snapshot's per-span aggregates and counters."""
    spans = {name: (a["count"], round(a["total_ms"], 3),
                    round(a["self_ms"], 3), round(a["fenced_ms"], 3))
             for name, a in sorted(snap["spans"].items())}
    return (f"spans (count, total ms, self ms, fenced ms): {spans}; "
            f"counters: {dict(sorted(snap['counters'].items()))}")


def top_device_ops(prof, limit: int = 10) -> List[Tuple[str, float, int]]:
    """The device-side events (kernels, copies) of a finished trace with the
    most time -> [(name, ms, calls)], largest first; none on a CPU-only
    trace.  An annotation's range on the device timeline (a span's, or
    torch's own) is no device event."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and e.key not in TRACER.aggs]
    return sorted(rows, key=lambda r: -r[1])[:limit]


def span_launches(events, names) -> Dict[str, Tuple[int, int]]:
    """Per span name of ``names`` found in a finished trace's events ->
    (calls, kernel launches of the CUDA runtime that started inside its
    calls, on any thread)."""
    from torch.autograd import DeviceType

    names = set(names)
    ranges: Dict[str, List[Tuple[float, float]]] = {}
    launches: List[float] = []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in names:
            ranges.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
        elif "LaunchKernel" in e.name:
            launches.append(e.time_range.start)
    launches.sort()
    out = {}
    for name, spans in sorted(ranges.items()):
        inside, edge = 0, float("-inf")
        for a, b in sorted(spans):       # nested calls of a name count once
            a = max(a, edge)
            if b > a:
                inside += (bisect.bisect_right(launches, b)
                           - bisect.bisect_left(launches, a))
                edge = b
        out[name] = (len(spans), inside)
    return out


@contextlib.contextmanager
def maybe_trace(enabled: bool, log_dir: str):
    """Record a ``torch.profiler`` trace of the block into ``log_dir``
    (a Chrome trace, ``trace_<pid>.json``) when ``enabled``, and log the
    ops with the most device time and the program's spans' calls and
    launches."""
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
                f"{top_device_ops(prof)}; program spans (calls, launches): "
                f"{span_launches(prof.events(), TRACER.aggs)}")
