"""The share of the device knapsack's item slots that hold a real shot,
from the program's own counters (``ops/knapsack.py:knapsack``,
``edsnet_torch/utils/profiling.py``): 100 x ``knapsack.live`` (items of
weight above 0) over ``knapsack.slots`` (rows x shot slots), over every
call of the traced phases: the loop's trips that can take an item.

``spans`` turns the tracer on (traced runs only, after the window) and
names the summary's spans; a program without the tracer reads None."""
NAMES = ("eval/summary", "knapsack/dp", "knapsack/backtrack", "eval/f1")
PROFILE = True


def _tracer():
    try:
        from edsnet_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "snapshot") else None


def spans(cell):
    tracer = _tracer()
    if tracer is None:
        return ()
    tracer.enable()
    return NAMES


def figure(snap):
    c = snap["counters"]
    if not c.get("knapsack.slots") or "knapsack.live" not in c:
        return None
    return 100.0 * c["knapsack.live"] / c["knapsack.slots"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
