"""The device knapsack's loop trips per video, from the program's own
counters (``ops/knapsack.py:knapsack``,
``edsnet_torch/utils/profiling.py``): ``knapsack.steps`` (the DP's and
the backtrack's trips, one each a shot slot) over ``knapsack.rows`` (one
a video at batch 1), over every call of the traced phases.

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
    if not c.get("knapsack.rows"):
        return None
    return c.get("knapsack.steps", 0) / c["knapsack.rows"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
