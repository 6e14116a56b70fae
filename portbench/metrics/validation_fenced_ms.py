"""An epoch's validation on the device evaluator, from the program's own
tracer (``edsnet_torch/utils/profiling.py``): the mean fenced time (CUDA
events on the stream at the call's entry and exit) of the span
``trainer/validation``, in ms, over every validation of the traced
phases.  Every record, not only the profiled stretch's: the stretch (2 s
from a fold's start) ends before the fold's first validation, and the
benchmark's syncs around the call wait on the host, where the device,
fed by a host-bound evaluator, idles all the same.

``spans`` turns the tracer on (traced runs only, after the window) and
names the evaluator's spans, so that idle gaps in validation are put
down to its stages; a program without the tracer reads None."""
NAME = "trainer/validation"
NAMES = (NAME, "eval/predict", "eval/nms", "eval/raster", "eval/summary",
         "knapsack/dp", "knapsack/backtrack", "eval/f1")
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
    times = [r["fenced_ms"] for r in snap["records"]
             if r["name"] == NAME and r["fenced_ms"] is not None]
    return sum(times) / len(times) if times else None


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
