"""The share of the head's ``predict`` calls whose forward was replayed
from a CUDA graph, from the program's own counters
(``models/graphed.py:eval_forward``, ``edsnet_torch/utils/profiling.py``):
100 x ``predict.graph_replays`` over ``predict.calls``, over every call of
the traced phases.

``spans`` turns the tracer on (traced runs only, after the window) and
names the pass's spans and the capture's; a program without the tracer,
or without the counters, reads None."""
NAMES = ("eval/pass", "eval/predict", "predict/capture")
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
    if not c.get("predict.calls"):
        return None
    return 100.0 * c.get("predict.graph_replays", 0) / c["predict.calls"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
