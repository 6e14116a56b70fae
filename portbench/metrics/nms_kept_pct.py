"""The share of the box slots the greedy NMS walks that it keeps, from
the program's own counters (``ops/bbox.py:nms_masked``,
``edsnet_torch/utils/profiling.py``): 100 x ``nms.kept`` (boxes in the
returned keep masks) over ``nms.slots`` (rows x box slots), over every
call of the traced phases: useful outcomes over attempts.

``spans`` turns the tracer on (traced runs only, after the window) and
names the pass's spans; a program without the tracer reads None."""
NAMES = ("eval/pass", "eval/predict", "eval/nms", "eval/raster")
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
    if not c.get("nms.slots") or "nms.kept" not in c:
        return None
    return 100.0 * c["nms.kept"] / c["nms.slots"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
