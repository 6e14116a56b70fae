"""The greedy NMS loop's trips per video, from the program's own counters
(``ops/bbox.py:nms_masked``, ``edsnet_torch/utils/profiling.py``):
``nms.iterations`` (the loop's trips, one a box slot of a row) over
``nms.rows`` (the rows, one a video at batch 1), over every call of the
traced phases: the boxes of a video's padded length, every scale.

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
    if not c.get("nms.rows"):
        return None
    return c.get("nms.iterations", 0) / c["nms.rows"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
