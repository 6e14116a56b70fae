"""The share of the anchor-free head's boxes that reach past their
video, from the program's own counters (``models/dsnet_af.py``,
``edsnet_torch/utils/profiling.py``): 100 x ``af.clipped`` (valid boxes
with left < 0 or right > the video's length, before ``predict_nms``
clips them) over ``af.boxes`` (the valid positions decoded, one box
each), over every call of the traced phases.  The ``exp`` extents pile
such boxes up at a video's ends, where NMS suppresses them.

``spans`` turns the tracer on (traced runs only, after the window) and
names the pass's spans; a program without the counters reads None."""
NAMES = ("eval/pass", "eval/predict", "af/decode", "eval/nms")
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
    if not c.get("af.boxes") or "af.clipped" not in c:
        return None
    return 100.0 * c["af.clipped"] / c["af.boxes"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
