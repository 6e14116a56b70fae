"""The share of the local attentions' buffer slots that hold a real
position, from the program's own counters (``models/encoder.py``:
``MultiAttention``, ``edsnet_torch/utils/profiling.py``): 100 x
``lg.valid`` (the real positions gathered into the segments' buffers)
over ``lg.slots`` (B x segments x the buffer's length, ceil(N / 4) of
the padded batch), over every forward of the traced phases.  The buffers
follow the padded bucket and the segments each video's true length, so
the rest is padding the local attentions compute for nothing.

``spans`` turns the tracer on (traced runs only, after the window) and
names the pass's spans; a program without the counters reads None."""
NAMES = ("eval/pass", "eval/predict", "lg/encoder", "lg/local")
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
    if not c.get("lg.slots") or "lg.valid" not in c:
        return None
    return 100.0 * c["lg.valid"] / c["lg.slots"]


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
