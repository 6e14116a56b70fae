"""The train step's host time, from the program's own tracer
(``edsnet_torch/utils/profiling.py``): the mean host-clock time of the
span ``steps/train_step`` (the step's enqueue: labels, forward, losses,
backward, Adam), in ms, over the steps of the span phase.  There the
benchmark's syncs wrap ``ab_train_step`` from outside, so they fall
outside the program's span; the profiled stretch's steps are left out,
since the profiler's cost per op about doubles a step's host time.

``spans`` turns the tracer on (traced runs only, after the window) and
names the step's spans; a program without the tracer reads None."""
NAME = "steps/train_step"
NAMES = (NAME, "steps/labels", "steps/forward", "steps/loss",
         "steps/backward", "steps/adam")
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
    times = [r["host_ms"] for r in snap["records"]
             if r["name"] == NAME and not r["profiled"]]
    return sum(times) / len(times) if times else None


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
