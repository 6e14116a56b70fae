"""A fold's set-up, from the program's own tracer
(``edsnet_torch/utils/profiling.py``): the mean host-clock time of the
span ``trainer/setup`` (``train_records`` from its entry to its first
epoch: the items, the model and its weights, the validation batches, the
pools), in ms, over every fold of the traced phases: no sync of the
benchmark falls inside it.

``spans`` turns the tracer on (traced runs only, after the window) and
names the fold's spans, so that the profiled stretch's idle gaps are put
down to the set-up's phases and the epoch plans; a program without the
tracer reads None."""
NAME = "trainer/setup"
NAMES = ("trainer/fold", NAME, "trainer/setup.items", "trainer/setup.model",
         "trainer/setup.eval_batches", "trainer/setup.pools",
         "trainer/epoch_plan")
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
    times = [r["host_ms"] for r in snap["records"] if r["name"] == NAME]
    return sum(times) / len(times) if times else None


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
