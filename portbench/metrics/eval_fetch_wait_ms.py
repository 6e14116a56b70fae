"""The evaluation pass's wait for the device, from the program's own
tracer (``edsnet_torch/utils/profiling.py``): the host-clock time of the
spans ``eval/fetch`` (``evaluate_on_device``'s copies of the F-scores and
summaries to the host, where the host waits for the device) summed per
``eval/pass``, in ms, over the passes that ran while the profiler
recorded, fetches and all: a sync of the benchmark's span phase just
before a fetch would leave it nothing to wait for.

``spans`` turns the tracer on (traced runs only, after the window) and
names the pass's host spans; a program without the tracer reads None."""
PASS, FETCH = "eval/pass", "eval/fetch"
NAMES = (PASS, FETCH, "eval/diversity")
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
    passes = {r["id"]: [0.0, True, 0] for r in snap["records"]
              if r["name"] == PASS and r["profiled"]}
    for r in snap["records"]:
        got = passes.get(r["parent_id"]) if r["name"] == FETCH else None
        if got is not None:
            got[0] += r["host_ms"]
            got[1] &= r["profiled"]
            got[2] += 1
    waits = [ms for ms, profiled, n in passes.values() if profiled and n]
    return sum(waits) / len(waits) if waits else None


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
