"""The local-global encoder's segment loop in an evaluation pass, from the
program's own tracer (``edsnet_torch/utils/profiling.py``): the
host-clock time of the spans ``lg/local`` (``models/encoder.py``:
``MultiAttention``'s gather, local attention, shared fc and scatter of
each of its segments) summed per ``eval/pass`` that holds them, in ms,
over the passes that ran while the profiler recorded, loops and all.

``spans`` turns the tracer on (traced runs only, after the window) and
names the pass's spans; a program without the span reads None."""
PASS, LOCAL = "eval/pass", "lg/local"
NAMES = (PASS, "eval/predict", "lg/encoder", LOCAL)
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
    parent = {r["id"]: r["parent_id"] for r in snap["records"]}
    passes = {r["id"]: [0.0, True, 0] for r in snap["records"]
              if r["name"] == PASS and r["profiled"]}
    for r in snap["records"]:
        if r["name"] != LOCAL:
            continue
        up = r["parent_id"]        # the loop lies inside lg/encoder
        while up is not None and up not in passes:
            up = parent.get(up)
        got = passes.get(up)
        if got is not None:
            got[0] += r["host_ms"]
            got[1] &= r["profiled"]
            got[2] += 1
    times = [ms for ms, profiled, n in passes.values() if profiled and n]
    return sum(times) / len(times) if times else None


def read(t):
    tracer = _tracer()
    return None if tracer is None else figure(tracer.snapshot())
