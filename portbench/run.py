"""The benchmark of the PyTorch port (``edsnet_torch``) on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``'s ``workloads``; everything it is made of is found by
name under ``portbench/`` (``lib/cell.py``).  A run:

1. set-up (``setup_s``, from the start of this file to the window): the
   data and the weights from ``--seed`` (``lib/data.py``,
   ``lib/weights.py``), the program's objects and a warm-up of every shape
   the cell's traffic uses, by the traffic's driver (``drivers/``);
2. the window: the driver's work for ``--seconds``, the unit running at
   the end finishing it; the cell's end-to-end metrics come from it;
3. with ``--trace 1``, a profiled stretch and a span phase after the
   window, read by the cell's per-layer metrics (``metrics/``);
4. the comparison that decides ``correct`` (``lib/check.py``), after the
   device's peak memory has been read;
5. the import guard: a run whose process holds JAX, Flax or the JAX
   package fails.

The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  No card, fewer cards than the cell asks for, or a missing program
exits non-zero with no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench-cache"
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
# one process, few threads: the host's BLAS and OpenMP pools kept to one
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BANNED = ("jax", "jaxlib", "flax", "edsnet_tpu")
TRACE_PROFILE_S = 2.0     # the profiled stretch
TRACE_SPANS_S = 10.0      # the span phase (at least one unit)


def banned_modules():
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(cell, run, window, device):
    """The traced phases, and each per-layer metric that finds something
    to read -> (metrics, device extras, breakdown)."""
    from portbench.lib import trace as tr
    t = tr.Trace(cell=cell, window=window)
    spans, labels, calls = [], [], []
    profiled = False
    for reader in cell.readers.values():
        names = reader.spans(cell) if hasattr(reader, "spans") else ()
        spans += [s for s in names if s not in spans]
        calls += [c for c in getattr(reader, "CALLS", ()) if c not in calls]
        profiled |= bool(getattr(reader, "PROFILE", False) or
                         getattr(reader, "CALLS", ()))
    labels = spans + [c for c in calls if c not in spans]
    extra = {}
    if profiled:
        tr.profile_phase(t, run.unit, TRACE_PROFILE_S, labels, calls, device)
        extra = {"busy_s": t.busy_s, "window_s": t.window_s}
    if spans:
        tr.span_phase(t, run.unit, TRACE_SPANS_S, spans, device)
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]].read(t)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out, extra, t.breakdown


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device=None, cell=None):
    """One run -> (result dict, compared rows).  ``device`` None: the
    first card, which must exist; a test passes its own ``device`` and
    ``cell``."""
    import torch
    from portbench.lib import check
    from portbench.lib.cell import load_cell

    cell = cell if cell is not None else load_cell(name)
    if device is None:
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        if found < cell.chips:
            raise SystemExit(f"portbench: {cell.name} needs {cell.chips} "
                             f"CUDA device(s); found {found}")
        device = torch.device("cuda", 0)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    run = cell.driver.Run(cell, seed, device, workdir)
    try:
        run.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        window = run.window(seconds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = int(torch.cuda.max_memory_allocated(device))
            kind = torch.cuda.get_device_name(device)
        else:
            peak, kind = 0, "cpu"
        metrics = dict(window["metrics"], setup_s=setup_s)
        dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
        breakdown = None
        if traced:
            metrics, extra, breakdown = per_layer(cell, run, window, device)
            dev.update(extra)
        else:
            wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
            metrics = {k: {"value": float(v), "unit": wanted[k]}
                       for k, v in metrics.items() if k in wanted}
        numbers = run.judge()
        ok, rows = check.verdict(numbers, cell.limits)
        result = {"correct": bool(ok), "attempted": int(window["attempted"]),
                  "failed": int(run.failed(ok)), "metrics": metrics,
                  "device": dev}
        if breakdown:
            result["breakdown"] = breakdown
        result["compared"] = {
            n: {"value": v if math.isfinite(v) else None, "limit": lim}
            for n, v, lim in rows}
        return result, rows
    finally:
        run.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    logging.basicConfig(stream=sys.stderr, level=logging.WARNING)
    opts = parse(argv)
    try:
        import edsnet_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 2
    result, rows = run_cell(opts.workload, opts.seed, opts.seconds,
                            bool(opts.trace))
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark "
              f"may load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f"compared {name}: {value!r} (limit {limit!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
