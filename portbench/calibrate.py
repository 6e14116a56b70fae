"""The readings that a cell's limits (``limits/<cell>.json``) are set
from: the program's numbers over many seeds, and its control's.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control 3] [--seconds 6]

For each seed: the cell's set-up and a short window at the cell's own
sizes and load (``--seconds``; a train cell's window is one fold), then
the run's comparison -> one JSON line ``{"side": "program", ...}``.  For
the first ``--control`` seeds also the control: the plain reference put
in the program's place in float32 with TF32 on (the nearest precision
below the configuration's float32), against the float64 reference on the
same inputs: for a train cell its first three steps from the fold's
weights and its predict from the parameters of the fold's first
validation; for an eval cell its predict of every judged video; and for
``f_gap`` the F-scores of the program's judged summaries in bfloat16
(the precision below the program's float32 F) against float64 ->
``{"side": "control", ...}``.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(cell, run, device) -> dict:
    """The control's numbers on the inputs of ``run``'s judged work."""
    import numpy as np
    import torch
    from portbench.lib import check

    def predict(weights, videos):
        gaps = {}
        for video in videos:
            with check.precision(True):
                got = check.ref_predict(cell, weights, video.seq, device,
                                        torch.float32)
            want = check.ref_predict(cell, weights, video.seq, device)
            for k, v in check.predict_gaps(*got, *want).items():
                gaps[k] = max(gaps.get(k, 0.0), v)
        return gaps

    if cell.traffic["kind"] == "train_folds":
        k = run.first
        fold = run.folds[k % len(run.folds)]
        weights, seed = run._weights(k), run._fold_seed(k)
        want = check.follow_steps(cell, weights, fold.train, seed, device, 3)
        got = check.follow_steps(cell, weights, fold.train, seed, device, 3,
                                 dtype=torch.float32, tf32=True)
        wd = float(cell.traffic["program"]["weight_decay"])
        # the control's Adam state after step 1, as the program's is read
        prog = {"p0": got["p0"], "p_end": got["params"],
                "losses": got["losses"],
                "exp_avg": {n: (1 - check.MOMENT_DECAY)
                            * (g + wd * got["p0"][n])
                            for n, g in got["grad"].items()}}
        out = check.train_numbers(prog, want, wd)
        out.update(predict(run.train.out["p_val"], fold.test))
        by_key = {v.key: v for v in run.videos}
        videos_of = {id(e["tb"]): [by_key[r.key] for r in e["records"]]
                     for prepared in run.train.prepared for e in prepared}
        f = check.f_control(cell, run.evals.records, videos_of)
        out["f_gap"] = max(f["video"], f["mean"])
        return out
    videos = [v for f in sorted(run.judged) for v in run.folds[f].test]
    out = predict(run.weights, videos)
    records = [r for f in sorted(run.judged) for r in run.judged[f]]
    out["f_gap"] = check.f_control(cell, records, run.videos_of)["video"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=6.0)
    opts = p.parse_args(argv)

    import torch
    from portbench.lib import check
    from portbench.lib.cell import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(opts.workload)
    for i, seed in enumerate(opts.seeds):
        workdir = Path(tempfile.mkdtemp(prefix="portbench-cal-"))
        run = cell.driver.Run(cell, seed, device, workdir)
        t0 = time.perf_counter()
        try:
            run.setup()
            run.window(0.0 if cell.traffic["kind"] == "train_folds"
                       else opts.seconds)
            numbers = run.judge()
            ok, _ = check.verdict(numbers, cell.limits)
            print(json.dumps({"cell": cell.name, "seed": seed,
                              "side": "program", "correct": ok,
                              "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            if i < opts.control:
                print(json.dumps({"cell": cell.name, "seed": seed,
                                  "side": "control",
                                  "numbers": control_numbers(cell, run,
                                                             device)}),
                      flush=True)
        finally:
            run.close()
            shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
