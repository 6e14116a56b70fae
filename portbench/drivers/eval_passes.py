"""Driver of ``eval_passes`` traffic: evaluation passes of a model, each a
call of the port's ``edsnet_torch.parallel.eval_device.evaluate_on_device``
on one fold's test videos, as ``evaluate.py`` evaluates a fold; the
passes cycle over the folds.

Set-up builds the model the way ``evaluate.py`` does (the CLI's
``setup``, ``get_model``) and loads the benchmark's weights, made from
the seed, where ``evaluate.py`` loads a checkpoint; the eval batches of
every fold are prepared once (``prepare_eval_batches``), as the trainer
prepares its validation's.

The window: passes run until ``seconds`` have passed; the pass running
then runs to its end and closes the window.  Each pass is timed from its
call to the return of its F-scores and diversities to the host.  The
reference judges the window's first pass of each fold, stage by stage,
and every answer of the window is held to its fold's judged F-scores.
"""
from __future__ import annotations

import time
from collections import Counter
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import check, data
from portbench.lib.capture import EvalCapture
from portbench.lib.hooks import patched
from portbench.lib.weights import make_weights


class Run:
    def __init__(self, cell, seed: int, device: torch.device, workdir: Path):
        self.cell, self.seed, self.device = cell, seed, device
        self.program = cell.traffic["program"]
        self.evals = EvalCapture(cell.model.HEAD.targets["predict"])
        self.k = 0                    # passes run so far
        self._patches = None

    def setup(self) -> None:
        from edsnet_torch import evaluate
        from edsnet_torch.config import get_arguments
        from edsnet_torch.data.dataset import VideoRecord
        from edsnet_torch.models.model_zoo import get_model
        from edsnet_torch.parallel import eval_device
        self.eval_device = eval_device
        cfg = self.cell.config
        self.args = get_arguments(self.cell.program_args(
            "--device", "gpu" if self.device.type == "cuda" else "cpu"))
        self.program_device = evaluate.setup(self.args)
        self.videos = data.make_videos(self.cell.traffic, self.seed,
                                       cfg["num_feature"], self.device)
        self.folds = data.make_folds(self.cell.traffic, self.videos,
                                     self.seed)
        self.by_key = {v.key: v for v in self.videos}
        self.weights = make_weights(self.cell.model.weight_spec(cfg),
                                    data.torch_seed(self.seed, 11),
                                    self.device)
        model = get_model(self.args.model, **vars(self.args))
        model.load_state_dict({k: v.cpu() for k, v in self.weights.items()},
                              strict=True)
        self.model = model.to(self.program_device).eval()
        self.fold_records = [[VideoRecord(*v) for v in fold.test]
                             for fold in self.folds]
        self.prepared = [eval_device.prepare_eval_batches(
            recs, int(self.program["batch_size"]),
            int(self.program["bucket_size"]), self.program_device,
            need_motion=False) for recs in self.fold_records]
        self.videos_of = {id(e["tb"]): [self.by_key[r.key]
                                        for r in e["records"]]
                          for prepared in self.prepared for e in prepared}
        self._patches = patched(self.evals.wrappers())
        self._patches.__enter__()
        for _ in self.folds:          # warm-up: every fold once
            self.unit()

    def unit(self) -> List[Dict]:
        """Run the next pass -> its per-video answers."""
        f = self.k % len(self.folds)
        per_video: List[Dict] = []
        self.eval_device.evaluate_on_device(
            self.model, self.fold_records[f],
            float(self.program["nms_thresh"]),
            batch_size=int(self.program["batch_size"]),
            bucket_size=int(self.program["bucket_size"]),
            prepared=self.prepared[f], per_video=per_video)
        self.k += 1
        return per_video

    def window(self, seconds: float) -> Dict:
        n_folds = len(self.folds)
        self.judged: Dict[int, List[Dict]] = {}
        self.answers: List = []       # (fold, {key: F}) of every pass
        times: List[float] = []
        predicted: Counter = Counter()
        first = self.k
        t0 = time.perf_counter()
        while True:
            f = self.k % n_folds
            judged = self.k - first < n_folds
            self.evals.active = judged
            start = len(self.evals.records)
            t = time.perf_counter()
            per_video = self.unit()
            times.append(time.perf_counter() - t)
            self.evals.active = False
            if judged:
                self.judged[f] = self.evals.records[start:]
            self.answers.append((f, {a["key"]: a["fscore"]
                                     for a in per_video}))
            for v in self.folds[f].test:
                predicted[len(v.seq)] += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        videos = sum(predicted.values())
        return {"seconds": elapsed, "attempted": len(times),
                "predicted": dict(predicted),
                "metrics": {"eval_videos_per_s": videos / elapsed,
                            "eval_pass_p90_ms":
                                float(np.percentile(times, 90)) * 1e3}}

    def judge(self) -> Dict:
        records = [r for recs in self.judged.values() for r in recs]
        numbers = check.judge_batches(
            self.cell, records, self.videos_of, self.weights, self.device,
            float(self.program["nms_thresh"]))
        f_ref = numbers.pop("f_ref")
        gaps, self.bad = [], 0
        for f, got in self.answers:
            want = {v.key for v in self.folds[f].test}
            if set(got) != want or not want <= set(f_ref):
                gaps.append(float("inf"))
                self.bad += 1
                continue
            gap = max(abs(got[k] - f_ref[k]) for k in want)
            gaps.append(gap)
            self.bad += gap > self.cell.limits.get("f_gap", 0.0)
        numbers["f_gap"] = max([numbers.get("f_gap", 0.0)] + gaps)
        ran = {f for f, _ in self.answers}
        numbers["count_diff"] = len(ran - set(self.judged)) + sum(
            abs(len(recs) - len(self.prepared[f]))
            for f, recs in self.judged.items())
        return numbers

    def failed(self, ok: bool) -> int:
        """Passes with an answer missing or wrong (at least 1 when a
        stage number failed)."""
        return max(self.bad, 0 if ok else 1)

    def close(self) -> None:
        if self._patches is not None:
            self._patches.__exit__(None, None, None)
            self._patches = None
