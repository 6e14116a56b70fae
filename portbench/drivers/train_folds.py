"""Driver of ``train_folds`` traffic: training runs of folds back to
back, each a call of the port's ``edsnet_torch.trainer.train_records`` on
the fold's training and validation videos, as ``train.py`` runs a split.

A fold's seed (``--seed``, which seeds the trainer's epoch order, its
dropout and label generators) and its initial weights are drawn from the
run's seed and the fold's number; the trainer's ``init_weights`` is
handed the benchmark's weights.  Each fold writes its checkpoint under
the run's work directory, which is emptied after it.

The window: folds run until ``seconds`` have passed; the fold running
then runs to its end and closes the window.  The reference follows the
window's first fold: its first three steps, and its first validation
from the parameters that validation was given.
"""
from __future__ import annotations

import shutil
import time
from collections import Counter
from pathlib import Path
from typing import Dict

import torch

from portbench.lib import check, data
from portbench.lib.capture import EvalCapture, TrainCapture
from portbench.lib.hooks import patched
from portbench.lib.weights import make_weights
from portbench.reference.labels import keyshot_target

FOLLOW = 3    # train steps the reference follows


class Run:
    def __init__(self, cell, seed: int, device: torch.device, workdir: Path):
        self.cell, self.seed, self.device = cell, seed, device
        self.workdir = Path(workdir)
        self.program = cell.traffic["program"]
        self.epochs = int(self.program["max_epoch"])
        targets = cell.model.HEAD.targets
        self.evals = EvalCapture(targets["predict"])
        self.train = TrainCapture(self.evals, targets["train_step"], FOLLOW)
        self.k = 0                   # folds run so far
        self._patches = None

    # set-up ------------------------------------------------------------
    def setup(self) -> None:
        from edsnet_torch import trainer
        from edsnet_torch.data.dataset import VideoRecord
        cfg = self.cell.config
        self.trainer = trainer
        self.videos = data.make_videos(self.cell.traffic, self.seed,
                                       cfg["num_feature"], self.device)
        self.folds = data.make_folds(self.cell.traffic, self.videos,
                                     self.seed)
        self.records = {v.key: VideoRecord(*v) for v in self.videos}
        self.trainable = {v.key: keyshot_target(v) is not None
                          for v in self.videos}
        self.spec = self.cell.model.weight_spec(cfg)
        self._patches = patched({**self.evals.wrappers(),
                                 **self.train.wrappers()})
        self._patches.__enter__()
        # warm-up: one epoch on every video, validating on fold 0's
        self._call(self.videos, self.folds[0].test, self._weights(-1),
                   self._fold_seed(-1), judged=False, epochs=1, tag="warm")

    def _fold_seed(self, k: int) -> int:
        return int(data.stream(self.seed, 10, k + 1).integers(0, 2 ** 31 - 3))

    def _weights(self, k: int) -> Dict[str, torch.Tensor]:
        return make_weights(self.spec, data.torch_seed(self.seed, 11, k + 1),
                            self.device)

    def _call(self, train, test, weights, fold_seed: int, judged: bool,
              epochs: int, tag: str) -> None:
        fold_dir = self.workdir / tag
        args = self.trainer_args(fold_seed, fold_dir, epochs)
        self.train.start_fold({k: v.cpu() for k, v in weights.items()},
                              judged)
        try:
            self.trainer.train_records(
                args, [self.records[v.key] for v in train],
                [self.records[v.key] for v in test], fold_dir / "fold.pt")
        finally:
            shutil.rmtree(fold_dir, ignore_errors=True)

    def trainer_args(self, fold_seed: int, fold_dir: Path, epochs: int):
        from edsnet_torch.config import get_arguments
        args = get_arguments(self.cell.program_args(
            "--seed", str(fold_seed), "--model-dir", str(fold_dir),
            "--max-epoch", str(epochs), "--device",
            "gpu" if self.device.type == "cuda" else "cpu"))
        fold_dir.mkdir(parents=True, exist_ok=True)
        return args

    # work --------------------------------------------------------------
    def unit(self, judged: bool = False) -> int:
        """Run the next fold -> its number."""
        k = self.k
        fold = self.folds[k % len(self.folds)]
        self._call(fold.train, fold.test, self._weights(k),
                   self._fold_seed(k), judged, self.epochs, f"fold{k}")
        self.k += 1
        return k

    def window(self, seconds: float) -> Dict:
        self.first = self.k
        trained: Counter = Counter()
        t0 = time.perf_counter()
        while True:
            k = self.unit(judged=self.k == self.first)
            for v in self.folds[k % len(self.folds)].train:
                if self.trainable[v.key]:
                    trained[len(v.seq)] += self.epochs
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        positions = sum(n * c for n, c in trained.items())
        return {"seconds": elapsed, "attempted": self.k - self.first,
                "trained": dict(trained),
                "metrics": {"train_positions_per_s": positions / elapsed}}

    # correctness -------------------------------------------------------
    def judge(self) -> Dict:
        """Every number of the judged fold; run after the window."""
        k = self.first
        fold = self.folds[k % len(self.folds)]
        out = self.train.out
        ref = check.follow_steps(self.cell, self._weights(k), fold.train,
                                 self._fold_seed(k), self.device, FOLLOW)
        numbers = check.train_numbers(out, ref,
                                      float(self.program["weight_decay"]))
        by_key = {v.key: v for v in self.videos}
        videos_of = {id(e["tb"]): [by_key[r.key] for r in e["records"]]
                     for prepared in self.train.prepared for e in prepared}
        val = check.judge_batches(
            self.cell, self.evals.records, videos_of, out["p_val"],
            self.device, float(self.program["nms_thresh"]))
        f_ref = val.pop("f_ref")
        want_steps = sum(self.trainable[v.key] for v in fold.train)
        numbers.update(val)
        numbers["count_diff"] = (
            abs(out.get("steps_before_val", -1) - want_steps)
            + abs(len(f_ref) - len(fold.test)))
        mean_ref = sum(f_ref.values()) / max(len(f_ref), 1)
        numbers["f_gap"] = max(numbers.get("f_gap", float("inf")),
                               abs(float(out["val_f"]) - mean_ref))
        return numbers

    def failed(self, ok: bool) -> int:
        return 0 if ok else 1

    def close(self) -> None:
        if self._patches is not None:
            self._patches.__exit__(None, None, None)
            self._patches = None
