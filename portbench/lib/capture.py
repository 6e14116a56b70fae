"""What the timed path produced, kept for the comparison that decides
``correct``: references to the program's own output tensors, taken where
its evaluator and its train step hand them on.  Nothing here copies to
the host or waits for the device while the window runs, except the
clones of the parameters and of Adam's first moments at the train steps
the reference follows (device copies, queued like the step itself).

The wrapped names are the device evaluator's stages and the trainer's
calls below, and the two that the configuration's head names
(``HEAD.targets``: its ``predict`` and its ``train_step``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

EVAL_BATCH = "edsnet_torch.parallel.eval_device:_eval_batch_device"
NMS = "edsnet_torch.parallel.eval_device:nms_masked"
KNAPSACK = "edsnet_torch.ops.summary:knapsack"
VALIDATE = "edsnet_torch.trainer:eval_fscore_device"
INIT_WEIGHTS = "edsnet_torch.trainer:init_weights"
PREPARE_EVAL = "edsnet_torch.trainer:prepare_eval_batches"


class EvalCapture:
    """One record per ``_eval_batch_device`` call while ``active``: the
    batch's identity and its stages' outputs (predict's scores and boxes,
    the NMS's clipped boxes and keep set, the knapsack's inputs and
    output, the F-scores and summaries)."""

    def __init__(self, predict: str):
        self.predict_target = predict     # the head's predict
        self.active = False
        self.records: List[Dict] = []
        self._open: Optional[Dict] = None

    def wrappers(self) -> Dict[str, Callable]:
        def batch(fn):
            def call(model, batch, *args, **kwargs):
                if not self.active:
                    return fn(model, batch, *args, **kwargs)
                self._open = {"batch": id(batch)}
                try:
                    fs, summ = fn(model, batch, *args, **kwargs)
                finally:
                    rec, self._open = self._open, None
                rec.update(fscores=fs, summaries=summ)
                self.records.append(rec)
                return fs, summ
            return call

        def stage(*names):
            def make(fn):
                def call(*args, **kwargs):
                    out = fn(*args, **kwargs)
                    if self._open is not None:
                        got = (args + tuple(kwargs.values())
                               + (out if isinstance(out, tuple) else (out,)))
                        self._open.update(
                            {k: v for k, v in zip(names, got) if k})
                    return out
                return call
            return make

        def predict(fn):
            def call(model, *args, **kwargs):
                out = fn(model, *args, **kwargs)
                if self._open is not None:
                    self._open.update(scores=out[0], boxes=out[1])
                return out
            return call

        return {EVAL_BATCH: batch, self.predict_target: predict,
                # nms_masked(scores, bboxes, thresh, valid) -> keep
                NMS: stage("", "boxes_c", "", "", "keep"),
                # knapsack(values, weights, capacity, max_capacity) -> picked
                KNAPSACK: stage("values", "weights", "capacity", "",
                                "picked")}


def _params(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


class TrainCapture:
    """The trainer's hooks: ``init_weights`` loads the fold's weights that
    the benchmark made (``weights``, by name); while ``judged``, the
    parameters before step 1 and before step ``follow + 1``, the losses of
    steps 1..``follow``, Adam's first moments after step 1, and the
    parameters and F-score of the fold's first validation, with its
    evaluator's stages recorded by ``evals``."""

    def __init__(self, evals: EvalCapture, train_step: str, follow: int = 3):
        self.evals = evals
        self.step_target = train_step     # the head's train step
        self.follow = follow
        self.weights: Dict[str, torch.Tensor] = {}
        self.judged = False
        self.steps = 0
        self.prepared: List[List[Dict]] = []
        self.out: Dict = {}

    def start_fold(self, weights: Dict[str, torch.Tensor], judged: bool
                   ) -> None:
        self.weights, self.judged, self.steps = weights, judged, 0
        if judged:
            self.out = {"losses": [], "validations": 0}

    def wrappers(self) -> Dict[str, Callable]:
        def init(fn):
            def call(model, generator):
                model.load_state_dict(self.weights, strict=True)
            return call

        def step(fn):
            def call(model, optimizer, *args, **kwargs):
                self.steps += 1
                judged = self.judged and self.steps <= self.follow + 1
                if judged and self.steps == 1:
                    self.out["p0"] = _params(model)
                if judged and self.steps == self.follow + 1:
                    self.out["p_end"] = _params(model)
                metrics = fn(model, optimizer, *args, **kwargs)
                if judged and self.steps <= self.follow:
                    self.out["losses"].append(metrics["loss"])
                if judged and self.steps == 1:
                    # a step that left Adam untouched has no moment:
                    # it gave Adam a zero gradient
                    self.out["exp_avg"] = {
                        k: optimizer.state.get(p, {}).get(
                            "exp_avg", torch.zeros_like(p)).clone()
                        for k, p in model.named_parameters()}
                return metrics
            return call

        def validate(fn):
            def call(model, prepared, *args, **kwargs):
                first = self.judged and self.out.get("validations") == 0
                if not first:
                    return fn(model, prepared, *args, **kwargs)
                self.out["validations"] = 1
                self.out["p_val"] = _params(model)
                self.out["steps_before_val"] = self.steps
                self.evals.active = True
                try:
                    val = fn(model, prepared, *args, **kwargs)
                finally:
                    self.evals.active = False
                self.out["val_f"] = val
                return val
            return call

        def prepare(fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                if self.judged:
                    self.prepared.append(out)
                return out
            return call

        return {INIT_WEIGHTS: init, self.step_target: step,
                VALIDATE: validate,
                PREPARE_EVAL: prepare}
