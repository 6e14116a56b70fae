"""The plain reference against the port, at a test's widths on the CPU:
every cell's whole run comes out correct, with each number far inside
its limit; and each fault planted in the timed path turns ``correct``
false (the run's look for a card skipped, the rest of it driven)."""
import pytest
import torch

from portbench import run as bench
from portbench.lib import hooks
from portbench.tests.conftest import tiny_cell

CELLS = ["ab-nystromformer.train-tvsum", "ab-attention.eval-summe",
         "ab-nystromformer.eval-summe"]


def _run(name, cpu, seed=12345678901, patch=None):
    cell = tiny_cell(name)
    with hooks.patched(patch or {}):
        result, rows = bench.run_cell(name, seed, 0.3, False, device=cpu,
                                      cell=cell)
    return result, {n: v for n, v, _ in rows}


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name, cpu):
    result, numbers = _run(name, cpu)
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert numbers["cls_gap"] < 1e-5
    for exact in ("keep_diff", "shot_diff", "pick_diff", "summary_diff",
                  "count_diff"):
        assert numbers[exact] == 0
    assert numbers["f_gap"] < 1e-6
    if "loss_gap" in numbers:
        assert numbers["loss_gap"] < 1e-5
        assert numbers["grad_gap"] < 1e-5
        assert numbers["change_gap"] < 1e-2


def _second_row_altered(fn):
    """The score of the first box of a batch's second video raised by
    1e-2 where predict produces it."""
    def call(model, *args, **kwargs):
        scores, boxes = fn(model, *args, **kwargs)
        scores = scores.clone()
        if scores.shape[0] > 1:
            scores[1, 0] += 1e-2
        return scores, boxes
    return call


@pytest.mark.parametrize("fault", [None, "second_row"])
def test_eval_judges_every_row_of_a_batch(fault, cpu):
    """At batch 2 every video of a judged batch is held to the
    reference: a fault in a batch's second row alone is caught."""
    name = "ab-attention.eval-summe"
    cell = tiny_cell(name)
    cell.traffic = dict(cell.traffic, program=dict(
        cell.traffic["program"], batch_size=2))
    patch = ({} if fault is None else
             {"edsnet_torch.models.dsnet:_AnchorBased.predict":
              _second_row_altered})
    with hooks.patched(patch):
        result, rows = bench.run_cell(name, 424242, 0.3, False, device=cpu,
                                      cell=cell)
    numbers = {n: v for n, v, _ in rows}
    assert result["correct"] == (fault is None), numbers


# --------------------------------------------------------------- faults

def _step_unchanged(fn):
    """A train step that leaves the model and Adam as they were."""
    def call(model, optimizer, *args, **kwargs):
        saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
        state = {id(p): {k: v.clone() for k, v in s.items()}
                 for p, s in optimizer.state.items()}
        out = fn(model, optimizer, *args, **kwargs)
        with torch.no_grad():
            model.load_state_dict(saved)
        for p in list(optimizer.state):
            if id(p) in state:
                optimizer.state[p] = state[id(p)]
            else:
                del optimizer.state[p]
        return out
    return call


def _half_the_batch(fn):
    """The step's batch with the second half of its positions left out,
    the losses' means taken over the rest."""
    def call(batch):
        out = dict(fn(batch))
        mask = out["mask"].clone()
        n = int(mask[0].sum())
        mask[:, n // 2:] = False
        out["mask"] = mask
        for key in ("neg_eligible", "inc_eligible"):
            out[key] = out[key] & mask[..., None]
        out["cls_pos"] = out["cls_pos"] * mask[..., None]
        out["num_pos"] = out["cls_pos"].flatten(1).sum(1).to(torch.int32)
        return out
    return call


def _answer_altered(fn):
    """Every F-score the evaluator produces, nudged by 1e-3."""
    def call(*args, **kwargs):
        fs, summ = fn(*args, **kwargs)
        return fs + 1e-3, summ
    return call


def _summary_altered(fn):
    """The first frame of every summary flipped."""
    def call(*args, **kwargs):
        summ = fn(*args, **kwargs).clone()
        summ[:, 0] = ~summ[:, 0]
        return summ
    return call


def _score_altered(fn):
    """The first box's score raised by 1e-2 where predict produces it."""
    def call(model, *args, **kwargs):
        scores, boxes = fn(model, *args, **kwargs)
        scores = scores.clone()
        scores[:, 0] += 1e-2
        return scores, boxes
    return call


FAULTS = {
    "state_unchanged": ({"edsnet_torch.trainer:ab_train_step":
                         _step_unchanged}, "train"),
    "half_the_batch": ({"edsnet_torch.parallel.steps:resolve_batch":
                        _half_the_batch}, "train"),
    "answer_altered": ({"edsnet_torch.parallel.eval_device:"
                        "_eval_batch_device": _answer_altered}, "both"),
    "summary_altered": ({"edsnet_torch.ops.summary:keyshot_summ":
                         _summary_altered}, "both"),
    "score_altered": ({"edsnet_torch.models.dsnet:_AnchorBased.predict":
                       _score_altered}, "both"),
}


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in sorted(FAULTS)
    if FAULTS[fault][1] == "both" or "train" in name])
def test_a_broken_timed_path_is_not_correct(name, fault, cpu):
    result, numbers = _run(name, cpu, patch=FAULTS[fault][0])
    assert not result["correct"], numbers
    assert result["failed"] >= 1
