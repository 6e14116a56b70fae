"""The anchor-free head (DSNet-AF) against the benchmark's plain reference
(``portbench/reference/anchor_free.py`` inside ``configs/af-attention.py``),
on the CPU at a test's widths (F 32, 2 heads): the port's ``predict`` on
padded batches against the float64 reference at each video's length; the
whole ``af-attention.eval-summe`` cell cut to test size comes out correct,
and a fault planted in the decode turns it false; and the tracer's
``af.boxes`` and ``af.clipped`` counters equal the counts they stand for,
and stay still with the tracer off."""
import numpy as np
import pytest
import torch

from edsnet_torch.config import get_arguments
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.utils import profiling
from portbench import run as bench
from portbench.lib import check, hooks
from portbench.lib.weights import make_weights
from portbench.tests.conftest import tiny_cell
from portbench.tests.test_portbench_af import AF_FAULTS

CELL = "af-attention.eval-summe"
BUCKET = 64
# f32 against f64 at these widths: the scores sit up to ~2.5e-6 apart; a
# box end is exp of the loc head, whose f32 rounding after the trunk's
# seven LayerNorms reaches ~2e-4 of the end (the cell's limit is 3e-3)
SCORE_TOL = 1e-5
BOX_TOL = 1e-3


@pytest.fixture(scope="module")
def cell():
    return tiny_cell(CELL)


@pytest.fixture(scope="module")
def model_and_weights(cell):
    args = get_arguments(cell.program_args("--device", "cpu"))
    weights = make_weights(cell.model.weight_spec(cell.config), 1234,
                           torch.device("cpu"))
    model = get_model(args.model, **vars(args))
    model.load_state_dict(weights, strict=True)
    return model.eval(), weights


def _batch(lengths, feat, seed):
    """Unit-norm features padded to the bucket, and the mask."""
    rng = np.random.RandomState(seed)
    n_pad = -(-max(lengths) // BUCKET) * BUCKET
    seqs = [rng.randn(n, feat).astype(np.float32) for n in lengths]
    seqs = [s / np.linalg.norm(s, axis=-1, keepdims=True) for s in seqs]
    x = np.zeros((len(lengths), n_pad, feat), np.float32)
    mask = np.zeros((len(lengths), n_pad), bool)
    for j, s in enumerate(seqs):
        x[j, :len(s)] = s
        mask[j, :len(s)] = True
    return seqs, torch.from_numpy(x), torch.from_numpy(mask)


@pytest.mark.parametrize("n", [40, 97, 150])
def test_port_predict_matches_the_reference(n, cell, model_and_weights):
    model, weights = model_and_weights
    seqs, x, mask = _batch([n], cell.config["num_feature"], n)
    with torch.no_grad():
        scores, boxes = model.predict(x, mask)
    want_s, want_b = check.ref_predict(cell, weights, seqs[0],
                                       torch.device("cpu"))
    assert want_s.shape == (n,) and want_b.shape == (n, 2)
    gaps = check.predict_gaps(scores[0].numpy().astype(np.float64),
                              boxes[0].numpy().astype(np.float64),
                              want_s, want_b)
    assert gaps["cls_gap"] < SCORE_TOL, gaps
    assert gaps["box_gap"] < BOX_TOL, gaps
    assert want_s.max() == pytest.approx(1.0, abs=1e-6)


def _run(patch=None, seed=2 ** 31 + 4321):
    cell = tiny_cell(CELL)
    with hooks.patched(patch or {}):
        result, rows = bench.run_cell(CELL, seed, 0.3, False,
                                      device=torch.device("cpu"), cell=cell)
    return result, {n: v for n, v, _ in rows}


def test_tiny_cell_is_correct_with_every_exact_diff_zero():
    result, numbers = _run()
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert numbers["cls_gap"] < SCORE_TOL
    for exact in ("keep_diff", "shot_diff", "pick_diff", "summary_diff",
                  "count_diff"):
        assert numbers[exact] == 0, exact
    assert numbers["f_gap"] < 1e-6


@pytest.mark.parametrize("fault", ["score_altered", "without_centerness"])
def test_a_planted_fault_is_not_correct(fault):
    """The first box's score raised by 1e-2 where predict produces it;
    the centerness left out of the decode's score."""
    result, numbers = _run(AF_FAULTS[fault])
    assert not result["correct"], numbers
    assert result["failed"] >= 1


@pytest.fixture
def tracer():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.mark.parametrize("masked", [True, False])
def test_decode_counters_count_the_boxes(masked, tracer, cell,
                                         model_and_weights):
    model, _ = model_and_weights
    lengths = [40, 97, 150, 64]
    _, x, mask = _batch(lengths, cell.config["num_feature"], 7)
    mask_arg = mask if masked else None
    with torch.no_grad():
        model.predict(x, mask_arg)            # off: nothing moves
        assert tracer.snapshot()["counters"] == {}
        tracer.enable()
        _, boxes = model.predict(x, mask_arg)
        tracer.disable()
        model.predict(x, mask_arg)            # off again
    snap = tracer.snapshot()
    b = boxes.numpy()
    if masked:
        lens = np.asarray(lengths)[:, None]
        valid = mask.numpy()
    else:
        lens = np.full((len(lengths), 1), x.shape[1])
        valid = np.ones(x.shape[:2], bool)
    clipped = int((((b[..., 0] < 0) | (b[..., 1] > lens)) & valid).sum())
    assert snap["counters"]["af.boxes"] == int(valid.sum())
    assert snap["counters"]["af.clipped"] == clipped
    assert 0 < clipped < valid.sum()
    assert snap["spans"]["af/decode"]["count"] == 1
