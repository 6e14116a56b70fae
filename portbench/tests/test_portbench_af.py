"""The anchor-free cell ``af-attention.eval-summe`` at a test's widths on
the CPU: the plain reference head (``reference/anchor_free.py``) agrees
with the port's whole run, every row of a batch is judged, each fault
planted in the timed path turns ``correct`` false, and the two readers
of the head's decode (``af_decode_ms``, ``af_clipped_pct``) read the
program's span and counters: by hand-made snapshots, None without them,
and in a traced run."""
import pytest
import torch

from portbench import run as bench
from portbench.lib import hooks
from portbench.lib.cell import BENCH_DIR, load_cell, load_module
from portbench.tests.conftest import tiny_cell
from portbench.tests.test_portbench_reference import (
    FAULTS, _score_altered, _second_row_altered)

CELL = "af-attention.eval-summe"
PREDICT = "edsnet_torch.models.dsnet_af:_AnchorFree.predict"
READERS = ("af_decode_ms", "af_clipped_pct")


def _run(cpu, patch=None, seed=12345678901, traced=False, seconds=0.3):
    cell = tiny_cell(CELL)
    with hooks.patched(patch or {}):
        result, rows = bench.run_cell(CELL, seed, seconds, traced,
                                      device=cpu, cell=cell)
    return result, {n: v for n, v, _ in rows}


def test_reference_agrees_with_the_port(cpu):
    result, numbers = _run(cpu)
    assert result["correct"], numbers
    assert result["failed"] == 0
    assert numbers["cls_gap"] < 1e-5
    for exact in ("keep_diff", "shot_diff", "pick_diff", "summary_diff",
                  "count_diff"):
        assert numbers[exact] == 0
    assert numbers["f_gap"] < 1e-6


def test_the_head_is_the_reference_anchor_free_one():
    cell = load_cell(CELL)
    head = cell.model.HEAD
    assert head.targets["predict"] == PREDICT
    assert head.boxes_per_position(cell.config) == 1
    # one mixer: ab-attention's own function, not a copy
    ab = load_cell("ab-attention.eval-summe").model
    assert head.mixer is ab.mixer
    with pytest.raises(NotImplementedError, match="train-tvsum"):
        head.labels(cell.config, None, {})


@pytest.mark.parametrize("fault", [None, "second_row"])
def test_eval_judges_every_row_of_a_batch(fault, cpu):
    cell = tiny_cell(CELL)
    cell.traffic = dict(cell.traffic, program=dict(
        cell.traffic["program"], batch_size=2))
    patch = {} if fault is None else {PREDICT: _second_row_altered}
    with hooks.patched(patch):
        result, rows = bench.run_cell(CELL, 424242, 0.3, False, device=cpu,
                                      cell=cell)
    numbers = {n: v for n, v, _ in rows}
    assert result["correct"] == (fault is None), numbers


def _without_centerness(fn):
    """The decode with the centerness left out of the score."""
    def call(pred_cls, pred_loc, pred_ctr, mask=None):
        return fn(pred_cls, pred_loc, torch.ones_like(pred_ctr), mask)
    return call


AF_FAULTS = {
    "answer_altered": FAULTS["answer_altered"][0],
    "summary_altered": FAULTS["summary_altered"][0],
    "score_altered": {PREDICT: _score_altered},
    "without_centerness": {"edsnet_torch.models.dsnet_af:_af_predict":
                           _without_centerness},
}


@pytest.mark.parametrize("fault", sorted(AF_FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, cpu):
    result, numbers = _run(cpu, patch=AF_FAULTS[fault])
    assert not result["correct"], numbers
    assert result["failed"] >= 1


# ----------------------------------------------------------------- readers

def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"portbench_metric_{name}")


def _rec(id_, name, host, parent=None, profiled=True):
    return {"id": id_, "name": name, "parent": None, "parent_id": parent,
            "start_ns": 0, "end_ns": int(host * 1e6), "host_ms": host,
            "self_ms": host, "fenced_ms": None, "profiled": profiled}


def _snapshot():
    records = [
        # pass 10: two videos, each decode inside eval/predict
        _rec(12, "af/decode", 0.1, 11), _rec(11, "eval/predict", 5.0, 10),
        _rec(14, "af/decode", 0.3, 13), _rec(13, "eval/predict", 6.0, 10),
        _rec(10, "eval/pass", 100.0),
        _rec(22, "af/decode", 0.2, 21), _rec(21, "eval/predict", 5.0, 20),
        _rec(20, "eval/pass", 90.0),
        # a pass the profiler stopped inside: its decode ran untraced
        _rec(32, "af/decode", 9.0, 31, profiled=False),
        _rec(31, "eval/predict", 5.0, 30), _rec(30, "eval/pass", 80.0),
        # a pass outside the profiled stretch
        _rec(42, "af/decode", 9.0, 41, profiled=False),
        _rec(41, "eval/predict", 5.0, 40, profiled=False),
        _rec(40, "eval/pass", 80.0, profiled=False)]
    counters = {"af.boxes": 2000, "af.clipped": 150}
    return {"spans": {}, "counters": counters, "records": records,
            "dropped": 0}


def test_readers_on_a_hand_made_snapshot():
    snap = _snapshot()
    assert _reader("af_decode_ms").figure(snap) == pytest.approx(0.3)
    assert _reader("af_clipped_pct").figure(snap) == pytest.approx(7.5)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_its_span_or_counter_reads_none(name):
    reader = _reader(name)
    empty = {"spans": {}, "counters": {}, "records": [], "dropped": 0}
    assert reader.figure(empty) is None
    snap = _snapshot()
    snap["records"] = [r for r in snap["records"] if r["name"] != "af/decode"]
    snap["counters"] = {}
    assert reader.figure(snap) is None


@pytest.mark.parametrize("name", READERS)
def test_names_are_no_import_targets(name):
    reader = _reader(name)
    assert reader.PROFILE
    try:
        names = reader.spans(load_cell(CELL))
    finally:
        from edsnet_torch.utils import profiling
        profiling.disable()
        profiling.reset()
    assert names and all("/" in n and not hooks.exists(n) for n in names)


def _round_up(x, m):
    return -(-x // m) * m


def test_traced_run_reads_the_decode(cpu, monkeypatch):
    from edsnet_torch.parallel import eval_device
    from edsnet_torch.utils import profiling
    seen = []
    evaluate = eval_device.evaluate_on_device

    def kept(model, records, *args, **kwargs):
        if profiling.enabled():
            seen.extend(r.seq.shape[0] for r in records)
        return evaluate(model, records, *args, **kwargs)

    monkeypatch.setattr(eval_device, "evaluate_on_device", kept)
    try:
        result, _ = _run(cpu, seed=2 ** 31 + 12345, traced=True,
                         seconds=0.5)
    finally:
        profiling.disable()
        profiling.reset()
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(k in m for k in READERS), m
    assert m["nms_loop_iters"] == pytest.approx(
        sum(_round_up(n, 256) for n in seen) / len(seen))
    assert 0 < m["af_clipped_pct"] < 100
    assert m["af_decode_ms"] > 0


@pytest.mark.parametrize("n", [64, 300])
def test_forward_flops_count_the_products(n):
    """The configuration's count equals the matmul work of a run of the
    plain reference head at a test width: the mixer, the trunk and the
    heads' 4 outputs a position."""
    from portbench.lib.weights import make_weights
    from portbench.tests.test_portbench_counts import _count_matmuls
    cell = load_cell(CELL)
    cfg = dict(cell.config, num_feature=64, num_head=2)
    W = make_weights(cell.model.weight_spec(cfg), 0, torch.device("cpu"))
    x = torch.randn(n, 64)
    got = _count_matmuls(lambda: cell.model.HEAD.predict(cfg, W, x))
    assert got == pytest.approx(cell.model.forward_flops(cfg, n), rel=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 5550123])
def test_control_fails_where_the_program_passes(seed, card):
    """As ``test_portbench_control.py`` for the anchor-free cell: the
    reference in float32 with TF32 on fails a limit the program meets."""
    import shutil
    import tempfile
    from pathlib import Path

    from portbench import calibrate
    from portbench.lib import check
    from portbench.tests.test_portbench_control import _small
    cell = _small(CELL)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-test-"))
    run = cell.driver.Run(cell, seed, card, workdir)
    try:
        run.setup()
        run.window(3.0)
        ok, rows = check.verdict(run.judge(), cell.limits)
        assert ok, rows
        control = calibrate.control_numbers(cell, run, card)
        ok, rows = check.verdict(
            {k: control.get(k, 0.0) for k in cell.limits}, cell.limits)
        assert not ok, rows
    finally:
        run.close()
        shutil.rmtree(workdir, ignore_errors=True)
