"""The per-layer metrics that read the program's own tracer: each reader's
arithmetic on a snapshot made by hand (None where its span or counter is
missing), its names left alone by the hooks, and a traced run of a cell
cut to test size on the CPU, whose NMS and knapsack counts equal the
padded shapes of the videos it evaluated."""
import pytest

from portbench.lib import hooks
from portbench.lib.cell import BENCH_DIR, load_cell, load_module
from portbench.tests.conftest import tiny_cell

TRAIN = ("train_step_fenced_ms", "train_step_dispatch_ms",
         "fold_setup_span_ms", "validation_fenced_ms")
EVAL = ("nms_loop_iters", "nms_kept_pct", "knapsack_steps",
        "knapsack_live_pct", "eval_fetch_wait_ms")


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"portbench_metric_{name}")


def _rec(id_, name, host, parent=None, fenced=None, profiled=True):
    return {"id": id_, "name": name, "parent": parent and parent[1],
            "parent_id": parent and parent[0], "start_ns": 0,
            "end_ns": int(host * 1e6), "host_ms": host, "self_ms": host,
            "fenced_ms": fenced, "profiled": profiled}


def _snapshot():
    fold = (0, "trainer/fold")
    pass1, pass2, pass3 = (10, "eval/pass"), (20, "eval/pass"), \
        (30, "eval/pass")
    records = [
        _rec(1, "trainer/setup", 300.0, fold, profiled=True),
        _rec(2, "steps/train_step", 20.0, fold, fenced=2.0, profiled=False),
        _rec(3, "steps/train_step", 24.0, fold, fenced=4.0, profiled=False),
        # the profiled stretch's: the profiler's own cost inflates it
        _rec(4, "steps/train_step", 45.0, fold, fenced=44.0),
        _rec(5, "trainer/validation", 600.0, fold, fenced=500.0),
        _rec(6, "trainer/validation", 700.0, fold, fenced=700.0,
             profiled=False),
        _rec(0, "trainer/fold", 2000.0),
        _rec(7, "trainer/setup", 500.0, (8, "trainer/fold"),
             profiled=False),
        _rec(11, "eval/fetch", 3.0, pass1), _rec(12, "eval/fetch", 5.0, pass1),
        _rec(10, "eval/pass", 100.0),
        _rec(21, "eval/fetch", 30.0, pass2), _rec(20, "eval/pass", 120.0),
        # a pass the profiler stopped inside: its fetch ran untraced
        _rec(31, "eval/fetch", 0.1, pass3, profiled=False),
        _rec(30, "eval/pass", 90.0),
        _rec(41, "eval/fetch", 0.2, (40, "eval/pass"), profiled=False),
        _rec(40, "eval/pass", 80.0, profiled=False)]
    counters = {"nms.rows": 4, "nms.iterations": 9216, "nms.slots": 9216,
                "nms.kept": 1152, "knapsack.rows": 4, "knapsack.steps": 512,
                "knapsack.slots": 256, "knapsack.live": 200}
    return {"spans": {}, "counters": counters, "records": records,
            "dropped": 0}


def test_readers_on_a_hand_made_snapshot():
    snap = _snapshot()
    want = {"train_step_fenced_ms": 3.0, "train_step_dispatch_ms": 22.0,
            "fold_setup_span_ms": 400.0, "validation_fenced_ms": 600.0,
            "nms_loop_iters": 2304.0, "nms_kept_pct": 12.5,
            "knapsack_steps": 128.0, "knapsack_live_pct": 78.125,
            "eval_fetch_wait_ms": 19.0}
    for name, value in want.items():
        assert _reader(name).figure(snap) == pytest.approx(value), name


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_reader_without_its_span_or_counter_reads_none(name):
    reader = _reader(name)
    snap = _snapshot()
    empty = {"spans": {}, "counters": {}, "records": [], "dropped": 0}
    assert reader.figure(empty) is None
    # each reader's own names and counters taken out of the full snapshot
    names = set(reader.NAMES)
    snap["records"] = [r for r in snap["records"] if r["name"] not in names]
    prefix = name.split("_")[0] + "."
    snap["counters"] = {k: v for k, v in snap["counters"].items()
                        if not k.startswith(prefix)}
    assert reader.figure(snap) is None


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_names_are_no_import_targets(name):
    """The hooks leave a program span's name alone: only the profiler's
    annotation, which the program makes, labels it."""
    reader = _reader(name)
    assert reader.PROFILE
    try:
        names = reader.spans(load_cell(
            "ab-nystromformer.train-tvsum" if name in TRAIN
            else "ab-attention.eval-summe"))
    finally:
        from edsnet_torch.utils import profiling
        profiling.disable()
        profiling.reset()
    assert names and all("/" in n and not hooks.exists(n) for n in names)


def _round_up(x, m):
    return -(-x // m) * m


def test_traced_eval_run_counts_the_padded_shapes(cpu, monkeypatch):
    from edsnet_torch.parallel import eval_device
    from edsnet_torch.utils import profiling
    from portbench import run as bench
    cell = tiny_cell("ab-attention.eval-summe")
    seen = []
    evaluate = eval_device.evaluate_on_device

    def kept(model, records, *args, **kwargs):
        if profiling.enabled():
            seen.extend((r.seq.shape[0], len(r.cps)) for r in records)
        return evaluate(model, records, *args, **kwargs)

    monkeypatch.setattr(eval_device, "evaluate_on_device", kept)
    try:
        result, _ = bench.run_cell(cell.name, 2 ** 31 + 12345, 0.5, True,
                                   device=cpu, cell=cell)
    finally:
        profiling.disable()
        profiling.reset()
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(k in m for k in EVAL), m
    scales = len(cell.config["anchor_scales"])
    assert m["nms_loop_iters"] == pytest.approx(
        sum(_round_up(n, 256) * scales for n, _ in seen) / len(seen))
    assert m["knapsack_steps"] == pytest.approx(
        sum(2 * _round_up(s, 16) for _, s in seen) / len(seen))
    assert 0 < m["nms_kept_pct"] < 100 and 0 < m["knapsack_live_pct"] < 100
    assert m["eval_fetch_wait_ms"] >= 0
