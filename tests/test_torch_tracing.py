"""The port's tracer (edsnet_torch/utils/profiling.py): off it records
nothing and hands out one shared null context; on, nested spans keep their
parents, self times and aggregates, raw records stop at the cap with a
count of those dropped, a span lies on the profiler's clock inside its own
``record_function`` event, and the NMS and knapsack counters count exactly.
Tracing changes no result of the device evaluator or the trainer, and
``--profile`` waits for the device at no step."""
import re
import time
import types

import numpy as np
import pytest
import torch
import yaml

from edsnet_torch import trainer
from edsnet_torch.data.dataset import VideoRecord, load_yaml
from edsnet_torch.models.common import init_weights
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.ops.bbox import nms_masked
from edsnet_torch.ops.knapsack import knapsack
from edsnet_torch.parallel import eval_device
from edsnet_torch.utils import profiling
from tests.test_torch_eval import SMALL, _videos
from tests.test_torch_resume import _args, _make_mock_h5


@pytest.fixture
def tracer():
    """The tracer, reset and on; off and reset afterwards."""
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def _boxes(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    scores = torch.rand(b, n, generator=g)
    left = torch.randint(0, 40, (b, n), generator=g).float()
    width = torch.randint(0, 12, (b, n), generator=g).float()  # 0: dropped
    valid = torch.rand(b, n, generator=g) > 0.2
    return scores, torch.stack([left, left + width], -1), valid


def _items(b, n, seed):
    g = torch.Generator().manual_seed(seed)
    values = torch.randint(0, 50, (b, n), generator=g)
    weights = torch.randint(0, 9, (b, n), generator=g)
    weights[:, n // 2:] = 0                    # padding items
    capacity = torch.randint(5, 30, (b,), generator=g)
    return values, weights, capacity


def test_off_path_records_nothing():
    profiling.disable()
    profiling.reset()
    assert profiling.span("eval/nms") is profiling.span(
        "steps/train_step", fence=torch.device("cpu"))
    nms_masked(*_boxes(2, 16, 0)[:2], 0.5)
    knapsack(*_items(2, 8, 0), max_capacity=30)
    with profiling.span("a/b"):
        profiling.count("x", 3)
    snap = profiling.snapshot()
    assert snap == {"spans": {}, "counters": {}, "records": [], "dropped": 0}


def test_nested_spans_parents_self_time_and_aggregates(tracer):
    for _ in range(2):
        with tracer.span("t/outer"):
            time.sleep(0.004)
            with tracer.span("t/inner"):
                time.sleep(0.006)
            with tracer.span("t/inner"):
                pass
    snap = tracer.snapshot()
    by_name = {}
    for r in snap["records"]:
        by_name.setdefault(r["name"], []).append(r)
    outer, inner = by_name["t/outer"], by_name["t/inner"]
    assert len(outer) == 2 and len(inner) == 4
    assert all(r["parent"] is None and r["parent_id"] is None for r in outer)
    ids = {r["id"] for r in outer}
    assert all(r["parent"] == "t/outer" and r["parent_id"] in ids
               for r in inner)
    for o in outer:
        kids = [r for r in inner if r["parent_id"] == o["id"]]
        assert o["self_ms"] == pytest.approx(
            o["host_ms"] - sum(k["host_ms"] for k in kids), abs=1e-6)
        assert o["self_ms"] >= 3.5 and o["start_ns"] <= kids[0]["start_ns"]
        assert all(r["fenced_ms"] is None and not r["profiled"]
                   for r in kids + [o])
    agg = snap["spans"]
    assert agg["t/outer"]["count"] == 2 and agg["t/inner"]["count"] == 4
    assert agg["t/outer"]["total_ms"] == pytest.approx(
        sum(r["host_ms"] for r in outer))
    assert agg["t/outer"]["self_ms"] == pytest.approx(
        agg["t/outer"]["total_ms"] - agg["t/inner"]["total_ms"])
    assert agg["t/inner"]["fenced_ms"] == 0.0


def test_raw_records_stop_at_the_cap(tracer, monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    for _ in range(5):
        with tracer.span("t/step", fence=torch.device("cpu")):
            pass
    snap = tracer.snapshot()
    assert len(snap["records"]) == 3 and snap["dropped"] == 2
    agg = snap["spans"]["t/step"]
    assert agg["count"] == 5
    # fenced on the CPU: the host clock
    assert agg["fenced_ms"] == pytest.approx(agg["total_ms"])
    assert [r["fenced_ms"] for r in snap["records"]] == pytest.approx(
        [r["host_ms"] for r in snap["records"]])


@pytest.mark.parametrize("on", [True, False])
def test_recording_notes_spans_and_counters_and_measures_nothing(tracer,
                                                                 on):
    """What a CUDA graph's capture notes, tracer on or off: the open spans
    with their fences, and each counter's int or tensor; nothing is
    recorded or counted until the block ends."""
    if not on:
        tracer.disable()
    valid = torch.tensor([0, 1, 2])
    with tracer.recording() as rec:
        with tracer.span("t/outer"):
            with tracer.span("t/inner", fence=torch.device("cpu")):
                assert rec.open == [("t/outer", None),
                                    ("t/inner", torch.device("cpu"))]
                tracer.count("t.n", 2)
                tracer.count_nonzero("t.valid", valid)
        assert rec.open == []
    assert [name for name, _ in rec.counts] == ["t.n", "t.valid"]
    assert rec.counts[0][1] == 2 and rec.counts[1][1] is valid
    snap = tracer.snapshot()
    assert (snap["spans"], snap["counters"], snap["records"]) == ({}, {},
                                                                   [])
    with tracer.span("t/outer"):
        tracer.count("t.n", 1)
    snap = tracer.snapshot()
    assert snap["counters"] == ({"t.n": 1} if on else {})
    assert ("t/outer" in snap["spans"]) is on


def test_span_lies_in_its_profiler_event(tracer):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("t/clock"):
            torch.ones(1000).cumsum(0)
            time.sleep(0.002)
    rec, = tracer.snapshot()["records"]
    assert rec["profiled"]
    base = prof.profiler.kineto_results.trace_start_ns()
    event, = [e for e in prof.events() if e.name == "t/clock"]
    lo = base + event.time_range.start * 1e3
    hi = base + event.time_range.end * 1e3
    assert lo - 1e6 <= rec["start_ns"] <= rec["end_ns"] <= hi + 1e6


@pytest.mark.parametrize("b,n,seed", [(1, 24, 0), (3, 40, 1), (2, 7, 2)])
def test_nms_counters_exact(tracer, b, n, seed):
    scores, boxes, valid = _boxes(b, n, seed)
    keep = nms_masked(scores, boxes, 0.4, valid)
    c = tracer.snapshot()["counters"]
    assert c["nms.rows"] == b and c["nms.iterations"] == n
    assert c["nms.slots"] == b * n
    assert c["nms.kept"] == int(keep.sum()) > 0


@pytest.mark.parametrize("b,n,seed", [(1, 16, 0), (4, 10, 1)])
def test_knapsack_counters_exact(tracer, b, n, seed):
    values, weights, capacity = _items(b, n, seed)
    knapsack(values, weights, capacity, max_capacity=30)
    snap = tracer.snapshot()
    c = snap["counters"]
    assert c["knapsack.rows"] == b and c["knapsack.steps"] == 2 * n
    assert c["knapsack.slots"] == b * n
    assert c["knapsack.live"] == int((weights > 0).sum()) < b * n
    assert {"knapsack/dp", "knapsack/backtrack"} <= set(snap["spans"])


def test_evaluation_identical_with_tracing(tracer):
    model = get_model("anchor-based", **SMALL)
    init_weights(model, torch.Generator().manual_seed(0))
    model.eval()
    records = [VideoRecord(**v) for v in _videos()]
    runs = []
    for on in (False, True):
        (tracer.enable if on else tracer.disable)()
        per_video = []
        mean = eval_device.evaluate_on_device(model, records, 0.5,
                                              batch_size=2, bucket_size=32,
                                              per_video=per_video)
        runs.append((mean, per_video))
    (f_off, off), (f_on, on) = runs
    assert f_on == f_off
    for a, b in zip(off, on):
        assert a["fscore"] == b["fscore"] and a["diversity"] == b["diversity"]
        np.testing.assert_array_equal(a["summary"], b["summary"])
    spans = tracer.snapshot()["spans"]
    assert spans["eval/pass"]["count"] == 1
    assert spans["eval/fetch"]["count"] == spans["eval/f1"]["count"] == 2
    for name in ("eval/predict", "eval/nms", "eval/raster", "eval/summary",
                 "eval/diversity", "knapsack/dp"):
        assert spans[name]["count"] >= 1, name


def test_training_identical_with_tracing(tracer, tmp_path, monkeypatch):
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    losses = []
    step = trainer.ab_train_step

    def kept(*args, **kwargs):
        metrics = step(*args, **kwargs)
        losses.append(float(metrics["loss"]))
        return metrics

    monkeypatch.setattr(trainer, "ab_train_step", kept)
    runs = []
    for on in (False, True):
        (tracer.enable if on else tracer.disable)()
        losses.clear()
        out = trainer.train(_args(tmp_path, f"m{on}", 2, extra=()), split,
                            tmp_path / f"m{on}.pt")
        runs.append((out, list(losses)))
    assert runs[0] == runs[1] and len(runs[0][1]) == 2
    snap = tracer.snapshot()
    spans, c = snap["spans"], snap["counters"]
    assert spans["trainer/fold"]["count"] == spans["trainer/setup"]["count"]
    # 2 epochs of one batch of the two train videos
    assert spans["steps/train_step"]["count"] == c["steps.steps"] == 2
    assert c["steps.positions"] == 2 * (20 + 24)
    for name in ("steps/labels", "steps/forward", "steps/loss",
                 "steps/backward", "steps/adam", "trainer/epoch_plan",
                 "trainer/setup.items", "trainer/setup.pools",
                 "trainer/setup.eval_batches"):
        assert spans[name]["count"] >= 1, name
    assert spans["trainer/setup.model"]["count"] == 2
    assert spans["trainer/validation"]["count"] == 2
    for r in snap["records"]:
        if r["name"].startswith("steps/") and r["name"] != "steps/train_step":
            assert r["parent"] == "steps/train_step", r
        if r["name"].startswith("trainer/setup."):
            assert r["parent"] == "trainer/setup", r


class _LooksOnCuda(torch.Tensor):
    """A CPU tensor that says it lives on a card, so that a wait keyed on
    where the step's outputs live runs here as it would there."""

    @property
    def is_cuda(self):
        return True


def test_profile_waits_at_no_step(tmp_path, monkeypatch, caplog):
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    step = trainer.ab_train_step
    monkeypatch.setattr(trainer, "ab_train_step", lambda *a, **k: {
        key: v.as_subclass(_LooksOnCuda) for key, v in step(*a, **k).items()})
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waits.append("synchronize"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: types.SimpleNamespace(
                            synchronize=lambda: waits.append("stream")))
    caplog.set_level("INFO")
    trainer.train(_args(tmp_path, "p", 2, extra=("--profile",)), split,
                  tmp_path / "p.pt")
    assert waits == []
    assert not profiling.enabled()
    lines = [r.getMessage() for r in caplog.records]
    trace = [m for m in lines if m.startswith("trace: spans")][-1]
    assert "'steps/train_step': (2," in trace
    assert "'steps.positions': 88" in trace and "'nms.iterations'" in trace
    top = [m for m in lines if "top device ops" in m][-1]
    assert re.search(r"'steps/train_step': \(1, 0\)", top), top
    summary = yaml.safe_load(
        [m for m in lines if m.startswith("train throughput: ")][-1]
        [len("train throughput: "):])
    assert summary["frames"] == 88 and summary["steps"] == 2


def test_span_launches_count_inside_each_name():
    from torch.autograd import DeviceType

    def ev(name, a, b, device=DeviceType.CPU):
        return types.SimpleNamespace(
            name=name, device_type=device,
            time_range=types.SimpleNamespace(start=a, end=b))

    events = [ev("steps/train_step", 0, 10), ev("steps/train_step", 20, 30),
              ev("steps/forward", 1, 4), ev("eval/nms", 40, 50),
              ev("cudaLaunchKernel", 2, 2.5), ev("cudaLaunchKernel", 5, 6),
              ev("cuLaunchKernel", 25, 26), ev("cudaMemcpyAsync", 26, 27),
              ev("cudaLaunchKernel", 35, 36),
              ev("kernel", 3, 4, DeviceType.CUDA)]
    got = profiling.span_launches(
        events, {"steps/train_step", "steps/forward", "eval/nms", "t/none"})
    assert got == {"steps/train_step": (2, 3), "steps/forward": (1, 1),
                   "eval/nms": (1, 0)}
