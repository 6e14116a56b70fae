"""The benchmark's arithmetic: operation and byte counts, the shares of
a peak, the trace's reduction and the window's rates."""
import sys
import time
import types
import warnings

import pytest
import torch

from portbench.lib import peaks, trace
from portbench.lib.cell import BENCH_DIR, load_cell, load_module


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"portbench_metric_{name}")


def _count_matmuls(fn, *args):
    """2 x multiply-adds of every matmul, einsum-free forward."""
    total = [0]

    class Counter(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types_, args_=(), kwargs=None):
            out = func(*args_, **(kwargs or {}))
            if getattr(func, "__name__", "") in ("__matmul__", "matmul"):
                total[0] += 2 * args_[0].shape[-1] * out.numel()
            return out

    with Counter():
        fn(*args)
    return total[0]


@pytest.mark.parametrize("config", ["ab-attention", "ab-nystromformer"])
@pytest.mark.parametrize("n", [64, 300])
def test_forward_flops_count_the_products(config, n):
    """The configuration's count equals the mixer's and trunk's matmul
    work (the attention's n^2 products and the projections), counted
    from a run of the plain reference at a test width."""
    from portbench.reference import model as ref_model
    from portbench.lib.weights import make_weights
    cell = load_cell(f"{config}.eval-summe")
    cfg = dict(cell.config, num_feature=64, num_head=2)
    spec = cell.model.weight_spec(cfg)
    W = make_weights(spec, 0, torch.device("cpu"))
    x = torch.randn(n, 64)
    got = _count_matmuls(
        lambda: ref_model.forward(
            W, x, lambda W_, x_, d: cell.model.mixer(cfg, W_, x_, d),
            cfg["anchor_scales"], cfg["fc_depth"],
            ref_model.Draws(None, n)))
    want = cell.model.forward_flops(cfg, n)
    # the residual conv is a conv2d, which the count above does not see
    conv = 0
    if "residual_conv_kernel" in cfg:
        conv = 2 * (-(-n // 64) * 64) * cfg["residual_conv_kernel"] \
            * cfg["dim_head"] * cfg["num_head"]
    assert got + conv == pytest.approx(want, rel=1e-9)


def test_attention_roofline_least_time():
    reader = _reader("attn_fwd_roofline")
    # compute-bound at n 4096, D 128: 4 H n^2 D / 495e12
    assert reader.least_seconds(8, 4096, 128) == pytest.approx(
        4 * 8 * 4096 ** 2 * 128 / peaks.TF32_FLOPS)
    # bandwidth-bound at n 64: 16 H n D bytes / 3.35e12
    assert reader.least_seconds(8, 64, 128) == pytest.approx(
        16 * 8 * 64 * 128 / peaks.HBM_BYTES)
    q = torch.zeros(2, 8, 256, 128)
    mask = torch.zeros(2, 256, dtype=torch.bool)
    mask[0, :100] = True
    mask[1, :256] = True
    least = reader.least_seconds(8, 100, 128) + reader.least_seconds(
        8, 256, 128)
    t = types.SimpleNamespace(
        kernels=[("flash_fwd_kernel", 0.0, least * 4),
                 ("other", 0.0, 1.0)],
        calls={reader.CORE: [((q, q, q, mask), {"precision": "highest"})]})
    assert reader.read(t) == pytest.approx(25.0)
    assert reader.read(types.SimpleNamespace(kernels=[], calls={})) is None


_CALLS = {"all": 0, "profiled": 0}


def traced_target(x):
    """A wrapped name for ``test_profile_phase_keeps_only_traced_calls``:
    counts its calls, and those made while the profiler records."""
    _CALLS["all"] += 1
    _CALLS["profiled"] += bool(torch.autograd._profiler_enabled())
    time.sleep(0.002)
    return x + 1


def test_profile_phase_keeps_only_traced_calls():
    """The profiler stops inside a unit (on a labelled call's entry); the
    calls whose arguments a metric reads are those whose work the trace
    holds, not the one that stopped it nor the rest of that unit."""
    target = "portbench.tests.test_portbench_counts:traced_target"
    _CALLS.update(all=0, profiled=0)
    module = sys.modules[__name__]

    def unit():
        for _ in range(10):
            module.traced_target(torch.zeros(2))

    t = trace.Trace(cell=None, window={})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # no CUDA to trace here
        trace.profile_phase(t, unit, 0.005, [target], [target],
                            torch.device("cpu"))
    kept = len(t.calls[target])
    assert kept == _CALLS["profiled"] >= 1
    assert _CALLS["all"] > kept       # the stopping unit ran on untraced


def test_mfu_counts_three_passes_in_training():
    cell = load_cell("ab-nystromformer.train-tvsum")
    train = _reader("mfu_pct.train")
    evaluation = _reader("mfu_pct.eval")
    flops = cell.model.forward_flops(cell.config, 500)
    t = types.SimpleNamespace(cell=cell, window={"trained": {500: 10},
                                                 "seconds": 2.0})
    assert train.read(t) == pytest.approx(
        100 * 3 * 10 * flops / 2.0 / peaks.TF32_FLOPS)
    t.window = {"predicted": {500: 10}, "seconds": 2.0}
    assert evaluation.read(t) == pytest.approx(
        100 * 10 * flops / 2.0 / peaks.TF32_FLOPS)
    assert train.read(t) is None


class _Ev:
    def __init__(self, name, a, b, cuda, label=False):
        from torch.autograd import DeviceType
        self.name = name
        self.is_user_annotation = label
        self.time_range = types.SimpleNamespace(start=a * 1e6, end=b * 1e6)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU


def test_trace_reduction_busy_idle_and_gaps():
    events = [_Ev("outer", 0.0, 10.0, False), _Ev("inner", 2.0, 6.0, False),
              _Ev("k1", 1.0, 3.0, True), _Ev("k2", 2.5, 4.0, True),
              _Ev("k1", 7.0, 8.0, True),
              _Ev("inner", 2.0, 9.0, True, label=True)]
    out = trace.reduce_events(events, ["outer", "inner"])
    assert out["busy_s"] == pytest.approx(4.0)      # [1, 4] and [7, 8]
    assert out["window_s"] == pytest.approx(10.0)
    assert dict(out["breakdown"]["device_ops"]) == pytest.approx(
        {"k1": 3.0, "k2": 1.5})
    # gaps: [0, 1] in outer, [4, 7] in inner (opened at 2), [8, 10] outer
    assert dict(out["breakdown"]["idle_gaps"]) == pytest.approx(
        {"outer": 3.0, "inner": 3.0})
    idle = _reader("device_idle_pct.train")
    t = types.SimpleNamespace(busy_s=out["busy_s"], window_s=out["window_s"])
    assert idle.read(t) == pytest.approx(60.0)


def test_span_metrics():
    step = _reader("train_step_ms")
    fold = _reader("fold_setup_ms")
    nms = _reader("nms_ms")
    predict = _reader("predict_ms")
    cell = load_cell("ab-nystromformer.train-tvsum")
    targets = cell.model.HEAD.targets
    assert step.spans(cell) == (targets["train_step"],)
    assert fold.spans(cell) == (fold.FOLD, targets["train_step"])
    assert predict.spans(cell) == (predict.PASS, targets["predict"])
    t = types.SimpleNamespace(cell=cell, spans={
        targets["train_step"]: [(1.0, 1.02), (1.5, 1.54)],
        fold.FOLD: [(0.5, 3.0)],
        nms.PASS: [(0.0, 1.0), (1.0, 2.0)],
        nms.NMS: [(0.1, 0.2), (1.1, 1.4)],
        targets["predict"]: [(0.0, 0.05), (1.0, 1.01)]})
    assert step.read(t) == pytest.approx(30.0)
    assert fold.read(t) == pytest.approx(500.0)
    assert nms.read(t) == pytest.approx(200.0)
    assert predict.read(t) == pytest.approx(30.0)
    assert step.read(types.SimpleNamespace(cell=cell, spans={})) is None


def test_window_rate_and_tail(cpu):
    """The eval window's rate is every video over all the window, and its
    tail the 90th percentile of every pass."""
    from portbench.tests.conftest import tiny_cell
    from portbench import run as bench
    cell = tiny_cell("ab-nystromformer.eval-summe")
    result, _ = bench.run_cell(cell.name, 11, 0.5, False, device=cpu,
                               cell=cell)
    m = result["metrics"]
    assert set(m) == {"eval_videos_per_s", "eval_pass_p90_ms", "setup_s"}
    assert m["eval_videos_per_s"]["value"] > 0
    assert m["eval_pass_p90_ms"]["value"] > 0
    assert result["attempted"] >= 1
