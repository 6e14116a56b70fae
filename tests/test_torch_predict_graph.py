"""The heads' eval forward replayed from CUDA graphs
(``edsnet_torch/models/graphed.py``).

On the CPU: the rule that decides which forwards are graphed (from the
model and the length alone), and ``predict`` left eager there, returning
the eager forward's decode, with the tracer counting its calls and no
replay.  On a card (``cuda`` marker; every case skips without one):
graphed ``predict`` against the eager forward and decode at each eval
bucket and at batch 4, for the headline model (F 1024, the Nystromformer
mixer of 8 heads of 64, 64 landmarks, anchor scale 12) and for every
backbone and depth the CLIs build; an in-place weight change read by the
next replay; results that do not alias the graph's buffers; a capture on a
key's second call only; graphs that go with their model; the flash route
left eager, its kernel still launched and counted.

Imports neither JAX nor edsnet_tpu, so the card's cases also run where
only the port is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_predict_graph.py
"""
import gc
import weakref

import pytest
import torch

from edsnet_torch.kernels import flash_attention as flash
from edsnet_torch.models.dsnet import _decode_predictions
from edsnet_torch.models.dsnet_af import _af_predict
from edsnet_torch.models.graphed import graphable
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel.tensor_parallel import emulate_tp
from edsnet_torch.utils import profiling


def _model(model_type="anchor-based", base_model="nystromformer",
           num_feature=1024, num_head=8, use_pallas=None,
           model_depth="shallow", anchor_scales=(12,), pooling_type="roi",
           seed=0):
    torch.manual_seed(seed)
    return get_model(model_type, base_model=base_model,
                     num_feature=num_feature, num_hidden=128,
                     anchor_scales=list(anchor_scales), num_head=num_head,
                     fc_depth=7, pooling_type=pooling_type,
                     model_depth=model_depth, attention_depth=2,
                     use_pallas=use_pallas).eval()


def _inputs(lens, bucket, num_feature, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(len(lens), bucket, num_feature, generator=g)
    mask = torch.arange(bucket)[None, :] < torch.tensor(lens)[:, None]
    x = x * mask[..., None]
    return x.to(device), mask.to(device)


def _eager(model, x, mask):
    """The eager forward and the head's decode: ``predict`` before
    graphs."""
    out = model(x, mask)
    if len(out) == 3:
        return _af_predict(*out, mask)
    return _decode_predictions(*out, model.scales)


@pytest.fixture
def tracer():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.reset()


def _counters():
    return profiling.snapshot()["counters"]


# --- the rule, on the CPU ------------------------------------------------

@pytest.mark.parametrize("name,kwargs,on_cuda,want", [
    ("nystromformer", {}, True, True),
    ("nystromformer, cpu", {}, False, False),
    ("nystromformer, anchor-free", {"model_type": "anchor-free"}, True,
     True),
    ("attention, flash route", {"base_model": "attention"}, True, False),
    ("attention, anchor-free flash route",
     {"base_model": "attention", "model_type": "anchor-free"}, True, False),
    ("attention, --use-pallas", {"base_model": "attention",
                                 "use_pallas": True}, True, False),
    ("attention, --no-pallas", {"base_model": "attention",
                                "use_pallas": False}, True, True),
    ("attention, head dim 16 off the kernel",
     {"base_model": "attention", "num_feature": 32}, True, True),
])
def test_graphable_rule(name, kwargs, on_cuda, want):
    kwargs = {"num_feature": 256, "num_head": 2, **kwargs}
    model = _model(**kwargs)
    assert graphable(model, on_cuda, 512) is want, name


def test_training_is_not_graphable():
    model = _model(num_feature=256, num_head=2).train()
    assert not graphable(model, True, 512)


def test_tensor_parallel_is_not_graphable():
    model = _model(base_model="attention", num_feature=256, num_head=2,
                   use_pallas=False)
    assert graphable(model, True, 512)
    with emulate_tp(model, 2):
        assert not graphable(model, True, 512)
    assert graphable(model, True, 512)


@pytest.mark.parametrize("model_type,base_model", [
    ("anchor-based", "nystromformer"), ("anchor-based", "attention"),
    ("anchor-free", "nystromformer"), ("anchor-free", "attention")])
def test_predict_on_cpu_is_the_eager_decode(tracer, model_type, base_model):
    model = _model(model_type, base_model, num_feature=256, num_head=2)
    x, mask = _inputs([200, 77], 256, 256)
    with torch.inference_mode():
        want = _eager(model, x, mask)
        for _ in range(3):
            got = model.predict(x, mask)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    counters = _counters()
    assert counters["predict.calls"] == 3
    assert counters.get("predict.graph_replays", 0) == 0
    assert counters.get("predict.graph_captures", 0) == 0
    assert "_eval_graphs" not in model.__dict__


# --- on a card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _predict_thrice(model, x, mask):
    """The first call eager, the second captures and replays, the third
    replays -> the three results."""
    with torch.inference_mode():
        return [model.predict(x, mask) for _ in range(3)]


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b), float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("lens,bucket", [
    ([200], 256), ([400], 512), ([700], 768), ([780], 1024),
    ([700, 300, 520, 130], 768)])
def test_graphed_predict_equals_eager(cuda_device, tracer, lens, bucket):
    model = _model().to(cuda_device)
    x, mask = _inputs(lens, bucket, 1024, cuda_device)
    with torch.inference_mode():
        want = _eager(model, x, mask)
    runs = _predict_thrice(model, x, mask)
    for got in runs:
        _assert_same(got, want)
    counters = _counters()
    assert counters["predict.calls"] == 3
    assert counters["predict.graph_captures"] == 1
    assert counters["predict.graph_replays"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,model_depth,base_model", [
    ("anchor-based", "shallow", "nystromformer"),
    ("anchor-based", "shallow/fft", "nystromformer"),
    ("anchor-based", "shallow/dwt", "nystromformer"),
    ("anchor-based", "shallow/flat-pooling", "nystromformer"),
    ("anchor-based", "shallow", "fourier"),
    ("anchor-based", "shallow", "performer"),
    ("anchor-based", "shallow", "linformer"),
    ("anchor-based", "shallow", "dwt"),
    ("anchor-based", "shallow", "linear"),
    ("anchor-based", "shallow", "lstm"),
    ("anchor-based", "shallow", "bilstm"),
    ("anchor-based", "shallow", "gcn"),
    ("anchor-based", "deep", "nystromformer"),
    ("anchor-based", "local-global-attention", "nystromformer"),
    ("anchor-based", "original", "attention"),
    ("anchor-free", "shallow", "nystromformer"),
    ("anchor-free", "deep", "nystromformer"),
    ("anchor-free", "local-global-attention", "nystromformer"),
    ("anchor-free", "original", "attention"),
])
def test_every_graphable_head_replays_its_eager_forward(
        cuda_device, tracer, model_type, model_depth, base_model):
    """Each backbone, depth and pooling (``shallow/<pooling>``, at the
    single scale) the CLIs build, at bucket 256 and batch 2; attention
    under --no-pallas (the dense route) where the flash route would keep
    it eager."""
    depth, _, pooling = model_depth.partition("/")
    model = _model(model_type, base_model, model_depth=depth,
                   use_pallas=False, pooling_type=pooling or "roi",
                   anchor_scales=(12,) if pooling else (4, 8)
                   ).to(cuda_device)
    x, mask = _inputs([200, 90], 256, 1024, cuda_device)
    with torch.inference_mode():
        want = _eager(model, x, mask)
    for got in _predict_thrice(model, x, mask):
        _assert_same(got, want)
    assert _counters()["predict.graph_replays"] == 2


@pytest.mark.cuda
def test_replay_reads_weights_changed_in_place(cuda_device, tracer):
    model = _model().to(cuda_device)
    x, mask = _inputs([230], 256, 1024, cuda_device)
    before = _predict_thrice(model, x, mask)[-1]
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    model.train()
    cls, loc = model(x, mask)
    (cls.sum() + loc.sum()).backward()
    optimizer.step()
    model.eval()
    with torch.inference_mode():
        want = _eager(model, x, mask)
        got = model.predict(x, mask)
    _assert_same(got, want)
    assert not torch.equal(got[0], before[0])
    counters = _counters()
    assert counters["predict.graph_captures"] == 1
    assert counters["predict.graph_replays"] == 3


@pytest.mark.cuda
def test_results_do_not_alias_the_graph(cuda_device):
    model = _model().to(cuda_device)
    inputs = [_inputs([250 - 40 * i], 256, 1024, cuda_device, seed=i)
              for i in range(3)]
    _predict_thrice(model, *inputs[0])          # the key is captured
    with torch.inference_mode():
        wants = [_eager(model, x, mask) for x, mask in inputs]
        gots = [model.predict(x, mask) for x, mask in inputs]
    for got, want in zip(gots, wants):
        _assert_same(got, want)


@pytest.mark.cuda
def test_capture_on_second_call_only(cuda_device, tracer):
    model = _model().to(cuda_device)
    x, mask = _inputs([300], 512, 1024, cuda_device)
    seen = []
    with torch.inference_mode():
        for _ in range(4):
            model.predict(x, mask)
            c = _counters()
            seen.append((c.get("predict.graph_captures", 0),
                         c.get("predict.graph_replays", 0)))
        model.predict(x[:, :256], mask[:, :256])    # a new key: eager
    assert seen == [(0, 0), (1, 1), (1, 2), (1, 3)]
    c = _counters()
    assert (c["predict.calls"], c["predict.graph_captures"],
            c["predict.graph_replays"]) == (5, 1, 3)
    assert profiling.snapshot()["spans"]["predict/capture"]["count"] == 1


def _graphed_model(device):
    model = _model().to(device)
    _predict_thrice(model, *_inputs([300], 256, 1024, device))
    return model


@pytest.mark.cuda
def test_graphs_go_with_their_model(cuda_device):
    """The graphs, their pools and buffers go with the model; a second
    model's captures leave nothing behind (no workspace of a new stream)."""
    _graphed_model(cuda_device)           # the process's first capture
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    model = _graphed_model(cuda_device)
    graphs = model._eval_graphs
    (entry,) = graphs.entries.values()
    refs = [weakref.ref(graphs), weakref.ref(entry)]
    del model, graphs, entry
    gc.collect()
    assert [r() for r in refs] == [None, None]
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) == base


@pytest.mark.cuda
def test_new_parameter_addresses_drop_the_graphs(cuda_device, tracer):
    model = _model().to(cuda_device)
    x, mask = _inputs([300], 256, 1024, cuda_device)
    _predict_thrice(model, x, mask)
    # new parameter storage; the old is kept, so no address comes back
    old = [p.detach() for p in model.parameters()]
    model.to(torch.float64).to(torch.float32)
    assert all(p.data_ptr() != o.data_ptr()
               for p, o in zip(model.parameters(), old))
    with torch.inference_mode():
        want = _eager(model, x, mask)
        got = _predict_thrice(model, x, mask)
    for g in got:
        _assert_same(g, want)
    assert _counters()["predict.graph_captures"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["anchor-based", "anchor-free"])
def test_flash_route_stays_eager(cuda_device, tracer, model_type):
    model = _model(model_type, "attention").to(cuda_device)
    x, mask = _inputs([300], 512, 1024, cuda_device)
    assert not graphable(model, True, 512)
    before = flash.flash_attention_fwd.launches
    runs = _predict_thrice(model, x, mask)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 3
    for got in runs[1:]:
        _assert_same(got, runs[0])
    c = _counters()
    assert c["predict.calls"] == 3
    assert c.get("predict.graph_replays", 0) == 0
    assert "_eval_graphs" not in model.__dict__
