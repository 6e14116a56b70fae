"""The heads' eval forward replayed from CUDA graphs
(``edsnet_torch/models/graphed.py``).

On the CPU: the rule that decides which forwards are graphed (from the
model and the length alone), and ``predict`` left eager there, returning
the eager forward's decode, with the tracer counting its calls and no
replay; and, with stand-ins for the CUDA graph calls (the work captured
runs once, at capture), a capture split at each flash call into pieces,
the spans and counters it notes, and a replay that calls the module's
``flash_attention`` with a mask of its own, opens the noted spans and
adds the noted counts.  On a card (``cuda`` marker; every case skips
without one): graphed ``predict`` against the eager forward and decode at
each eval bucket and at batch 4, for the headline model (F 1024, the
Nystromformer mixer of 8 heads of 64, 64 landmarks, anchor scale 12) and
for every backbone and depth the CLIs build; an in-place weight change
read by the next replay; results that do not alias the graph's buffers; a
capture on a key's second call only; graphs that go with their model; the
flash route replayed in pieces, bit-equal, its kernel launched and
counted once a call and replay, the local-global head's counters and
spans in every replayed forward, and each recorded flash call keeping its
own video's mask.

Imports neither JAX nor edsnet_tpu, so the card's cases also run where
only the port is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_predict_graph.py
"""
import contextlib
import gc
import types
import weakref

import pytest
import torch

from edsnet_torch.kernels import flash_attention as flash
from edsnet_torch.models import graphed
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
    ("attention, flash route", {"base_model": "attention"}, True, True),
    ("attention, anchor-free flash route",
     {"base_model": "attention", "model_type": "anchor-free"}, True, True),
    ("attention, --use-pallas", {"base_model": "attention",
                                 "use_pallas": True}, True, True),
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


# --- a capture in pieces, with stand-ins for the CUDA graph calls -------

class _FakeGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: what it captured ran once, at
    capture; a replay is counted."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _FakeCapture:
    """``torch.cuda.graph`` on the CPU, logging each piece's capture."""
    capture_stream = types.SimpleNamespace(wait_stream=lambda stream: None)
    log = None

    def __init__(self, graph, pool=None):
        self.graph = graph

    def __enter__(self):
        self.log.append("begin")

    def __exit__(self, *exc):
        self.log.append("end")


@pytest.fixture
def fake_graphs(monkeypatch):
    """The CUDA graph calls ``models/graphed.py`` makes, as stand-ins; the
    capture log."""
    log = []
    monkeypatch.setattr(_FakeCapture, "log", log)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    return log


def _flash_model(model_depth):
    """The attention head on the flash route on the CPU (--use-pallas: the
    kernel's twin), at test widths."""
    return _model(base_model="attention", num_feature=64, num_head=2,
                  use_pallas=True, model_depth=model_depth)


LG, LOCAL = ("lg/encoder",), ("lg/encoder", "lg/local")
# depth -> the open spans where each piece ends, the counters noted
PIECES = {
    "shallow": ([(), ()], []),
    "local-global-attention": (
        [LG, LOCAL, LOCAL, LOCAL, LOCAL, ()],
        ["lg.segments", "lg.slots"] + ["lg.valid"] * 4),
}


@pytest.mark.parametrize("model_depth", sorted(PIECES))
def test_capture_splits_at_each_flash_call(fake_graphs, tracer,
                                           monkeypatch, model_depth):
    model = _flash_model(model_depth)
    x, mask = _inputs([41, 3], 64, 64)
    spans, counts = PIECES[model_depth]
    called = []
    monkeypatch.setattr(flash, "flash_attention",
                        lambda *args, **kwargs: called.append(args))
    with torch.inference_mode():
        g = graphed._Graph(model, x, mask)
    assert called == []         # neither the warm-up nor the capture
    assert len(g.pieces) == len(spans) == len(g.steps) + 1
    assert fake_graphs == ["begin", "end"] * len(spans)
    assert [[name for name, _ in piece] for piece in g.spans] \
        == [list(names) for names in spans]
    assert [step.precision for step in g.steps] == ["default"] * len(g.steps)
    assert all(step.out.dtype == torch.float32
               and step.out.shape == step.q.shape for step in g.steps)
    assert [name for name, _ in g.counts] == counts
    # the warm-up and the capture are no forward: nothing traced
    snap = profiling.snapshot()
    assert snap["counters"] == {} and snap["spans"] == {}


@pytest.mark.parametrize("model_depth", sorted(PIECES))
def test_replay_calls_the_module_wrapper_with_masks_of_its_own(
        fake_graphs, monkeypatch, model_depth):
    model = _flash_model(model_depth)
    x, mask = _inputs([41, 3], 64, 64)
    with torch.inference_mode():
        g = graphed._Graph(model, x, mask)
        calls = []
        original = flash.flash_attention

        def recorded(*args, **kwargs):
            calls.append((args, kwargs))
            return original(*args, **kwargs)

        monkeypatch.setattr(flash, "flash_attention", recorded)
        g.replay(x, mask)
    assert [piece.replays for piece in g.pieces] == [1] * len(g.pieces)
    assert len(calls) == len(g.steps)
    for (args, kwargs), step in zip(calls, g.steps):
        assert args[:3] == (step.q, step.k, step.v)
        assert args[3] is not step.mask and torch.equal(args[3], step.mask)
        assert kwargs == {"precision": "default"}
        assert torch.equal(step.out, original(*args, **kwargs))


def test_replay_adds_the_noted_counts_and_opens_the_noted_spans(
        fake_graphs, tracer, monkeypatch):
    """Through ``predict``, with every forward graphable: a capture
    traced or not counts one forward a call, as eager forwards do, and
    each replay opens ``lg/encoder`` and ``lg/local`` once.  (The stand-in
    pieces run nothing at a replay, so only the eager call's result is
    the forward's.)"""
    monkeypatch.setattr(graphed, "graphable", lambda *args: True)
    model = _flash_model("local-global-attention")
    x, mask = _inputs([41, 3], 64, 64)
    with torch.inference_mode():
        want = _eager(model, x, mask)
        eager = _counters()
        profiling.reset()
        runs = _predict_thrice(model, x, mask)
    _assert_same(runs[0], want)
    c = _counters()
    assert (c["predict.calls"], c["predict.graph_captures"],
            c["predict.graph_replays"], c["predict.graph_pieces"]) \
        == (3, 1, 2, 12)
    for name in ("lg.segments", "lg.slots", "lg.valid"):
        assert c[name] == 3 * eager[name], name
    snap = profiling.snapshot()
    assert snap["spans"]["lg/encoder"]["count"] == 3
    assert snap["spans"]["lg/local"]["count"] == 3
    parents = {r["id"]: r["name"] for r in snap["records"]}
    for r in snap["records"]:
        if r["name"] == "lg/local":
            assert parents[r["parent_id"]] == "lg/encoder"


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
    under --no-pallas (the dense route; the flash route's pieces have
    tests of their own below)."""
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


def _launches_by_head_dim():
    return dict(flash.flash_attention_fwd.launches_by_head_dim)


def _launched_since(before):
    after = _launches_by_head_dim()
    return {d: n - before.get(d, 0) for d, n in after.items()
            if n != before.get(d, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,model_depth,launches,pieces", [
    ("anchor-based", "shallow", {128: 1}, 2),
    ("anchor-free", "shallow", {128: 1}, 2),
    ("anchor-based", "local-global-attention", {128: 1, 512: 4}, 6)])
def test_flash_route_replays_in_pieces(cuda_device, tracer, model_type,
                                       model_depth, launches, pieces):
    model = _model(model_type, "attention",
                   model_depth=model_depth).to(cuda_device)
    x, mask = _inputs([300], 512, 1024, cuda_device)
    assert graphable(model, True, 512)
    with torch.inference_mode():
        want = _eager(model, x, mask)
        before = _launches_by_head_dim()
        runs = _predict_thrice(model, x, mask)
        torch.cuda.synchronize()
        # once a call: eager, the capture's replay (its warm-up launches
        # none), a replay
        assert _launched_since(before) == {d: 3 * n
                                           for d, n in launches.items()}
        for _ in range(2):
            before = _launches_by_head_dim()
            runs.append(model.predict(x, mask))
            torch.cuda.synchronize()
            assert _launched_since(before) == launches
    for got in runs:
        _assert_same(got, want)
    c = _counters()
    assert (c["predict.calls"], c["predict.graph_captures"],
            c["predict.graph_replays"]) == (5, 1, 4)
    assert c["predict.graph_pieces"] == pieces * c["predict.graph_replays"]


def _local_global(device):
    return _model("anchor-based", "attention",
                  model_depth="local-global-attention").to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("lens,bucket", [
    ([241], 256), ([1200], 1216), ([241, 2], 256), ([5], 64)])
def test_local_global_replay_counts_and_spans_every_forward(
        cuda_device, tracer, lens, bucket):
    """Lengths whose last segment is short (241: 61 / 61 / 61 / 58) or
    empty (5: 2 / 2 / 1 / 0; 2: 1 / 1 / 0 / 0), buckets of 64; the graph
    captured with the tracer off, then the tracer on."""
    model = _local_global(cuda_device)
    x, mask = _inputs(lens, bucket, 1024, cuda_device)
    profiling.disable()
    with torch.inference_mode():
        model.predict(x, mask)
        model.predict(x, mask)                  # captured, tracer off
        profiling.enable()
        want = _eager(model, x, mask)
        eager = _counters()
        profiling.reset()
        runs = [model.predict(x, mask) for _ in range(2)]
    for got in runs:
        _assert_same(got, want)
    c = _counters()
    assert c["predict.graph_replays"] == 2
    assert c["predict.graph_pieces"] == 12
    for name in ("lg.segments", "lg.slots", "lg.valid"):
        assert c[name] == 2 * eager[name], name
    assert eager["lg.valid"] == sum(lens)
    snap = profiling.snapshot()
    assert snap["spans"]["lg/encoder"]["count"] == 2
    assert snap["spans"]["lg/local"]["count"] == 2
    parents = {r["id"]: r["name"] for r in snap["records"]}
    assert all(parents[r["parent_id"]] == "lg/encoder"
               for r in snap["records"] if r["name"] == "lg/local")


def _segment_lengths(n, segments=4):
    size = -(-n // segments)
    return [max(0, min((s + 1) * size, n) - s * size)
            for s in range(segments)]


@pytest.mark.cuda
@pytest.mark.parametrize("model_depth", ["shallow",
                                         "local-global-attention"])
def test_recorded_flash_calls_keep_their_own_masks(cuda_device,
                                                   model_depth):
    """The benchmark's view (``portbench/lib/hooks.py:recorded`` on the
    module attribute): two videos of one bucket replayed in turn; after
    the second, each call's mask still sums to its own video's lengths
    (the length for the global attention, a segment's for a local one)."""
    from portbench.lib import hooks

    model = _model("anchor-based", "attention",
                   model_depth=model_depth).to(cuda_device)
    lens = [300, 170]
    videos = [_inputs([n], 512, 1024, cuda_device, seed=i)
              for i, n in enumerate(lens)]
    calls = []
    target = "edsnet_torch.kernels.flash_attention:flash_attention"
    with torch.inference_mode():
        model.predict(*videos[0])
        model.predict(*videos[0])               # the key is captured
        with hooks.patched({target: hooks.recorded(calls, lambda: True)}):
            for x, mask in videos:
                model.predict(x, mask)
        torch.cuda.synchronize()
    want = []
    for n in lens:
        want.append([n])
        if model_depth != "shallow":
            want += [[s] for s in _segment_lengths(n)]
    assert [args[3].sum(-1).tolist() for args, _ in calls] == want
