"""EDSNet's local-global anchor-based head against the benchmark's plain
reference (``portbench/reference/local_global.py`` inside
``configs/ab-local-global.py``).

On the CPU at a test's widths (F 32, 2 global heads; the local heads stay
at 2): the port's ``predict`` on padded, masked batches against the
float64 reference at each video's length, n 97 giving segments of 25 / 25
/ 25 / 22; the whole ``ab-local-global.eval-tvsum`` cell cut to test size
comes out correct, and a fault planted in the encoder turns it false; the
tracer's ``lg.segments``, ``lg.slots`` and ``lg.valid`` equal the counts
they stand for and stay still with the tracer off; the three readers of
the cell read their figures, and None without their spans, counters or
kernel; the configuration's operation count is the reference's.

On a card (``cuda`` marker; skips without one): the port's ``predict`` at
the published widths (F 1024, 8 global heads of 128, 2 local heads of
512, the flash route) against the float64 reference, inside the cell's
limits.  Imports neither JAX nor edsnet_tpu, so the card's cases also run
where only the port is installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_lg_reference.py
"""
import json
import types

import numpy as np
import pytest
import torch

from edsnet_torch.config import get_arguments
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.utils import profiling
from portbench import run as bench
from portbench.lib import check, hooks
from portbench.lib.cell import BENCH_DIR, load_cell
from portbench.lib.weights import make_weights
from portbench.tests.conftest import tiny_cell
from portbench.tests.test_portbench_af import _rec
from portbench.tests.test_portbench_counts import _count_matmuls, _reader

CELL = "ab-local-global.eval-tvsum"
BUCKET = 64
SEGMENTS = 4
# f32 against f64 at these widths: the scores sit up to ~1.3e-6 apart and
# the box ends up to ~8e-5 (relative; exp of the loc head after the
# encoder's LayerNorm and the trunk's seven); the cell's limits are 1e-4
# and 3e-3
SCORE_TOL = 1e-5
BOX_TOL = 1e-3


@pytest.fixture(scope="module")
def cell():
    return tiny_cell(CELL)


def _model(cell, device, seed=1234):
    args = get_arguments(cell.program_args(
        "--device", "gpu" if device.type == "cuda" else "cpu"))
    weights = make_weights(cell.model.weight_spec(cell.config), seed, device)
    model = get_model(args.model, **vars(args))
    model.load_state_dict({k: v.cpu() for k, v in weights.items()},
                          strict=True)
    return model.to(device).eval(), weights


@pytest.fixture(scope="module")
def model_and_weights(cell):
    return _model(cell, torch.device("cpu"))


def _batch(lengths, feat, seed, bucket=BUCKET):
    """Unit-norm features padded to the bucket, and the mask."""
    rng = np.random.RandomState(seed)
    n_pad = -(-max(lengths) // bucket) * bucket
    seqs = [rng.randn(n, feat).astype(np.float32) for n in lengths]
    seqs = [s / np.linalg.norm(s, axis=-1, keepdims=True) for s in seqs]
    x = np.zeros((len(lengths), n_pad, feat), np.float32)
    mask = np.zeros((len(lengths), n_pad), bool)
    for j, s in enumerate(seqs):
        x[j, :len(s)] = s
        mask[j, :len(s)] = True
    return seqs, torch.from_numpy(x), torch.from_numpy(mask)


def _gaps(cell, weights, seqs, scores, boxes, device):
    """Each row's predict against the reference at its video's length."""
    out = []
    for j, seq in enumerate(seqs):
        want_s, want_b = check.ref_predict(cell, weights, seq, device)
        t = len(seq) * len(cell.config["anchor_scales"])
        assert want_s.shape == (t,) and want_b.shape == (t, 2)
        out.append(check.predict_gaps(
            scores[j].cpu().numpy().astype(np.float64),
            boxes[j].cpu().numpy().astype(np.float64), want_s, want_b))
    return out


@pytest.mark.parametrize("n", [40, 97, 150])
def test_port_predict_matches_the_reference(n, cell, model_and_weights):
    """The video of n positions beside one of 45 in a padded batch."""
    model, weights = model_and_weights
    seqs, x, mask = _batch([n, 45], cell.config["num_feature"], n)
    with torch.no_grad():
        scores, boxes = model.predict(x, mask)
    for gaps in _gaps(cell, weights, seqs, scores, boxes,
                      torch.device("cpu")):
        assert gaps["cls_gap"] < SCORE_TOL, gaps
        assert gaps["box_gap"] < BOX_TOL, gaps


def _bucket_length_segments(fn):
    """The segments cut from the padded batch's length, not each video's."""
    def call(x, mask):
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                          device=x.device)
    return call


def _without_local_l2n():
    """The local path's L2 normalisation dropped: in each forward of
    ``MultiAttention`` the first ``l2_normalize`` (the global path's)
    runs, the later ones (a segment's each) return their input."""
    calls = [0]

    def forward(fn):
        def call(self, *args, **kwargs):
            calls[0] = 0
            return fn(self, *args, **kwargs)
        return call

    def l2n(fn):
        def call(x, *args, **kwargs):
            calls[0] += 1
            return fn(x, *args, **kwargs) if calls[0] == 1 else x
        return call

    return {"edsnet_torch.models.encoder:MultiAttention.forward": forward,
            "edsnet_torch.models.encoder:l2_normalize": l2n}


LG_FAULTS = {
    "bucket_length_segments": lambda: {
        "edsnet_torch.models.encoder:_true_lengths":
            _bucket_length_segments},
    "without_local_l2n": _without_local_l2n,
}


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
    assert numbers["box_gap"] < BOX_TOL
    for exact in ("keep_diff", "shot_diff", "pick_diff", "summary_diff",
                  "count_diff"):
        assert numbers[exact] == 0, exact
    assert numbers["f_gap"] < 1e-6


@pytest.mark.parametrize("fault", sorted(LG_FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    result, numbers = _run(LG_FAULTS[fault]())
    assert not result["correct"], numbers
    assert result["failed"] >= 1
    assert numbers["cls_gap"] > 1e-3, numbers


@pytest.fixture
def tracer():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.mark.parametrize("masked", [True, False])
def test_segment_counters_count_the_slots(masked, tracer, cell,
                                          model_and_weights):
    model, _ = model_and_weights
    lengths = [40, 97, 150, 64]
    _, x, mask = _batch(lengths, cell.config["num_feature"], 7)
    mask_arg = mask if masked else None
    b, n = x.shape[:2]
    with torch.no_grad():
        model.predict(x, mask_arg)            # off: nothing moves
        assert tracer.snapshot()["counters"] == {}
        tracer.enable()
        model.predict(x, mask_arg)
        tracer.disable()
        model.predict(x, mask_arg)            # off again
    snap = tracer.snapshot()
    buf = -(-n // SEGMENTS)
    c = snap["counters"]
    assert c["lg.segments"] == b * SEGMENTS
    assert c["lg.slots"] == b * SEGMENTS * buf
    assert c["lg.valid"] == (sum(lengths) if masked else b * n)
    assert snap["spans"]["lg/encoder"]["count"] == 1
    assert snap["spans"]["lg/local"]["count"] == 1
    (local,) = [r for r in snap["records"] if r["name"] == "lg/local"]
    assert local["parent"] == "lg/encoder"


# ----------------------------------------------------------------- readers

def _snapshot():
    records = [
        # pass 10: two videos, each loop inside lg/encoder in eval/predict
        _rec(13, "lg/local", 1.0, 12), _rec(12, "lg/encoder", 2.0, 11),
        _rec(11, "eval/predict", 5.0, 10),
        _rec(16, "lg/local", 3.0, 15), _rec(15, "lg/encoder", 4.0, 14),
        _rec(14, "eval/predict", 6.0, 10),
        _rec(10, "eval/pass", 100.0),
        _rec(23, "lg/local", 2.0, 22), _rec(22, "lg/encoder", 3.0, 21),
        _rec(21, "eval/predict", 5.0, 20), _rec(20, "eval/pass", 90.0),
        # a pass the profiler stopped inside: its loop ran untraced
        _rec(33, "lg/local", 9.0, 32, profiled=False),
        _rec(32, "lg/encoder", 9.5, 31, profiled=False),
        _rec(31, "eval/predict", 10.0, 30), _rec(30, "eval/pass", 80.0),
        # a pass outside the profiled stretch
        _rec(43, "lg/local", 9.0, 42, profiled=False),
        _rec(42, "lg/encoder", 9.5, 41, profiled=False),
        _rec(41, "eval/predict", 10.0, 40, profiled=False),
        _rec(40, "eval/pass", 80.0, profiled=False)]
    counters = {"lg.segments": 80, "lg.slots": 16000, "lg.valid": 12800}
    return {"spans": {}, "counters": counters, "records": records,
            "dropped": 0}


def test_span_and_counter_readers_on_a_hand_made_snapshot():
    snap = _snapshot()
    # (1 + 3) and 2 ms in the two profiled passes
    assert _reader("lg_local_ms").figure(snap) == pytest.approx(3.0)
    assert _reader("lg_segment_fill_pct").figure(snap) == pytest.approx(80.0)


@pytest.mark.parametrize("name", ["lg_local_ms", "lg_segment_fill_pct"])
def test_reader_without_its_span_or_counter_reads_none(name):
    reader = _reader(name)
    empty = {"spans": {}, "counters": {}, "records": [], "dropped": 0}
    assert reader.figure(empty) is None
    snap = _snapshot()
    snap["records"] = [r for r in snap["records"] if r["name"] != "lg/local"]
    snap["counters"] = {"predict.calls": 4}
    assert reader.figure(snap) is None


def _attention_call(heads, n_pad, d, lens):
    q = torch.zeros(len(lens), heads, n_pad, d)
    mask = torch.arange(n_pad)[None, :] < torch.tensor(lens)[:, None]
    return (q, q, q, mask), {"precision": "highest"}


def test_head_dim_512_roofline_reads_only_its_calls_and_kernel():
    reader = _reader("attn_fwd512_roofline")
    core = _reader("attn_fwd_roofline")
    least = sum(core.least_seconds(2, n, 512) for n in (60, 64, 37))
    t = types.SimpleNamespace(
        kernels=[("void (anonymous namespace)::flash_fwd_cluster_kernel"
                  "<256, 3>(float const*, float const*)", 0.0, least * 2),
                 ("void (anonymous namespace)::flash_fwd_cluster_kernel"
                  "<256, 3>(float const*, float const*)", 5.0,
                  5.0 + least * 2),
                 ("void (anonymous namespace)::flash_fwd_kernel<128, 3>"
                  "(float const*)", 1.0, 2.0),
                 ("flash_fwd_cluster_kernel<128, 3>", 2.0, 3.0)],
        calls={reader.CORE: [_attention_call(2, 64, 512, [60]),
                             _attention_call(8, 256, 128, [250]),
                             _attention_call(2, 64, 512, [64, 37])]})
    assert reader.read(t) == pytest.approx(25.0)
    assert reader.CALLS == core.CALLS


@pytest.mark.parametrize("missing", ["kernel", "call", "both"])
def test_head_dim_512_roofline_without_its_kernel_or_call_reads_none(
        missing):
    reader = _reader("attn_fwd512_roofline")
    kernels = [("flash_fwd_kernel<128, 3>", 0.0, 1.0)]
    if missing == "call":
        kernels.append(("flash_fwd_cluster_kernel<256, 3>", 1.0, 2.0))
    calls = [_attention_call(8, 256, 128, [250])]
    if missing == "kernel":
        calls.append(_attention_call(2, 64, 512, [60]))
    t = types.SimpleNamespace(kernels=kernels, calls={reader.CORE: calls})
    assert reader.read(t) is None


@pytest.mark.parametrize("name", ["lg_local_ms", "lg_segment_fill_pct"])
def test_names_are_no_import_targets(name):
    reader = _reader(name)
    assert reader.PROFILE
    try:
        names = reader.spans(load_cell(CELL))
    finally:
        profiling.disable()
        profiling.reset()
    assert names and all("/" in n and not hooks.exists(n) for n in names)


@pytest.mark.parametrize("n", [64, 97, 301])
def test_forward_flops_count_the_products(n):
    """The configuration's count equals the matmul work of a run of the
    plain reference head at a test width: the global attention, the four
    segments' at their true lengths, the shared fc twice over n rows,
    fc2, the trunk and the heads."""
    cell = load_cell(CELL)
    cfg = dict(cell.config, num_feature=64, num_head=2)
    W = make_weights(cell.model.weight_spec(cfg), 0, torch.device("cpu"))
    x = torch.randn(n, 64)
    got = _count_matmuls(lambda: cell.model.HEAD.predict(cfg, W, x))
    assert got == pytest.approx(cell.model.forward_flops(cfg, n), rel=1e-9)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def full_cell():
    return load_cell(CELL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [240, 700, 1200])
def test_published_widths_on_the_card_match_the_reference(
        n, cuda_device, full_cell):
    """F 1024, 8 global heads of 128 and 2 local heads of 512 on the flash
    route, a video of n positions padded to its eval bucket (a multiple of
    256) beside a shorter one, against the float64 reference, inside the
    cell's limits; f32 products without TF32, as ``evaluate.setup`` sets
    them for the cell."""
    from edsnet_torch.kernels import flash_attention as flash
    limits = json.loads((BENCH_DIR / "limits" / f"{CELL}.json").read_text())
    with check.precision(False):
        model, weights = _model(full_cell, cuda_device, seed=n)
        seqs, x, mask = _batch([n, n // 3], 1024, n, bucket=256)
        before = dict(flash.flash_attention_fwd.launches_by_head_dim)
        with torch.no_grad():
            scores, boxes = model.predict(x.to(cuda_device),
                                          mask.to(cuda_device))
        torch.cuda.synchronize(cuda_device)
        gaps = _gaps(full_cell, weights, seqs, scores, boxes, cuda_device)
    after = flash.flash_attention_fwd.launches_by_head_dim
    assert after.get(512, 0) - before.get(512, 0) == SEGMENTS
    assert after.get(128, 0) - before.get(128, 0) == 1
    for g in gaps:
        assert g["cls_gap"] <= limits["cls_gap"], gaps
        assert g["box_gap"] <= limits["box_gap"], gaps
    print(f"n {n}: {gaps}")
