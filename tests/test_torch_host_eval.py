"""edsnet_torch host evaluator and knapsack audit vs edsnet_tpu: per-video F
and diversity of the host ``evaluate`` against the port's device evaluator
and JAX's host ``evaluate`` on the same weights, ``KnapsackAudit``'s counts
and report lines against JAX's, and the evaluate CLI with ``--host-eval``
and ``--knapsack-audit`` printing JAX's lines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edsnet_tpu import evaluate as jax_evaluate
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.ops import summary as jax_summ
from edsnet_tpu.utils.checkpoint import save_checkpoint
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch.convert import flax_to_state_dict
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.ops import summary as port_summ
from edsnet_torch.parallel import eval_device as port_eval
from tests.test_torch_eval import FEAT, SMALL, _videos, _write_dataset

# (model type, port and JAX factory kwargs)
CONFIGS = {
    "anchor-based attention": ("anchor-based", dict(SMALL)),
    "anchor-free nystromformer": ("anchor-free", dict(
        base_model="nystromformer", num_feature=FEAT, num_hidden=8,
        num_head=2, fc_depth=2)),
}
JAX_EXTRA = dict(model_depth="shallow", attention_depth=2,
                 encoder_type="classic", orientation="paper")


def _models(name):
    kind, kwargs = CONFIGS[name]
    jmodel = jax_get_model(kind, **JAX_EXTRA, **kwargs)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, FEAT)), jnp.ones((1, 32), bool))
    model = get_model(kind, **kwargs)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_evaluate_matches_device_and_jax(name):
    videos = _videos()
    jmodel, variables, model = _models(name)
    records = [VideoRecord(**v) for v in videos]
    host, device = [], []
    got = port_evaluate.evaluate(model, records, 0.5, batch_size=2,
                                 bucket_size=32, per_video=host)
    port_eval.evaluate_on_device(model, records, 0.5, batch_size=2,
                                 bucket_size=32, per_video=device)
    assert [p["key"] for p in host] == [v["key"] for v in videos]
    for h, d in zip(host, device):
        assert h["fscore"] == pytest.approx(d["fscore"], abs=1e-6), h["key"]
        assert h["diversity"] == pytest.approx(d["diversity"], abs=1e-6)
        np.testing.assert_array_equal(h["summary"], d["summary"])
    assert any(p["summary"].any() for p in host)

    want = jax_evaluate.evaluate(jmodel, variables,
                                 [JaxRecord(**v) for v in videos], 0.5,
                                 batch_size=2, bucket_size=32)
    assert got == pytest.approx(want, abs=1e-6)


def _record(n_seq=20, n_frames=300, seed=0, cls=VideoRecord):
    """tests/ops/test_knapsack_audit.py's record: 15 shots, so the 15 %
    budget packs a few."""
    rng = np.random.RandomState(seed)
    bounds = np.linspace(0, n_frames, 16, dtype=np.int32)
    return cls(
        key="../d/tvsum.h5/video_0",
        seq=rng.randn(n_seq, 8).astype(np.float32),
        gtscore=rng.rand(n_seq).astype(np.float32),
        cps=np.stack([bounds[:-1], bounds[1:] - 1], 1),
        n_frames=n_frames,
        nfps=bounds[1:] - bounds[:-1],
        picks=np.arange(n_seq, dtype=np.int32) * 15,
        user_summary=(rng.rand(3, n_frames) > 0.8).astype(np.float32))


def _flip(real):
    """A solver whose ``bnb`` packs the shots after the DP's: a forced tie
    flip, as tests/ops/test_knapsack_audit.py makes one."""
    def flipped(values, weights, capacity, solver="auto"):
        if solver == "bnb":
            sel = real(values, weights, capacity, solver="dp")
            return [i + 1 for i in sel if i + 1 < len(values)] or sel
        return real(values, weights, capacity, solver=solver)
    return flipped


def _audit_run(audit, summ, record):
    kept_cls = np.array([0.9, 0.5], np.float32)
    kept_boxes = np.array([[0, 8], [10, 18]], np.int32)
    pred_summ = summ.bbox2summary(
        record.seq.shape[0], kept_cls, kept_boxes, record.cps,
        record.n_frames, record.nfps, record.picks)
    audit.check(record, kept_cls, kept_boxes, "avg", pred_summ)
    return pred_summ


def test_audit_counts_divergence_as_jax(monkeypatch):
    audits = {}
    for pkg, module, summ, name, cls in (
            ("jax", jax_evaluate, jax_summ, "knapsack", JaxRecord),
            ("port", port_evaluate, port_summ, "knapsack_host",
             VideoRecord)):
        audit = module.KnapsackAudit()
        assert audit.available
        record = _record(cls=cls)
        _audit_run(audit, summ, record)         # the same selection
        assert (audit.n_videos, audit.n_diverged) == (1, 0)
        with monkeypatch.context() as m:
            m.setattr(summ, name, _flip(getattr(summ, name)))
            _audit_run(audit, summ, record)
        audits[pkg] = audit
    got, want = audits["port"], audits["jax"]
    assert (got.n_videos, got.n_diverged) == (want.n_videos,
                                              want.n_diverged) == (2, 1)
    assert got.abs_df == pytest.approx(want.abs_df, abs=1e-12)
    assert got.report() == want.report()
    assert "1/2 videos diverged" in got.report()


def test_audit_report_without_library_as_jax(monkeypatch):
    monkeypatch.setattr(jax_evaluate, "_native_load", lambda: None)
    monkeypatch.setattr(port_evaluate, "_native_load", lambda: None)
    reports = []
    for module, cls in ((jax_evaluate, JaxRecord),
                        (port_evaluate, VideoRecord)):
        audit = module.KnapsackAudit()
        audit.check(_record(cls=cls), np.array([0.9]), np.array([[0, 8]]),
                    "avg", np.zeros(300, bool))
        assert audit.n_videos == 0
        reports.append(audit.report())
    assert reports[0] == reports[1]
    assert "unavailable" in reports[1]


def test_evaluate_passes_every_video_through_audit():
    _, _, model = _models("anchor-based attention")
    records = [VideoRecord(**v) for v in _videos()]
    audit = port_evaluate.KnapsackAudit()
    port_evaluate.evaluate(model, records, 0.5, batch_size=2, bucket_size=32,
                           knapsack_audit=audit)
    assert audit.n_videos == len(records)
    assert audit.report().startswith(
        f"knapsack audit: {audit.n_diverged}/{len(records)} videos diverged")


@pytest.mark.parametrize("flag", ["--host-eval", "--knapsack-audit"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_evaluate_cli_host_paths_print_jax_lines(tmp_path, capsys, flag,
                                                 name):
    split = _write_dataset(tmp_path, _videos())
    _, variables, _ = _models(name)
    save_checkpoint(variables, tmp_path / "model" / "checkpoint"
                    / "mock.yml.0.pt")
    kind, kwargs = CONFIGS[name]
    argv = [kind, "--device", "cpu", "--base-model", kwargs["base_model"],
            "--splits", str(split), "--data-root", str(tmp_path),
            "--model-dir", str(tmp_path / "model"),
            "--num-feature", str(FEAT), "--num-head", "2",
            "--num-hidden", "8", "--fc-depth", "2", "--bucket-size", "32",
            "--batch-size", "2"]
    if kind == "anchor-based":
        argv += ["--anchor-scales", "4", "8"]
    argv.append(flag)
    jax_evaluate.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    port_evaluate.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == (3 if flag == "--knapsack-audit" else 2)
    assert "F-score" in want[-1]
    assert got == want
    # the default path prints the same F
    port_evaluate.main(argv[:-1])
    assert capsys.readouterr().out.strip().splitlines() == want[-2:]
