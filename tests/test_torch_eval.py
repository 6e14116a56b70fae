"""edsnet_torch evaluate path vs edsnet_tpu: per-video F-scores and
summaries of the device evaluator, the evaluate CLI on a checkpoint written
by edsnet_tpu, and the port's import isolation."""
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from edsnet_tpu import evaluate as jax_evaluate
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.parallel import eval_device as jax_eval
from edsnet_tpu.utils.checkpoint import save_checkpoint
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch.convert import flax_to_state_dict
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel import eval_device as port_eval

REPO = Path(__file__).resolve().parent.parent
FEAT = 32
SMALL = dict(base_model="attention", num_feature=FEAT, num_hidden=8,
             anchor_scales=[4, 8], num_head=2, fc_depth=2,
             pooling_type="roi")


def _video(rng, key, n_seq, users, uniform=True):
    n_frames = n_seq * 15
    feats = rng.randn(n_seq, FEAT).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    bounds = np.linspace(0, n_frames, 13, dtype=np.int32)
    if uniform:
        picks = np.arange(n_seq, dtype=np.int32) * 15
    else:   # strictly increasing, irregular, first pick after frame 0
        picks = np.sort(rng.choice(np.arange(2, n_frames), n_seq,
                                   replace=False)).astype(np.int32)
    return dict(key=key, seq=feats, gtscore=rng.rand(n_seq).astype(np.float32),
                cps=np.stack([bounds[:-1], bounds[1:] - 1], 1),
                n_frames=n_frames,
                nfps=(bounds[1:] - bounds[:-1]).astype(np.int32), picks=picks,
                user_summary=(rng.rand(users, n_frames) > 0.8
                              ).astype(np.float32))


def _videos():
    rng = np.random.RandomState(3)
    return [_video(rng, "d/tvsum_0", 40, 5), _video(rng, "d/tvsum_1", 57, 5),
            _video(rng, "d/summe_0", 33, 15, uniform=False),
            _video(rng, "d/summe_1", 61, 17)]


def _jax_model_and_vars():
    model = jax_get_model("anchor-based", model_depth="shallow",
                          attention_depth=2, encoder_type="classic",
                          orientation="paper", **SMALL)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    variables = model.init(rngs, jnp.zeros((1, 32, FEAT)),
                           jnp.ones((1, 32), bool))
    return model, variables


def test_device_eval_matches_jax_per_video():
    videos = _videos()
    jmodel, variables = _jax_model_and_vars()
    model = get_model("anchor-based", **SMALL)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()

    jrecords = [JaxRecord(**v) for v in videos]
    records = [VideoRecord(**v) for v in videos]
    jbatches = jax_eval.prepare_eval_batches(jrecords, 2, 32)
    batches = port_eval.prepare_eval_batches(records, 2, 32, "cpu")
    assert [b["uniform_rate"] for b in batches] == [15, 0]
    for jb, tb in zip(jbatches, batches):
        assert jb["frame_bucket"] == tb["frame_bucket"]
        want_f, want_s = jax_eval._eval_batch_device(
            jmodel, variables, jb["jb"], 2, 0.5, jb["frame_bucket"],
            uniform_rate=jb["uniform_rate"])
        got_f, got_s = port_eval._eval_batch_device(
            model, tb["tb"], 2, 0.5, tb["frame_bucket"],
            uniform_rate=tb["uniform_rate"])
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        assert np.asarray(want_s).any()

    per_video = []
    got = port_eval.evaluate_on_device(model, records, 0.5, batch_size=2,
                                       bucket_size=32, per_video=per_video)
    want = jax_eval.evaluate_on_device(jmodel, variables, jrecords, 0.5,
                                       batch_size=2, bucket_size=32)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert [p["key"] for p in per_video] == [v["key"] for v in videos]
    mean_f = port_eval.eval_fscore_device(model, batches, 0.5)
    assert float(mean_f) == pytest.approx(got[0], rel=1e-6)


def _write_dataset(tmp_path, videos):
    with h5py.File(tmp_path / "mock_tvsum.h5", "w") as f:
        for i, v in enumerate(videos):
            g = f.create_group(f"video_{i}")
            g["features"] = v["seq"]
            g["gtscore"] = v["gtscore"]
            g["change_points"] = v["cps"]
            g["n_frame_per_seg"] = v["nfps"]
            g["n_frames"] = v["n_frames"]
            g["picks"] = v["picks"]
            g["user_summary"] = v["user_summary"]
    keys = [f"../datasets/mock_tvsum.h5/video_{i}" for i in range(len(videos))]
    split = tmp_path / "mock.yml"
    with open(split, "w") as f:
        yaml.dump([{"train_keys": keys[:1], "test_keys": keys}], f)
    return split


def test_evaluate_cli_reads_jax_checkpoint(tmp_path, capsys):
    split = _write_dataset(tmp_path, _videos())
    _, variables = _jax_model_and_vars()
    save_checkpoint(variables, tmp_path / "model" / "checkpoint"
                    / "mock.yml.0.pt")
    argv = ["anchor-based", "--device", "cpu", "--splits", str(split),
            "--data-root", str(tmp_path), "--model-dir",
            str(tmp_path / "model"), "--num-feature", str(FEAT),
            "--num-head", "2", "--num-hidden", "8", "--fc-depth", "2",
            "--anchor-scales", "4", "8", "--bucket-size", "32",
            "--batch-size", "2"]
    jax_evaluate.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    port_evaluate.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 2 and "F-score" in want[-1]
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--context-parallel", "2"], ["--tensor-parallel", "2"],
    ["--num-devices", "2"], ["--host-eval"], ["--knapsack-audit"],
    ["--base-model", "nystromformer"], ["--model-depth", "deep"],
    ["--pooling-type", "fft"]])
def test_unserved_flags_raise(flags):
    args = port_evaluate.config_lib.get_arguments(
        ["anchor-based", "--device", "cpu", *flags])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_evaluate.setup(args)


def test_gpu_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            port_evaluate.resolve_device(name)
    assert port_evaluate.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, edsnet_torch\n"
        "for m in pkgutil.walk_packages(edsnet_torch.__path__, "
        "'edsnet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'edsnet_tpu', 'h5py', 'yaml', 'msgpack', "
        "'optax'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('edsnet_torch')"
        "))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 26
    assert {f"edsnet_torch.{m}" for m in (
        "train", "trainer", "data.batching", "ops.losses", "parallel.steps",
        "utils.profiling", "kernels.flash_attention")} <= imported
