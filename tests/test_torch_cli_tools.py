"""edsnet_torch's CLI tools vs edsnet_tpu's on the CPU: model_info prints
JAX's counts for every --model-depth of both heads (and the constants
collection of Performer), make_split writes JAX's yaml for the same seed
(random, cross and --extra-datasets), and sweep writes a JSON report with
JAX's keys on a mock h5 at --max-epoch 1 (trained through the port's
train.train_split_file, its diversity through eval_fold_from_checkpoint).
"""
import json

import h5py
import numpy as np
import pytest
import yaml

from edsnet_tpu import make_split as jax_make_split
from edsnet_tpu import model_info as jax_model_info
from edsnet_tpu import sweep as jax_sweep
from edsnet_torch import make_split, model_info, sweep

SMALL = ["--num-feature", "64", "--num-hidden", "8", "--num-head", "2",
         "--fc-depth", "1", "--anchor-scales", "4", "8"]
LG = "local-global-attention"
CONFIGS = {
    "ab-shallow": ["anchor-based"],
    "ab-deep": ["anchor-based", "--model-depth", "deep"],
    "ab-local-global": ["anchor-based", "--model-depth", LG],
    "ab-original": ["anchor-based", "--model-depth", "original"],
    "ab-cross-classic": ["anchor-based", "--model-depth", "cross-attention"],
    "ab-cross-local-global": ["anchor-based", "--model-depth",
                              "cross-attention", "--encoder-type",
                              "local-global", "--attention-depth", "1"],
    "ab-cross-lstm": ["anchor-based", "--model-depth", "cross-attention",
                      "--base-model", "lstm"],
    "ab-performer": ["anchor-based", "--base-model", "performer"],
    "ab-nystromformer-fft": ["anchor-based", "--base-model", "nystromformer",
                             "--pooling-type", "fft", "--anchor-scales",
                             "12"],
    "af-shallow": ["anchor-free"],
    "af-deep": ["anchor-free", "--model-depth", "deep"],
    "af-original": ["anchor-free", "--model-depth", "original"],
    "af-local-global": ["anchor-free", "--model-depth", LG],
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_model_info_prints_jax_counts(config, capsys):
    argv = SMALL + CONFIGS[config][1:]
    argv = CONFIGS[config][:1] + argv
    jax_model_info.main(argv)
    want = capsys.readouterr().out
    model_info.main(argv)
    got = capsys.readouterr().out
    assert "total:" in want
    assert got == want
    if config == "ab-performer":
        assert "constants:" in got


def _tiny_h5(path, n_videos=5):
    """tests/test_cli_tools.py's h5: videos of 16 + i positions."""
    rng = np.random.RandomState(0)
    with h5py.File(path, "w") as f:
        for i in range(n_videos):
            n_seq = 16 + i
            g = f.create_group(f"video_{i}")
            g["features"] = rng.randn(n_seq, 8).astype(np.float32)
            g["gtscore"] = rng.rand(n_seq).astype(np.float32)
            b = np.linspace(0, n_seq * 15, 5, dtype=np.int32)
            g["change_points"] = np.stack([b[:-1], b[1:] - 1], 1)
            g["n_frame_per_seg"] = b[1:] - b[:-1]
            g["n_frames"] = n_seq * 15
            g["picks"] = np.arange(n_seq, dtype=np.int32) * 15
    return path


@pytest.mark.parametrize("flags", [
    ["--num-splits", "3", "--seed", "1"],
    ["--method", "cross", "--seed", "1"],
    ["--num-splits", "2", "--seed", "0", "--extra-datasets", "EXTRA"],
    ["--method", "cross", "--train-ratio", "0.6", "--seed", "7",
     "--extra-datasets", "EXTRA"]],
    ids=["random", "cross", "random-extra", "cross-extra"])
def test_make_split_writes_jax_yaml(tmp_path, flags, capsys):
    ds = _tiny_h5(tmp_path / "ds.h5", 7)
    extra = _tiny_h5(tmp_path / "extra.h5", 3)
    flags = [str(extra) if f == "EXTRA" else f for f in flags]
    outs = {}
    for name, tool in (("jax", jax_make_split), ("port", make_split)):
        outs[name] = tmp_path / f"{name}.yml"
        tool.main(["--dataset", str(ds), "--save-path", str(outs[name]),
                   *flags])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split(" -> ")[0] == printed[1].split(" -> ")[0]
    assert outs["port"].read_text() == outs["jax"].read_text()
    folds = yaml.safe_load(outs["port"].read_text())
    for fold in folds:
        assert not set(fold["train_keys"]) & set(fold["test_keys"])
        assert len(fold["train_keys"]) + len(fold["test_keys"]) == 7 + (
            3 if "--extra-datasets" in flags else 0)


def _keys(tree):
    """The nested key structure of a JSON report, leaves as their type."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


def test_sweep_report_has_jax_keys(tmp_path):
    """Both sweeps on the same mock h5 (a canonical tvsum split, an aug
    split whose dataset is absent, no summe split file): the same
    settings, split entries, statuses and keys at every level; the port's
    checkpoint reproduces its trained F."""
    data = tmp_path / "datasets"
    data.mkdir()
    rng = np.random.RandomState(0)
    with h5py.File(data / "eccv16_dataset_tvsum_google_pool5.h5", "w") as f:
        for i in range(5):
            n_seq = int(rng.choice([18, 24]))
            n_frames = n_seq * 15
            g = f.create_group(f"video_{i}")
            feats = rng.randn(n_seq, 16).astype(np.float32)
            g["features"] = feats / np.linalg.norm(feats, axis=-1,
                                                   keepdims=True)
            g["gtscore"] = rng.rand(n_seq).astype(np.float32)
            bounds = np.linspace(0, n_frames, 11, dtype=np.int32)
            g["change_points"] = np.stack([bounds[:-1], bounds[1:] - 1], 1)
            g["n_frame_per_seg"] = bounds[1:] - bounds[:-1]
            g["n_frames"] = n_frames
            g["picks"] = np.arange(n_seq, dtype=np.int32) * 15
            g["user_summary"] = (rng.rand(3, n_frames) > 0.8).astype(
                np.float32)
    splits = tmp_path / "splits"
    splits.mkdir()
    keys = [f"../datasets/eccv16_dataset_tvsum_google_pool5.h5/video_{i}"
            for i in range(5)]
    (splits / "tvsum.yml").write_text(yaml.dump(
        [{"train_keys": keys[:4], "test_keys": keys[4:]}]))
    (splits / "tvsum_aug.yml").write_text(yaml.dump(
        [{"train_keys": keys[:4] + [
            "../datasets/eccv16_dataset_ovp_google_pool5.h5/video_0"],
          "test_keys": keys[4:]}]))
    reports = {}
    for name, tool in (("jax", jax_sweep), ("port", sweep)):
        out = tmp_path / f"{name}.json"
        reports[name] = tool.run_sweep([
            "--data-root", str(data), "--splits-dir", str(splits),
            "--output", str(out), "--model-root", str(tmp_path / name),
            "--settings", "canonical", "aug", "--max-epoch", "1",
            "--extra", "--device", "cpu", "--base-model", "linear",
            "--num-feature", "16", "--num-hidden", "8", "--fc-depth", "1",
            "--num-head", "2", "--bucket-size", "32", "--anchor-scales",
            "4"])
        assert json.loads(out.read_text()) == reports[name]
    got, want = reports["port"], reports["jax"]
    assert _keys(got) == _keys(want)
    assert got["config"] == want["config"]
    for setting in ("canonical", "aug"):
        for stem, entry in want["settings"][setting].items():
            assert got["settings"][setting][stem]["status"] == \
                entry["status"]
    tvsum = got["settings"]["canonical"]["tvsum"]
    assert tvsum["status"] == "ok"
    assert 0.0 <= tvsum["fscores"]["mean"] <= 1.0
    assert abs(tvsum["fscores_from_ckpt"]["split0"]
               - tvsum["fscores"]["split0"]) <= 1e-6
    assert got["settings"]["aug"]["tvsum_aug"]["missing"] == [
        "eccv16_dataset_ovp_google_pool5.h5"]
    assert (tmp_path / "port" / "canonical" / "tvsum" / "checkpoint"
            / "tvsum.yml.0.pt").is_file()
